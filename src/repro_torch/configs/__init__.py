"""Config registry: importing this package registers every architecture
of the port:

  * the 10 assigned LM-family archs (``lm_archs``) — full + smoke,
  * the paper's own ResNet/VGG/ViT families (``vision_archs``),
  * the shape cells (``shapes``).

``repro_torch.models.api.get_config(name, smoke=...)`` is the lookup API.
"""
from repro_torch.configs import lm_archs  # noqa: F401
from repro_torch.configs import vision_archs  # noqa: F401
from repro_torch.configs.lm_archs import ASSIGNED  # noqa: F401
from repro_torch.configs.shapes import (SHAPES, ShapeCell,  # noqa: F401
                                       smoke_cell, supported)
