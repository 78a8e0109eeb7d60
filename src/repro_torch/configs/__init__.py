"""Config registry: importing this package registers every LM-family
architecture of ``lm_archs`` (full and smoke).  The vision families and
the shape cells of the reference come with their slices (ROADMAP queue 1
items 7 and 15).

``repro_torch.models.api.get_config(name, smoke=...)`` is the lookup API.
"""
from repro_torch.configs import lm_archs  # noqa: F401
from repro_torch.configs.lm_archs import ASSIGNED  # noqa: F401
