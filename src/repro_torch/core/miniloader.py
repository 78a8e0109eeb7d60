"""MiniLoader — opportunistic layer construction (paper Sec. III-B).

Conventional construction (the PISeL-faithful path) instantiates the
layer and *numerically initializes* every parameter, materializing f32
buffers whose values pre-trained weights overwrite anyway.

MiniLoader replaces that with:

  * **abstract construction** — the unit's ``nn.Module`` built on
    ``torch.device("meta")``: shapes, dtypes and tree layout, no storage
    and no initialization;
  * **bit-packed placeholders** — 1 bit per parameter (``ceil(n/8)``
    uint8 bytes), the paper's 1/32-of-fp32 memory, holding slot identity
    between construction and weight application.

PISeL keeps real numerical initialization (``init_unit``) on the engine's
device; the contrast between the two is what the paper measures.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import synchronize
from repro_torch.store.store import leaf_path_name

PyTree = Any


@dataclasses.dataclass
class ConstructedUnit:
    """A layer structure produced by the Layer construction unit."""
    name: str
    abstract: PyTree                     # meta-tensor tree (shapes, dtypes)
    init_params: Optional[PyTree]        # PISeL path: materialized init
    placeholders: Optional[Dict[str, np.ndarray]]  # Mini path: bit-packed
    mem_bytes: int                       # residency between L-end and A-end
    t_construct_end: float = 0.0

    @property
    def mini(self) -> bool:
        return self.placeholders is not None


def n_params(abstract: PyTree) -> int:
    return sum(math.prod(l.shape) for l in tree_util.leaves(abstract))


def full_bytes(abstract: PyTree) -> int:
    return sum(math.prod(l.shape) * l.element_size()
               for l in tree_util.leaves(abstract))


def construct_unit(model, name: str, seed: int, *, mini: bool,
                   device: torch.device) -> ConstructedUnit:
    """The pipeline's L_i.

    mini=False — PISeL-faithful: real numerical initialization on
    ``device`` from a generator seeded with ``seed`` (deliberately the
    expensive path the paper measures).
    mini=True — MiniLoader: the meta-device structure + 1-bit
    placeholders.
    """
    if mini:
        abstract = model.abstract_unit(name)
        placeholders: Dict[str, np.ndarray] = {}
        mem = 0
        for path, leaf in tree_util.leaves_with_path(abstract):
            packed = np.zeros((math.prod(leaf.shape) + 7) // 8, np.uint8)
            placeholders[leaf_path_name(path)] = packed
            mem += packed.nbytes
        return ConstructedUnit(name, abstract, None, placeholders, mem,
                               time.monotonic())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init_unit(name, gen)
    synchronize(device)
    abstract = tree_util.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
    return ConstructedUnit(name, abstract, params, None, full_bytes(abstract),
                           time.monotonic())
