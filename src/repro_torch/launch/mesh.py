"""The serving mesh (a port of ``repro.launch.mesh.make_serving_mesh``).

A ``("data", "model")`` mesh of *logical* devices, all on one physical
device: the card by default, or the CPU when the caller asks for it.  The
reference gets a mesh on one CPU by simulating host devices; the port's
counterpart keeps every logical device's buffers on the one physical
device, keyed by the logical device's id.  A mesh over several cards
waits for a machine that has them (ROADMAP).  ``make_local_mesh`` and
``make_production_mesh`` serve training and come with it (ROADMAP queue 1
item 15).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import LogicalDevice, Mesh


def make_serving_mesh(mesh_shape: Sequence[int],
                      device: DeviceLike = None) -> Mesh:
    """A ("data", "model") mesh of ``prod(mesh_shape)`` logical devices
    on ``device`` (default: the GPU) — the serving stack's knob for
    sharded cold starts.  A 1-d shape means pure model parallelism:
    ``(4,)`` == ``(1, 4)``."""
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) == 1:
        shape = (1,) + shape
    if len(shape) != 2:
        raise ValueError(f"mesh_shape must be 1- or 2-d, got {mesh_shape}")
    if min(shape) < 1:
        raise ValueError(f"mesh_shape {shape} has an empty axis")
    dev = resolve_device(device)
    n = shape[0] * shape[1]
    devices = np.empty(n, dtype=object)
    for i in range(n):
        devices[i] = LogicalDevice(i, dev)
    return Mesh(devices.reshape(shape), ("data", "model"))
