"""Meshes of the port (a port of ``repro.launch.mesh``).

A ``("data", "model")`` mesh of *logical* devices, all on one physical
device: the card by default, or the CPU when the caller asks for it.  The
reference gets a mesh on one CPU by simulating host devices; the port's
counterpart keeps every logical device's buffers on the one physical
device, keyed by the logical device's id.  A mesh over several cards
waits for a machine that has them (ROADMAP).

``make_local_mesh`` is the training process's own mesh: a process drives
one card (data parallelism across cards is one process a card, joined by
``torch.distributed``), so it is (1, 1) on that card.
``make_production_mesh`` is the reference's pod shape as a logical mesh
on the meta device: for specs only, never for placement.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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


def _logical(shape, axes, dev: torch.device) -> Mesh:
    n = int(np.prod(shape))
    devices = np.empty(n, dtype=object)
    for i in range(n):
        devices[i] = LogicalDevice(i, dev)
    return Mesh(devices.reshape(tuple(shape)), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16): the reference's
    pod meshes, as logical devices on the meta device — specs only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _logical(shape, axes, torch.device("meta"))


def make_local_mesh(model_parallel: int = 1,
                    device: DeviceLike = None) -> Mesh:
    """Whatever this process computes on (tests / smoke runs): its one
    device (default: the GPU), as a (data, model) mesh; ``model_parallel``
    is capped at the process's device count, as in the reference."""
    dev = resolve_device(device)
    n = 1
    mp = min(model_parallel, n)
    return _logical((n // mp, mp), ("data", "model"), dev)
