"""Where the port runs.

Every entry point (``ColdStartEngine``, ``transformer.build``,
``reference_generate``) takes ``device=None``, which means the GPU: with no
CUDA device present it raises instead of carrying on elsewhere.  Passing
``device="cpu"`` runs the same code on the CPU, where each kernel wrapper
takes its plain PyTorch version; the tests do that.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found: the port runs on the GPU by default; "
                "pass device='cpu' to run its plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device):
    """Wait for the work queued on the calling thread's current stream of
    ``device`` — not for other threads' streams, as
    ``torch.cuda.synchronize()`` would.  No-op on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()
