"""The assigned input-shape cells and per-(arch x shape) applicability,
the twin of the reference's ``configs/shapes.py``.

LM shapes are seq_len x global_batch.  ``decode_*`` / ``long_*`` are one
new token against a seq_len KV cache, not a training step.  Skips:

  * ``long_500k`` needs sub-quadratic attention -> skipped for pure
    full-attention archs (O(S) ring caches / O(1) states run it);
  * encoder-only archs (hubert) have no autoregressive step -> decode
    shapes are skipped; ``prefill`` for an encoder is a plain forward.

The reference's Pallas tile profiles (``KernelBlocks``) have no twin
here: each CUDA kernel's launch choices come from its own ``plan`` in
``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.api import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def supported(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, Optional[str]]:
    """(runnable, skip_reason)."""
    if cell.kind == "decode":
        if cfg.is_encoder:
            return False, "encoder-only: no autoregressive decode step"
        if cell.name == "long_500k" and not cfg.subquadratic:
            return False, ("full attention: 500k-token KV decode is "
                           "infeasible (O(S) cache per token)")
    return True, None


def smoke_cell(kind: str) -> ShapeCell:
    """Reduced cells for CPU smoke tests."""
    return {"train": ShapeCell("smoke_train", "train", 32, 2),
            "prefill": ShapeCell("smoke_prefill", "prefill", 32, 2),
            "decode": ShapeCell("smoke_decode", "decode", 64, 2)}[kind]
