"""Work of the decoders (dense and MoE) by kernel family and of the whole
model, from the configuration's shapes alone.

Each product counts its inputs once and its output once: the
activations' rows, the weight and its scales, the output's rows; its
operations are 2 per multiply-add of the rows that need it (a decode
step's live rows, and each token's ``top_k`` experts).  Attention counts
4 dh operations a visible (query, key) pair and head, and q, k, v and
the output once.  ``weight_transform`` counts each int8 value, its
column's scale and the bf16 output once (1-D leaves: the f32 read and
the bf16 write of the cast).
"""
from __future__ import annotations

from typing import Tuple

from portbench import weights as W

Work = Tuple[float, float]          # (operations, bytes)

BF16, INT8, F32 = 2, 1, 4


def _add(a: Work, b: Work) -> Work:
    return a[0] + b[0], a[1] + b[1]


def visible_pairs(S: int, window: int) -> int:
    """Sum over queries 0..S-1 of the keys each sees: min(i + 1, W)."""
    if window <= 0 or S <= window:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def weight_transform_load(cfg) -> Work:
    """Every leaf of the model transformed once at A (int8 -> bf16 for
    two or more axes, f32 -> bf16 casts for 1-D leaves)."""
    ops = nbytes = 0.0
    for unit in W.unit_names(cfg):
        for _, shape, _ in W.unit_leaves(cfg, unit):
            n = 1
            for s in shape:
                n *= s
            if len(shape) >= 2:
                ops += n
                nbytes += n * (INT8 + BF16) + shape[-1] * F32
            else:
                nbytes += n * (F32 + BF16)
    return ops, nbytes


def flash_prefill(cfg, S: int) -> Work:
    """One prefill's attention over S tokens, every layer."""
    H, K = cfg["n_heads"], cfg["n_kv_heads"]
    dh = W.head_dim(cfg)
    pairs = visible_pairs(S, cfg.get("sliding_window", 0))
    ops = 4.0 * dh * pairs * H
    nbytes = BF16 * (2 * S * H * dh + 2 * S * K * dh)
    return cfg["n_layers"] * ops, cfg["n_layers"] * nbytes


def _product(rows: int, k: int, n: int, weight_bytes: int) -> Work:
    return (2.0 * rows * k * n,
            BF16 * rows * k + weight_bytes * k * n + F32 * n
            + BF16 * rows * n)


def products(cfg, rows: int, weight_bytes: int = INT8) -> Work:
    """Every weight product of one call of the model over ``rows`` token
    rows (a prefill of ``rows`` tokens, or a decode step with ``rows``
    live rows): q, k, v, o, the FFN or each expert over the rows routed
    to it, and the head.  The embedding's gather and the router (f32,
    elementwise in the port) are not products of a weight kernel."""
    d, H, K = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh, f, V = W.head_dim(cfg), cfg["d_ff"], cfg["vocab_size"]
    per: Work = (0.0, 0.0)
    for n in (H * dh, K * dh, K * dh):
        per = _add(per, _product(rows, d, n, weight_bytes))
    per = _add(per, _product(rows, H * dh, d, weight_bytes))
    E = cfg.get("n_experts", 0)
    if E:
        routed = cfg["top_k"] * rows            # token rows over experts
        ops = 2.0 * routed * d * f * 3
        touched = min(E, routed)                # experts reached, at most
        nbytes = touched * (weight_bytes * 3 * d * f + F32 * (2 * f + d)) \
            + BF16 * routed * 3 * (d + f)
        per = _add(per, (ops, nbytes))
    else:
        for k, n in ((d, f), (d, f), (f, d)):
            per = _add(per, _product(rows, k, n, weight_bytes))
    total = (cfg["n_layers"] * per[0], cfg["n_layers"] * per[1])
    return _add(total, _product(rows, d, V, weight_bytes))


def model_flops_token(cfg, pos: int) -> float:
    """Model operations of one token at position ``pos``: 2 per weight
    multiply-add it needs (each layer's projections, its FFN or its top-k
    experts and the router, the head) and its attention over
    min(pos + 1, W) keys."""
    d, H, K = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh, f, V = W.head_dim(cfg), cfg["d_ff"], cfg["vocab_size"]
    w = cfg.get("sliding_window", 0)
    ctx = min(pos + 1, w) if w > 0 else pos + 1
    per = 2.0 * (d * H * dh + 2 * d * K * dh + H * dh * d) \
        + 4.0 * H * dh * ctx
    E = cfg.get("n_experts", 0)
    per += 2.0 * (d * E + cfg["top_k"] * 3 * d * f) if E \
        else 2.0 * 3 * d * f
    return cfg["n_layers"] * per + 2.0 * d * V


def model_flops_prefill(cfg, S: int) -> float:
    """Model operations of a prompt of S tokens (sum over positions)."""
    d, H = cfg["d_model"], cfg["n_heads"]
    dh = W.head_dim(cfg)
    base = model_flops_token(cfg, 0) - cfg["n_layers"] * 4.0 * H * dh
    pairs = visible_pairs(S, cfg.get("sliding_window", 0))
    return S * base + cfg["n_layers"] * 4.0 * H * dh * pairs
