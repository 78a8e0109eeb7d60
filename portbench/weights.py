"""The cells' weights, made on the card from ``--seed``.

Every leaf is named and shaped as the port's unit trees name and shape
it (``embed/tok``, ``attn/wq`` (d, H, dh), ``moe/experts/wg`` (E, d, f),
...), and drawn from one ``torch.Generator`` on the device per unit,
seeded from the run's seed and the unit's index, one large call a leaf.
Drawing a unit again with the same seed gives the same bits, so the
reference draws the weights anew, unit by unit, instead of keeping a
copy beside the program's.

Two serving types:

* ``float`` units: f32 normal draws at each leaf's scale (He's fan-in
  rule, as the port initialises its layers; embeddings 0.02; norm scales
  0.1 around the ``1 + scale`` form; a configuration's ``init`` may set
  the embeddings' ``embed_std``, a ``residual_scale`` on the projections
  that write the residual stream (``attn/wo``, ``mlp/wd``,
  ``moe/experts/wd``)).  The store quantizes them to int8;
* ``int8`` units: per-column int8 values and their f32 scales, drawn
  directly in the type an int8-resident instance serves: a normal draw
  rounded at 127/4 to the column, clipped to +-127, with each column's
  scale the leaf's standard deviation times 4/127 times a draw in
  [0.75, 1.25).  1-D leaves stay f32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], float]


def unit_names(cfg: Dict[str, Any]) -> List[str]:
    return (["embed"] + [f"block_{j:03d}" for j in range(cfg["n_layers"])]
            + ["final"])


def head_dim(cfg: Dict[str, Any]) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def unit_leaves(cfg: Dict[str, Any], unit: str) -> List[Leaf]:
    """(path, shape, standard deviation) of every leaf of ``unit``, in
    the order they are drawn."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    H, K, dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    f = cfg["d_ff"]
    init = cfg.get("init", {})
    he = lambda fan: math.sqrt(2.0 / fan)           # noqa: E731
    res = init.get("residual_scale", 1.0)
    if unit == "embed":
        return [("tok", (V, d), init.get("embed_std", 0.02))]
    if unit == "final":
        return [("norm/scale", (d,), 0.1), ("head/w", (d, V), he(d))]
    out: List[Leaf] = [
        ("norm1/scale", (d,), 0.1),
        ("attn/wq", (d, H, dh), he(d)), ("attn/wk", (d, K, dh), he(d)),
        ("attn/wv", (d, K, dh), he(d)),
        ("attn/wo", (H, dh, d), res * he(H * dh)),
        ("norm2/scale", (d,), 0.1)]
    if cfg.get("n_experts", 0):
        E = cfg["n_experts"]
        out += [("moe/router", (d, E), he(d)),
                ("moe/experts/wg", (E, d, f), he(d)),
                ("moe/experts/wu", (E, d, f), he(d)),
                ("moe/experts/wd", (E, f, d), res * he(f))]
    else:
        out += [("mlp/wg", (d, f), he(d)), ("mlp/wu", (d, f), he(d)),
                ("mlp/wd", (f, d), res * he(f))]
    return out


def unit_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7_919 * (index + 1)) % (1 << 62)


def generator(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(unit_seed(seed, index))
    return g


def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"attn/wq": t}`` -> ``{"attn": {"wq": t}}``."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def float_unit(cfg, unit: str, index: int, seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """Flat ``path -> f32 tensor`` of one ``float`` unit."""
    g = generator(seed, index, device)
    out = {}
    for path, shape, std in unit_leaves(cfg, unit):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        out[path] = t.normal_(0.0, std, generator=g)
    return out


CLIP = 4.0      # the int8 draw's clip, in standard deviations


def int8_unit(cfg, unit: str, index: int, seed: int, device
              ) -> Dict[str, Any]:
    """Flat ``path -> (int8 values, f32 column scales)`` for 2-D and
    wider leaves, ``path -> f32 tensor`` for 1-D ones, of one ``int8``
    unit."""
    g = generator(seed, index, device)
    out: Dict[str, Any] = {}
    for path, shape, std in unit_leaves(cfg, unit):
        z = torch.empty(shape, dtype=torch.float32, device=device)
        z.normal_(0.0, 1.0, generator=g)
        if len(shape) < 2:
            out[path] = z.mul_(std)
            continue
        q = z.mul_(127.0 / CLIP).round_().clamp_(-127, 127).to(torch.int8)
        del z
        u = torch.empty(shape[-1], dtype=torch.float32, device=device)
        u.uniform_(0.75, 1.25, generator=g)
        out[path] = (q, u.mul_(std * CLIP / 127.0))
    return out
