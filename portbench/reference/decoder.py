"""Plain float32 reference of the cells' decoders: the dense decoder with
a sliding window (h2o-danube-3-4b) and the top-k MoE decoder with the
port's capacity semantics (mixtral-8x7b), after their published
descriptions as the port states them:

* pre-norm blocks; RMSNorm ``x * rsqrt(mean(x^2) + 1e-6) * (1 + scale)``;
* GQA attention (query head ``h`` reads kv head ``h // (H / K)``), RoPE
  on split halves, a query at ``i`` seeing keys in ``(i - W, i]``;
* SwiGLU ``(silu(x wg) * (x wu)) wd``;
* MoE: f32 router logits, softmax, the top ``k`` experts (the lower
  index first among equal probabilities), weights renormalised.  Within
  a prompt's prefill each expert takes at most ``C = ceil(k S / E *
  capacity_factor)`` of its ``S`` tokens, those of the largest weight
  (the lower position first among equal ones), and the rest lose that
  expert's share; a decoded token is one row of its own and is never
  dropped.

:class:`Reference` runs a list of sequences (prompt + served tokens) a
layer at a time, drawing each layer's weights as it comes to it, and
returns the logits of the positions that predict the served tokens.
``precision="fp8"`` is the control: every product with a weight takes
its operands rounded to float8 e4m3 (one scale a row of the activations,
one a column of the weight).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench.reference.quant import fp8

Weights = Callable[[str, int], Dict[str, torch.Tensor]]

Q_BLOCK = 512
EPS = 1e-6


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * (
        1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, dh), positions 0..T-1."""
    T, dh = x.shape[0], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """Causal GQA attention, a block of queries at a time.  q (T, H, dh),
    k/v (T, K, dh) -> (T, H, dh)."""
    T, H, dh = q.shape
    K = k.shape[1]
    rep = H // K
    out = torch.empty_like(q)
    kk, vv = k.transpose(0, 1), v.transpose(0, 1)               # K, T, dh
    for a in range(0, T, Q_BLOCK):
        b = min(T, a + Q_BLOCK)
        lo = max(0, a - window + 1) if window > 0 else 0
        qb = q[a:b].reshape(b - a, K, rep, dh).permute(1, 2, 0, 3)
        s = torch.einsum("krqd,ktd->krqt", qb, kk[:, lo:b]) / math.sqrt(dh)
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(lo, b, device=q.device)[None, :]
        ok = ki <= qi
        if window > 0:
            ok &= ki > qi - window
        s = s.masked_fill(~ok, float("-inf")).softmax(-1)
        o = torch.einsum("krqt,ktd->krqd", s, vv[:, lo:b])
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, dh)
    return out


class Reference:
    def __init__(self, cfg: Dict, weights: Weights, *,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.weights = weights
        self.precision = precision

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (..., K) times w (K, N)."""
        if self.precision == "fp8":
            return fp8(a, -1) @ fp8(w, 0)
        return a @ w

    # ------------------------------------------------------------- blocks
    def block(self, w, x: torch.Tensor, n_prompt: int) -> torch.Tensor:
        c = self.cfg
        d, H, K = c["d_model"], c["n_heads"], c["n_kv_heads"]
        dh = c.get("head_dim") or d // H
        T = x.shape[0]
        h = rmsnorm(x, w["norm1/scale"])
        q = self.mm(h, w["attn/wq"].reshape(d, H * dh)).view(T, H, dh)
        k = self.mm(h, w["attn/wk"].reshape(d, K * dh)).view(T, K, dh)
        v = self.mm(h, w["attn/wv"].reshape(d, K * dh)).view(T, K, dh)
        th = c["rope_theta"]
        o = attention(rope(q, th), rope(k, th), v, c.get("sliding_window",
                                                         0))
        x = x + self.mm(o.reshape(T, H * dh), w["attn/wo"].reshape(H * dh, d))
        h = rmsnorm(x, w["norm2/scale"])
        if c.get("n_experts", 0):
            return x + self.moe(w, h, n_prompt)
        return x + self.swiglu(h, w["mlp/wg"], w["mlp/wu"], w["mlp/wd"])

    def swiglu(self, h, wg, wu, wd):
        return self.mm(torch.nn.functional.silu(self.mm(h, wg))
                       * self.mm(h, wu), wd)

    def moe(self, w, h: torch.Tensor, n_prompt: int) -> torch.Tensor:
        c = self.cfg
        E, k = c["n_experts"], c["top_k"]
        T = h.shape[0]
        probs = self.mm(h, w["moe/router"]).softmax(-1)            # T, E
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        vals = vals / vals.sum(-1, keepdim=True)
        wte = torch.zeros_like(probs).scatter_(1, idx, vals)      # T, E
        keep = torch.ones_like(wte, dtype=torch.bool)
        S = n_prompt
        C = max(1, min(math.ceil(k * S / E * c["capacity_factor"]), S))
        if C < S:
            order = torch.sort(wte[:S], dim=0, descending=True,
                               stable=True).indices           # S, E
            dropped = torch.ones((S, E), dtype=torch.bool, device=h.device)
            dropped.scatter_(0, order[:C], False)
            keep[:S] &= ~dropped
        out = torch.zeros_like(h)
        for e in range(E):
            rows = torch.nonzero(keep[:, e] & (wte[:, e] > 0))[:, 0]
            if rows.numel() == 0:
                continue
            y = self.swiglu(h[rows], w["moe/experts/wg"][e],
                            w["moe/experts/wu"][e], w["moe/experts/wd"][e])
            out[rows] += wte[rows, e, None] * y
        return out

    # ----------------------------------------------------------------- run
    @torch.no_grad()
    def served_logits(self, seqs: Sequence[Tuple[torch.Tensor, int]]
                      ) -> List[torch.Tensor]:
        """``seqs``: (input tokens: the prompt and the served tokens but
        the last, n_prompt).  Returns, for each, the f32 logits of its
        positions ``n_prompt - 1 ...``: the rows that predict the served
        tokens."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            L = self.cfg["n_layers"]
            tok = self.weights("embed", 0)["tok"]
            xs = [tok[t.to(tok.device)] for t, _ in seqs]
            del tok
            for j in range(L):
                w = self.weights(f"block_{j:03d}", j + 1)
                xs = [self.block(w, x, n) for x, (_, n) in zip(xs, seqs)]
                del w
            w = self.weights("final", L + 1)
            return [self.mm(rmsnorm(x[n - 1:], w["norm/scale"]),
                            w["head/w"])
                    for x, (_, n) in zip(xs, seqs)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
