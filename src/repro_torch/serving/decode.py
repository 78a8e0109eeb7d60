"""Sampling, request validation and the serial generation reference.

The slotted continuous-batching ``DecodeScheduler`` of the reference comes
with the next slice (ROADMAP queue 1 item 5); :func:`reference_generate`
is the serial ``B=1`` ``prefill`` + ``decode_step`` loop it will be held
against.

Sampling rule (shared by the first token and every decode step):
temperature 0 is greedy ``argmax``; temperature > 0 draws from the
softmax of ``logits / temperature`` with a ``torch.Generator`` seeded from
``(seed, position)``, so each row is deterministic and independent of the
other rows.  The port does not reproduce JAX's random bits.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.api import CacheOverflowError, GenerateSpec

PyTree = Any


def _row_seed(seed: int, pos: int) -> int:
    return (int(seed) * 1_000_003 + int(pos)) % (1 << 63)


def sample_tokens(logits: torch.Tensor, seed: torch.Tensor,
                  next_pos: torch.Tensor,
                  temperature: torch.Tensor) -> torch.Tensor:
    """Per-row next-token choice.  logits: (B, V); seed / next_pos /
    temperature: (B,).  Returns (B,) int32."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = temperature.tolist()
    if not any(t > 0 for t in temps):
        return out
    seeds, poss = seed.tolist(), next_pos.tolist()
    for b, t in enumerate(temps):
        if t <= 0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_row_seed(seeds[b], poss[b]))
        probs = torch.softmax(logits[b].float() / max(t, 1e-6), dim=-1)
        out[b] = torch.multinomial(probs, 1, generator=gen)[0].to(
            torch.int32)
    return out


def sample_first(logits: torch.Tensor, spec: GenerateSpec,
                 n_prompt: int) -> int:
    """First token from full-prompt logits ((1, S, V): prefill output or
    the cold pipeline's in-flight forward)."""
    dev = logits.device
    return int(sample_tokens(
        logits[:, -1, :],
        torch.tensor([spec.seed], device=dev),
        torch.tensor([n_prompt], device=dev),
        torch.tensor([spec.temperature], dtype=torch.float32,
                     device=dev))[0])


def validate_spec(spec: GenerateSpec, n_prompt: int, cache_len: int) -> int:
    """Clamp n_new to the per-request max_len and validate against the
    KV cache capacity; returns the effective n_new."""
    n_new = int(spec.n_new)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {spec.n_new}")
    if spec.max_len is not None:
        n_new = min(n_new, int(spec.max_len) - n_prompt)
        if n_new < 1:
            raise CacheOverflowError(
                f"max_len={spec.max_len} leaves no room to generate "
                f"after a {n_prompt}-token prompt")
    if n_prompt + n_new > cache_len:
        raise CacheOverflowError(
            f"prompt ({n_prompt}) + n_new ({n_new}) = {n_prompt + n_new} "
            f"tokens overflow the decode cache (cache_len={cache_len}); "
            f"lower n_new / set max_len <= {cache_len} or provision a "
            f"larger cache")
    return n_new


def _as_prompt(prompt, device: torch.device) -> torch.Tensor:
    arr = torch.as_tensor(prompt).to(device=device, dtype=torch.int64)
    if arr.dim() == 1:
        arr = arr[None, :]
    if arr.dim() != 2 or arr.shape[0] != 1 or arr.shape[1] < 1:
        raise ValueError(f"prompt must be (S,) or (1, S), got "
                         f"{tuple(arr.shape)}")
    return arr


@torch.no_grad()
def reference_generate(model, params: PyTree, prompt, *, n_new: int,
                       cache_len: int = 256, temperature: float = 0.0,
                       seed: int = 0, eos_id: Optional[int] = None,
                       max_len: Optional[int] = None,
                       device: DeviceLike = None) -> List[int]:
    """Serial B=1 ``prefill`` + ``decode_step`` loop with the sampling
    rule above — token-level ground truth for the generation tests.

    device: where to generate (default: the GPU; raises without one unless
    ``device="cpu"``); ``model`` and ``params`` must live there."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is built for {model.device}, generating "
                         f"on {dev}")
    for leaf in tree_util.leaves(params):
        if leaf.device != dev:
            raise ValueError(f"params live on {leaf.device}, generating on "
                             f"{dev}")
    spec = GenerateSpec(prompt=prompt, n_new=n_new, temperature=temperature,
                        max_len=max_len, eos_id=eos_id, seed=seed)
    prompt = _as_prompt(prompt, dev)
    S = int(prompt.shape[1])
    n_new = validate_spec(spec, S, cache_len)

    cache = model.init_cache(1, cache_len)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    out = [sample_first(logits, spec, S)]
    seeds = torch.tensor([seed], device=dev)
    temps = torch.tensor([temperature], dtype=torch.float32, device=dev)
    cur = torch.tensor([[out[0]]], dtype=torch.int64, device=dev)
    for t in range(S, S + n_new - 1):
        if eos_id is not None and out[-1] == eos_id:
            break
        pos = torch.tensor([t], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, cache, cur, pos)
        nxt = sample_tokens(logits[:, -1, :], seeds, pos + 1, temps)
        cur = nxt[:, None].to(torch.int64)
        out.append(int(nxt[0]))
    return out
