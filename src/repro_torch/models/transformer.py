"""LM assembly of the port: the stacked steady-state view and the
streaming unit view of ``repro.models.transformer``, for every LM family:
dense, MoE (Mixtral, Arctic), SSM (Mamba-2), hybrid (Griffin), and the
audio encoder (hubert) and VLM (internvl2) backbones behind their stub
frontends.

Parameters are nested dicts of tensors with the reference's tree
structure and layouts: ``{"embed": {"tok"}, "blocks": {"s0": {...}, ...,
"t0": {...}, ...}, "final": {"norm", "head"}}``.  Layers are grouped as
the reference groups them: a repeating pattern of block kinds (length 1
for uniform stacks, ``("rglru", "rglru", "attn")`` for Griffin) whose
slot ``s{slot}`` leaves are stacked ``(n_units, ...)``, plus a tail of
the layers left over (``t{t}``, unstacked).  The forward passes loop over
the stacked units in Python (PyTorch runs eagerly; there is no scan to
keep small).  Decode caches have the same grouping: attention K/V
``(B, K, S_max, dh)``, SSD ``{"conv", "ssm"}`` and RG-LRU ``{"conv", "h"}``
states, ``(n_units, B, ...)`` in the stacked groups and ``(B, ...)`` in
the tail.

The embed, block and final units are ``nn.Module``s (:class:`EmbedUnit`,
:class:`BlockUnit` of one block kind, :class:`FinalUnit`) that own their
parameters in those layouts.  Constructing one is the pipeline's layer
construction: on ``torch.device("meta")`` it is MiniLoader's shape-only
structure (:meth:`LM.abstract_unit`), on a real device with ``init_`` it
is the PISeL-faithful numerical initialization (:meth:`LM.init_unit`).

The audio family embeds its frames (``frames @ proj``) and ends in an
encoder head; the VLM embeds its image rows (``img @ mm_proj``) ahead of
the tokens, so positions count the image rows first.  A token-only VLM
batch (the schedulers' prompts, and every decode step, where the
reference passes a zero-length image) has no image rows.

Training (:meth:`LM.loss`) differentiates the same block functions, for
every family: attention, rmsnorm and the two scans go through autograd
functions whose backwards are the hand-written kernels
``flash_attention_bwd``, ``rmsnorm_bwd``, ``ssd_scan_bwd`` and
``rglru_scan_bwd``; the MoE FFN, the convolutions, layernorm, the gates
and the audio and VLM frontend projections are PyTorch ops that autograd
differentiates.  Each unit body is rematerialised under
``torch.utils.checkpoint`` as the reference's ``jax.checkpoint``.

The paged side (``decode_step_paged``, ``gather_pages`` /
``pack_pages`` / ``copy_page``, and ``prefill_continue`` for prefix
reuse) follows the reference's ``transformer.py:615-844``: it runs over
every cache group, and the full-attention kinds' K/V of a group live in
page pools, ``(n_units, P, K, pt, dh)`` stacked and ``(P, K, pt, dh)`` in
the tail, while SSM and RG-LRU states and sliding-window rings stay
slot-resident beside them (Griffin pages its ``attn`` layers, Mamba-2
pages nothing).  Like the slotted caches, pools and caches are written
in place.
``prefill_chunked`` (the reference's ``transformer.py:491``) runs a
full-attention prompt through the same ``block_chunk`` as
``prefill_continue``, one segment at a time, so attention and the head
hold a chunk's rows, not the prompt's.  ``abstract_cache`` and
``input_specs`` are the reference's abstract values as meta tensors.
:func:`build` hands the vision family to :mod:`repro_torch.models.vision`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import quant
from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import griffin, layers, moe, ssm
from repro_torch.models.api import ArchConfig, Family
from repro_torch.quant import QuantLeaf

PyTree = Any

AUX_LOSS_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# unit modules
# ---------------------------------------------------------------------------

class UnitModule(nn.Module):
    """Parameters of one pipeline unit, laid out as the reference's unit
    tree (sub-dicts become sub-modules, leaves frozen parameters).  The
    computation stays in the functions below, which take any tree of the
    same layout (the pipeline applies retrieved weights, not these)."""

    def __init__(self, cfg: ArchConfig, shapes: Dict[str, Any], device):
        super().__init__()
        self.cfg = cfg
        for key, val in sorted(shapes.items()):
            if isinstance(val, dict):
                self.add_module(key, UnitModule(cfg, val, device))
            else:
                self.register_parameter(key, nn.Parameter(
                    torch.empty(val, dtype=cfg.param_dtype, device=device),
                    requires_grad=False))

    def tree(self) -> PyTree:
        """The parameters as a nested dict of tensors (no copies)."""
        out: Dict[str, Any] = {n: p.detach()
                               for n, p in self.named_parameters(recurse=False)}
        for n, m in self.named_children():
            out[n] = m.tree()
        return out


class EmbedUnit(UnitModule):
    """The token table; the audio family's frame projection ``proj``
    instead; the VLM's table and its image projection ``mm_proj``."""

    def __init__(self, cfg: ArchConfig, device):
        proj = (cfg.frontend_dim, cfg.d_model)
        if cfg.family == Family.AUDIO:
            shapes = {"proj": proj}
        elif cfg.family == Family.VLM:
            shapes = {"tok": (cfg.vocab_size, cfg.d_model), "mm_proj": proj}
        else:
            shapes = {"tok": (cfg.vocab_size, cfg.d_model)}
        super().__init__(cfg, shapes, device)

    def init_(self, gen: torch.Generator) -> "EmbedUnit":
        p = self.tree()
        if "tok" in p:
            layers.embed_init_(p["tok"], gen)
        for name in ("proj", "mm_proj"):
            if name in p:
                layers.dense_init_(p[name], gen)
        return self


class BlockUnit(UnitModule):
    """One pre-norm block of ``kind``: ``attn`` / ``local_attn``
    (attention + MLP), ``moe`` (attention + the MoE FFN), ``ssd`` (the
    Mamba-2 mixer) or ``rglru`` (the RG-LRU mixer + MLP)."""

    def __init__(self, cfg: ArchConfig, kind: str, device):
        _check_kind(kind)
        shapes: Dict[str, Any] = {"norm1": layers.norm_shapes(cfg)}
        if kind in ATTN_KINDS:
            shapes.update(attn=layers.attn_shapes(cfg),
                          norm2=layers.norm_shapes(cfg))
            if kind == "moe":
                shapes["moe"] = moe.moe_shapes(cfg)
            else:
                shapes["mlp"] = layers.mlp_shapes(cfg)
        elif kind == "ssd":
            shapes["ssd"] = ssm.ssd_shapes(cfg)
        else:
            shapes.update(rglru=griffin.rglru_shapes(cfg),
                          norm2=layers.norm_shapes(cfg),
                          mlp=layers.mlp_shapes(cfg))
        super().__init__(cfg, shapes, device)
        self.kind = kind

    def init_(self, gen: torch.Generator) -> "BlockUnit":
        """The reference's ``block_params`` init rules, drawn in the order
        norm1, mixer, norm2, MLP or MoE."""
        cfg, p = self.cfg, self.tree()
        layers.norm_init_(cfg, p["norm1"])
        if self.kind in ATTN_KINDS:
            layers.attn_init_(cfg, p["attn"], gen)
        elif self.kind == "ssd":
            ssm.ssd_init_(cfg, p["ssd"], gen)
        else:
            griffin.rglru_init_(cfg, p["rglru"], gen)
        if "norm2" in p:
            layers.norm_init_(cfg, p["norm2"])
        if "mlp" in p:
            layers.mlp_init_(cfg, p["mlp"], gen)
        if "moe" in p:
            moe.moe_init_(cfg, p["moe"], gen)
        return self


class FinalUnit(UnitModule):
    """Final norm and (untied) LM head."""

    def __init__(self, cfg: ArchConfig, device):
        shapes: Dict[str, Any] = {"norm": layers.norm_shapes(cfg)}
        if cfg.is_encoder or not cfg.tie_embeddings:
            shapes["head"] = {"w": (cfg.d_model, cfg.vocab_size)}
        super().__init__(cfg, shapes, device)

    def init_(self, gen: torch.Generator) -> "FinalUnit":
        p = self.tree()
        layers.norm_init_(self.cfg, p["norm"])
        if "head" in p:
            layers.dense_init_(p["head"]["w"], gen)
        return self


# ---------------------------------------------------------------------------
# per-kind block functions: "attn", "local_attn", "moe", "ssd", "rglru"
# ---------------------------------------------------------------------------

ATTN_KINDS = ("attn", "local_attn", "moe")    # attention + an FFN
KINDS = ATTN_KINDS + ("ssd", "rglru")


def _check_kind(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; have {KINDS}")


def _kind_window(cfg, kind: str) -> int:
    if kind == "local_attn":
        return cfg.local_attn_window
    return cfg.sliding_window


def block_params(cfg, kind: str, gen: torch.Generator) -> PyTree:
    return BlockUnit(cfg, kind, gen.device).init_(gen).tree()


def _ffn_half(cfg, kind: str, p: PyTree, x: torch.Tensor, *,
              with_aux: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's second half: norm2, then the MLP or the MoE FFN, and
    the residual.  Returns (x, the MoE aux loss if ``with_aux``, else
    None)."""
    h = layers.apply_norm(cfg, p["norm2"], x)
    if kind == "moe":
        y, aux = moe.moe_block(cfg, p["moe"], h, with_aux=with_aux)
        return x + y, aux
    return x + layers.mlp_block(cfg, p["mlp"], h), None


def block_apply(cfg, kind: str, p: PyTree, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence forward of one block.  Returns (x, aux loss), the
    aux loss None for every kind but ``moe``."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind == "ssd":
        return x + ssm.ssd_block(cfg, p["ssd"], h), None
    if kind == "rglru":
        x = x + griffin.rglru_block(cfg, p["rglru"], h)
    else:
        x = x + layers.attention_block(cfg, p["attn"], h, positions,
                                       window=_kind_window(cfg, kind))
    return _ffn_half(cfg, kind, p, x, with_aux=True)


def kind_cache(cfg, kind: str, batch: int, cache_len: int,
               device) -> PyTree:
    """Zeroed decode cache for one layer of this kind."""
    _check_kind(kind)
    if kind == "ssd":
        conv, state = ssm.init_states(cfg, batch, device)
        return {"conv": conv, "ssm": state}
    if kind == "rglru":
        conv, h = griffin.init_states(cfg, batch, device)
        return {"conv": conv, "h": h}
    w = _kind_window(cfg, kind)
    n = min(cache_len, w) if w > 0 else cache_len
    shape = (batch, cfg.n_kv_heads, n, cfg.dh)            # kv-head-major
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _store(cache: PyTree, **new: torch.Tensor) -> PyTree:
    """Write recurrent states into their cache leaves in place."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def block_decode(cfg, kind: str, p: PyTree, x: torch.Tensor,
                 pos: torch.Tensor, cache: PyTree
                 ) -> Tuple[torch.Tensor, PyTree]:
    """Single-token decode.  x: (B, 1, d); pos: (B,) int32.  Writes this
    token's K/V, or the layer's new recurrent state, into ``cache`` in
    place."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind == "ssd":
        y, conv, state = ssm.ssd_decode(cfg, p["ssd"], h, cache["conv"],
                                        cache["ssm"])
        return x + y, _store(cache, conv=conv, ssm=state)
    if kind == "rglru":
        y, conv, hs = griffin.rglru_decode(cfg, p["rglru"], h, cache["conv"],
                                           cache["h"])
        _store(cache, conv=conv, h=hs)
    else:
        y, _, _ = layers.attention_decode(cfg, p["attn"], h, pos, cache["k"],
                                          cache["v"],
                                          window=_kind_window(cfg, kind))
    return _ffn_half(cfg, kind, p, x + y)[0], cache


def block_prefill(cfg, kind: str, p: PyTree, x: torch.Tensor,
                  positions: torch.Tensor, cache: PyTree
                  ) -> Tuple[torch.Tensor, PyTree]:
    """Full-sequence forward that also fills this layer's decode cache
    (in place)."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind == "ssd":
        y, (conv, state) = ssm.ssd_block(cfg, p["ssd"], h,
                                         return_state=True)
        return x + y, _store(cache, conv=conv, ssm=state)
    if kind == "rglru":
        y, (conv, hs) = griffin.rglru_block(cfg, p["rglru"], h,
                                            return_state=True)
        _store(cache, conv=conv, h=hs)
        return _ffn_half(cfg, kind, p, x + y)[0], cache
    y, k, v = layers.attention_block(cfg, p["attn"], h, positions,
                                     window=_kind_window(cfg, kind),
                                     return_kv=True)
    x = x + y
    S = k.shape[1]
    W_c = cache["k"].shape[2]
    n = min(S, W_c)
    slots = (S - n + torch.arange(n, device=k.device)) % W_c
    cache["k"][:, :, slots] = k[:, S - n:].transpose(1, 2).to(
        cache["k"].dtype)
    cache["v"][:, :, slots] = v[:, S - n:].transpose(1, 2).to(
        cache["v"].dtype)
    return _ffn_half(cfg, kind, p, x)[0], cache


def _kind_paged(cfg, kind: str) -> bool:
    """True when this layer kind's KV can live in a shared page pool:
    full attention only (a sliding-window ring reuses physical slots
    for rolling positions, so it stays slot-resident)."""
    return kind in ATTN_KINDS and _kind_window(cfg, kind) == 0


def block_decode_paged(cfg, kind: str, p: PyTree, x: torch.Tensor,
                       pos: torch.Tensor, cache: PyTree, pages: PyTree,
                       tables: torch.Tensor):
    """Single-token decode with full-attention KV served from a page pool
    (written in place).  ``pages`` is ``{"k", "v"}`` of ``(P, K, pt, dh)``
    for paged kinds and ``None`` for kinds whose state stays slot-resident
    (then ``cache`` is that state and this defers to :func:`block_decode`).
    Returns (x, cache, pages)."""
    if pages is None:
        x, cache = block_decode(cfg, kind, p, x, pos, cache)
        return x, cache, None
    h = layers.apply_norm(cfg, p["norm1"], x)
    y, kp, vp = layers.attention_decode_paged(cfg, p["attn"], h, pos,
                                              pages["k"], pages["v"], tables)
    x = _ffn_half(cfg, kind, p, x + y)[0]
    return x, cache, {"k": kp, "v": vp}


def block_chunk(cfg, kind: str, p: PyTree, x: torch.Tensor, cache_l: PyTree,
                off: int, cs: int) -> Tuple[torch.Tensor, PyTree]:
    """One full-attention block over a ``cs``-token segment starting at
    absolute position ``off``, attending to the cache prefix + itself.
    Writes the segment's K/V into rows ``[off, off + cs)`` of ``cache_l``
    (in place); the queries sit at the last ``cs`` of ``off + cs`` key
    positions, which ``flash_attention`` masks from absolute positions."""
    positions = (off + torch.arange(cs, device=x.device))[None, :]
    h = layers.apply_norm(cfg, p["norm1"], x)
    q, k, v = layers.qkv_project(cfg, p["attn"], h, positions)
    kc, vc = cache_l["k"], cache_l["v"]
    kc[:, :, off:off + cs] = k.transpose(1, 2).to(kc.dtype)
    vc[:, :, off:off + cs] = v.transpose(1, 2).to(vc.dtype)
    o = ops.flash_attention(q, kc[:, :, :off + cs].transpose(1, 2),
                            vc[:, :, :off + cs].transpose(1, 2), causal=True)
    x = x + layers.attn_out(cfg, p["attn"], o)
    return _ffn_half(cfg, kind, p, x)[0], cache_l


def _head(cfg, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    x = layers.apply_norm(cfg, params["final"]["norm"], x)
    return layers.head_logits(cfg, params, x)


def _stack_spent(per: List[PyTree]) -> PyTree:
    """``tree_map(torch.stack)`` over the unit trees ``per``, each unit's
    dict entry dropped once its leaf is stacked; one unit stacks as a
    view (``unsqueeze(0)``)."""
    first = per[0]
    if isinstance(first, dict):
        out = {}
        for k in list(first):
            out[k] = _stack_spent([p[k] for p in per])
            for p in per:
                p[k] = None
        return out
    if isinstance(first, QuantLeaf):
        return QuantLeaf(_stack_spent([p.q for p in per]),
                         _stack_spent([p.scale for p in per]))
    if len(per) == 1:
        return first.unsqueeze(0)
    return torch.stack(per)


def _index(tree: PyTree, i: int) -> PyTree:
    """Unit ``i`` of a stacked tree (``None`` leaves stay ``None``)."""
    return tree_util.tree_map(lambda a: None if a is None else a[i], tree)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class LM:
    """One architecture = config + functions over a param tree, on
    ``device``."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.pattern, self.n_units, self.tail_kinds = self._groups(cfg)
        for kind in set(self.pattern) | set(self.tail_kinds):
            _check_kind(kind)
        self._abstract_units: Dict[str, PyTree] = {}

    @staticmethod
    def _groups(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(pattern of block kinds, number of pattern units, tail kinds)."""
        kinds = cfg.layer_kinds()
        if cfg.family == Family.HYBRID:
            pat = tuple(cfg.block_pattern or ("rglru", "rglru", "attn"))
        else:
            pat = (kinds[0],)
        n_units = len(kinds) // len(pat)
        return pat, n_units, tuple(kinds[n_units * len(pat):])

    def layer_kind(self, j: int) -> str:
        u = len(self.pattern)
        if j < self.n_units * u:
            return self.pattern[j % u]
        return self.tail_kinds[j - self.n_units * u]

    def _layers(self, tree: PyTree):
        """(kind, layer view) of every layer of a grouped tree (params or
        cache) in layer order: unit i's slot views of the stacked groups,
        then the tail groups."""
        for i in range(self.n_units):
            for slot, kind in enumerate(self.pattern):
                yield kind, _index(tree[f"s{slot}"], i)
        for t, kind in enumerate(self.tail_kinds):
            yield kind, tree[f"t{t}"]

    # ------------------------------------------------------- streaming view
    def unit_names(self) -> List[str]:
        return (["embed"]
                + [f"block_{j:03d}" for j in range(self.cfg.n_layers)]
                + ["final"])

    def unit_module(self, name: str, device=None) -> UnitModule:
        """The unit as an ``nn.Module`` with uninitialised parameters on
        ``device`` (default: the model's)."""
        device = self.device if device is None else device
        if name == "embed":
            return EmbedUnit(self.cfg, device)
        if name == "final":
            return FinalUnit(self.cfg, device)
        return BlockUnit(self.cfg, self.layer_kind(int(name.split("_")[1])),
                         device)

    def init_unit(self, name: str, gen: torch.Generator) -> PyTree:
        """PISeL-faithful construction: full numerical initialization, on
        the generator's device."""
        return self.unit_module(name, gen.device).init_(gen).tree()

    def abstract_unit(self, name: str) -> PyTree:
        """MiniLoader construction: the unit built on the meta device —
        shapes and dtypes, no storage, no initialization.  Cached: the
        structure is static per model."""
        if name not in self._abstract_units:
            self._abstract_units[name] = self.unit_module(name,
                                                          "meta").tree()
        return self._abstract_units[name]

    def assemble(self, units: Dict[str, PyTree], *,
                 consume: bool = False) -> PyTree:
        """The stacked param tree from per-unit trees.  ``consume``: the
        unit trees are spent: each unit's leaf leaves its tree as soon as
        it is stacked (and a lone unit is stacked as a view), so the
        stacked params never sit beside a second copy of the units' (a
        cold start of mixtral-8x7b's 47 GB of int8-resident params would
        not fit the card twice)."""
        u = len(self.pattern)
        blocks: Dict[str, PyTree] = {}
        for slot in range(u):
            per = [units[f"block_{i * u + slot:03d}"]
                   for i in range(self.n_units)]
            blocks[f"s{slot}"] = (_stack_spent(per) if consume else
                                  tree_util.tree_map(
                                      lambda *xs: torch.stack(xs), *per))
        for t in range(len(self.tail_kinds)):
            blocks[f"t{t}"] = units[f"block_{self.n_units * u + t:03d}"]
        return {"embed": units["embed"], "blocks": blocks,
                "final": units["final"]}

    @torch.no_grad()
    def unit_apply(self, name: str, uparams: PyTree,
                   state: Dict[str, Any]) -> Dict[str, Any]:
        """Layer-wise cold-start execution (the pipeline's E_i).

        state: {"batch": inputs} before embed; {"x": activations} after.
        After the final unit, state["logits"] holds the output.
        """
        cfg = self.cfg
        out = dict(state)
        if name == "embed":
            x = self.embed({"embed": uparams}, state["batch"])
            out["x"] = x
            out["positions"] = torch.arange(x.shape[1],
                                            device=x.device)[None, :]
            if cfg.tie_embeddings and not cfg.is_encoder:
                out["embed_tok"] = uparams["tok"]
            return out
        if name == "final":
            params = {"final": uparams}
            if cfg.tie_embeddings and not cfg.is_encoder:
                params["embed"] = {"tok": state["embed_tok"]}
            out["logits"] = _head(cfg, params, state["x"])
            return out
        kind = self.layer_kind(int(name.split("_")[1]))
        out["x"], _ = block_apply(cfg, kind, uparams, state["x"],
                                  state["positions"])
        return out

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> PyTree:
        """Freshly initialized stacked params on the model's device, one
        generator per unit seeded from ``seed`` (as :func:`deploy_model`
        seeds them)."""
        units = {}
        for i, name in enumerate(self.unit_names()):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(unit_seed(seed, i))
            units[name] = self.init_unit(name, gen)
        return self.assemble(units)

    def abstract(self) -> PyTree:
        """The stacked param tree on the meta device."""
        return self.assemble({n: self.abstract_unit(n)
                              for n in self.unit_names()})

    # --------------------------------------------------------------- forward
    def embed(self, params: PyTree, batch: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """Token rows; the audio family's ``frames @ proj``; the VLM's
        ``img @ mm_proj`` rows ahead of its token rows, none for a batch
        without ``img`` (a decode step's: the reference passes a
        zero-length image there, which adds no rows)."""
        cfg = self.cfg
        p = params["embed"]
        cd = cfg.compute_dtype
        if cfg.family == Family.AUDIO:
            return quant.einsum(batch["frames"].to(cd), p["proj"], cd)
        x = layers.embed_lookup(cfg, p, batch["tokens"])
        if cfg.family == Family.VLM and batch.get("img") is not None:
            img = quant.einsum(batch["img"].to(cd), p["mm_proj"], cd)
            x = torch.cat([img, x], dim=1)
        return x

    @torch.no_grad()
    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward.  Returns (logits (B, S, V), aux_loss: the sum of
        the MoE blocks' load-balance losses, else 0)."""
        cfg = self.cfg
        x = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p in self._layers(params["blocks"]):
            x, a = block_apply(cfg, kind, p, x, positions)
            if a is not None:
                aux = aux + a
        return _head(cfg, params, x), aux

    # -------------------------------------------------------------- training
    def forward_train(self, params: PyTree, batch: Dict[str, torch.Tensor],
                      *, remat: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward that carries gradients (the reference's ``forward``
        under ``jax.value_and_grad``).  ``remat``: each unit body runs
        under ``torch.utils.checkpoint`` (non-reentrant) and runs again in
        the backward, as the reference's ``jax.checkpoint(body)``.  The
        stacked leaves are unbound once, so the backward stacks the
        units' gradients in one op.  The tail layers run outside
        checkpoint, as the reference's.  Returns (logits, aux_loss)."""
        cfg, pat = self.cfg, self.pattern
        x = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        slots = []
        for slot in range(len(pat)):
            group = params["blocks"][f"s{slot}"]
            slots.append((group, [("/".join(p), leaf.unbind(0)) for p, leaf
                                  in tree_util.leaves_with_path(group)]))

        def body(x, aux, unit):
            for kind, p in zip(pat, unit):
                x, a = block_apply(cfg, kind, p, x, positions)
                if a is not None:
                    aux = aux + a
            return x, aux

        for i in range(self.n_units):
            unit = [tree_util.unflatten(group, {n: u[i] for n, u in parts})
                    for group, parts in slots]
            if remat:
                x, aux = checkpoint(body, x, aux, unit, use_reentrant=False)
            else:
                x, aux = body(x, aux, unit)
        for t, kind in enumerate(self.tail_kinds):
            x, a = block_apply(cfg, kind, params["blocks"][f"t{t}"], x,
                               positions)
            if a is not None:
                aux = aux + a
        return _head(cfg, params, x), aux

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor], *,
             remat: bool = True, unroll: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy from f32 logits (``logsumexp`` minus the
        gold logit, ``labels < 0`` masked) plus ``AUX_LOSS_WEIGHT`` times
        the aux loss.  Returns (total, {"ce", "aux", "accuracy"}), with
        gradients to every parameter that asks for one.  Labels cover every
        position of the logits, the VLM's image rows first, as the
        reference's; a VLM batch whose labels cover only its text positions
        gets its image rows masked (labels -1).  ``unroll`` is accepted for
        the reference's signature: the port's units already run in a Python
        loop."""
        del unroll
        logits, aux = self.forward_train(params, batch, remat=remat)
        labels = batch["labels"].to(logits.device)
        n_img = logits.shape[1] - labels.shape[1]
        if n_img > 0 and batch.get("img") is not None and \
                n_img == batch["img"].shape[1]:
            labels = torch.cat([torch.full_like(labels[:, :1], -1).expand(
                -1, n_img), labels], dim=1)
        lg = logits.float()
        valid = labels >= 0
        lbl = torch.where(valid, labels, torch.zeros_like(labels)).long()
        logz = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, lbl[..., None])[..., 0]
        nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
        denom = valid.sum().clamp(min=1)
        ce = nll.sum() / denom
        total = ce + AUX_LOSS_WEIGHT * aux
        with torch.no_grad():
            acc = ((lg.argmax(dim=-1) == lbl) & valid).sum() / denom
        return total, {"ce": ce, "aux": aux, "accuracy": acc}

    # ------------------------------------------------------- decode + cache
    def init_cache(self, batch: int, cache_len: int) -> PyTree:
        return {key: self._group_cache(kind, stacked, batch, cache_len)
                for key, kind, stacked in self._cache_groups()}

    def abstract_cache(self, batch: int, cache_len: int) -> PyTree:
        """The tree of :meth:`init_cache` on the meta device: shapes and
        dtypes, no storage (the reference's ``jax.eval_shape``)."""
        return {key: self._group_cache(kind, stacked, batch, cache_len,
                                       device="meta")
                for key, kind, stacked in self._cache_groups()}

    @torch.no_grad()
    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                cache: PyTree) -> Tuple[torch.Tensor, PyTree]:
        """Run the full prompt and fill ``cache`` (in place).  Returns
        (logits, cache)."""
        cfg = self.cfg
        x = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for (kind, p), (_, c) in zip(self._layers(params["blocks"]),
                                     self._layers(cache)):
            x, _ = block_prefill(cfg, kind, p, x, positions, c)
        return _head(cfg, params, x), cache

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree,
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """tokens: (B, 1); pos: (B,) int32 absolute position of this token.
        Writes the token's K/V and the recurrent states into ``cache`` in
        place.  Returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        x = self.embed(params, {"tokens": tokens})
        for (kind, p), (_, c) in zip(self._layers(params["blocks"]),
                                     self._layers(cache)):
            x, _ = block_decode(cfg, kind, p, x, pos, c)
        return _head(cfg, params, x), cache

    # ----------------------------------------------------- paged KV decode
    def _cache_groups(self) -> List[Tuple[str, str, bool]]:
        """(key, kind, stacked) for every block cache group: the pattern
        slots ``s{i}``, then the tail layers ``t{t}``."""
        out = [(f"s{i}", k, True) for i, k in enumerate(self.pattern)]
        out += [(f"t{t}", k, False) for t, k in enumerate(self.tail_kinds)]
        return out

    def _paged_groups(self) -> List[Tuple[str, bool]]:
        """(key, stacked) of the groups whose K/V live in page pools."""
        return [(key, stacked) for key, kind, stacked in self._cache_groups()
                if _kind_paged(self.cfg, kind)]

    def _paged_leaves(self, *trees: PyTree):
        """Per paged group and per ``"k"`` / ``"v"``, that leaf of each
        tree (pools, caches) with a leading unit axis: the stacked
        group's leaf itself, a tail group's as a ``[None]`` view, so one
        indexing writes both in place."""
        for key, stacked in self._paged_groups():
            for n in ("k", "v"):
                yield tuple(t[key][n] if stacked else t[key][n][None]
                            for t in trees)

    def _group_cache(self, kind: str, stacked: bool, batch: int,
                     cache_len: int, device=None) -> PyTree:
        """One group's zeroed cache on ``device`` (default: the model's):
        ``(n_units, B, ...)`` leaves when stacked, ``(B, ...)`` in the
        tail."""
        device = self.device if device is None else device
        per = [kind_cache(self.cfg, kind, batch, cache_len, device)
               for _ in range(self.n_units if stacked else 1)]
        if not stacked:
            return per[0]
        return tree_util.tree_map(lambda *xs: torch.stack(xs), *per)

    def paged_kinds(self) -> List[str]:
        return sorted(k for k in set(self.pattern) | set(self.tail_kinds)
                      if _kind_paged(self.cfg, k))

    @property
    def supports_prefix_cache(self) -> bool:
        """Prefix reuse needs every layer's sequence state in pages (an
        unshared SSM, RG-LRU or ring state would silently diverge) and a
        token-only prompt identity (no image or audio side inputs)."""
        cfg = self.cfg
        return (not cfg.is_encoder
                and cfg.family not in (Family.AUDIO, Family.VLM)
                and all(_kind_paged(cfg, k)
                        for k in set(self.pattern) | set(self.tail_kinds)))

    def kv_page_bytes(self, page_tokens: int) -> int:
        """Device bytes one page id costs across all paged layers (K and
        V); 0 when no layer pages (Mamba-2, ring-only models)."""
        cfg = self.cfg
        item = torch.empty((), dtype=cfg.compute_dtype).element_size()
        per = 2 * cfg.n_kv_heads * page_tokens * cfg.dh * item
        return per * sum(self.n_units if stacked else 1
                         for _, stacked in self._paged_groups())

    def init_kv_pages(self, n_pages: int, page_tokens: int) -> PyTree:
        """Physical page pools: per paged group ``{"k", "v"}`` of
        ``(n_units, n_pages, K, pt, dh)`` (stacked) or ``(n_pages, K, pt,
        dh)`` (tail); ``None`` for the groups that do not page.  The caller
        sizes ``n_pages`` to the budget + 1 (the scratch page)."""
        cfg = self.cfg
        pools: Dict[str, PyTree] = {key: None
                                    for key, _, _ in self._cache_groups()}
        for key, stacked in self._paged_groups():
            shape = (n_pages, cfg.n_kv_heads, page_tokens, cfg.dh)
            if stacked:
                shape = (self.n_units,) + shape
            pools[key] = {n: torch.zeros(shape, dtype=cfg.compute_dtype,
                                         device=self.device)
                          for n in ("k", "v")}
        return pools

    def init_cache_paged(self, batch: int, cache_len: int) -> PyTree:
        """Slot-resident decode state with the paged groups' K/V leaves
        ``None`` (they live in the pools): the structure of
        :meth:`init_cache`, so the per-slot join applies."""
        return {key: {"k": None, "v": None} if _kind_paged(self.cfg, kind)
                else self._group_cache(kind, stacked, batch, cache_len)
                for key, kind, stacked in self._cache_groups()}

    def init_request_cache(self, paged_len: int, state_len: int) -> PyTree:
        """B=1 prefill cache for paged admission: the paged kinds sized to
        the request's page span (``paged_len`` rows feed
        :meth:`pack_pages`), the slot-resident kinds to the scheduler's
        state length, so that the slot-join shapes match."""
        return {key: self._group_cache(
                    kind, stacked, 1,
                    paged_len if _kind_paged(self.cfg, kind) else state_len)
                for key, kind, stacked in self._cache_groups()}

    def strip_paged(self, cache: PyTree) -> PyTree:
        """A per-request cache projected onto the paged state structure:
        the paged groups' K/V leaves become ``None`` (their content moves
        by :meth:`pack_pages` instead)."""
        out = dict(cache)
        for key, _ in self._paged_groups():
            out[key] = {"k": None, "v": None}
        return out

    def gather_pages(self, cache: PyTree, pools: PyTree,
                     ids: torch.Tensor) -> PyTree:
        """Copy physical pages ``ids`` (in logical order) into rows
        ``[0, len(ids) * pt)`` of a contiguous B=1 cache, in place — the
        device half of a prefix hit."""
        m, idx = int(ids.numel()), ids.long()
        for pool, c in self._paged_leaves(pools, cache):
            L, _, K, pt, dh = pool.shape
            c[:, 0, :, :m * pt] = pool[:, idx].transpose(1, 2).reshape(
                L, K, m * pt, dh).to(c.dtype)
        return cache

    def pack_pages(self, pools: PyTree, cache: PyTree, ids: torch.Tensor,
                   first_page: int) -> PyTree:
        """Copy B=1 cache rows ``[first_page * pt, (first_page + len(ids))
        * pt)`` into physical pages ``ids``, in place — the device half
        of admission."""
        m, idx = int(ids.numel()), ids.long()
        for pool, c in self._paged_leaves(pools, cache):
            L, _, K, pt, dh = pool.shape
            lo = first_page * pt
            seg = c[:, 0, :, lo:lo + m * pt].reshape(L, K, m, pt, dh)
            pool[:, idx] = seg.transpose(1, 2).to(pool.dtype)
        return pools

    def copy_page(self, pools: PyTree, src: int, dst: int) -> PyTree:
        """Device half of a copy-on-write fork: page ``src`` into ``dst``
        across every paged layer, in place."""
        for (pool,) in self._paged_leaves(pools):
            pool[:, dst] = pool[:, src]
        return pools

    @torch.no_grad()
    def prefill_continue(self, params: PyTree, batch: Dict[str, torch.Tensor],
                         cache: PyTree, *, off: int
                         ) -> Tuple[torch.Tensor, PyTree]:
        """Resume a full-attention prefill at absolute position ``off``:
        cache rows ``[0, off)`` already hold valid K/V (gathered from
        shared prefix pages) and ``batch["tokens"]`` is the suffix.
        Returns (logits for the suffix, cache filled through ``off +
        suffix_len``, in place)."""
        if not self.supports_prefix_cache:
            raise ValueError("prefill_continue: full-attention decoder LMs "
                             "only")
        x = self._segment(params, self.embed(params, batch), cache, off)
        return _head(self.cfg, params, x), cache

    def _segment(self, params: PyTree, x: torch.Tensor, cache: PyTree,
                 off: int) -> torch.Tensor:
        """Every layer over the segment ``x`` at absolute positions
        ``[off, off + x.shape[1])`` through :func:`block_chunk`, its K/V
        written into ``cache`` in place; the hidden rows before the
        head."""
        for (kind, p), (_, c) in zip(self._layers(params["blocks"]),
                                     self._layers(cache)):
            x, _ = block_chunk(self.cfg, kind, p, x, c, off, x.shape[1])
        return x

    @torch.no_grad()
    def prefill_chunked(self, params: PyTree, batch: Dict[str, torch.Tensor],
                        cache: PyTree, *, chunk: int = 2048
                        ) -> Tuple[torch.Tensor, PyTree]:
        """Chunked prefill for full-attention decoder LMs: the prompt goes
        through every layer in ``chunk``-row segments, in order, each
        attending to the cache prefix and itself, so attention and the
        head hold one chunk's rows at a time instead of the prompt's.
        Offsets are static (a Python loop).  The VLM's image rows come
        first, as in :meth:`prefill`.  Writes the cache in place and
        returns the last chunk's logits ``(B, chunk, V)`` with it.

        Raises ``ValueError`` for a sliding window, an encoder, the SSM
        and hybrid families, ``S % chunk != 0`` and a cache shorter than
        the prompt."""
        cfg = self.cfg
        if (cfg.sliding_window or cfg.is_encoder
                or cfg.family in (Family.SSM, Family.HYBRID)):
            raise ValueError("prefill_chunked: full-attention decoder LMs "
                             "only")
        x_all = self.embed(params, batch if cfg.family == Family.VLM
                           else {"tokens": batch["tokens"]})
        S = x_all.shape[1]
        chunk = min(chunk, S)
        if S % chunk:
            raise ValueError(f"prefill_chunked: {S} prompt rows are not a "
                             f"multiple of the chunk {chunk}")
        for key, _, _ in self._cache_groups():
            n = cache[key]["k"].shape[-2]
            if n < S:
                raise ValueError(f"prefill_chunked: cache {key} holds {n} "
                                 f"rows, the prompt {S}")
        for off in range(0, S, chunk):
            x = self._segment(params, x_all[:, off:off + chunk], cache, off)
        return _head(cfg, params, x), cache

    @torch.no_grad()
    def decode_step_paged(self, params: PyTree, cache: PyTree,
                          pools: PyTree, tables: torch.Tensor,
                          tokens: torch.Tensor, pos: torch.Tensor):
        """Batched single-token decode over the shared page pools.

        cache: :meth:`init_cache_paged` state; pools: :meth:`init_kv_pages`
        tensors; tables: (B, NP) int32 page ids per row; tokens (B, 1);
        pos (B,) int32.  Writes in place.  Returns (logits, cache, pools).
        """
        cfg = self.cfg
        x = self.embed(params, {"tokens": tokens})
        # every layer in order, each with its cache view and its pages
        # (None for a slot-resident kind, which block_decode_paged hands
        # to block_decode)
        for (kind, p), (_, c), (_, pages) in zip(
                self._layers(params["blocks"]), self._layers(cache),
                self._layers(pools)):
            x, _, _ = block_decode_paged(cfg, kind, p, x, pos, c, pages,
                                         tables)
        return _head(cfg, params, x), cache, pools

    # ----------------------------------------------------------- input specs
    def input_specs(self, kind: str, seq: int, batch: int
                    ) -> Dict[str, torch.Tensor]:
        """Meta-tensor stand-ins (shape and dtype, no storage) for every
        model input of a shape cell, as the reference's
        ``ShapeDtypeStruct``s.  kind: "train" | "prefill" | "decode"."""
        cfg = self.cfg

        def sd(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        i32 = torch.int32
        if kind == "decode":
            return {"tokens": sd((batch, 1), i32), "pos": sd((batch,), i32)}
        if cfg.family == Family.AUDIO:
            specs = {"frames": sd((batch, seq, cfg.frontend_dim),
                                  cfg.compute_dtype)}
        elif cfg.family == Family.VLM:
            n_img = min(256, seq // 2)
            specs = {"tokens": sd((batch, seq - n_img), i32),
                     "img": sd((batch, n_img, cfg.frontend_dim),
                               cfg.compute_dtype)}
        else:
            specs = {"tokens": sd((batch, seq), i32)}
        if kind == "train":
            specs["labels"] = sd((batch, seq), i32)
        return specs


def unit_seed(seed: int, index: int) -> int:
    """Seed of unit ``index``'s generator under a model seed."""
    return (int(seed) * 1_000_003 + index) % (1 << 63)


_models: Dict[Tuple[ArchConfig, str], LM] = {}


def build(cfg: ArchConfig, device: DeviceLike = None):
    """Build (cached) the model for a config on ``device`` (default: the
    GPU; raises without one unless ``device="cpu"``): an :class:`LM`, or
    for the vision family a :class:`~repro_torch.models.vision.VisionModel`."""
    if cfg.family == Family.VISION:
        from repro_torch.models import vision
        return vision.build(cfg, device)
    dev = resolve_device(device)
    key = (cfg, str(dev))
    if key not in _models:
        _models[key] = LM(cfg, dev)
    return _models[key]


def _quant_pair(a):
    """``(q, scale)`` of a reference ``QuantLeaf`` (an object with ``q``
    and ``scale`` arrays), else ``None``."""
    if hasattr(a, "q") and hasattr(a, "scale"):
        return a.q, a.scale
    return None


def _as_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes, as JAX exports it
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # writable copy


def params_from_numpy(cfg: ArchConfig, tree: PyTree,
                      device: DeviceLike = None) -> PyTree:
    """Carry a reference parameter tree (numpy arrays, ``blocks/s0``
    leaves stacked ``(n_units, ...)``; for the vision family ``{unit:
    unit tree}``) into the port's params on ``device``, checking it
    against the model's structure and shapes.
    A quantized leaf (the reference's ``QuantLeaf``, with numpy ``q`` and
    ``scale``) becomes a :class:`~repro_torch.quant.QuantLeaf`."""
    dev = resolve_device(device)

    def shape(leaf):
        pair = _quant_pair(leaf)
        return tuple(np.shape(pair[0] if pair is not None else leaf))

    def carry(leaf):
        pair = _quant_pair(leaf)
        if pair is None:
            return _as_tensor(leaf, dev)
        return QuantLeaf(_as_tensor(pair[0], dev), _as_tensor(pair[1], dev))

    want = {"/".join(p): tuple(leaf.shape) for p, leaf in
            tree_util.leaves_with_path(build(cfg, dev).abstract())}
    got = {"/".join(p): shape(leaf) for p, leaf in
           tree_util.leaves_with_path(tree)}
    if want != got:
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"model: expected {want}, got {got}")
    return tree_util.tree_map(carry, tree)
