"""LM assembly of the port: the stacked steady-state view and the
streaming unit view of ``repro.models.transformer``, dense family.

Parameters are nested dicts of tensors with the reference's tree
structure and layouts: ``{"embed": {"tok"}, "blocks": {"s0": {...}},
"final": {"norm", "head"}}``, every ``blocks/s0`` leaf stacked
``(n_units, ...)``.  The forward passes loop over the stacked units in
Python (PyTorch runs eagerly; there is no scan to keep small).

The embed, block and final units are ``nn.Module``s (:class:`EmbedUnit`,
:class:`BlockUnit`, :class:`FinalUnit`) that own their parameters in
those layouts.  Constructing one is the pipeline's layer construction:
on ``torch.device("meta")`` it is MiniLoader's shape-only structure
(:meth:`LM.abstract_unit`), on a real device with ``init_`` it is the
PISeL-faithful numerical initialization (:meth:`LM.init_unit`).

The paged side (``decode_step_paged`` over page pools ``(n_units, P, K,
pt, dh)``, ``gather_pages`` / ``pack_pages`` / ``copy_page``, and
``prefill_continue`` for prefix reuse) follows the reference's
``transformer.py:615-830``; like the slotted caches, pools and caches are
written in place.

Only the dense family runs in this slice; every other family raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.api import ArchConfig, Family
from repro_torch.quant import QuantLeaf

PyTree = Any

_PENDING = {
    Family.MOE: "ROADMAP queue 1 item 11 (MoE)",
    Family.SSM: "ROADMAP queue 1 item 12 (mamba2, kernel ssd_scan)",
    Family.HYBRID: "ROADMAP queue 1 item 12 (recurrentgemma, kernel "
                   "rglru_scan)",
    Family.AUDIO: "ROADMAP queue 1 item 12 (hubert stub path)",
    Family.VLM: "ROADMAP queue 1 item 12 (internvl2 stub path)",
    Family.VISION: "ROADMAP queue 1 item 7 (vision family)",
}


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
    def __init__(self, cfg: ArchConfig, device):
        super().__init__(cfg, {"tok": (cfg.vocab_size, cfg.d_model)}, device)

    def init_(self, gen: torch.Generator) -> "EmbedUnit":
        layers.embed_init_(self.tok.data, gen)
        return self


class BlockUnit(UnitModule):
    """One pre-norm attention + MLP block."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__(cfg, {"norm1": layers.norm_shapes(cfg),
                               "attn": layers.attn_shapes(cfg),
                               "norm2": layers.norm_shapes(cfg),
                               "mlp": layers.mlp_shapes(cfg)}, device)

    def init_(self, gen: torch.Generator) -> "BlockUnit":
        p = self.tree()
        layers.norm_init_(self.cfg, p["norm1"])
        layers.attn_init_(self.cfg, p["attn"], gen)
        layers.norm_init_(self.cfg, p["norm2"])
        layers.mlp_init_(self.cfg, p["mlp"], gen)
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
# per-kind block functions (dense: "attn")
# ---------------------------------------------------------------------------

KIND = "attn"          # the block kind of every dense layer


def _check_kind(kind: str):
    if kind != KIND:
        raise NotImplementedError(
            f"block kind {kind!r}: only dense 'attn' blocks are ported "
            f"(see ROADMAP queue 1 items 11-12)")


def block_params(cfg, kind: str, gen: torch.Generator) -> PyTree:
    _check_kind(kind)
    return BlockUnit(cfg, gen.device).init_(gen).tree()


def block_apply(cfg, kind: str, p: PyTree, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward of one block (the reference also returns an
    aux loss, which only MoE blocks make)."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    x = x + layers.attention_block(cfg, p["attn"], h, positions,
                                   window=cfg.sliding_window)
    h = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.mlp_block(cfg, p["mlp"], h)


def kind_cache(cfg, kind: str, batch: int, cache_len: int,
               device) -> PyTree:
    """Zeroed decode cache for one layer of this kind."""
    _check_kind(kind)
    w = cfg.sliding_window
    n = min(cache_len, w) if w > 0 else cache_len
    shape = (batch, cfg.n_kv_heads, n, cfg.dh)            # kv-head-major
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def block_decode(cfg, kind: str, p: PyTree, x: torch.Tensor,
                 pos: torch.Tensor, cache: PyTree
                 ) -> Tuple[torch.Tensor, PyTree]:
    """Single-token decode.  x: (B, 1, d); pos: (B,) int32.  Writes this
    token's K/V into ``cache`` in place."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    y, kc, vc = layers.attention_decode(cfg, p["attn"], h, pos, cache["k"],
                                        cache["v"],
                                        window=cfg.sliding_window)
    x = x + y
    h = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.mlp_block(cfg, p["mlp"], h), {"k": kc, "v": vc}


def block_prefill(cfg, kind: str, p: PyTree, x: torch.Tensor,
                  positions: torch.Tensor, cache: PyTree
                  ) -> Tuple[torch.Tensor, PyTree]:
    """Full-sequence forward that also fills this layer's decode cache
    (in place)."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    y, k, v = layers.attention_block(cfg, p["attn"], h, positions,
                                     window=cfg.sliding_window,
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
    h = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.mlp_block(cfg, p["mlp"], h), cache


def _kind_paged(cfg, kind: str) -> bool:
    """True when this layer kind's KV can live in a shared page pool:
    full attention only (a sliding-window ring reuses physical slots
    for rolling positions, so it stays slot-resident)."""
    return kind == KIND and cfg.sliding_window == 0


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
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    y, kp, vp = layers.attention_decode_paged(cfg, p["attn"], h, pos,
                                              pages["k"], pages["v"], tables)
    x = x + y
    h = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.mlp_block(cfg, p["mlp"], h), cache, {"k": kp, "v": vp}


def block_chunk(cfg, kind: str, p: PyTree, x: torch.Tensor, cache_l: PyTree,
                off: int, cs: int) -> Tuple[torch.Tensor, PyTree]:
    """One full-attention block over a ``cs``-token segment starting at
    absolute position ``off``, attending to the cache prefix + itself.
    Writes the segment's K/V into rows ``[off, off + cs)`` of ``cache_l``
    (in place); the queries sit at the last ``cs`` of ``off + cs`` key
    positions, which ``flash_attention`` masks from absolute positions."""
    _check_kind(kind)
    positions = (off + torch.arange(cs, device=x.device))[None, :]
    h = layers.apply_norm(cfg, p["norm1"], x)
    q, k, v = layers.qkv_project(cfg, p["attn"], h, positions)
    kc, vc = cache_l["k"], cache_l["v"]
    kc[:, :, off:off + cs] = k.transpose(1, 2).to(kc.dtype)
    vc[:, :, off:off + cs] = v.transpose(1, 2).to(vc.dtype)
    o = ops.flash_attention(q, kc[:, :, :off + cs].transpose(1, 2),
                            vc[:, :, :off + cs].transpose(1, 2), causal=True)
    x = x + layers.attn_out(cfg, p["attn"], o)
    h = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.mlp_block(cfg, p["mlp"], h), cache_l


def _head(cfg, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    x = layers.apply_norm(cfg, params["final"]["norm"], x)
    return layers.head_logits(cfg, params, x)


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
        if cfg.family != Family.DENSE:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family.value!r} is not ported yet "
                f"— {_PENDING[cfg.family]}")
        self.cfg = cfg
        self.device = device
        self.n_units = cfg.n_layers
        self._abstract_units: Dict[str, PyTree] = {}

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
        return BlockUnit(self.cfg, device)

    def init_unit(self, name: str, gen: torch.Generator) -> PyTree:
        """PISeL-faithful construction: full numerical initialization, on
        the generator's device."""
        if name in ("embed", "final"):
            return self.unit_module(name, gen.device).init_(gen).tree()
        return block_params(self.cfg, KIND, gen)

    def abstract_unit(self, name: str) -> PyTree:
        """MiniLoader construction: the unit built on the meta device —
        shapes and dtypes, no storage, no initialization.  Cached: the
        structure is static per model."""
        if name not in self._abstract_units:
            self._abstract_units[name] = self.unit_module(name,
                                                          "meta").tree()
        return self._abstract_units[name]

    def assemble(self, units: Dict[str, PyTree]) -> PyTree:
        per = [units[f"block_{i:03d}"] for i in range(self.n_units)]
        blocks = {"s0": tree_util.tree_map(lambda *xs: torch.stack(xs),
                                           *per)}
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
        out["x"] = block_apply(cfg, KIND, uparams, state["x"],
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
        return layers.embed_lookup(self.cfg, params["embed"],
                                   batch["tokens"])

    @torch.no_grad()
    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward.  Returns (logits (B, S, V), aux_loss)."""
        cfg = self.cfg
        x = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        blocks = params["blocks"]["s0"]
        for i in range(self.n_units):
            x = block_apply(cfg, KIND, _index(blocks, i), x,
                            positions)
        return (_head(cfg, params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # ------------------------------------------------------- decode + cache
    def init_cache(self, batch: int, cache_len: int) -> PyTree:
        per = [kind_cache(self.cfg, KIND, batch, cache_len,
                          self.device) for _ in range(self.n_units)]
        return {"s0": tree_util.tree_map(lambda *xs: torch.stack(xs), *per)}

    @torch.no_grad()
    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                cache: PyTree) -> Tuple[torch.Tensor, PyTree]:
        """Run the full prompt and fill ``cache`` (in place).  Returns
        (logits, cache)."""
        cfg = self.cfg
        x = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        blocks = params["blocks"]["s0"]
        for i in range(self.n_units):
            x, _ = block_prefill(cfg, KIND, _index(blocks, i), x,
                                 positions, _index(cache["s0"], i))
        return _head(cfg, params, x), cache

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree,
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """tokens: (B, 1); pos: (B,) int32 absolute position of this token.
        Writes the token's K/V into ``cache`` in place.  Returns
        (logits (B, 1, V), cache)."""
        cfg = self.cfg
        x = self.embed(params, {"tokens": tokens})
        blocks = params["blocks"]["s0"]
        for i in range(self.n_units):
            x, _ = block_decode(cfg, KIND, _index(blocks, i), x,
                                pos, _index(cache["s0"], i))
        return _head(cfg, params, x), cache


    # ----------------------------------------------------- paged KV decode
    @property
    def paged(self) -> bool:
        """Whether the layers' KV can live in a page pool."""
        return _kind_paged(self.cfg, KIND)

    def paged_kinds(self) -> List[str]:
        return [KIND] if self.paged else []

    @property
    def supports_prefix_cache(self) -> bool:
        """Prefix reuse needs every layer's sequence state in pages."""
        return not self.cfg.is_encoder and self.paged

    def kv_page_bytes(self, page_tokens: int) -> int:
        """Device bytes one page id costs across all paged layers (K and
        V); 0 when no layer pages."""
        if not self.paged:
            return 0
        cfg = self.cfg
        item = torch.empty((), dtype=cfg.compute_dtype).element_size()
        return (self.n_units * 2 * cfg.n_kv_heads * page_tokens * cfg.dh
                * item)

    def init_kv_pages(self, n_pages: int, page_tokens: int) -> PyTree:
        """Physical page pools ``{"s0": {"k", "v"}}`` of ``(n_units,
        n_pages, K, pt, dh)`` (``{"s0": None}`` when no layer pages).  The
        caller sizes ``n_pages`` to the budget + 1 (the scratch page)."""
        if not self.paged:
            return {"s0": None}
        cfg = self.cfg
        shape = (self.n_units, n_pages, cfg.n_kv_heads, page_tokens, cfg.dh)
        return {"s0": {n: torch.zeros(shape, dtype=cfg.compute_dtype,
                                      device=self.device)
                       for n in ("k", "v")}}

    def init_cache_paged(self, batch: int, cache_len: int) -> PyTree:
        """Slot-resident decode state with paged K/V leaves ``None`` (they
        live in the pools): the structure of :meth:`init_cache`."""
        if self.paged:
            return {"s0": {"k": None, "v": None}}
        return self.init_cache(batch, cache_len)

    def init_request_cache(self, paged_len: int, state_len: int) -> PyTree:
        """B=1 prefill cache for paged admission: sized to the request's
        page span when the layers page, else to the slot state length."""
        return self.init_cache(1, paged_len if self.paged else state_len)

    def strip_paged(self, cache: PyTree) -> PyTree:
        """A per-request cache projected onto the paged state structure
        (paged K/V content moves by :meth:`pack_pages` instead)."""
        return {"s0": {"k": None, "v": None}} if self.paged else cache

    def gather_pages(self, cache: PyTree, pools: PyTree,
                     ids: torch.Tensor) -> PyTree:
        """Copy physical pages ``ids`` (in logical order) into rows
        ``[0, len(ids) * pt)`` of a contiguous B=1 cache, in place — the
        device half of a prefix hit."""
        if self.paged:
            m, idx = int(ids.numel()), ids.long()
            for n in ("k", "v"):
                pool, c = pools["s0"][n], cache["s0"][n]
                L, _, K, pt, dh = pool.shape
                c[:, 0, :, :m * pt] = pool[:, idx].transpose(1, 2).reshape(
                    L, K, m * pt, dh).to(c.dtype)
        return cache

    def pack_pages(self, pools: PyTree, cache: PyTree, ids: torch.Tensor,
                   first_page: int) -> PyTree:
        """Copy B=1 cache rows ``[first_page * pt, (first_page + len(ids))
        * pt)`` into physical pages ``ids``, in place — the device half
        of admission."""
        if self.paged:
            m, idx = int(ids.numel()), ids.long()
            for n in ("k", "v"):
                pool, c = pools["s0"][n], cache["s0"][n]
                L, _, K, pt, dh = pool.shape
                lo = first_page * pt
                seg = c[:, 0, :, lo:lo + m * pt].reshape(L, K, m, pt, dh)
                pool[:, idx] = seg.transpose(1, 2).to(pool.dtype)
        return pools

    def copy_page(self, pools: PyTree, src: int, dst: int) -> PyTree:
        """Device half of a copy-on-write fork: page ``src`` into ``dst``
        across every paged layer, in place."""
        if self.paged:
            for n in ("k", "v"):
                pools["s0"][n][:, dst] = pools["s0"][n][:, src]
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
        cfg = self.cfg
        x = self.embed(params, batch)
        cs = x.shape[1]
        blocks = params["blocks"]["s0"]
        for i in range(self.n_units):
            x, _ = block_chunk(cfg, KIND, _index(blocks, i), x,
                               _index(cache["s0"], i), off, cs)
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
        blocks = params["blocks"]["s0"]
        for i in range(self.n_units):
            pages = None if pools["s0"] is None else _index(pools["s0"], i)
            x, _, _ = block_decode_paged(cfg, KIND, _index(blocks, i), x,
                                         pos, _index(cache["s0"], i), pages,
                                         tables)
        return _head(cfg, params, x), cache, pools


def unit_seed(seed: int, index: int) -> int:
    """Seed of unit ``index``'s generator under a model seed."""
    return (int(seed) * 1_000_003 + index) % (1 << 63)


_models: Dict[Tuple[ArchConfig, str], LM] = {}


def build(cfg: ArchConfig, device: DeviceLike = None) -> LM:
    """Build (cached) the model for a config on ``device`` (default: the
    GPU; raises without one unless ``device="cpu"``)."""
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
    leaves stacked ``(n_units, ...)``) into the port's params on
    ``device``, checking it against the model's structure and shapes.
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
            tree_util.leaves_with_path(LM(cfg, dev).abstract())}
    got = {"/".join(p): shape(leaf) for p, leaf in
           tree_util.leaves_with_path(tree)}
    if want != got:
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"model: expected {want}, got {got}")
    return tree_util.tree_map(carry, tree)
