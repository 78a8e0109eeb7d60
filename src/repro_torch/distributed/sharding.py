"""Logical-axis sharding rules (MaxText-style), the serving half of
``repro.distributed.sharding``.

Parameters are classified by leaf path into *logical* axes, and a
:class:`ShardingRules` mapping resolves logical names to mesh axes; an
axis that does not resolve or does not divide its dimension falls back
to replication (``_guarded_spec``), so every (arch x mesh) pair plans.

The port has no JAX, so it keeps its own small :class:`Mesh`,
:class:`PartitionSpec` and :class:`NamedSharding`, with the parts of
JAX's that the shard-granular cold start reads: a mesh's ``shape``
(axis -> size), ``devices`` (an ndarray of devices in mesh coordinates)
and ``size``; a sharding's ``spec``, ``is_fully_replicated`` and
``devices_indices_map(shape)``, which returns for each device the same
tuple of slices as JAX's.

A mesh's devices are *logical*: each carries an integer ``id`` and the
physical ``torch.device`` it lives on, and every device of one mesh
shares that physical device (:func:`repro_torch.launch.mesh.
make_serving_mesh`).  Buffers and cache keys are keyed by ``id``, never
by ``torch.device``, which all of them share.

The training half: :func:`use_rules` makes a (mesh, rules) pair the
active context (:func:`active_context`); :func:`constrain` resolves an
activation's logical names against it, as the reference's does, and
returns the tensor unchanged, since a mesh of the port lies on one device
and there is nothing to constrain; :func:`cache_specs` and
:func:`batch_specs` give the reference's specs for decode caches and
input batches.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.store.store import leaf_path_name

PyTree = Any
Axes = Union[None, str, Tuple[str, ...]]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of axes, or None)."""
    mapping: Dict[str, Axes]

    def resolve(self, name: Optional[str]) -> Axes:
        if name is None:
            return None
        return self.mapping.get(name, None)


def serve_rules(*, multi_pod: bool = False) -> ShardingRules:
    """Serving: weights TP over `model`, replicated over data; batch DP."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules({
        # activations
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": None,
        "ff": "model",
        "vocab": "model",
        "expert_act": "model",
        # decode KV cache: sequence-sharded over `model` (split-K decode)
        "kv_seq": "model",
        # params
        "fsdp": None,
        "tensor": "model",
        "tensor_alt": None,
        "expert": "model",
        "vocab_p": "model",
    })


def train_rules(*, multi_pod: bool = False) -> ShardingRules:
    """Training: TP over `model` + FSDP/DP over (`pod`,)`data`."""
    dp = ("pod", "data") if multi_pod else ("data",)
    r = serve_rules(multi_pod=multi_pod)
    r.mapping.update({
        "batch": dp,
        "fsdp": dp,
    })
    return r


# ---------------------------------------------------------------------------
# the logical mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LogicalDevice:
    """One device of a mesh: its position-independent ``id`` and the
    physical device its buffers live on."""
    id: int
    device: torch.device


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array (``None``: not sharded); a
    trailing dimension left out is not sharded."""

    def __new__(cls, *axes: Axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """An ndarray of :class:`LogicalDevice` with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims with axis names "
                             f"{tuple(axis_names)}")
        phys = {d.device for d in devices.flat}
        if len(phys) != 1:
            raise ValueError(f"a mesh's devices share one physical device, "
                             f"got {sorted(map(str, phys))}")
        ids = [d.id for d in devices.flat]
        if len(set(ids)) != len(ids):
            raise ValueError(f"mesh device ids repeat: {ids}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.device: torch.device = phys.pop()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {self.size} logical devices on "
                f"{self.device})")


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    @property
    def is_fully_replicated(self) -> bool:
        return all(np.prod([self.mesh.shape[a] for a in self._axes(ax)]) == 1
                   for ax in self.spec)

    @staticmethod
    def _axes(ax: Axes) -> Tuple[str, ...]:
        if ax is None:
            return ()
        return (ax,) if isinstance(ax, str) else tuple(ax)

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[LogicalDevice, Tuple[slice, ...]]:
        """For each device, in mesh order, the slice of an array of
        ``shape`` it holds: a dimension sharded over axes ``(a, b)`` is
        cut into ``size(a) * size(b)`` equal blocks, the device taking
        the block of its row-major (a, b) coordinate; other dimensions
        are whole (``slice(None)``), as in JAX."""
        shape = tuple(int(s) for s in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than shape "
                             f"{shape}")
        sizes = self.mesh.shape
        pos = {a: i for i, a in enumerate(self.mesh.axis_names)}
        out = {}
        for coord in np.ndindex(*self.mesh.devices.shape):
            idx = []
            for dim, n in enumerate(shape):
                axes = self._axes(self.spec[dim]) if dim < len(self.spec) \
                    else ()
                parts = 1
                block = 0
                for a in axes:
                    parts *= sizes[a]
                    block = block * sizes[a] + coord[pos[a]]
                if parts == 1:
                    idx.append(slice(None))
                    continue
                if n % parts:
                    raise ValueError(f"dim {dim} of {shape} does not divide "
                                     f"into {parts} shards")
                step = n // parts
                idx.append(slice(block * step, (block + 1) * step))
            out[self.mesh.devices[coord]] = tuple(idx)
        return out

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _guarded_spec(mesh: Mesh, rules: ShardingRules, shape: Sequence[int],
                  logical: Sequence[Optional[str]]) -> PartitionSpec:
    """Resolve logical names to a PartitionSpec; drop any axis that does not
    divide its dimension or reuses an already-assigned mesh axis."""
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axes = rules.resolve(name)
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        # drop mesh axes already used by an earlier dim
        tup = tuple(a for a in tup if a not in used and a in mesh.shape)
        size = 1
        for a in tup:
            size *= mesh.shape[a]
        if not tup or size <= 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(tup)
        out.append(tup[0] if len(tup) == 1 else tup)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def use_rules(mesh: Mesh, rules: ShardingRules):
    token = _ACTIVE.set((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_context() -> Optional[Tuple[Mesh, ShardingRules]]:
    return _ACTIVE.get()


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axis names: the spec is resolved
    under an active context (so a bad name fails as in the reference),
    and ``x`` comes back as it is."""
    ctx = _ACTIVE.get()
    if ctx is None or len(logical) != x.dim():
        return x
    mesh, rules = ctx
    NamedSharding(mesh, _guarded_spec(mesh, rules, tuple(x.shape), logical))
    return x


# ---------------------------------------------------------------------------
# parameter classification
# ---------------------------------------------------------------------------

# leaf-name -> logical axes for the *trailing* dims (leading stacked `L`
# dims are padded with None automatically).
_PARAM_TABLE: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "tok": ("vocab_p", "fsdp"),
    "pos": (None, "fsdp"),
    "head.w": ("fsdp", "vocab_p"),
    # attention
    "wq": ("fsdp", "tensor", None),
    "wk": ("fsdp", "tensor", None),
    "wv": ("fsdp", "tensor", None),
    "wo": ("tensor", None, "fsdp"),
    # mlp
    "wg": ("fsdp", "tensor"),
    "wu": ("fsdp", "tensor"),
    "wd": ("tensor", "fsdp"),
    # moe
    "router": ("fsdp", None),
    "moe.wg": ("expert", "fsdp", "tensor"),
    "moe.wu": ("expert", "fsdp", "tensor"),
    "moe.wd": ("expert", "tensor", "fsdp"),
    # mamba-2 ssd
    "in_proj": ("fsdp", "tensor"),
    "out_proj": ("tensor", "fsdp"),
    "conv": (None, "tensor"),
    "a_log": (None,),
    "d_skip": (None,),
    "dt_bias": (None,),
    "ssd_norm": ("tensor",),
    # rg-lru
    "wx": ("fsdp", "tensor"),
    "wa": ("fsdp", "tensor"),
    "wy": ("tensor", "fsdp"),
    "lam": (None,),
    "gate_bias": (None,),
    # norms / misc
    "scale": (None,),
    "bias": (None,),
    # vision
    "kernel": (None, None, None, "tensor"),
    "w": ("fsdp", "tensor"),
}


def _leaf_logical(path: Tuple[str, ...], shape: Tuple[int, ...]
                  ) -> Tuple[Optional[str], ...]:
    keys = [str(p) for p in path]
    name = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) >= 2 else ""
    lookup = None
    if f"{parent}.{name}" in _PARAM_TABLE:
        lookup = _PARAM_TABLE[f"{parent}.{name}"]
    elif parent == "experts" and f"moe.{name}" in _PARAM_TABLE:
        lookup = _PARAM_TABLE[f"moe.{name}"]
    elif name in _PARAM_TABLE:
        lookup = _PARAM_TABLE[name]
    if lookup is None:
        lookup = (None,) * len(shape)
    # pad leading stacked dims (scan-stacked layer axis etc.)
    if len(lookup) < len(shape):
        lookup = (None,) * (len(shape) - len(lookup)) + tuple(lookup)
    elif len(lookup) > len(shape):
        lookup = tuple(lookup[-len(shape):])
    return tuple(lookup)


def _named_specs(tree: PyTree, mesh: Mesh, rules: ShardingRules
                 ) -> Dict[str, NamedSharding]:
    out = {}
    for path, leaf in tree_util.leaves_with_path(tree):
        shape = tuple(leaf.shape)
        spec = _guarded_spec(mesh, rules, shape, _leaf_logical(path, shape))
        out[leaf_path_name(path)] = NamedSharding(mesh, spec)
    return out


def param_specs(abstract_params: PyTree, mesh: Mesh,
                rules: ShardingRules) -> PyTree:
    """NamedSharding tree matching the (abstract) parameter tree.

    Works on the full (stacked) tree *and* on a single streaming unit's
    tree: classification keys off the trailing leaf-path components,
    which are identical in both views."""
    return tree_util.unflatten(abstract_params,
                               _named_specs(abstract_params, mesh, rules))


def leaf_specs(abstract_unit: PyTree, mesh: Mesh, rules: ShardingRules
               ) -> Dict[str, NamedSharding]:
    """Per-leaf NamedShardings of one streaming unit, keyed by the
    WeightStore's flat leaf path ("attn/wq", "norm1/scale", ...) — the
    resolution the shard-granular cold start plans its byte-range
    retrieval streams from."""
    return _named_specs(abstract_unit, mesh, rules)


def cache_specs(abstract_cache: PyTree, mesh: Mesh,
                rules: ShardingRules) -> PyTree:
    """KV/recurrent-state cache sharding: (L, B, K, S, dh) — batch over DP,
    cache sequence over `kv_seq` (split-K decode); state tensors
    batch-only.  Leaves are anything with a ``shape``; ``None`` leaves
    (a paged group's K/V) stay ``None``."""
    def f(leaf):
        if leaf is None:
            return None
        shape = tuple(leaf.shape)
        if len(shape) == 5:      # (L, B, K, S, dh) attn cache (kv-major)
            logical = (None, "batch", "kv_heads", "kv_seq", None)
        elif len(shape) == 4:    # (L, B, nh, ...) ssd state / conv state
            logical = (None, "batch", "tensor", None)
        elif len(shape) == 3:    # (L, B, width) rg-lru state
            logical = (None, "batch", "tensor")
        elif len(shape) == 2:    # (B,) aux / (L,B)
            logical = (None, "batch")
        elif len(shape) == 1:
            logical = ("batch",)
        else:
            logical = (None,) * len(shape)
        return NamedSharding(mesh, _guarded_spec(mesh, rules, shape,
                                                 logical))
    return tree_util.tree_map(f, abstract_cache)


def batch_specs(abstract_batch: PyTree, mesh: Mesh,
                rules: ShardingRules) -> PyTree:
    """Input batches: leading dim is global batch -> DP axes."""
    def f(leaf):
        shape = tuple(leaf.shape)
        logical = ("batch",) + (None,) * (len(shape) - 1)
        return NamedSharding(mesh, _guarded_spec(mesh, rules, shape,
                                                 logical))
    return tree_util.tree_map(f, abstract_batch)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
