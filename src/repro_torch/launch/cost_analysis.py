"""Cost accounting of one step: the twin of ``repro.launch.hlo_analysis``.

The reference reads a step's FLOPs and HBM bytes from XLA's cost analysis
of the compiled program and its collective bytes from the partitioned
HLO text.  The port runs eager PyTorch and has no HLO, so it counts the
step as it runs, on any device:

  * :func:`counting` installs a :class:`Tally` (a ``TorchDispatchMode``)
    for the step.  Each aten op adds its FLOPs (the matmul-like ops, by
    ``torch.utils.flop_counter``'s formulas) and its bytes (a view moves
    none, an ``empty`` none; an in-place scatter, such as a cache write,
    reads its other inputs and writes as many bytes as its values; every
    other op reads each tensor input once and writes each output once).
    Each registry kernel's call adds its own ``cost``
    (``repro_torch.kernels.ops.KernelSpec.cost``: the algorithm's work
    from the shapes) and one to ``kernels[name]``, and the aten ops inside
    the wrapper (its kernel's, its plain version's, or its meta branch's)
    are not counted.  So one step counts the same on meta tensors, on the
    CPU and on the card.  Every storage an op allocates is live from its
    allocation to its last tensor's death (a finalizer on the storage),
    which gives ``peak_live_bytes``.
  * :func:`tree_bytes` gives a state tree's bytes (its storages', each
    once); :func:`shard_bytes` a tree's bytes a device under its specs.
  * :func:`collective_bytes` gives a step's collective bytes a device
    from ``distributed/sharding.py``'s specs, as the reference's HLO scan
    would find them (the result bytes of each collective), for the
    parameters and gradients only (``"scope": "params_and_grads"``): the
    tensor-parallel activation collectives are not counted.

With no :class:`Tally` installed the registry's wrappers run as they are
(``repro_torch.kernels.cuda_lib.accounted``) and no mode is pushed: the
accounting costs nothing.  One tally at a time in a process.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as tree_util
from repro_torch.distributed.sharding import Mesh, NamedSharding, ShardingRules
from repro_torch.kernels import cuda_lib

PyTree = Any
aten = torch.ops.aten

# no bytes moved: allocations that write nothing, and _unsafe_view, a view
# its schema does not call one
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
             aten.new_empty_strided, aten._unsafe_view}

# ops that write some rows of their first argument in place: they read
# their other tensor inputs and write as many bytes as their last (the
# values, the source), not the whole of the first (a KV cache, say)
_SCATTER = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
            aten.index_add_, aten.scatter_, aten.scatter_add_,
            aten.masked_scatter_}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter")


def _tensors(args) -> list:
    """The tensors among an op's arguments (or outputs): top level and one
    list deep, as aten schemas pass them."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _OpInfo:
    """What the tally needs of an op's schema, worked out once an op."""

    def __init__(self, func):
        returns = func._schema.returns
        self.view = func.is_view
        self.moves = not (self.view or func._overloadpacket in _NO_BYTES)
        self.scatter = func._overloadpacket in _SCATTER
        # outputs the schema does not alias to an input (None: it cannot
        # say output by output)
        self.fresh = [r.alias_info is None for r in returns]
        # an out-of-place op of plain Tensor returns: on meta its outputs
        # are a function of its arguments' metadata, which can be cached
        self.cacheable = bool(returns) and all(self.fresh) and all(
            r.type.kind() == "TensorType" for r in returns)
        self.multi = len(returns) > 1
        self.count = flop_registry.get(func._overloadpacket)


def _meta_key(a):
    """A hashable key of an argument's metadata (a tensor's shape, strides
    and dtype; any other argument's value)."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_meta_key(x) for x in a)
    if isinstance(a, dict):
        return tuple(sorted((k, _meta_key(v)) for k, v in a.items()))
    return a


class Tally(TorchDispatchMode):
    """The counts of one step (see the module's note): ``flops``,
    ``bytes``, ``kernels`` (calls by registry name), ``peak_live_bytes``
    (the most storage that ops of the step held at once) and
    ``live_bytes`` (what they hold now).

    On meta tensors an out-of-place op's outputs depend on its arguments'
    metadata alone, so after its first call with some metadata the tally
    makes them as empty meta tensors of the recorded shapes and strides
    instead of running the op's meta function again (PyTorch runs an
    elementwise one in Python, ~0.2 ms a call): the same tensors, faster.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, int] = collections.Counter()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: Dict[int, int] = {}      # storage key -> its bytes
        self._paused = 0
        self._info: Dict[Any, _OpInfo] = {}
        self._meta_out: Dict[Any, tuple] = {}

    # -- registry kernels (cuda_lib.accounted) --------------------------
    @contextlib.contextmanager
    def kernel(self, name: str, cost: Callable, args, kwargs):
        """Around one wrapper call: the aten ops inside are not counted;
        when the call returns, its cost and one call are."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1
        flops, nbytes = cost(*args, **kwargs)
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.kernels[name] += 1

    # -- aten ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _OpInfo(func)
        if info.view:                   # no bytes, no storage of its own
            return func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        out = self._run(func, info, ins, args, kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        self._track(info, ins, outs)
        if self._paused or not info.moves:
            return out
        if info.scatter:
            self.bytes += sum(t.nbytes for t in ins[1:]) + ins[-1].nbytes
        else:
            self.bytes += sum(t.nbytes for t in ins) + sum(
                t.nbytes for t in outs)
        if info.count is not None:
            self.flops += int(info.count(*args, **kwargs, out_val=out))
        return out

    def _run(self, func, info: _OpInfo, ins, args, kwargs):
        meta = info.cacheable and all(t.device.type == "meta" for t in ins)
        if meta and not ins:             # a factory: meta if it says so
            dev = kwargs.get("device")
            meta = dev is not None and torch.device(dev).type == "meta"
        if not meta:
            return func(*args, **kwargs)
        key = (func, _meta_key(args), _meta_key(kwargs))
        made = self._meta_out.get(key)
        if made is None:
            out = func(*args, **kwargs)
            self._meta_out[key] = tuple(
                (tuple(t.shape), t.stride(), t.dtype) for t in (
                    out if isinstance(out, tuple) else (out,)))
            return out
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in made)
        return outs if info.multi else outs[0]

    def _track(self, info: _OpInfo, ins, outs):
        """Start the life of each storage the op allocated: an output the
        schema does not alias to an input, on a storage no input has and
        none of the step's holds yet."""
        fresh = [t for t, f in zip(outs, info.fresh) if f] \
            if len(outs) == len(info.fresh) else outs
        if not fresh:
            return
        have = {_key(t) for t in ins}
        for t in fresh:
            st = t.untyped_storage()
            key = st._cdata
            if key in have or key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, _free, weakref.ref(self), key)

    def record(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": dict(sorted(self.kernels.items())),
                "peak_live_bytes": self.peak_live_bytes}


def _free(ref, key: int):
    tally = ref()
    if tally is not None and key in tally._live:
        tally.live_bytes -= tally._live.pop(key)


@contextlib.contextmanager
def counting() -> Iterator[Tally]:
    """Count the step run inside: yields its :class:`Tally`."""
    tally = Tally()
    prev = cuda_lib.set_tally(tally)
    if prev is not None:
        cuda_lib.set_tally(prev)
        raise RuntimeError("a counting context is already active")
    try:
        with tally:
            yield tally
    finally:
        cuda_lib.set_tally(None)


def count_step(step: Callable[[], Any]) -> Dict[str, Any]:
    """``step()`` run once inside :func:`counting`; its record."""
    with counting() as tally:
        step()
    return tally.record()


def combine_linear(c1: Dict[str, Any], c2: Dict[str, Any],
                   n_units: int) -> Dict[str, Any]:
    """A record for ``n_units`` pattern units from records at one (c1) and
    two (c2): ``c1 + (n_units - 1) * (c2 - c1)``, entry by entry (nested
    dicts too), a negative difference taken as 0 (the reference's
    ``hlo_analysis.combine_linear``).  Exact for counts that each unit
    adds alike (FLOPs, bytes, kernel calls); the peak is an estimate."""
    def comb(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            a, b = a or {}, b or {}
            return {k: comb(a.get(k, 0), b.get(k, 0))
                    for k in sorted(set(a) | set(b))}
        return a + (n_units - 1) * max(b - a, 0)
    return comb(c1, c2)


# ---------------------------------------------------------------------------
# state trees
# ---------------------------------------------------------------------------

def _leaves(tree: PyTree) -> list:
    """Tensor leaves of a tree, an optimizer state's fields too."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [t for f in tree for t in _leaves(f)]
    return [t for t in tree_util.leaves(tree) if isinstance(t, torch.Tensor)]


def storage_sizes(tree: PyTree) -> list:
    """Bytes of each of a tree's storages, each once (a meta tensor's are
    the bytes it would hold)."""
    seen = {}
    for t in _leaves(tree):
        seen[_key(t)] = t.untyped_storage().nbytes()
    return list(seen.values())


def tree_bytes(tree: PyTree) -> int:
    """Bytes of a tree's storages, each counted once."""
    return sum(storage_sizes(tree))


def _axes(ax) -> tuple:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def shard_shape(shape, sharding: NamedSharding) -> tuple:
    """The shape of one device's block of an array of ``shape``."""
    sizes = sharding.mesh.shape
    out = []
    for dim, n in enumerate(shape):
        ax = sharding.spec[dim] if dim < len(sharding.spec) else None
        out.append(n // int(np.prod([sizes[a] for a in _axes(ax)])))
    return tuple(out)


def _spec_leaves(specs: PyTree) -> list:
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return [s for f in specs for s in _spec_leaves(f)]
    if isinstance(specs, NamedSharding):
        return [specs]
    return [s for s in tree_util.leaves(specs) if s is not None]


def shard_bytes(tree: PyTree, specs: PyTree) -> int:
    """Bytes a device holds of ``tree`` under ``specs`` (a tree of
    :class:`NamedSharding` of the same structure)."""
    leaves, shs = _leaves(tree), _spec_leaves(specs)
    if len(leaves) != len(shs):
        raise ValueError(f"{len(leaves)} leaves against {len(shs)} specs")
    return sum(int(np.prod(shard_shape(t.shape, s))) * t.element_size()
               for t, s in zip(leaves, shs))


# ---------------------------------------------------------------------------
# collectives from the specs
# ---------------------------------------------------------------------------

def collective_bytes(params: PyTree, specs: PyTree, mesh: Mesh,
                     rules: ShardingRules, *, kind: str,
                     micro_batches: int = 1,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Collective bytes a device for one step, counted as the reference's
    HLO scan counts them (each collective's result bytes a device).

    Let a leaf's block on a device hold ``s`` bytes (at ``dtype``, the
    dtype the step gathers and differentiates the leaf in, where given:
    bf16 under mixed precision), and ``f`` be the product of the data axes
    (the axes ``fsdp`` resolves to) its spec shards over.  A train step of
    M microbatches counts, a microbatch:

      * an all-gather of ``s * f`` bytes for each leaf with ``f > 1``,
        twice for the stacked blocks' leaves (``blocks/s*``: the forward,
        and the backward that re-runs it under remat), once for the rest;
      * a reduce-scatter of its gradient, ``s`` bytes;
      * for each leaf with ``f == 1``, an all-reduce of its gradient over
        the data axes, ``s`` bytes, where they hold more than one device.

    A serving step (``kind`` "prefill" or "decode") gathers each leaf with
    ``f > 1`` once (only where ``fsdp`` resolves: the big models' rule).
    Tensor-parallel activation collectives are not counted."""
    data = tuple(a for a in _axes(rules.resolve("fsdp")) if a in mesh.shape)
    dp = int(np.prod([mesh.shape[a] for a in data])) if data else 1
    out = dict.fromkeys(COLLECTIVE_KINDS, 0)
    counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
    train = kind == "train"
    paths = ["/".join(p) for p, _ in tree_util.leaves_with_path(params)]
    for path, t, sh in zip(paths, _leaves(params), _spec_leaves(specs)):
        used = {a for ax in sh.spec for a in _axes(ax)}
        f = int(np.prod([mesh.shape[a] for a in data if a in used]))
        s = int(np.prod(shard_shape(t.shape, sh))) * (
            dtype.itemsize if dtype is not None else t.element_size())
        if f > 1:
            gathers = (2 if path.startswith("blocks/s") else 1) if train \
                else 1
            out["all-gather"] += gathers * s * f
            counts["all-gather"] += gathers
        if not train:
            continue
        if f > 1:
            out["reduce-scatter"] += s
            counts["reduce-scatter"] += 1
        elif dp > 1:
            out["all-reduce"] += s
            counts["all-reduce"] += 1
    m = micro_batches if train else 1
    rec: Dict[str, Any] = {k: v * m for k, v in out.items() if v}
    rec["_counts"] = {k: v * m for k, v in counts.items() if v}
    rec["total"] = sum(v for k, v in out.items()) * m
    rec["scope"] = "params_and_grads"
    return rec
