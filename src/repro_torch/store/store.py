"""Layer-sharded weight store, byte for byte the format of
``repro.store.store``:

    <root>/<model>/manifest.json        # per-unit extent table
    <root>/<model>/<unit>.bin           # leaves concatenated, 64B-aligned

Each leaf records path, shape, dtype, offset, nbytes and crc32.  With
``quant="int8"`` every 2-D+ float leaf is stored as per-column int8 with
its f32 scales appended; dequantization is the ``weight_transform`` kernel
of the pipeline's application phase.  Stores deployed by either package
read in the other.

Reads are chunked and cooperatively suspendable: between chunks the reader
waits on the stream's gate (Algorithm 1's "block W").  A unit is read
straight into one host ``uint8`` tensor — pinned when CUDA is present, so
the application phase's host-to-device copy can run asynchronously — and
:meth:`WeightStore.deserialize` returns views into it.

Shard-granular cold starts read byte ranges instead of whole units:
:func:`slice_byte_runs` plans the runs of a leaf slice,
:meth:`WeightStore.read_leaf_slice` reads one slice (an int8 leaf with the
f32 scales of its columns) on the stream's own simulated channel, and
:meth:`WeightStore.open_unit` opens a unit once for a stream's reads.

A :class:`BandwidthModel` optionally simulates the storage device (the
page cache would otherwise hide the I/O phase the paper measures); the
bytes are still read.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
import zlib
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import analysis
from repro_torch import tree as tree_util

PyTree = Any
ALIGN = 64

Leaves = Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]

# manifest dtype names <-> torch dtypes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "int32": torch.int32, "uint8": torch.uint8}


# ---------------------------------------------------------------------------
# storage device model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BandwidthModel:
    """Simulated storage or link: per-request latency + a *shared*
    bandwidth cap per channel.

    Bandwidth is one token bucket per channel: all streams on a channel
    split it, so the WeightDecoupler's parallel prefetch gets no free
    bandwidth over serial PISeL retrieval.  ``channels`` models
    independent links: the cluster's intra-cluster link has one per node
    NIC (:mod:`repro_torch.cluster`), and a store serving shard-granular
    cold starts one per mesh device (each shard stream reads on its own
    channel).  The default (1) is one shared device; whole-unit reads go
    to channel 0.
    """
    bandwidth_mbps: float = 0.0          # 0 -> unthrottled (per channel)
    latency_ms: float = 0.0
    channels: int = 1

    def __post_init__(self):
        self._lock = analysis.make_lock("BandwidthModel._lock")
        self._next_free = [0.0] * max(1, int(self.channels))  # guarded-by: _lock

    def on_open(self):
        if self.latency_ms > 0:
            time.sleep(self.latency_ms / 1e3)

    def on_chunk(self, nbytes: int, channel: int = 0):
        if self.bandwidth_mbps <= 0:
            return
        dur = nbytes / (self.bandwidth_mbps * 1e6)
        with self._lock:
            ch = channel % len(self._next_free)
            start = max(time.monotonic(), self._next_free[ch])
            self._next_free[ch] = start + dur
        # the sleep runs with no lock held
        delay = (start + dur) - time.monotonic()
        if delay > 0:
            time.sleep(delay)

    def transfer(self, nbytes: int, *, channel: int = 0,
                 chunk_bytes: int = 1 << 20,
                 gate: Optional[threading.Event] = None,
                 on_chunk: Optional[Callable[[int], None]] = None):
        """Simulate moving ``nbytes`` over one channel of this link in
        suspendable chunks: the peer-exchange path, with no file
        underneath, only the wire cost of bytes already resident on
        another node.  ``gate``: the stream's Algorithm-1 suspension
        event, waited between chunks as a store read waits on it;
        ``on_chunk``: called with each chunk's size."""
        self.on_open()
        self.charge(nbytes, channel=channel, chunk_bytes=chunk_bytes,
                    gate=gate, on_chunk=on_chunk)

    def charge(self, nbytes: int, *, channel: int = 0,
               chunk_bytes: int = 1 << 20,
               gate: Optional[threading.Event] = None,
               on_chunk: Optional[Callable[[int], None]] = None):
        """The wire cost of ``nbytes`` on one channel, in suspendable
        chunks, with no request latency: :meth:`transfer` after its
        ``on_open``, and a store's slice read after its gather."""
        done = 0
        total = max(0, int(nbytes))
        while done < total:
            if gate is not None:
                gate.wait()
            n = min(int(chunk_bytes), total - done)
            self.on_chunk(n, channel)
            done += n
            if on_chunk is not None:
                on_chunk(n)


# ---------------------------------------------------------------------------
# tree <-> flat leaves
# ---------------------------------------------------------------------------

def leaf_path_name(path) -> str:
    """Canonical flat name of a leaf (``"attn/wq"``) — the leaf identity
    of the store layout, shared with the reference."""
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_unit(tree: PyTree) -> List[Tuple[str, Any]]:
    """Stable (path, leaf) list for a unit's param tree (sorted keys, as
    the reference flattens it).  Tensors stay where they lie; other
    leaves become numpy arrays."""
    return [(leaf_path_name(path), leaf if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf))
            for path, leaf in tree_util.leaves_with_path(tree)]


def _dtype_name(leaf) -> str:
    """The manifest's dtype of a leaf: numpy's name for it."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("deploying bfloat16 leaves is not supported; "
                             "deploy float32 and cast with apply_dtype")
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(leaf.dtype)


def _floating(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype.is_floating_point
    return np.issubdtype(leaf.dtype, np.floating)


def unflatten_unit(abstract: PyTree, leaves: Dict[str, Any]) -> PyTree:
    """Rebuild the unit tree from named leaves (against its abstract)."""
    for path, ab in tree_util.leaves_with_path(abstract):
        name = leaf_path_name(path)
        if tuple(leaves[name].shape) != tuple(ab.shape):
            raise ValueError(f"{name}: shape {tuple(leaves[name].shape)} != "
                             f"{tuple(ab.shape)}")
    return tree_util.unflatten(abstract, leaves)


def slice_byte_runs(shape: Tuple[int, ...], itemsize: int,
                    index: Tuple[Any, ...]) -> List[Tuple[int, int]]:
    """Contiguous (offset, nbytes) runs of ``arr[index]`` within the
    row-major payload of an array of ``shape`` — the byte-range plan a
    shard stream reads instead of the whole leaf.

    ``index`` is a per-dim sequence of slices (step 1), as
    ``NamedSharding.devices_indices_map`` gives them; runs are maximal:
    all dims inner to the outermost partial dim fold into one range.
    """
    if not shape:
        return [(0, itemsize)]
    norm = []
    for s, dim in zip(index, shape):
        start = 0 if s.start is None else int(s.start)
        stop = dim if s.stop is None else int(s.stop)
        norm.append((start, stop))
    # outermost-from-the-right dim whose slice is partial: runs span it
    # plus every (full) dim inside it
    k = 0
    for j in range(len(shape) - 1, -1, -1):
        if norm[j] != (0, shape[j]):
            k = j
            break
    inner = 1
    for d in shape[k + 1:]:
        inner *= d
    run_elems = (norm[k][1] - norm[k][0]) * inner
    if run_elems <= 0:
        return []
    strides = [0] * len(shape)           # element strides
    acc = 1
    for j in range(len(shape) - 1, -1, -1):
        strides[j] = acc
        acc *= shape[j]
    runs: List[Tuple[int, int]] = []
    for coords in itertools.product(*(range(a, b) for a, b in norm[:k])):
        off = sum(c * strides[j] for j, c in enumerate(coords))
        off += norm[k][0] * inner
        runs.append((off * itemsize, run_elems * itemsize))
    return runs


# the f32 bytes of the row block that quantize_int8 divides at once: an
# arctic-480b expert leaf's whole quotient would take 17.8 GB beside it
QUANT_BLOCK_BYTES = 1 << 30


def quantize_int8(leaf) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column int8 of a float leaf over its last axis, as the
    reference's store computes it in numpy: f32 scales amax / 127 (1 for
    an all-zero column), values rounded half to even and clipped to
    +-127.  In torch's threaded CPU ops, bit-equal to numpy's and several
    times faster on a multi-GB leaf.  A tensor is quantized on its own
    device (the same correctly rounded f32 division and rounding, so the
    same bytes) and only the int8 values and the scales come to the
    host.  The leaf is taken in row blocks of at most QUANT_BLOCK_BYTES
    at f32, once for the amax and once for the values, each block written
    straight into the host's int8: every step is elementwise or a max,
    so the bytes are the whole leaf's."""
    w = leaf.detach() if isinstance(leaf, torch.Tensor) else \
        torch.from_numpy(np.require(leaf, requirements="W"))
    w2 = w.reshape(-1, w.shape[-1])
    n, m = w2.shape
    rows = max(1, QUANT_BLOCK_BYTES // (4 * m))
    starts = range(0, n, rows)
    amax = None
    for i in starts:
        lo, hi = torch.aminmax(w2[i:i + rows].float(), dim=0)
        a = torch.maximum(hi, -lo)
        amax = a if amax is None else torch.maximum(amax, a)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar one, which can round the scale differently from numpy
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.empty((n, m), dtype=torch.int8)
    for i in starts:
        q[i:i + rows].copy_((w2[i:i + rows].float() / scale).round_()
                            .clamp_(-127, 127).to(torch.int8))
    return q.numpy(), scale.cpu().numpy()


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class WeightStore:
    def __init__(self, root: str, device: Optional[BandwidthModel] = None):
        """``device`` is the simulated storage device (as in the
        reference).  Units are read into pinned host memory when CUDA is
        present, so their host-to-device copies can run asynchronously."""
        self.root = root
        self.device = device or BandwidthModel()
        self.pin_memory = torch.cuda.is_available()
        os.makedirs(root, exist_ok=True)
        self._manifests: Dict[str, dict] = {}

    # ---------------------------------------------------------------- paths
    def _dir(self, model: str) -> str:
        return os.path.join(self.root, model)

    def _unit_path(self, model: str, unit: str) -> str:
        return os.path.join(self._dir(model), f"{unit}.bin")

    # --------------------------------------------------------------- deploy
    def deploy(self, model_name: str,
               units: Union[Mapping[str, PyTree],
                            Iterable[Tuple[str, PyTree]]], *,
               quant: Optional[str] = None) -> dict:
        """Write per-unit extents + manifest.  ``units``: unit -> tree of
        tensors or arrays, as a mapping or as an iterable of ``(unit,
        tree)`` pairs consumed once, in order.  Each unit is written and
        dropped before the next is taken, so a lazy source keeps one
        unit on the host at a time.

        quant: None (store native dtype) | "int8" (2-D+ float leaves
        quantized per output channel, scales stored f32 alongside).
        """
        d = self._dir(model_name)
        os.makedirs(d, exist_ok=True)
        manifest = {"model": model_name, "version": 1,
                    "quant": quant or "none", "units": {}}
        pairs = units.items() if isinstance(units, Mapping) else units
        for unit, tree in pairs:
            manifest["units"][unit] = self._write_unit(model_name, unit,
                                                       tree, quant)
            del tree            # before a lazy source draws the next unit
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._manifests[model_name] = manifest
        return manifest

    def _write_unit(self, model_name: str, unit: str, tree: PyTree,
                    quant: Optional[str]) -> dict:
        """Write one unit's ``.bin``, leaf by leaf (no copy of the unit's
        bytes is assembled); returns its manifest entry."""
        entries = []
        offset = 0
        with open(self._unit_path(model_name, unit), "wb") as f:
            for name, leaf in flatten_unit(tree):
                rec: Dict[str, Any] = {"path": name,
                                       "shape": list(leaf.shape),
                                       "dtype": _dtype_name(leaf)}
                if quant == "int8" and leaf.ndim >= 2 and _floating(leaf):
                    parts = quantize_int8(leaf)
                    rec["quant"] = "int8"
                    rec["scale_nbytes"] = parts[1].nbytes
                else:
                    parts = (np.ascontiguousarray(_to_numpy(leaf)),)
                    rec["quant"] = "none"
                pad = (-offset) % ALIGN
                f.write(b"\0" * pad)
                offset += pad
                rec["offset"] = offset
                rec["nbytes"] = sum(p.nbytes for p in parts)
                crc = 0
                for p in parts:
                    view = memoryview(p).cast("B")
                    crc = zlib.crc32(view, crc)
                    f.write(view)
                rec["crc32"] = crc & 0xFFFFFFFF
                offset += rec["nbytes"]
                entries.append(rec)
        return {"extents": entries, "nbytes": offset}

    def manifest(self, model_name: str) -> dict:
        if model_name not in self._manifests:
            with open(os.path.join(self._dir(model_name),
                                   "manifest.json")) as f:
                self._manifests[model_name] = json.load(f)
        return self._manifests[model_name]

    def unit_nbytes(self, model_name: str, unit: str) -> int:
        return self.manifest(model_name)["units"][unit]["nbytes"]

    # ----------------------------------------------------------------- read
    def read_unit(self, model_name: str, unit: str, *,
                  chunk_bytes: int = 4 << 20,
                  gate: Optional[threading.Event] = None,
                  on_progress: Optional[Callable[[int, int], None]] = None
                  ) -> torch.Tensor:
        """Chunked read of one unit extent into a host ``uint8`` tensor
        (pinned when CUDA is present).

        gate: cooperative suspension point — the reader blocks between
        chunks while the event is cleared (Algorithm 1's "block W").
        on_progress(bytes_done, bytes_total) per chunk.
        """
        path = self._unit_path(model_name, unit)
        total = os.path.getsize(path)
        analysis.note_io("read_unit")   # flags lock-held-across-I/O
        self.device.on_open()
        buf = torch.empty(total, dtype=torch.uint8,
                          pin_memory=self.pin_memory)
        view = memoryview(buf.numpy())
        done = 0
        with open(path, "rb") as f:
            while done < total:
                if gate is not None:
                    gate.wait()
                n = f.readinto(view[done:done + min(chunk_bytes,
                                                    total - done)])
                if not n:
                    raise IOError(f"short read of {path}")
                self.device.on_chunk(n)
                done += n
                if on_progress is not None:
                    on_progress(done, total)
        return buf

    def _leaf_rec(self, model_name: str, unit: str, leaf: str) -> dict:
        for rec in self.manifest(model_name)["units"][unit]["extents"]:
            if rec["path"] == leaf:
                return rec
        raise KeyError(f"{model_name}/{unit}/{leaf}")

    def leaf_slice_nbytes(self, model_name: str, unit: str, leaf: str,
                          index: Optional[Tuple[Any, ...]]) -> int:
        """Bytes a shard stream reads for ``leaf[index]`` (the whole
        payload when index is None — replicated leaves).  An int8 leaf
        charges its value slice (1 byte an element) plus the f32 scales
        of the columns the slice covers."""
        rec = self._leaf_rec(model_name, unit, leaf)
        if index is None:
            return rec["nbytes"]
        shape = tuple(rec["shape"])
        if rec.get("quant") == "int8":
            vals = sum(n for _, n in slice_byte_runs(shape, 1, index))
            lo = 0 if index[-1].start is None else int(index[-1].start)
            hi = shape[-1] if index[-1].stop is None else int(index[-1].stop)
            return vals + (hi - lo) * 4                  # f32 scales
        return sum(n for _, n in slice_byte_runs(
            shape, np.dtype(rec["dtype"]).itemsize, index))

    def open_unit(self, model_name: str, unit: str):
        """Open a unit extent for a sequence of :meth:`read_leaf_slice`
        calls (one simulated-device ``on_open`` for a whole shard
        stream)."""
        self.device.on_open()
        return open(self._unit_path(model_name, unit), "rb")

    def read_leaf_slice(self, model_name: str, unit: str, leaf: str,
                        index: Optional[Tuple[Any, ...]], *,
                        fh=None, chunk_bytes: int = 4 << 20,
                        gate: Optional[threading.Event] = None,
                        on_chunk: Optional[Callable[[int], None]] = None,
                        channel: int = 0,
                        out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Byte-range read of one leaf's shard, ``leaf[index]`` only —
        the unit of retrieval under shard-granular cold starts.

        index None reads the whole payload (crc-checked) and returns it
        as :meth:`deserialize` returns a leaf.  Otherwise only the runs
        covering the slice are read (through a mapping of the extent, one
        gather, no crc: a shard never sees the whole payload); an int8
        leaf gives the int8 values of ``leaf[index]`` at the leaf's
        logical shape plus the f32 scales of the slice's columns, the
        per-shard inputs of ``weight_transform``.  Returns ``(tensor,
        scale_or_None)`` on the host.

        Every read is charged to the simulated device in chunks on
        ``channel`` (the stream's own link), waiting on ``gate`` between
        chunks and reporting each chunk to ``on_chunk``.

        ``fh``: an open unit file (:meth:`open_unit`), one ``on_open`` a
        stream instead of one a leaf.  ``out``: a host tensor of the
        slice's shape (a view into the caller's full leaf) the gather
        writes straight into; without it the slice is gathered into a
        contiguous host tensor (pinned when CUDA is present).
        """
        rec = self._leaf_rec(model_name, unit, leaf)
        analysis.note_io("read_leaf_slice")   # lock-held-across-I/O probe
        close = False
        if fh is None:
            self.device.on_open()
            fh = open(self._unit_path(model_name, unit), "rb")
            close = True
        try:
            if index is None:
                return self._read_whole(model_name, unit, rec, fh,
                                        chunk_bytes, gate, on_chunk,
                                        channel)
            shape = tuple(rec["shape"])
            quant = rec.get("quant") == "int8"
            dt = np.dtype(np.int8) if quant else np.dtype(rec["dtype"])
            sn = rec.get("scale_nbytes", 0) if quant else 0
            mm = np.memmap(fh, dtype=np.uint8, mode="r")
            end = rec["offset"] + rec["nbytes"]
            arr = mm[rec["offset"]:end - sn].view(dt).reshape(shape)[
                tuple(index)]
            scale = None
            if quant:             # f32 scales of the slice's columns
                lo = 0 if index[-1].start is None else int(index[-1].start)
                hi = shape[-1] if index[-1].stop is None \
                    else int(index[-1].stop)
                scale = torch.from_numpy(np.array(
                    mm[end - sn:end].view(np.float32)[lo:hi]))
            got = out if out is not None else torch.empty(
                arr.shape, dtype=_DTYPES[dt.name], pin_memory=self.pin_memory)
            np.copyto(got.numpy(), arr)
            del arr, mm
            total = got.numel() * got.element_size() + \
                (scale.numel() * 4 if scale is not None else 0)
            self.device.charge(total, channel=channel,
                               chunk_bytes=chunk_bytes, gate=gate,
                               on_chunk=on_chunk)
            return got, scale
        finally:
            if close:
                fh.close()

    def _read_whole(self, model_name: str, unit: str, rec: dict, fh,
                    chunk_bytes: int, gate: Optional[threading.Event],
                    on_chunk: Optional[Callable[[int], None]],
                    channel: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One leaf's whole payload, read in suspendable chunks into a
        host tensor (pinned when CUDA is present) and crc-checked."""
        total = rec["nbytes"]
        buf = torch.empty(total, dtype=torch.uint8,
                          pin_memory=self.pin_memory)
        view = memoryview(buf.numpy())
        fh.seek(rec["offset"])
        done = 0
        while done < total:
            if gate is not None:
                gate.wait()
            n = fh.readinto(view[done:done + min(chunk_bytes,
                                                 total - done)])
            if not n:
                raise IOError(f"short read of {model_name}/{unit}/"
                              f"{rec['path']}")
            self.device.on_chunk(n, channel)
            done += n
            if on_chunk is not None:
                on_chunk(n)
        if zlib.crc32(view) & 0xFFFFFFFF != rec["crc32"]:
            raise IOError(f"crc mismatch for {model_name}/{unit}/"
                          f"{rec['path']}")
        return self._decode_leaf(rec, buf)

    @staticmethod
    def _decode_leaf(rec: dict, payload: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Views of one leaf's payload bytes: (values, scale_or_None).
        int8 leaves come back as (rows, last) int8 with f32 scales."""
        shape = tuple(rec["shape"])
        if rec.get("quant") == "int8":
            sn = rec["scale_nbytes"]
            q = payload[:-sn].view(torch.int8)
            sbytes = payload[-sn:]
            if sbytes.storage_offset() % 4:      # scales follow n*m bytes
                sbytes = sbytes.clone()
            scale = sbytes.view(torch.float32)
            return q.reshape(-1, shape[-1]), scale
        return payload.view(_DTYPES[rec["dtype"]]).reshape(shape), None

    # ---------------------------------------------------------- deserialize
    def deserialize(self, model_name: str, unit: str, raw: torch.Tensor
                    ) -> Leaves:
        """A unit's bytes (as :meth:`read_unit` returns them) ->
        {leaf_path: (tensor, scale_or_None)}, views into ``raw`` (no
        copies).

        int8-quantized leaves come back as (int8 2-D tensor, f32 scales);
        the caller runs the weight-transform (dequant) compute phase.
        """
        man = self.manifest(model_name)["units"][unit]
        out: Leaves = {}
        for rec in man["extents"]:
            payload = raw[rec["offset"]:rec["offset"] + rec["nbytes"]]
            crc = zlib.crc32(memoryview(payload.numpy())) & 0xFFFFFFFF
            if crc != rec["crc32"]:
                raise IOError(
                    f"crc mismatch for {model_name}/{unit}/{rec['path']}")
            out[rec["path"]] = self._decode_leaf(rec, payload)
        return out

    def read_and_deserialize(self, model_name: str, unit: str, **kw
                             ) -> Leaves:
        return self.deserialize(model_name, unit,
                                self.read_unit(model_name, unit, **kw))

    # -------------------------------------------------------------- helpers
    def has_model(self, model_name: str) -> bool:
        return os.path.exists(os.path.join(self._dir(model_name),
                                           "manifest.json"))

    def model_nbytes(self, model_name: str) -> int:
        return sum(u["nbytes"]
                   for u in self.manifest(model_name)["units"].values())


def deploy_model(store: WeightStore, model, model_name: str,
                 seed: int = 0, *, quant: Optional[str] = None,
                 params_by_unit: Optional[
                     Union[Mapping[str, PyTree],
                           Iterable[Tuple[str, PyTree]]]] = None) -> dict:
    """Deploy a model (streaming view) with freshly initialized or
    provided per-unit parameters — the platform's "publish model
    artifact" step.  ``params_by_unit`` is what :meth:`WeightStore.deploy`
    takes.  Fresh parameters come from one CPU ``torch.Generator`` per
    unit, seeded from ``seed``, each unit drawn when the store reaches it
    (the host holds one unit at a time)."""
    from repro_torch.models.transformer import unit_seed
    if params_by_unit is None:
        params_by_unit = (
            (name, model.init_unit(name, torch.Generator().manual_seed(
                unit_seed(seed, i))))
            for i, name in enumerate(model.unit_names()))
    return store.deploy(model_name, params_by_unit, quant=quant)
