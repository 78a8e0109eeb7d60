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

A :class:`BandwidthModel` optionally simulates the storage device (the
page cache would otherwise hide the I/O phase the paper measures); the
bytes are still read.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    """Simulated storage: per-request latency + a *shared* bandwidth cap.

    Bandwidth is one token bucket: all streams split it, so the
    WeightDecoupler's parallel prefetch gets no free bandwidth over serial
    PISeL retrieval.  (The reference's per-shard channels come with the
    shard slice, ROADMAP queue 1 item 13.)
    """
    bandwidth_mbps: float = 0.0          # 0 -> unthrottled
    latency_ms: float = 0.0

    def __post_init__(self):
        self._lock = analysis.make_lock("BandwidthModel._lock")
        self._next_free = 0.0            # guarded-by: _lock

    def on_open(self):
        if self.latency_ms > 0:
            time.sleep(self.latency_ms / 1e3)

    def on_chunk(self, nbytes: int):
        if self.bandwidth_mbps <= 0:
            return
        dur = nbytes / (self.bandwidth_mbps * 1e6)
        with self._lock:
            start = max(time.monotonic(), self._next_free)
            self._next_free = start + dur
        delay = (start + dur) - time.monotonic()
        if delay > 0:
            time.sleep(delay)


# ---------------------------------------------------------------------------
# tree <-> flat leaves
# ---------------------------------------------------------------------------

def leaf_path_name(path) -> str:
    """Canonical flat name of a leaf (``"attn/wq"``) — the leaf identity
    of the store layout, shared with the reference."""
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            raise ValueError("deploying bfloat16 leaves is not supported; "
                             "deploy float32 and cast with apply_dtype")
        return leaf.numpy()
    return np.asarray(leaf)


def flatten_unit(tree: PyTree) -> List[Tuple[str, np.ndarray]]:
    """Stable (path, leaf) list for a unit's param tree (sorted keys, as
    the reference flattens it)."""
    return [(leaf_path_name(path), _to_numpy(leaf))
            for path, leaf in tree_util.leaves_with_path(tree)]


def unflatten_unit(abstract: PyTree, leaves: Dict[str, Any]) -> PyTree:
    """Rebuild the unit tree from named leaves (against its abstract)."""
    for path, ab in tree_util.leaves_with_path(abstract):
        name = leaf_path_name(path)
        if tuple(leaves[name].shape) != tuple(ab.shape):
            raise ValueError(f"{name}: shape {tuple(leaves[name].shape)} != "
                             f"{tuple(ab.shape)}")
    return tree_util.unflatten(abstract, leaves)


def quantize_int8(leaf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column int8 of a float leaf over its last axis, as the
    reference's store computes it in numpy: f32 scales amax / 127 (1 for
    an all-zero column), values rounded half to even and clipped to
    +-127.  In torch's threaded CPU ops, bit-equal to numpy's and several
    times faster on a multi-GB leaf."""
    w = torch.from_numpy(np.require(leaf, requirements="W"))
    w2 = w.reshape(-1, leaf.shape[-1]).float()
    amax = w2.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w2 / scale), -127, 127).to(torch.int8)
    return q.numpy(), scale.numpy()


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
    def deploy(self, model_name: str, units: Dict[str, PyTree], *,
               quant: Optional[str] = None) -> dict:
        """Write per-unit extents + manifest.  ``units``: unit -> tree of
        tensors or arrays.

        quant: None (store native dtype) | "int8" (2-D+ float leaves
        quantized per output channel, scales stored f32 alongside).
        """
        d = self._dir(model_name)
        os.makedirs(d, exist_ok=True)
        manifest = {"model": model_name, "version": 1,
                    "quant": quant or "none", "units": {}}
        for unit, tree in units.items():
            entries = []
            blob = bytearray()
            for name, leaf in flatten_unit(tree):
                rec: Dict[str, Any] = {"path": name,
                                       "shape": list(leaf.shape),
                                       "dtype": str(leaf.dtype)}
                if quant == "int8" and leaf.ndim >= 2 and \
                        np.issubdtype(leaf.dtype, np.floating):
                    q, scale = quantize_int8(leaf)
                    payload = q.tobytes() + scale.tobytes()
                    rec["quant"] = "int8"
                    rec["scale_nbytes"] = scale.nbytes
                else:
                    payload = np.ascontiguousarray(leaf).tobytes()
                    rec["quant"] = "none"
                pad = (-len(blob)) % ALIGN
                blob.extend(b"\0" * pad)
                rec["offset"] = len(blob)
                rec["nbytes"] = len(payload)
                rec["crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
                blob.extend(payload)
                entries.append(rec)
            with open(self._unit_path(model_name, unit), "wb") as f:
                f.write(bytes(blob))
            manifest["units"][unit] = {"extents": entries,
                                       "nbytes": len(blob)}
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._manifests[model_name] = manifest
        return manifest

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
                 params_by_unit: Optional[Dict[str, PyTree]] = None) -> dict:
    """Deploy a model (streaming view) with freshly initialized or
    provided per-unit parameters — the platform's "publish model
    artifact" step.  Fresh parameters come from one CPU
    ``torch.Generator`` per unit, seeded from ``seed``."""
    from repro_torch.models.transformer import unit_seed
    if params_by_unit is None:
        params_by_unit = {}
        for i, name in enumerate(model.unit_names()):
            gen = torch.Generator().manual_seed(unit_seed(seed, i))
            params_by_unit[name] = model.init_unit(name, gen)
    return store.deploy(model_name, params_by_unit, quant=quant)
