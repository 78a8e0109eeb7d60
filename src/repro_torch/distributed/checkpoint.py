"""Fault-tolerant checkpointing, reusing the weight-store extent format
(the port of ``repro.distributed.checkpoint``).

Properties a 1000-node deployment needs and this implements:

  * **atomic**: write to ``step_<n>.tmp/``, fsync, rename — a crash
    mid-save never corrupts the latest checkpoint; ``latest`` is a
    pointer file updated after the rename;
  * **integrity**: every leaf extent carries crc32 (store format);
  * **elastic**: leaves are stored as full (unsharded) arrays; restore
    places them on any device or the port's ``NamedSharding``s;
  * **retention**: keeps the last ``keep`` checkpoints, reaps older;
  * **resume determinism**: the data pipeline is a pure function of
    (seed, step), so (step, params, opt_state) is the *complete* state.

The units and their names (``params``, ``opt_m``, ``opt_v``,
``opt_step``) and the store's layout are the reference's, so a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.distributed.resilience import reshard
from repro_torch.store.store import WeightStore, unflatten_unit
from repro_torch.training.optim import AdamWState

PyTree = Any


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, params: PyTree,
             opt_state: Optional[AdamWState] = None) -> str:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        store = WeightStore(tmp)
        units = {"params": params}
        if opt_state is not None:
            units["opt_m"] = opt_state.m
            units["opt_v"] = opt_state.v
            units["opt_step"] = {"step": opt_state.step}
        store.deploy("ckpt", units)
        # fsync the manifest + extents, then atomic rename
        for root, _, files in os.walk(tmp):
            for fn in files:
                with open(os.path.join(root, fn), "rb") as f:
                    os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._write_latest(name)
        self._reap()
        return final

    def _write_latest(self, name: str):
        ptr = os.path.join(self.dir, "latest.tmp")
        with open(ptr, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr, os.path.join(self.dir, "latest"))

    def _reap(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "latest")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, abstract_params: PyTree,
                abstract_opt: Optional[AdamWState] = None, *,
                step: Optional[int] = None,
                shardings: Optional[PyTree] = None,
                device=None) -> Tuple[int, PyTree, Optional[AdamWState]]:
        """Load (params, opt) from the checkpoint at ``step`` (default: the
        latest).  ``abstract_*`` give the trees' structure and shapes (meta
        tensors do).  The leaves land on ``device`` (default: the CPU), or
        where ``shardings`` (a tree of the port's ``NamedSharding``s or
        devices matching ``abstract_params``) places them: the *elastic*
        path, bytes written on any mesh load onto this one."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        store = WeightStore(path)
        dev = torch.device("cpu") if device is None else torch.device(device)

        def load_unit(unit: str, abstract: PyTree,
                      shards: Optional[PyTree]) -> PyTree:
            leaves = store.read_and_deserialize("ckpt", unit)
            tree = unflatten_unit(abstract, {k: v.to(dev, copy=True)
                                             for k, (v, _) in leaves.items()})
            if shards is not None:
                tree = reshard(tree, shards)
            return tree

        params = load_unit("params", abstract_params, shardings)
        opt = None
        if abstract_opt is not None:
            m = load_unit("opt_m", abstract_opt.m, shardings)
            v = load_unit("opt_v", abstract_opt.v, shardings)
            st = store.read_and_deserialize("ckpt", "opt_step")
            where = tree_util.leaves(params)[0].device if shardings is not \
                None else dev
            opt = AdamWState(st["step"][0].to(where, copy=True), m, v)
        return step, params, opt
