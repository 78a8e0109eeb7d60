"""Dry run of every (architecture x shape) cell: the twin of
``repro.launch.dryrun``.

For every cell, on the single-pod 16x16 mesh and the 2x16x16 multi-pod
mesh (logical meshes: ``launch/mesh.py``'s ``make_production_mesh``), it
builds the cell's step as the reference's ``build_cell`` does (bf16 serve
params, the big models' FSDP serving rule, gradient accumulation by
``train_micro_batches``, the encoder and chunked-prefill branches) and
runs it once on meta tensors inside ``cost_analysis.counting``:

  1. **memory** a device: params, optimizer state, cache and batch, exact
     from the shard shapes of the specs; the traced activation peak over
     the data-parallel degree, an estimate; whether the sum fits an
     H100's 80 GB;
  2. **cost** (single-pod): the traced global FLOPs and bytes (aten ops
     plus each registry kernel's own ``cost``) and kernel calls, with
     their ideal split over the mesh's devices, and the collective bytes
     a device from the specs (``cost_analysis.collective_bytes``).

A PyTorch step is a Python loop over every layer, so one pass traces it
at full depth, and the proof compile has no twin (nothing compiles).
The reference's cost compiles at one and two pattern units
(``_reduced_cfg``, ``combine_linear``) stay for one family: an MoE
train or prefill step routes hundreds of thousands of rows, and its
router's row chunks make a full-depth step millions of ops, which take
minutes to trace; every unit adds the same ops, so the combined counts
are the full step's (the peak is an estimate).  Outputs one JSON record
per cell for :mod:`repro_torch.launch.roofline`.  ``--smoke`` runs the
reduced configs on the CPU instead, on real tensors from a seed, the
kernels' plain versions in place of their meta branches.

Usage:
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out f.json]
      [--workers 8]
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ASSIGNED, SHAPES, ShapeCell, supported
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost_analysis, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.api import ArchConfig, Family, get_config
from repro_torch.training.optim import AdamW, AdamWState
from repro_torch.training.train import make_train_step

PyTree = Any


def train_micro_batches(cell: ShapeCell, mesh, micro_rows: int = 2) -> int:
    """Gradient-accumulation factor: ``micro_rows`` sequences a device a
    microbatch (default 2, the reference's pod-scale choice)."""
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    m = max(1, cell.batch // (dp * micro_rows))
    while cell.batch % m:
        m -= 1
    return m


@dataclasses.dataclass
class Cell:
    """One cell's step and state on a device.  ``step()`` runs it once
    (a train step updates ``params`` and ``opt_state`` in place; a prefill
    or decode step writes ``cache``)."""
    kind: str
    model: Any
    mesh: shd.Mesh
    rules: shd.ShardingRules
    step: Callable[[], Any]
    params: PyTree
    batch: Dict[str, torch.Tensor]
    param_specs: PyTree
    batch_specs: PyTree
    opt_state: Optional[AdamWState] = None
    opt_specs: Optional[AdamWState] = None
    cache: PyTree = None
    cache_specs: PyTree = None
    micro_batches: int = 1
    compute_dtype: Optional[torch.dtype] = None   # gathered / differentiated

    def state_bytes(self) -> Dict[str, int]:
        """Bytes of each state tree (its storages') on its device."""
        return {f"{k}_bytes": cost_analysis.tree_bytes(t) for k, t in
                (("params", self.params), ("opt", self.opt_state),
                 ("cache", self.cache), ("batch", self.batch))}


def _cast(tree: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_util.tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def make_batch(model, kind: str, seq: int, batch: int, device: torch.device,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """``model.input_specs`` on meta, or values from ``seed`` on another
    device: tokens and labels in the vocabulary, frames and image rows
    N(0, 1), and for a decode step each row at the end of its cache (pos
    ``seq - 1``)."""
    specs = model.input_specs(kind, seq, batch)
    if device.type == "meta":
        return specs
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, sd in specs.items():
        if name == "pos":
            t = torch.full(sd.shape, seq - 1, dtype=sd.dtype)
        elif sd.is_floating_point():
            t = torch.randn(sd.shape, generator=gen).to(sd.dtype)
        else:
            t = torch.randint(0, model.cfg.vocab_size, sd.shape,
                              generator=gen, dtype=sd.dtype)
        out[name] = t.to(device)
    return out


def _rules(cfg: ArchConfig, kind: str, multi_pod: bool) -> shd.ShardingRules:
    if kind == "train":
        return shd.train_rules(multi_pod=multi_pod)
    rules = shd.serve_rules(multi_pod=multi_pod)
    # big models cannot serve with TP-16 alone: bf16 params shard the full
    # mesh (per-layer weight gathers are the price)
    if cfg.param_count() * 2 / 16 > 8e9:
        rules.mapping["fsdp"] = ("pod", "data") if multi_pod else ("data",)
    return rules


def build_cell(cfg: ArchConfig, cell: ShapeCell, mesh, *,
               device="meta", seed: int = 0,
               serve_dtype: torch.dtype = torch.bfloat16,
               mixed_precision: bool = False, micro_rows: int = 2,
               chunked_prefill: int = 0) -> Cell:
    """The cell's step and state on ``device``: on meta the abstract
    trees (``LM.abstract``, ``AdamW.init`` of them, ``LM.input_specs``,
    ``LM.abstract_cache``), elsewhere params made from ``seed`` on the
    device and :func:`make_batch`'s inputs.

    Perf-iteration levers, as the reference's: ``mixed_precision`` (a
    bf16 param copy inside the train step), ``micro_rows`` and
    ``chunked_prefill`` (prompts in N-token segments, full-attention
    decoder LMs)."""
    model = transformer.build(cfg, device)
    dev = model.device
    meta = dev.type == "meta"
    rules = _rules(cfg, cell.kind, "pod" in mesh.shape)
    params = model.abstract() if meta else model.init(seed)
    batch = make_batch(model, cell.kind, cell.seq, cell.batch, dev, seed)
    b_sh = shd.batch_specs(batch, mesh, rules)

    def in_rules(fn):
        def step():
            with shd.use_rules(mesh, rules):
                return fn()
        return step

    if cell.kind == "train":
        micro = train_micro_batches(cell, mesh, micro_rows)
        opt = AdamW(lr=1e-4)
        opt_state = opt.init(params)
        p_sh = shd.param_specs(params, mesh, rules)
        o_sh = AdamWState(shd.replicated(mesh),
                          shd.param_specs(opt_state.m, mesh, rules),
                          shd.param_specs(opt_state.v, mesh, rules))
        fn = make_train_step(model, opt, remat=True, micro_batches=micro,
                             mixed_precision=mixed_precision, donate=True)
        return Cell("train", model, mesh, rules,
                    in_rules(lambda: fn(params, opt_state, batch)), params,
                    batch, p_sh, b_sh, opt_state, o_sh, micro_batches=micro,
                    compute_dtype=torch.bfloat16 if mixed_precision
                    else None)

    params = _cast(params, serve_dtype)
    p_sh = shd.param_specs(params, mesh, rules)
    common = dict(params=params, batch=batch, param_specs=p_sh,
                  batch_specs=b_sh)
    if cell.kind == "prefill" and cfg.is_encoder:
        return Cell("prefill", model, mesh, rules, in_rules(
            lambda: model.forward(params, batch)[0]), **common)
    cache = (model.abstract_cache if meta else model.init_cache)(
        cell.batch, cell.seq)
    c_sh = shd.cache_specs(cache, mesh, rules)
    if cell.kind == "prefill":
        chunkable = (chunked_prefill > 0 and cfg.sliding_window == 0
                     and cfg.family not in (Family.SSM, Family.HYBRID))
        if chunkable:
            def fn():
                return model.prefill_chunked(params, batch, cache,
                                             chunk=chunked_prefill)
        else:
            def fn():
                return model.prefill(params, batch, cache)
    else:
        def fn():
            return model.decode_step(params, cache, batch["tokens"],
                                     batch["pos"])
    return Cell(cell.kind, model, mesh, rules, in_rules(fn), cache=cache,
                cache_specs=c_sh, **common)


def _unit(cfg: ArchConfig) -> int:
    return len(cfg.block_pattern or ("rglru", "rglru", "attn")) \
        if cfg.family == Family.HYBRID else 1


def _n_units(cfg: ArchConfig) -> int:
    return cfg.n_layers // _unit(cfg)


def _reduced_cfg(cfg: ArchConfig, n_units: int) -> ArchConfig:
    u = _unit(cfg)
    return dataclasses.replace(cfg, n_layers=n_units * u + cfg.n_layers % u)


def by_units(cfg: ArchConfig, kind: str) -> bool:
    """Whether a cell's counts come from one and two units, combined (an
    MoE train or prefill step: see the module's note)."""
    return cfg.family == Family.MOE and kind != "decode"


def trace(cfg: ArchConfig, cell: ShapeCell, mesh, *, device="meta",
          built: Optional[Cell] = None, **opts) -> Dict[str, Any]:
    """The counts of the cell's step (``cost_analysis.count_step``), at
    full depth (of ``built``, the cell already built, where given) or,
    where :func:`by_units`, combined from one and two units."""
    if not by_units(cfg, cell.kind):
        c = built or build_cell(cfg, cell, mesh, device=device, **opts)
        return cost_analysis.count_step(c.step)
    c1, c2 = (cost_analysis.count_step(build_cell(
        _reduced_cfg(cfg, n), cell, mesh, device=device, **opts).step)
        for n in (1, 2))
    return cost_analysis.combine_linear(c1, c2, _n_units(cfg))


def data_parallel(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def memory_record(c: Cell, counts: Dict[str, Any]) -> Dict[str, Any]:
    """Bytes a device: the state trees exact from their shard shapes, the
    traced activation peak over the data-parallel degree (an estimate)."""
    sb = cost_analysis.shard_bytes
    rec = {"params_bytes_per_device": sb(c.params, c.param_specs),
           "opt_bytes_per_device": (sb(c.opt_state, c.opt_specs)
                                    if c.opt_state is not None else 0),
           "cache_bytes_per_device": (sb(c.cache, c.cache_specs)
                                      if c.cache is not None else 0),
           "batch_bytes_per_device": sb(c.batch, c.batch_specs),
           "activation_peak_bytes_global": counts["peak_live_bytes"],
           "activation_peak_bytes_per_device_estimate":
               counts["peak_live_bytes"] // data_parallel(c.mesh)}
    rec["live_bytes_per_device"] = sum(
        v for k, v in rec.items() if k.endswith("per_device")
        or k.endswith("estimate"))
    rec["fits_hbm_80g"] = bool(rec["live_bytes_per_device"]
                               <= roofline.HBM_BYTES)
    return rec


def cost_record(c: Cell, counts: Dict[str, Any]) -> Dict[str, Any]:
    """The traced global count, its ideal split over the mesh's devices,
    and the collective bytes a device from the specs."""
    n = c.mesh.size
    return {"flops": counts["flops"] / n, "bytes": counts["bytes"] / n,
            "split": "ideal: the traced global count over the mesh's "
                     "devices",
            "global": {"flops": counts["flops"], "bytes": counts["bytes"]},
            "kernels": counts["kernels"],
            "collectives": cost_analysis.collective_bytes(
                c.params, c.param_specs, c.mesh, c.rules, kind=c.kind,
                micro_batches=c.micro_batches, dtype=c.compute_dtype)}


def cell_shape(shape: str, smoke: bool) -> ShapeCell:
    cell = SHAPES[shape]
    if smoke:
        cell = dataclasses.replace(cell, seq=min(cell.seq, 128),
                                   batch=min(cell.batch, 32))
    return cell


def dryrun_cell(arch: str, shape: str, *, multi_pod: bool = False,
                costs: bool = True, smoke: bool = False,
                opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell's record, traced on meta (``smoke``: on the CPU)."""
    opts = opts or {}
    device = "cpu" if smoke else "meta"
    cfg = get_config(arch, smoke=smoke)
    cell = cell_shape(shape, smoke)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "device": str(device), "seq": cell.seq,
                           "batch": cell.batch, "smoke": smoke}
    if opts:
        rec["opts"] = dict(opts)
    ok, reason = supported(cfg, cell)
    if not ok:
        rec["status"] = "skip"
        rec["skip_reason"] = reason
        return rec
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec["devices"] = int(mesh.size)
        c = build_cell(cfg, cell, mesh, device=device, **opts)
        t0 = time.monotonic()
        counts = trace(cfg, cell, mesh, device=device, built=c, **opts)
        rec["trace_s"] = round(time.monotonic() - t0, 2)
        rec["depth"] = ("1 and 2 units, combined"
                        if by_units(cfg, cell.kind) else "full")
        rec["memory"] = memory_record(c, counts)
        if costs:
            rec["cost_per_device"] = cost_record(c, counts)
            if cell.kind == "train":
                rec["micro_batches"] = c.micro_batches
            rec["n_units"] = _n_units(cfg)
        rec["status"] = "ok"
    except Exception as e:  # a failure here is a bug in the port
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def iter_cells():
    for arch in ASSIGNED:
        for shape in SHAPES:
            yield arch, shape


def _cell_record(job) -> Dict[str, Any]:
    arch, shape, kw = job
    return dryrun_cell(arch, shape, **kw)


def records(jobs, workers: int = 1):
    """``dryrun_cell(arch, shape, **kw)`` of each ``(arch, shape, kw)`` in
    order; ``workers`` > 1 spreads them over that many spawned processes
    (the meta traces are Python-bound)."""
    if workers <= 1:
        yield from map(_cell_record, jobs)
        return
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        yield from pool.imap(_cell_record, jobs)


def summary(rec: Dict[str, Any]) -> str:
    """One line a record."""
    status = rec["status"]
    if status == "ok":
        live = rec["memory"]["live_bytes_per_device"] / 2 ** 30
        extra = f"live/dev={live:.2f}GiB trace={rec['trace_s']}s"
        if "cost_per_device" in rec:
            c = rec["cost_per_device"]
            extra += (f" flops/dev={c['flops']:.3e}"
                      f" coll/dev={c['collectives']['total']:.3e}B")
    elif status == "skip":
        extra = rec["skip_reason"]
    else:
        extra = rec["error"]
    return (f"[{rec['mesh']:7s}] {rec['arch']:18s} {rec['shape']:12s} "
            f"{status:5s} {extra}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-costs", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs on the CPU (machinery self-test)")
    ap.add_argument("--mixed-precision", action="store_true",
                    help="perf lever: bf16 param copy in the train step")
    ap.add_argument("--micro-rows", type=int, default=2,
                    help="perf lever: sequences/device/microbatch")
    ap.add_argument("--chunked-prefill", type=int, default=0,
                    help="perf lever: prefill segment length (0 = off)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=1,
                    help="processes tracing cells at once")
    args = ap.parse_args(argv)

    opts = {}
    if args.mixed_precision:
        opts["mixed_precision"] = True
    if args.micro_rows != 2:
        opts["micro_rows"] = args.micro_rows
    if args.chunked_prefill:
        opts["chunked_prefill"] = args.chunked_prefill
    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    # roofline costs are a single-pod deliverable
    jobs = [(arch, shape, dict(multi_pod=mp, smoke=args.smoke, opts=opts,
                               costs=(not args.no_costs) and not mp))
            for arch, shape in cells for mp in meshes]
    out = []
    for rec in records(jobs, args.workers):
        out.append(rec)
        print(summary(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {len(out)} records to {args.out}")
    n_fail = sum(r["status"] == "fail" for r in out)
    if n_fail:
        raise SystemExit(f"{n_fail} cells FAILED")


if __name__ == "__main__":
    main()
