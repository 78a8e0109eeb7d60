"""A warm function under open-loop arrivals, through the port's router
and pool.

Set-up draws the model's weights on the card and makes the instance
live with them as its cold start would leave them: ``float`` weights
quantized per column to int8 and applied in the compute dtype (the
benchmark's copy of the store's formula, then the cast); ``int8``
weights as the int8-resident params a ``compute_quant`` cold start
leaves (each 2-D or wider leaf a ``QuantLeaf`` of its int8 values and
column scales, 1-D leaves f32).  No store is written: the cold path is
another cell's.  The pool never evicts, and warm-up requests through the
router build the instance's scheduler and run the mix's shortest and
longest prompts.

One thread submits each request of the mix at its due time, whatever
the backlog, and each is timed from its due time; the router's
``entry.workers`` workers each hold a request from admission to its last
token, up to the scheduler's ``entry.gen_slots`` slots.  With
``load.preroll_s`` the arrivals start that long before the window, in
set-up, so that the window opens on the load's steady state; requests
due then are served and checked but are not the window's."""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict

import torch

from portbench import weights as W
from portbench.drivers import common
from portbench.reference.quant import int8_roundtrip
from portbench.traffic import open_loop

DRAIN_S = 60.0


def _request(i, spec, name):
    from repro_torch.serving.api import GenerateSpec, Request
    return Request(req_id=i, model=name,
                   gen=GenerateSpec(prompt=torch.as_tensor(spec["prompt"]),
                                    n_new=spec["n_new"],
                                    temperature=spec["temperature"],
                                    seed=i))


def live_params(ctx: common.Ctx, model):
    """The params an instance holds once its cold start has run."""
    units = {}
    if ctx.cfg["serving"]["weights"] == "int8":
        from repro_torch.quant import QuantLeaf
        for i, u in enumerate(W.unit_names(ctx.cfg)):
            flat = W.int8_unit(ctx.cfg, u, i, ctx.seed, ctx.device)
            units[u] = W.nest({p: (QuantLeaf(*v) if isinstance(v, tuple)
                                   else v) for p, v in flat.items()})
        return model.assemble(units, consume=True)
    cd = common.dtype(ctx.wl["entry"]["apply_dtype"])
    for i, u in enumerate(W.unit_names(ctx.cfg)):
        flat = W.float_unit(ctx.cfg, u, i, ctx.seed, ctx.device)
        units[u] = W.nest({p: (int8_roundtrip(t) if t.dim() >= 2 else t)
                           .to(cd) for p, t in flat.items()})
        del flat
    return model.assemble(units, consume=True)


def setup(ctx: common.Ctx) -> Dict[str, Any]:
    from repro_torch import metrics as metrics_mod
    from repro_torch.models import transformer
    from repro_torch.serving.policy import NeverEvict
    from repro_torch.serving.pool import FunctionInstance, InstancePool
    from repro_torch.serving.router import Router
    from repro_torch.store.store import WeightStore

    e, cfg, name = ctx.wl["entry"], ctx.cfg, ctx.cfg["name"]
    model = transformer.build(common.arch(cfg), ctx.device)
    store = WeightStore(os.path.join(ctx.tmp, "store"))   # never read
    registry = metrics_mod.MetricsRegistry()
    with ctx.spans.span("weights"):
        params = live_params(ctx, model)
    inst = FunctionInstance(model, name, store, warm=False,
                            gen_slots=e["gen_slots"],
                            gen_cache_len=common.cache_len(ctx.mix),
                            metrics=registry, device=ctx.device)
    inst.params = params
    pool = InstancePool(name, None, store, policy=NeverEvict(),
                        max_instances=1, instance_factory=lambda: inst,
                        metrics=registry, device=ctx.device)
    router = Router({name: pool}, workers=e["workers"], metrics=registry)
    preroll = float(ctx.wl["load"].get("preroll_s", 0.0))
    reqs = open_loop.generate(ctx.mix, ctx.wl["load"], ctx.seed,
                              cfg["vocab_size"], preroll + ctx.seconds)
    st = {"router": router, "inst": inst, "name": name, "reqs": reqs,
          "drained": True, "recs": [], "futs": [], "late": 0.0,
          "lock": threading.Lock(), "done": threading.Semaphore(0)}
    warm = [min(reqs, key=lambda r: r["n_prompt"]),
            max(reqs, key=lambda r: r["n_prompt"])]
    with ctx.spans.span("warmup"):
        futs = [router.submit(_request(-1 - k, s, name))
                for k, s in enumerate(warm)]
        for f in futs:
            f.result()
    # the arrivals start now; the window opens ``preroll`` later
    st["t0"] = time.monotonic() + preroll
    st["sender"] = threading.Thread(target=_send, args=(st, st["t0"]
                                                        - preroll))
    with ctx.spans.span("preroll"):
        st["sender"].start()
        time.sleep(max(0.0, st["t0"] - time.monotonic()))
    return st


def _send(st: Dict[str, Any], base: float):
    router, name, lock, done = (st["router"], st["name"], st["lock"],
                                st["done"])

    def finish(rec, fut):
        try:
            resp = fut.result()
            with lock:
                common.from_response(rec, resp)
        except Exception as ex:                 # reported as failed
            rec["error"] = repr(ex)
        done.release()

    for i, spec in enumerate(st["reqs"]):
        due = base + spec["due_s"]
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        t_sub = time.monotonic()
        st["late"] = max(st["late"], t_sub - due)
        rec = common.record(i, spec, t_sub, t_due=due)
        st["recs"].append(rec)
        fut = router.submit(_request(i, spec, name))
        fut.add_done_callback(lambda f, r=rec: finish(r, f))
        st["futs"].append(fut)


def window(ctx: common.Ctx, st: Dict[str, Any]) -> Dict[str, Any]:
    inst = st["inst"]
    steps0 = inst.scheduler.stats()["steps"]
    ctx.trace.start()
    t0 = st["t0"]
    t_end = t0 + ctx.seconds
    wait = t_end - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    steps1 = inst.scheduler.stats()["steps"]
    ctx.trace.stop()
    st["sender"].join()
    deadline = t_end + DRAIN_S
    for _ in st["futs"]:
        if not st["done"].acquire(timeout=max(0.0, deadline
                                              - time.monotonic())):
            st["drained"] = False
            break
    recs = st["recs"]
    for r in recs:
        if r["tokens"] is None and r["error"] is None:
            r["error"] = "no answer within a minute of the window's close"
    return {"t0": t0, "t1": t_end, "requests": recs,
            "steps": steps1 - steps0, "checks": {},
            "notes": backlog_notes(recs, t0, t_end, st["late"])}


def backlog_notes(recs, t0: float, t1: float, late: float
                  ) -> Dict[str, Any]:
    """What says whether the backlog grew over the window: how late the
    sender ran, the requests due in it that had no first token by its
    close, and the median TTFT of its first and second halves."""
    from portbench import stats
    mid = (t0 + t1) / 2
    due = [r for r in recs if r["t_first"] is not None
           and t0 <= r["t_due"] < t1]
    halves = [[r["t_first"] - r["t_due"] for r in due
               if (r["t_due"] < mid) == first] for first in (True, False)]
    med = [stats.quantile(h, 0.5) for h in halves]
    return {"late_s": late,
            "waiting_at_close": sum(1 for r in recs
                                    if t0 <= r["t_due"] < t1
                                    and (r["t_first"] is None
                                         or r["t_first"] >= t1)),
            "ttft_p50_ms_halves": [None if m is None else 1e3 * m
                                   for m in med]}


def close(st: Dict[str, Any]):
    st["router"].shutdown(wait=st["drained"])
    st["inst"].evict()
    st.clear()
