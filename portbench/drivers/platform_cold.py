"""Scale from zero: every request meets a function with no live
instance, through the port's router and pool.

Set-up draws the model's ``float`` weights on the card, deploys them as
an int8 store behind the benchmark's simulated device
(:mod:`portbench.storage`), and builds one pool whose keep-alive and
node cache are off, so each request's cold start reads the whole store
through the decoupler, constructs (L), applies (A, ``weight_transform``
to ``entry.apply_dtype``) and answers the prompt in the pipeline (E)
before the instance decodes the rest through its scheduler.  Each
request advances the pool's logical clock by a second, so the
keep-alive of 0 evicts the last instance before the next request.

The clients of the mix run in a closed loop through ``Router.submit``.
The run fails (``checks``) if any request of the window was served warm
or any cold start read fewer bytes through the simulated device than the
store holds."""
from __future__ import annotations

import os
import time
from typing import Any, Dict

import torch

from portbench import weights as W
from portbench.drivers import common
from portbench.storage import StoreDevice
from portbench.traffic import closed_loop


def _request(i, spec, name, logical):
    from repro_torch.serving.api import GenerateSpec, Request
    return Request(req_id=i, model=name, t_logical=logical,
                   gen=GenerateSpec(prompt=torch.as_tensor(spec["prompt"]),
                                    n_new=spec["n_new"],
                                    temperature=spec["temperature"],
                                    seed=i))


def setup(ctx: common.Ctx) -> Dict[str, Any]:
    from repro_torch import metrics as metrics_mod
    from repro_torch.core.coldstart import ColdStartEngine
    from repro_torch.models import transformer
    from repro_torch.serving.policy import KeepAliveTTL
    from repro_torch.serving.pool import FunctionInstance, InstancePool
    from repro_torch.serving.router import Router
    from repro_torch.store.store import WeightStore

    e, cfg, name = ctx.wl["entry"], ctx.cfg, ctx.cfg["name"]
    model = transformer.build(common.arch(cfg), ctx.device)
    device = StoreDevice(e["store_mbps"], e.get("store_latency_ms", 0.0),
                         e.get("store_channels", 1))
    store = WeightStore(os.path.join(ctx.tmp, "store"), device=device)
    units = W.unit_names(cfg)
    with ctx.spans.span("deploy"):
        store.deploy(name, ((u, W.nest(W.float_unit(cfg, u, i, ctx.seed,
                                                      ctx.device)))
                            for i, u in enumerate(units)), quant="int8")
    store_bytes = store.model_nbytes(name)
    streams = closed_loop.generate(ctx.mix, ctx.wl["load"], ctx.seed,
                                   cfg["vocab_size"])
    registry = metrics_mod.MetricsRegistry()
    clen = common.cache_len(ctx.mix)
    kw = dict(strategy=e["strategy"], io_workers=e["io_workers"],
              chunk_bytes=e["chunk_bytes"], device=ctx.device)
    longest = max((s for st in streams for s in st),
                  key=lambda s: s["n_prompt"])

    # The harness puts the instance together: the platform's constructors
    # take no apply dtype (its pools apply int8 stores in f32), and the
    # paper's path applies them in the compute dtype.  So one instance is
    # built here, its engine replaced by one that applies in
    # ``entry.apply_dtype`` and was warmed once as at deploy time (an
    # engine keeps no weights between loads, only each unit's static
    # plan), before the pool sees it.  The pool keeps its one instance
    # after each eviction, which drops the params and the scheduler, so
    # every request meets it cold and the window builds nothing but what
    # a cold start builds.
    engine = ColdStartEngine(model, name, store, metrics=registry,
                             apply_dtype=common.dtype(e["apply_dtype"]),
                             **kw)
    with ctx.spans.span("warmup"):
        engine.warmup({"tokens": torch.as_tensor(longest["prompt"][None])})
    inst = FunctionInstance(model, name, store, warm=False, gen_slots=1,
                            gen_cache_len=clen, metrics=registry, **kw)
    inst.engine = engine

    pool = InstancePool(name, None, store,
                        policy=KeepAliveTTL(float(e["keep_alive_s"])),
                        max_instances=1, instance_factory=lambda: inst,
                        metrics=registry, device=ctx.device)
    router = Router({name: pool}, workers=1, metrics=registry)
    st = {"router": router, "pool": pool, "store": store, "device": device,
          "store_bytes": store_bytes, "streams": streams, "logical": 0.0,
          "name": name, "registry": registry}
    with ctx.spans.span("warmup"):
        for k in range(int(e.get("warm_requests", 1))):
            st["logical"] += 1.0
            router.submit(_request(-1 - k, longest, name,
                                   st["logical"])).result()
    return st


def window(ctx: common.Ctx, st: Dict[str, Any]) -> Dict[str, Any]:
    router, device, name = st["router"], st["device"], st["name"]
    stream = st["streams"][0]
    recs = []
    ctx.trace.start()
    t0 = time.monotonic()
    t_end = t0 + ctx.seconds
    i = 0
    while time.monotonic() < t_end:
        spec = stream[i % len(stream)]
        st["logical"] += 1.0
        before = device.bytes_served
        t_sub = time.monotonic()
        rec = common.record(i, spec, t_sub)
        with ctx.spans.span("cold_request"):
            try:
                resp = router.submit(_request(i, spec, name,
                                              st["logical"])).result(
                                                  timeout=120.0)
                common.from_response(rec, resp)
            except Exception as ex:             # reported as failed
                rec["error"] = repr(ex)
        rec["store_bytes"] = device.bytes_served - before
        recs.append(rec)
        i += 1
    ctx.trace.stop()
    served = [r for r in recs if r["error"] is None]
    warm = sum(1 for r in served if not r["cold"])
    short = sum(1 for r in served if r["store_bytes"] < st["store_bytes"])
    return {"t0": t0, "t1": t_end, "requests": recs,
            "store": {"bytes": st["store_bytes"],
                      "mbps": device.bandwidth_mbps},
            "checks": {"warm_served": (warm, 0),
                       "short_store_reads": (short, 0)}}


def close(st: Dict[str, Any]):
    st["router"].shutdown()
    st["pool"].sweep(st["logical"] + 1.0)      # the keep-alive of 0 evicts
    st.clear()
