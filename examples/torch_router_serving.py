"""Concurrent serving through the port's Router / InstancePool API:
submit overlapping invocations of a cold model, watch the pool scale
out, keep-alive reclaim instances, and the router dispatch
inference-first — then the generation-first path: overlapping
GenerateSpec requests join one instance's continuous-batching decode
scheduler (a cold generation request's first token is sampled inside the
loading pipeline) — and last a two-node cluster scale-out: the second
node cold-starts the model by streaming every unit from its peer over
the intra-cluster link, touching the origin store zero times
(``repro_torch.cluster``).  Runs on the GPU; ``--device cpu`` runs the
kernels' plain PyTorch versions instead.  Every node of the cluster
shares the one device.

    PYTHONPATH=src python examples/torch_router_serving.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.cluster import ClusterPlatform              # noqa: E402
from repro_torch.device import resolve_device                # noqa: E402
from repro_torch.models import transformer                   # noqa: E402
from repro_torch.models.api import get_config                # noqa: E402
from repro_torch.serving import (GenerateSpec, InstancePool,  # noqa: E402
                                 KeepAliveTTL, Request, Router)
from repro_torch.store.store import (BandwidthModel,         # noqa: E402
                                     WeightStore, deploy_model)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the GPU by default (no GPU is an error), or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("smollm-360m", smoke=True)
    model = transformer.build(cfg, device=dev)
    store = WeightStore(tempfile.mkdtemp(),
                        BandwidthModel(bandwidth_mbps=400, latency_ms=0.2))
    deploy_model(store, model, "demo", seed=0)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)))}

    # one pool, up to two containers, 30 s keep-alive on the caller's clock
    pool = InstancePool("demo", lambda: (model, batch), store,
                        strategy="cicada", policy=KeepAliveTTL(30.0),
                        max_instances=2, device=dev)

    with Router({"demo": pool}, workers=4) as router:
        # four overlapping invocations of a cold function: the pool
        # scales to two instances (two pipelines), the rest are warm
        futs = [router.submit(Request(req_id=i, model="demo", batch=batch))
                for i in range(4)]
        for f in futs:
            r = f.result()
            print(f"req {r.req_id}: {'COLD' if r.cold else 'warm'}  "
                  f"class={r.cls.name}  latency={r.latency_s * 1e3:7.1f}ms  "
                  f"queue={r.queue_s * 1e3:6.1f}ms")
        print("router:", router.stats)

    st = pool.stats()
    print(f"pool: instances={st.size} live={st.live} "
          f"cold={st.cold_starts} warm={st.warm_hits}")

    # keep-alive: 31 s of idleness (logical clock) reclaims both
    n = pool.sweep(31.0)
    print(f"swept after 31 s idle: {n} evicted -> live={pool.stats().live}")

    # ---- generation-first path -------------------------------------------
    # Both instances were just evicted, so the first generation request
    # is cold: its first token is sampled inside the loading pipeline
    # (ttft < load time).  The following requests join the instance's
    # continuous decode batch instead of waiting for each other.
    rng = np.random.default_rng(1)
    gens = []
    with Router({"demo": pool}, workers=4) as router:
        futs = [router.submit(Request(
                    req_id=i, model="demo",
                    gen=GenerateSpec(
                        prompt=rng.integers(0, cfg.vocab_size,
                                            (16,)).astype(np.int32),
                        n_new=12)))
                for i in range(4)]
        for f in futs:
            r = f.result()
            gens.append(r)
            tpot = 1e3 * sum(r.tpot_s) / max(len(r.tpot_s), 1)
            print(f"gen {r.req_id}: {'COLD' if r.cold else 'warm'}  "
                  f"ttft={r.ttft_s * 1e3:7.1f}ms  tpot={tpot:5.1f}ms  "
                  f"tokens={[int(t) for t in r.tokens[:6]]}...")
    inst = next(i for i in pool._instances if i.scheduler is not None)
    print("decode scheduler:", inst.scheduler.stats())

    # ---- two-node cluster scale-out --------------------------------------
    # A slow shared origin (20 MB/s) and a fast intra-cluster link: node0
    # cold-starts from the origin and publishes every unit to the
    # placement table; node1's cold start of the same model streams all
    # of its units from node0's cache — zero origin reads.
    slow = WeightStore(store.root,
                       BandwidthModel(bandwidth_mbps=20, latency_ms=0.2))
    cluster = ClusterPlatform(slow, {"demo": (lambda: (model, batch))},
                              n_nodes=2, cluster_bw_mbps=2000,
                              keep_alive_s=1e9, device=dev)
    router = cluster.router(workers_per_node=2)
    try:
        r0 = router.submit_to("node0", Request(req_id=0, model="demo",
                                               batch=batch)).result()
        r1 = router.submit_to("node1", Request(req_id=1, model="demo",
                                               batch=batch)).result()
        # a routed (not pinned) warm request lands on a warm node
        r2 = router.submit(Request(req_id=2, model="demo",
                                   batch=batch)).result()
    finally:
        router.shutdown()
    n0, n1 = cluster.nodes
    print(f"cluster: node0 cold load={r0.load_s * 1e3:.1f}ms "
          f"(origin reads={n0.origin_reads():.0f})")
    print(f"         node1 cold load={r1.load_s * 1e3:.1f}ms "
          f"(origin reads={n1.origin_reads():.0f}, "
          f"peer reads={n1.peer_reads():.0f})  "
          f"<- served entirely by its peer")
    print(f"         warm request routed to {r2.node} "
          f"(locality-aware placement)")
    print("placement:", cluster.placement.snapshot())
    return {"pool": st, "gens": gens, "cluster": cluster,
            "responses": (r0, r1, r2)}


if __name__ == "__main__":
    main()
