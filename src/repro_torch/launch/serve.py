"""Serving launcher: trace-driven serverless inference with Cicada, on the
GPU (a port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --models smollm-360m --workload generate``

Deploys the requested models with random weights to a weight store (a
temporary one unless ``--store`` names a directory; a simulated storage
device makes the I/O phase visible), generates an Azure-like invocation
trace, replays it through the ServerlessPlatform once per ``--strategy``
and prints the trace summary and, per strategy, the cold/warm mix,
latency and pipeline utilization.

``--workload generate --n-new 16`` replays the same trace as
*generation* requests: each invocation decodes n-new tokens through the
instances' continuous-batching DecodeSchedulers, and the report adds
TTFT / TPOT / tokens-per-second.

``--device cpu`` runs everything on the CPU through the kernels' plain
versions (the default is the GPU, and no GPU is an error).  Smoke
configs are the default; ``--full`` serves the published widths.

``--autoscale`` attaches the SLO autoscaler
(:mod:`repro_torch.serving.autoscale`): it ticks in the background for
the replay, pre-provisions warm instances off the arrival-rate slope and
queue depth (``--rps-per-instance`` converts a rate into a count), and
the report prints each pool's prewarms.

``--nodes N`` serves the trace from an N-node cluster
(:mod:`repro_torch.cluster`, every node on the one device): a
locality-aware front-end router places each invocation on the node
already warm or cache-resident for the model, and scale-out cold starts
stream weights from peer nodes over the intra-cluster link
(``--cluster-bw-mbps``) instead of re-reading the shared origin store —
at most one origin read per unit, cluster-wide.  The report then prints
each node's served / cold / warm counts and origin and peer reads, and
the placement table; ``--metrics-out`` writes the cluster snapshot.

``--mesh N`` streams weights shard-granularly onto a ``(1, N)`` mesh of
logical devices (one byte-range retrieval stream per device, each on its
own simulated store channel: the store's device gets N channels) and
serves warm requests from the params the shards committed.  The port's
mesh is logical: its N devices lie on the one serving device, and the
launcher says so.  ``--compute-quant`` is refused with it, as in the
reference.  The port has no forced kernel mode: ``--pallas`` takes
``auto`` only, since a tensor's device alone picks its kernel.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch.cluster import ClusterPlatform
from repro_torch.core.miniloader import n_params
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.api import Family, get_config
from repro_torch.serving.api import GenerateSpec
from repro_torch.serving.engine import ServerlessPlatform
from repro_torch.serving.trace import azure_like_trace, summarize
from repro_torch.store.store import BandwidthModel, WeightStore, deploy_model

STRATEGIES = ["traditional", "pisel", "mini", "preload", "cicada"]


def example_batch(cfg, seq: int = 32):
    """A representative one-shot request, as the reference draws it: a
    (1, 3, img_res, img_res) f32 image for the vision family, (1, seq,
    frontend_dim) bf16 frames for the audio encoder, ``min(8, seq // 2)``
    bf16 image rows and the rest tokens for the VLM, a token batch for
    the other LMs.  The float64 draws convert as ``jnp.asarray`` converts
    them (through float32), so both packages get the same bits."""
    rng = np.random.default_rng(0)
    if cfg.family == Family.VISION:
        return {"image": torch.as_tensor(
            rng.standard_normal((1, 3, cfg.img_res, cfg.img_res)),
            dtype=torch.float32)}
    if cfg.family == Family.AUDIO:
        return {"frames": torch.as_tensor(
            rng.standard_normal((1, seq, cfg.frontend_dim)),
            dtype=torch.bfloat16)}
    if cfg.family == Family.VLM:
        n_img = min(8, seq // 2)
        return {"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (1, seq - n_img))),
                "img": torch.as_tensor(
                    rng.standard_normal((1, n_img, cfg.frontend_dim)),
                    dtype=torch.bfloat16)}
    return {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, seq)))}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["smollm-360m"])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--strategy", nargs="+", default=["cicada"],
                    choices=STRATEGIES,
                    help="one replay of the trace per strategy, each on a "
                         "fresh platform")
    ap.add_argument("--invocations", type=int, default=40)
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--keep-alive", type=float, default=30.0)
    ap.add_argument("--concurrency", type=int, default=1,
                    help="router workers / max in-flight invocations")
    ap.add_argument("--max-instances", type=int, default=1,
                    help="instance-pool scale-out limit per model")
    ap.add_argument("--workload", default="oneshot",
                    choices=["oneshot", "generate"],
                    help="oneshot: batch->logits forwards; generate: "
                         "multi-token decode through the continuous-"
                         "batching scheduler")
    ap.add_argument("--n-new", type=int, default=16,
                    help="tokens to generate per invocation "
                         "(--workload generate)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt length for generation invocations")
    ap.add_argument("--gen-slots", type=int, default=8,
                    help="decode-scheduler slots per instance "
                         "(max concurrent generations batching)")
    ap.add_argument("--gen-cache-len", type=int, default=256,
                    help="KV cache positions per slot")
    ap.add_argument("--kv-page-tokens", type=int, default=None,
                    metavar="PT",
                    help="enable block-paged decode KV: full-attention "
                         "K/V lives in a shared refcounted pool of "
                         "PT-token pages (page-budget admission + "
                         "prefix caching) instead of per-slot arena "
                         "rows (default: slotted)")
    ap.add_argument("--kv-budget-mb", type=float, default=None,
                    help="with --kv-page-tokens: device byte budget for "
                         "the page pool across all attention layers "
                         "(default: the slotted arena's worth, "
                         "gen-slots x gen-cache-len tokens)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 = sampled generation")
    ap.add_argument("--cache-budget-mb", type=float, default=None,
                    help="enable the node-local shared WeightCache with "
                         "this byte budget (0 = unbounded; default: no "
                         "cache)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="model-parallel mesh width: stream weights "
                         "shard-granularly onto (1, N) logical devices on "
                         "the serving device (1 = seed path)")
    ap.add_argument("--pallas", default="auto", choices=["auto"],
                    help="kernel dispatch: the port picks each kernel by "
                         "its tensors' device (auto only)")
    ap.add_argument("--compute-quant", action="store_true",
                    help="serve int8 weights in place: deploy models "
                         "quantized (int8 values + per-column scales), "
                         "keep them quantized-resident across cold "
                         "starts and run weight matmuls through the "
                         "quant_matmul kernel")
    ap.add_argument("--nodes", type=int, default=1,
                    help="serve from an N-node cluster (repro_torch."
                         "cluster): locality-aware routing + peer-to-peer "
                         "weight exchange (1 = single-node platform)")
    ap.add_argument("--cluster-bw-mbps", type=float, default=1000.0,
                    help="--nodes N: intra-cluster link bandwidth, one "
                         "channel per node (0 = unthrottled)")
    ap.add_argument("--bandwidth-mbps", type=float, default=400.0,
                    help="simulated store bandwidth per channel; with "
                         "--mesh N the store exposes N channels (one "
                         "independent link per device)")
    ap.add_argument("--store", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the last platform's metrics snapshot "
                         "(counter/gauge/histogram JSON) to this path")
    ap.add_argument("--autoscale", action="store_true",
                    help="attach the SLO autoscaler: pre-provision warm "
                         "instances on arrival-rate slope / queue "
                         "depth, scale-in on idle")
    ap.add_argument("--rps-per-instance", type=float, default=2.0,
                    help="--autoscale: arrival rate one warm instance "
                         "is budgeted to absorb")
    ap.add_argument("--device", default=None,
                    help="where to deploy and serve: the GPU by default "
                         "(no GPU is an error), or 'cpu'")
    return ap


def _report(args, strategy: str, platform, responses):
    lat = np.array([r.latency_s for r in responses])
    cold = np.array([r.cold for r in responses])
    print(f"strategy={strategy}  n={len(responses)}  "
          f"cold={int(cold.sum())} ({cold.mean():.0%})  "
          f"warm={int((~cold).sum())}  concurrency={args.concurrency}")
    print(f"latency: mean={lat.mean() * 1e3:.1f}ms "
          f"p50={np.percentile(lat, 50) * 1e3:.1f}ms "
          f"p99={np.percentile(lat, 99) * 1e3:.1f}ms")
    if cold.any():
        ut = np.array([r.utilization for r in responses])[cold]
        print(f"cold-start: mean={lat[cold].mean() * 1e3:.1f}ms "
              f"pipeline-util={ut.mean():.1%}")
    if args.workload == "generate":
        ttft = np.array([r.ttft_s for r in responses])
        tpot = np.concatenate([r.tpot_s for r in responses if r.tpot_s]) \
            if any(r.tpot_s for r in responses) else np.array([0.0])
        n_tok = sum(r.n_generated for r in responses)
        span = max(r.t_done for r in responses) - \
            min(r.t_arrival for r in responses)
        print(f"generation: n_new={args.n_new}  total-tokens={n_tok}  "
              f"tokens/s={n_tok / max(span, 1e-9):.1f}")
        print(f"TTFT: p50={np.percentile(ttft, 50) * 1e3:.1f}ms "
              f"p99={np.percentile(ttft, 99) * 1e3:.1f}ms   "
              f"TPOT: mean={tpot.mean() * 1e3:.2f}ms")
        if cold.any():
            ct = ttft[cold]
            cl = np.array([r.load_s for r in responses])[cold]
            print(f"cold TTFT: mean={ct.mean() * 1e3:.1f}ms "
                  f"(load {cl.mean() * 1e3:.1f}ms — first token "
                  f"in-pipeline: {bool((ct < cl).all())})")
    if args.nodes > 1:
        _report_cluster(platform, responses)
        return
    if args.concurrency > 1:
        q = np.array([r.queue_s for r in responses])
        rs = platform.last_router_stats
        print(f"queueing: mean={q.mean() * 1e3:.1f}ms "
              f"max={q.max() * 1e3:.1f}ms  "
              f"max-in-flight={rs.max_in_flight}")
    for name, ps in platform.pool_stats().items():
        print(f"pool[{name}]: instances={ps.size} live={ps.live} "
              f"cold={ps.cold_starts} warm={ps.warm_hits} "
              f"evictions={ps.evictions}")
        if platform.autoscaler is not None:
            print(f"autoscaler[{name}]: prewarms={ps.prewarms}")
    cs = platform.cache_stats()
    if cs is not None:
        print(f"weight-cache: hits={cs.hits} misses={cs.misses} "
              f"deduped-reads={cs.waits} evictions={cs.evictions} "
              f"resident={cs.bytes_cached / 1e6:.1f}MB "
              f"hit-rate={cs.hit_rate:.0%}")


def _report_cluster(cluster, responses):
    """The per-node lines and the placement table of a cluster replay."""
    served = np.array([r.node for r in responses])
    for nd in cluster.nodes:
        ps = nd.platform.pool_stats()
        print(f"node[{nd.node_id}]: "
              f"served={int((served == nd.node_id).sum())} "
              f"cold={sum(p.cold_starts for p in ps.values())} "
              f"warm={sum(p.warm_hits for p in ps.values())} "
              f"origin-reads={nd.origin_reads():.0f} "
              f"peer-reads={nd.peer_reads():.0f}")
    snap = cluster.cluster_snapshot()
    agg = snap["cluster"]["counters"]
    print(f"cluster: origin-reads="
          f"{agg.get('cluster/origin_reads', 0):.0f} "
          f"peer-reads={agg.get('cluster/peer_reads', 0):.0f} "
          f"peer-bytes={agg.get('cluster/peer_bytes', 0) / 1e6:.1f}MB")
    pl = snap["placement"]
    print(f"placement: models={pl['models']} "
          f"origin-elections={pl['origin_elections']} "
          f"peer-referrals={pl['peer_referrals']}")


def _refuse(args):
    """The options the launcher refuses, before anything is deployed."""
    # the reference's refusals, with its messages
    if args.compute_quant and (args.mesh > 1 or args.nodes > 1):
        raise SystemExit("--compute-quant serves int8 leaves in place on "
                         "a single device; not supported with --mesh/"
                         "--nodes")
    if args.nodes > 1:
        if args.autoscale:
            raise SystemExit("--autoscale is a per-node policy; not "
                             "supported with --nodes > 1")
        if args.kv_page_tokens:
            raise SystemExit("--kv-page-tokens is per-node scheduler "
                             "state; not yet plumbed with --nodes > 1")


def main(argv=None):
    """Run the launcher; returns ``{strategy: [Response, ...]}``."""
    args = _parser().parse_args(argv)
    _refuse(args)
    device = resolve_device(args.device)

    store_dir = args.store or tempfile.mkdtemp(prefix="cicada-store-")
    store = WeightStore(store_dir,
                        BandwidthModel(args.bandwidth_mbps, 0.2,
                                       channels=max(1, args.mesh)))
    mesh_shape = (1, args.mesh) if args.mesh > 1 else None
    if mesh_shape is not None:
        card = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        print(f"mesh: {mesh_shape} = {args.mesh} logical devices on one "
              f"physical device ({device}, {card}), one store channel each")
    builders = {}
    for name in args.models:
        cfg = get_config(name, smoke=args.smoke)
        model = transformer.build(cfg, device=device)
        if not store.has_model(name):
            print(f"deploying {name} "
                  f"({n_params(model.abstract()) / 1e6:.1f}M params"
                  f"{', int8' if args.compute_quant else ''}) ...")
            deploy_model(store, model, name, seed=args.seed,
                         quant="int8" if args.compute_quant else None)
        builders[name] = (lambda m=model, c=cfg: (m, example_batch(c)))

    trace = azure_like_trace(duration_s=args.duration,
                             n_invocations=args.invocations,
                             models=args.models, seed=args.seed)
    print("trace:", summarize(trace))

    def make_batch(name):
        return example_batch(get_config(name, smoke=args.smoke))

    cache_budget = None if args.cache_budget_mb is None \
        else int(args.cache_budget_mb * 1e6)
    out = {}
    platform = None
    for strategy in args.strategy:
        if args.nodes > 1:
            # the peer tier requires per-node caches: default unbounded
            platform = ClusterPlatform(
                store, builders, n_nodes=args.nodes,
                cluster_bw_mbps=args.cluster_bw_mbps,
                cache_budget_bytes=0 if cache_budget is None
                else cache_budget,
                strategy=strategy, keep_alive_s=args.keep_alive,
                max_instances=args.max_instances, gen_slots=args.gen_slots,
                gen_cache_len=args.gen_cache_len, mesh_shape=mesh_shape,
                device=device)
        else:
            platform = ServerlessPlatform(
                store, builders, strategy=strategy,
                keep_alive_s=args.keep_alive,
                max_instances=args.max_instances,
                cache_budget_bytes=cache_budget,
                gen_slots=args.gen_slots, gen_cache_len=args.gen_cache_len,
                kv_page_tokens=args.kv_page_tokens,
                kv_budget_bytes=None if args.kv_budget_mb is None
                else int(args.kv_budget_mb * 1e6),
                mesh_shape=mesh_shape,
                compute_quant=args.compute_quant, device=device,
                autoscale=dict(rps_per_instance=args.rps_per_instance)
                if args.autoscale else None)
        make_spec = None
        if args.workload == "generate":
            rng = np.random.default_rng(args.seed)

            def make_spec(name):
                cfg = get_config(name, smoke=args.smoke)
                return GenerateSpec(
                    prompt=rng.integers(0, cfg.vocab_size,
                                        (args.prompt_len,)).astype(np.int32),
                    n_new=args.n_new, temperature=args.temperature,
                    seed=args.seed)

        autoscaler = getattr(platform, "autoscaler", None)
        if autoscaler is not None:
            autoscaler.start()
        try:
            responses = platform.run_trace(trace, make_batch,
                                           concurrency=args.concurrency,
                                           make_spec=make_spec)
        finally:
            if autoscaler is not None:
                autoscaler.stop()
        _report(args, strategy, platform, responses)
        out[strategy] = responses
    if args.metrics_out:
        is_cluster = args.nodes > 1
        snap = platform.cluster_snapshot() if is_cluster \
            else platform.metrics_snapshot()
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2)
        if is_cluster:
            print(f"cluster snapshot -> {args.metrics_out} "
                  f"({snap['n_nodes']} nodes)")
        else:
            print(f"metrics snapshot -> {args.metrics_out} "
                  f"({len(snap['counters'])} counters, "
                  f"{len(snap['gauges'])} gauges, "
                  f"{len(snap['histograms'])} histograms)")
    return out


if __name__ == "__main__":
    main()
