"""The single-node hooks the port's cluster plugs into, held against the
JAX package: ``BandwidthModel``'s channels and ``transfer`` (on one
scripted clock, both packages sleep the same amounts; with one channel,
every read is the old shared bucket), the decoupler's ``ShardSource``
(a peer-served stream stays external to Algorithm 1 and is never
prioritized; a source needs a cache), the engine handing the source on
only when its strategy decouples, and the launcher's ``--nodes`` (the
per-node and placement report equal to the JAX launcher's; the
refusals are ``test_torch_launch.py``'s).

Threads are synchronised with events, never with sleeps."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.core import decoupler as jdecoupler
from repro.core.pipeline import PipelineTrace as JTrace
from repro.core.scheduler import PriorityAwareScheduler as JScheduler
from repro.core.units import PipelineState as JState
from repro.launch import serve as jserve
from repro.store import store as jstore
from repro.store.cache import WeightCache as JCache
from repro_torch.core import ColdStartEngine
from repro_torch.core import decoupler as tdecoupler
from repro_torch.core.pipeline import PipelineTrace
from repro_torch.core.scheduler import HIGH, NORMAL, PriorityAwareScheduler
from repro_torch.core.units import PipelineState
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.store import store as tstore
from repro_torch.store.cache import WeightCache

torch.set_num_threads(2)

PACKAGES = {
    "port": (tstore, tdecoupler, PriorityAwareScheduler, PipelineTrace,
             PipelineState, WeightCache),
    "ref": (jstore, jdecoupler, JScheduler, JTrace, JState, JCache),
}


# ---------------------------------------------------------------------------
# BandwidthModel: channels and transfer
# ---------------------------------------------------------------------------

class FakeClock:
    """A scripted clock: ``sleep`` advances ``monotonic`` and is logged."""

    def __init__(self):
        self.now = 100.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(round(s, 9))
        self.now += s


class CountingGate:
    def __init__(self):
        self.waits = 0

    def wait(self):
        self.waits += 1


def _bandwidth_script(mod, monkeypatch, channels):
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", clock)
    bw = mod.BandwidthModel(bandwidth_mbps=100.0, latency_ms=2.0,
                            channels=channels)
    bw.on_open()
    bw.on_chunk(1 << 20)                       # channel 0 by default
    bw.on_chunk(1 << 20, 0)
    bw.on_chunk(3 << 19, 1)                    # wraps with one channel
    bw.on_chunk(1 << 18, 5)
    gate, chunks = CountingGate(), []
    bw.transfer((5 << 19) + 7, channel=1, chunk_bytes=1 << 20, gate=gate,
                on_chunk=chunks.append)
    bw.transfer(0, channel=2, gate=gate, on_chunk=chunks.append)
    return clock.sleeps, chunks, gate.waits, len(bw._next_free)


@pytest.mark.parametrize("channels", [1, 3])
def test_bandwidth_channels_and_transfer_match_reference(monkeypatch,
                                                         channels):
    got = _bandwidth_script(tstore, monkeypatch, channels)
    want = _bandwidth_script(jstore, monkeypatch, channels)
    assert got == want
    sleeps, chunks, waits, n = got
    assert n == channels
    # transfer charges the gate and on_chunk once a chunk
    assert chunks == [1 << 20, 1 << 20, (1 << 19) + 7] and waits == 3
    if channels == 1:
        # one shared bucket: each chunk waits for the one before it
        assert sleeps[1:4] == [pytest.approx((1 << 20) / 1e8)] + [
            pytest.approx((1 << 20) / 1e8), pytest.approx((3 << 19) / 1e8)]


def test_channel_one_store_reads_are_unchanged(tmp_path, monkeypatch):
    """A store read on the default model charges channel 0 chunk by chunk,
    exactly the sleeps of the reference's store on the same bytes."""
    rng = np.random.default_rng(0)
    units = {"u": {"w": rng.standard_normal((300, 40)).astype(np.float32),
                   "b": rng.standard_normal((40,)).astype(np.float32)}}
    tstore.WeightStore(str(tmp_path)).deploy("m", units)
    out = {}
    for side, mod in (("port", tstore), ("ref", jstore)):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", clock)
        st = mod.WeightStore(str(tmp_path), mod.BandwidthModel(
            bandwidth_mbps=10.0, latency_ms=1.0))
        raw = st.read_unit("m", "u", chunk_bytes=4096)
        out[side] = (clock.sleeps, bytes(np.asarray(raw).tobytes()),
                     len(st.device._next_free))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 1 + -(-len(out["port"][1]) // 4096)


# ---------------------------------------------------------------------------
# the decoupler's ShardSource
# ---------------------------------------------------------------------------

class FakeStore:
    """Just what the decoupler's unit-granular path calls; ``read_unit``
    parks until ``release`` is set."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.reads = 0

    def unit_nbytes(self, model, unit):
        return 64

    def read_unit(self, model, unit, *, chunk_bytes, gate, on_progress):
        self.reads += 1
        self.entered.set()
        self.release.wait(30)
        on_progress(64, 64)
        return b"raw"

    def deserialize(self, model, unit, raw):
        return {"w": (raw, None)}


class ParkedSource:
    """A ShardSource that serves from a peer (``serve_peer``) or runs the
    origin thunk, parking until ``release`` in the peer case."""

    def __init__(self, base, serve_peer):
        class Source(base):
            def fetch(src, model, unit, skey, nbytes, read_origin, *,
                      gate=None, on_chunk=None):
                self.calls.append((model, unit, skey, nbytes))
                if not serve_peer:
                    return read_origin(), "origin"
                self.entered.set()
                self.release.wait(30)
                on_chunk(nbytes)
                return {"w": (b"peer", None)}, "peer"

            def publish(src, model, unit, skey):
                self.published.append((model, unit, skey))

        self.source = Source()
        self.calls, self.published = [], []
        self.entered = threading.Event()
        self.release = threading.Event()


def _decisions(side, serve_peer):
    store_mod, dec_mod, sched_cls, trace_cls, state_cls, cache_cls = \
        PACKAGES[side]
    # every local read is late at once: Algorithm 1 would prioritize it
    sched = sched_cls(bw_bytes_per_s=1e12, a_overhead_s=0.0)
    store = FakeStore()
    src = ParkedSource(dec_mod.ShardSource, serve_peer)
    cache = cache_cls()
    dec = dec_mod.WeightDecoupler(store, "m", sched, trace_cls(),
                                  state=state_cls(), io_workers=2,
                                  cache=cache, source=src.source)
    trace = dec.trace
    trace.start()
    dec.prefetch(["u0"])
    parked = src if serve_peer else store
    assert parked.entered.wait(30)
    during = sched.adjust_priority("u0")
    parked.release.set()
    with dec.cv:
        assert dec.cv.wait_for(lambda: "u0" in dec.ready, 30)
    after = sched.adjust_priority("u0")
    meta = trace.events_for("R")["u0"].meta
    dec.shutdown()
    return (during, after, store.reads, src.calls, src.published, meta,
            sched.stats()["suspends"], "u0" in {k[1] for k in
                                                cache._entries})


@pytest.mark.parametrize("serve_peer", [True, False], ids=["peer", "origin"])
def test_peer_served_stream_stays_external(serve_peer):
    got = _decisions("port", serve_peer)
    want = _decisions("ref", serve_peer)
    assert got == want
    during, after, reads, calls, published, meta, suspends, cached = got
    assert calls == [("m", "u0", 0, 64)] and published == [("m", "u0", 0)]
    assert cached and after == NORMAL
    if serve_peer:
        # never prioritized: the transfer is another node's cache
        assert (during, reads, suspends) == (NORMAL, 0, 0)
        assert meta == {"peer": True}
    else:
        assert (during, reads) == (HIGH, 1) and meta is None


def test_source_requires_a_cache():
    for side in PACKAGES:
        _, dec_mod, sched_cls, trace_cls, state_cls, _ = PACKAGES[side]
        with pytest.raises(ValueError, match="requires a WeightCache"):
            dec_mod.WeightDecoupler(FakeStore(), "m", sched_cls(),
                                    trace_cls(), state=state_cls(),
                                    source=dec_mod.ShardSource())


def test_engine_hands_the_source_only_when_decoupling(tmp_path):
    """cicada's streams read through the source (one fetch a unit);
    pisel, which does not decouple, and a cache-less engine never call
    it, as in the reference."""
    cfg = get_config("smollm-360m", smoke=True)
    m = transformer.build(cfg, device="cpu")
    store = tstore.WeightStore(str(tmp_path))
    tstore.deploy_model(store, m, "m")
    batch = {"tokens": torch.tensor([[1, 2, 3, 4]])}
    n_units = len(m.unit_names())
    for strategy, cache, want in (("cicada", WeightCache(), n_units),
                                  ("pisel", WeightCache(), 0),
                                  ("cicada", None, 0)):
        src = ParkedSource(tdecoupler.ShardSource, serve_peer=False)
        eng = ColdStartEngine(m, "m", store, strategy=strategy, cache=cache,
                              source=src.source, device="cpu")
        eng.load(batch)
        assert len(src.calls) == want and len(src.published) == want, \
            strategy


# ---------------------------------------------------------------------------
# the launcher's --nodes
# ---------------------------------------------------------------------------

def _cluster_lines(out: str):
    return [line for line in out.splitlines()
            if line.startswith(("node[", "cluster:", "placement:"))]


def test_launcher_nodes_prints_the_reference_report(tmp_path, capsys):
    args = ["--nodes", "2", "--invocations", "6", "--duration", "120",
            "--keep-alive", "20", "--bandwidth-mbps", "0",
            "--cluster-bw-mbps", "0", "--workload", "generate",
            "--n-new", "3", "--prompt-len", "5"]
    got = tserve.main(args + ["--store", str(tmp_path / "t"), "--device",
                              "cpu", "--metrics-out",
                              str(tmp_path / "snap.json")])["cicada"]
    tout = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        want = jserve.main(args + ["--store", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    assert [(r.req_id, r.cold, r.node) for r in got] == \
        [(r.req_id, r.cold, r.node) for r in want]
    assert all(r.node is not None and r.n_generated == 3 for r in got)
    lines = _cluster_lines(tout)
    assert len(lines) == 4 and lines == _cluster_lines(jout)
    assert "cluster snapshot -> " in tout and "(2 nodes)" in tout
    snap = json.loads((tmp_path / "snap.json").read_text())
    assert snap["n_nodes"] == 2 and set(snap["nodes"]) == {"node0", "node1"}
