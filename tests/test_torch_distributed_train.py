"""The port's training half of ``distributed`` and ``launch`` against the
JAX package's, on the CPU: checkpoints written by either package restore
in the other leaf for leaf; the port's resume is bit-equal to a straight
run; preemption saves and stops; retention and the ``latest`` pointer;
``quantize_int8`` bit-equal and error feedback equal; ``compressed_psum``
over two gloo processes within the reference test's ``max|x| / 127``;
``HeartbeatMonitor`` on one script through both; the sharding context
and ``reshard``; ``launch.train`` on smollm smoke with
``--compress-grads``, then ``--resume``."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jckpt
from repro.distributed import compression as jcomp
from repro.distributed import resilience as jres
from repro.distributed import sharding as jshd
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.training import optim as joptim
from repro_torch import tree as tree_util
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import resilience as tres
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.training import data as tdata
from repro_torch.training import optim as toptim
from repro_torch.training import train as ttrain
from torch_testlib import ROOT

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("smollm-360m", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config("smollm-360m", smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    tm = ttransformer.build(tcfg, device="cpu")
    return jm, tm


def _state(r, tree, scale=1.0):
    return tree_util.tree_map(
        lambda t: torch.from_numpy((r.standard_normal(tuple(t.shape))
                                    * scale).astype(np.float32)), tree)


def _flat_jax(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def test_port_checkpoint_restores_in_jax(pair, tmp_path):
    jm, tm = pair
    r = np.random.default_rng(0)
    params = _state(r, tm.abstract())
    st = toptim.AdamWState(torch.tensor(7, dtype=torch.int32),
                           _state(r, params), _state(r, params, 0.01))
    tckpt.Checkpointer(str(tmp_path)).save(7, params, st)
    ab = jm.abstract()
    step, jp, js = jckpt.Checkpointer(str(tmp_path)).restore(
        ab, jax.eval_shape(joptim.AdamW().init, ab))
    assert step == 7 and int(js.step) == 7 and js.step.dtype == jnp.int32
    for got, want in ((jp, params), (js.m, st.m), (js.v, st.v)):
        g, w = _flat_jax(got), tree_util.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b.numpy())


def test_jax_checkpoint_restores_in_port(pair, tmp_path):
    jm, tm = pair
    jp = jm.init(jax.random.key(3))
    jopt = joptim.AdamW()
    js = jopt.init(jp)
    js = js._replace(step=jnp.asarray(5, jnp.int32),
                     m=jax.tree.map(lambda a: a + 1.5, js.m))
    jckpt.Checkpointer(str(tmp_path)).save(5, jp, js)
    ck = tckpt.Checkpointer(str(tmp_path))
    ab = tm.abstract()
    step, tp, ts = ck.restore(ab, toptim.AdamWState(None, ab, ab))
    assert step == 5 and ts.step.item() == 5 and \
        ts.step.dtype == torch.int32
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(tree_util.leaves(got), _flat_jax(want)):
            np.testing.assert_array_equal(a.numpy(), b)
    # the elastic path: onto a logical mesh's NamedShardings
    mesh = tmesh.make_serving_mesh((1, 2), device="cpu")
    sh = tshd.param_specs(ab, mesh, tshd.train_rules())
    _, tp2, _ = ck.restore(ab, shardings=sh)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(tp2),
                                                 tree_util.leaves(tp)))


def test_resume_trajectory_bit_equal(pair, tmp_path):
    """6 straight steps == 3, checkpoint, restore, 3 (bit for bit: the
    reference's test holds 1e-6)."""
    _, tm = pair
    opt = toptim.AdamW(lr=1e-3)
    step = ttrain.make_train_step(tm, opt)
    data = tdata.MarkovLM(tm.cfg.vocab_size, seed=1)

    def run(p, s, lo, hi):
        for i in range(lo, hi):
            p, s, _ = step(p, s, {k: torch.as_tensor(v) for k, v in
                                  data.batch(4, 16, i).items()})
        return p, s

    p0 = tm.init(0)
    s0 = opt.init(p0)
    straight, _ = run(p0, s0, 0, 6)
    p3, s3 = run(p0, s0, 0, 3)
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(3, p3, s3)
    ab = tm.abstract()
    at, pr, sr = ck.restore(ab, toptim.AdamWState(None, ab, ab))
    assert at == 3
    resumed, _ = run(pr, sr, 3, 6)
    for a, b in zip(tree_util.leaves(straight), tree_util.leaves(resumed)):
        assert torch.equal(a, b)


def test_preemption_saves_and_stops(pair, tmp_path):
    _, tm = pair
    opt = toptim.AdamW(lr=1e-3)
    ck = tckpt.Checkpointer(str(tmp_path))
    loop = ttrain.TrainLoop(tm, opt, checkpointer=ck, ckpt_every=1000,
                            log_every=1000, log_fn=lambda s: None)
    params = tm.init(0)
    data = tdata.MarkovLM(tm.cfg.vocab_size, seed=0)
    calls = {"n": 0}
    orig = loop.step_fn

    def step_and_preempt(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            loop._preempted = True          # simulated SIGTERM
        return orig(*a)

    loop.step_fn = step_and_preempt
    loop.run(params, opt.init(params),
             tdata.host_batches(data, global_batch=4, seq=16), n_steps=50)
    assert calls["n"] == 2                  # stopped early
    assert ck.latest_step() == 2            # checkpoint written on preempt


def test_checkpoint_retention_and_latest(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path), keep=2)
    w = torch.arange(8, dtype=torch.float32)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": w * s})
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    step, params, _ = ck.restore({"w": torch.empty(8, device="meta")})
    assert step == 4 and torch.equal(params["w"], w * 4)
    os.makedirs(str(tmp_path / "step_00000005.tmp"))     # a crashed save
    assert ck.latest_step() == 4 and ck.all_steps() == [3, 4]


def test_int8_compression_matches_reference():
    r = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 1e3):
        x = (r.standard_normal(257) * scale).astype(np.float32)
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        np.testing.assert_array_equal(
            tcomp.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))
    assert tcomp.quantize_int8(torch.zeros(4))[1].item() == 1.0
    g = {"a": r.standard_normal((8, 8)).astype(np.float32),
         "b": {"c": r.standard_normal(5).astype(np.float32)}}
    jf, tf = jcomp.make_error_feedback_transform(), \
        tcomp.make_error_feedback_transform()
    jef = jcomp.init_error_feedback(jax.tree.map(jnp.asarray, g))
    tef = tcomp.init_error_feedback(tree_util.tree_map(torch.from_numpy, g))
    for _ in range(5):
        jc, jef = jf(jax.tree.map(jnp.asarray, g), jef)
        tc, tef = tf(tree_util.tree_map(torch.from_numpy, g), tef)
        for a, b in zip(tree_util.leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_util.leaves(tef), jax.tree.leaves(jef)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


PSUM = r"""
import datetime, os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.distributed.compression import compressed_psum

def run(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    x = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    got = compressed_psum(torch.from_numpy(x[rank])).numpy()
    ok = np.abs(got - x.mean(0)).max() <= np.abs(x).max() / 127.0 + 1e-6
    open(os.path.join(out, f"rank{rank}"), "w").write("OK" if ok else "BAD")
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2)
"""


def test_compressed_psum_two_gloo_processes(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "psum.py"
    script.write_text(PSUM)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(port),
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    for rank in (0, 1):
        assert (tmp_path / f"rank{rank}").read_text() == "OK"


def test_heartbeat_monitor_matches_reference():
    mons = (jres.HeartbeatMonitor(threshold=1.5, timeout_s=10.0),
            tres.HeartbeatMonitor(threshold=1.5, timeout_s=10.0))
    script = [(f"host{h}", 1.0 if h != 2 else 3.0, float(s))
              for s in range(5) for h in range(4)] + [("host0", 1.0, 30.0)]
    for host, dur, now in script:
        for m in mons:
            m.report(host, dur, now=now)
    for now in (5.0, 12.0, 31.0):
        assert mons[0].stragglers(now) == mons[1].stragglers(now)
        assert mons[0].suggest_evict(now) == mons[1].suggest_evict(now)
    assert mons[1].stragglers(5.0) == ["host2"]
    assert {h: (s.ema_s, s.steps) for h, s in mons[0].hosts.items()} == \
        {h: (s.ema_s, s.steps) for h, s in mons[1].hosts.items()}


def test_sharding_context_constrain_and_reshard():
    """``constrain`` is a no-op outside a context and returns ``x`` inside
    one after resolving its spec, so a bad logical name fails as in the
    reference; ``reshard`` places a tree by NamedShardings or devices."""
    x = torch.ones(4, 6)
    assert tshd.constrain(x, "batch", "embed") is x
    assert tshd.active_context() is None
    mesh = tmesh.make_local_mesh(device="cpu")
    rules = tshd.train_rules()
    with tshd.use_rules(mesh, rules):
        assert tshd.active_context() == (mesh, rules)
        assert tshd.constrain(x, "batch", "embed") is x
        assert tshd.constrain(x, "batch") is x          # rank mismatch
        with pytest.raises(TypeError):
            tshd.constrain(x, ["batch"], None)
    assert tshd.active_context() is None
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jshd.use_rules(jmesh, jshd.train_rules()):
        with pytest.raises(TypeError):
            jshd.constrain(jnp.ones((4, 6)), ["batch"], None)
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    sh = {"a": tshd.replicated(mesh), "b": {"c": "cpu"}}
    moved = tres.reshard(tree, sh)
    assert all(t.device.type == "cpu" for t in tree_util.leaves(moved))
    assert mesh.shape == {"data": 1, "model": 1}
    prod = tmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and \
        prod.device.type == "meta"
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}


def test_launch_train_smoke_compress_then_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    common = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
              "--seq", "16", "--batch", "4", "--ckpt-dir", ck]
    hist = tlaunch.main(common + ["--steps", "3", "--ckpt-every", "3",
                                  "--compress-grads"], log_every=1)
    assert hist["step"] == [1, 2, 3]
    assert all(np.isfinite(hist["loss"]))
    assert tckpt.Checkpointer(ck).latest_step() == 3
    hist2 = tlaunch.main(common + ["--steps", "2", "--resume"], log_every=1)
    assert hist2["step"] == [4, 5]
    text = capsys.readouterr().out
    assert "resumed from step 3" in text and "mesh={'data': 1, 'model': 1}" \
        in text
    with pytest.raises(ValueError, match="production mesh"):
        tlaunch.main(common + ["--steps", "1", "--production-mesh"])
