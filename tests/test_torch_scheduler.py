"""The port's slotted continuous-batching ``DecodeScheduler`` on the CPU
(smollm-360m smoke, f32): the cases of ``tests/test_generate.py``
(join mid-batch, leave, EOS, sampled determinism, overflow, ``max_len``,
``n_slots``), tokens equal to the port's ``reference_generate`` at
concurrency 1 and 4, greedy tokens equal to the JAX scheduler's on the
same weights (``REPRO_PALLAS=ref``), and the cold-start resume from an
injected first token."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import DecodeScheduler as JScheduler
from repro.serving import GenerateSpec as JSpec
from repro_torch.metrics import MetricsRegistry
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import (CacheOverflowError, DecodeScheduler,
                                 GenerateSpec, reference_generate)

torch.set_num_threads(2)
CACHE_LEN = 64
PROMPT_LEN = 8


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.fixture(scope="module")
def dense():
    """The port's smoke model and params, carried from JAX's init, plus
    the JAX model and params."""
    jcfg = dataclasses.replace(jget_config("smollm-360m", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config("smollm-360m", smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return tcfg, tm, tparams, jm, jparams


def _prompt(cfg, seed, n=PROMPT_LEN):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n,))


def _ref(m, params, prompt, **kw):
    return reference_generate(m, params, prompt, cache_len=CACHE_LEN,
                              device="cpu", **kw)


def _concurrent(sched, specs):
    out = [None] * len(specs)

    def run(i):
        out[i] = sched.generate(specs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


@pytest.mark.parametrize("concurrency", [1, 4])
def test_tokens_equal_reference(dense, concurrency):
    cfg, m, params, _, _ = dense
    sched = DecodeScheduler(m, params, n_slots=4, cache_len=CACHE_LEN)
    prompts = [_prompt(cfg, 20 + i, n) for i, n in enumerate((5, 8, 13, 21))]
    specs = [GenerateSpec(prompt=p, n_new=7, seed=i,
                          temperature=0.7 if i == 3 else 0.0)
             for i, p in enumerate(prompts)]
    if concurrency == 1:
        got = [sched.generate(s) for s in specs]
    else:
        got = _concurrent(sched, specs)
    for p, s, r in zip(prompts, specs, got):
        assert r.tokens == _ref(m, params, p, n_new=7, seed=s.seed,
                                temperature=s.temperature)
        assert len(r.tpot_s) == 6 and all(dt >= 0 for dt in r.tpot_s)
    # concurrent requests overlap (how much depends on thread timing)
    assert 1 <= sched.stats()["max_occupancy"] <= concurrency
    assert sched.stats()["joined"] == 4 and sched.stats()["active"] == 0


def test_greedy_tokens_equal_jax_scheduler(dense):
    cfg, m, params, jm, jparams = dense
    prompts = [_prompt(cfg, 30 + i) for i in range(3)]
    jsched = JScheduler(jm, jparams, n_slots=3, cache_len=CACHE_LEN)
    want = [jsched.generate(JSpec(prompt=p.astype(np.int32), n_new=6)).tokens
            for p in prompts]
    sched = DecodeScheduler(m, params, n_slots=3, cache_len=CACHE_LEN)
    got = _concurrent(sched, [GenerateSpec(prompt=p, n_new=6)
                              for p in prompts])
    assert [r.tokens for r in got] == want


def test_join_mid_batch_does_not_perturb_other_slots(dense):
    cfg, m, params, _, _ = dense
    sched = DecodeScheduler(m, params, n_slots=4, cache_len=CACHE_LEN)
    pa, pb = _prompt(cfg, 1), _prompt(cfg, 2)
    out = {}

    def run_a():
        out["a"] = sched.generate(GenerateSpec(prompt=pa, n_new=48)).tokens

    ta = threading.Thread(target=run_a)
    ta.start()
    deadline = time.monotonic() + 120
    while sched.stats()["steps"] < 2:          # A's decode is running
        assert time.monotonic() < deadline, "A never started stepping"
        time.sleep(0.002)
    out["b"] = sched.generate(GenerateSpec(prompt=pb, n_new=6)).tokens
    ta.join(timeout=120)
    assert not ta.is_alive()
    assert out["a"] == _ref(m, params, pa, n_new=48)
    assert out["b"] == _ref(m, params, pb, n_new=6)
    assert sched.stats()["max_occupancy"] >= 2
    assert sched.stats()["active"] == 0


def test_leave_frees_slot_for_next_joiner(dense):
    cfg, m, params, _, _ = dense
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=CACHE_LEN)
    prompts = [_prompt(cfg, 10 + i) for i in range(4)]
    got = _concurrent(sched, [GenerateSpec(prompt=p, n_new=5)
                              for p in prompts])
    for p, r in zip(prompts, got):
        assert r.tokens == _ref(m, params, p, n_new=5)
    st = sched.stats()
    assert st["max_occupancy"] <= 2 and st["joined"] == 4


def test_eos_leaves_early(dense):
    cfg, m, params, _, _ = dense
    p = _prompt(cfg, 3)
    ref = _ref(m, params, p, n_new=8)
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=CACHE_LEN)
    got = sched.generate(GenerateSpec(prompt=p, n_new=8,
                                      eos_id=int(ref[2]))).tokens
    assert got == ref[:ref.index(ref[2]) + 1]
    assert sched.stats()["active"] == 0


def test_sampled_generation_deterministic_and_matches_reference(dense):
    cfg, m, params, _, _ = dense
    p = _prompt(cfg, 4)
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=CACHE_LEN)
    spec = GenerateSpec(prompt=p, n_new=6, temperature=0.8, seed=7)
    a = sched.generate(spec).tokens
    assert a == sched.generate(spec).tokens
    assert a == _ref(m, params, p, n_new=6, temperature=0.8, seed=7)


def test_overflow_raises_before_touching_a_slot(dense):
    cfg, m, params, _, _ = dense
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=16)
    with pytest.raises(CacheOverflowError):
        sched.generate(GenerateSpec(prompt=_prompt(cfg, 5), n_new=16))
    assert sched.stats()["active"] == 0 and sched.stats()["steps"] == 0


def test_max_len_clamps_n_new(dense):
    cfg, m, params, _, _ = dense
    p = _prompt(cfg, 6)
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=CACHE_LEN)
    got = sched.generate(GenerateSpec(prompt=p, n_new=100,
                                      max_len=PROMPT_LEN + 4)).tokens
    assert got == _ref(m, params, p, n_new=4)
    with pytest.raises(CacheOverflowError):
        sched.generate(GenerateSpec(prompt=p, n_new=4, max_len=PROMPT_LEN))


def test_n_slots_bounds_residency(dense):
    cfg, m, params, _, _ = dense
    with pytest.raises(ValueError, match="n_slots"):
        DecodeScheduler(m, params, n_slots=0)
    with pytest.raises(ValueError, match="cache_len"):
        DecodeScheduler(m, params, cache_len=1)
    sched = DecodeScheduler(m, params, n_slots=1, cache_len=CACHE_LEN)
    got = _concurrent(sched, [GenerateSpec(prompt=_prompt(cfg, 40 + i),
                                           n_new=4) for i in range(3)])
    assert all(len(r.tokens) == 4 for r in got)
    assert sched.stats()["max_occupancy"] == 1
    sched.reset_peaks()
    assert sched.stats()["max_occupancy"] == 0


def test_resume_from_injected_first_token(dense):
    """The cold-start path: the pipeline's first token is injected; the
    prefill only builds the cache and generation resumes after it."""
    cfg, m, params, _, _ = dense
    p = _prompt(cfg, 8)
    ref = _ref(m, params, p, n_new=6)
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=CACHE_LEN)
    r = sched.generate(GenerateSpec(prompt=p, n_new=6), first_token=ref[0],
                       t_first=123.0)
    assert r.tokens == ref and r.t_first == 123.0
    # n_new=1: the injected token is the whole answer, no step runs
    one = sched.generate(GenerateSpec(prompt=p, n_new=1), first_token=7,
                         t_first=1.0)
    assert one.tokens == [7] and sched.stats()["steps"] == 5


def test_metrics_and_kernel_modes(dense):
    cfg, m, params, _, _ = dense
    reg = MetricsRegistry()
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=CACHE_LEN,
                            metrics=reg)
    sched.generate(GenerateSpec(prompt=_prompt(cfg, 9), n_new=4))
    snap = reg.snapshot()
    assert snap["counters"]["decode/steps"] == 3
    assert snap["counters"]["decode/joined"] == 1
    assert snap["gauges"]["decode/occupancy"] == {"value": 0.0, "max": 1.0}
    assert set(sched.kernel_modes().values()) == {"plain"}
    assert "quant_matmul" in sched.kernel_modes()
