"""The port's slotted ``DecodeScheduler`` on the recurrent families (f32,
smoke configs, weights carried from the JAX init): tokens equal the
port's ``reference_generate`` at concurrency 1 and 4 and the JAX
scheduler's greedy tokens (``REPRO_PALLAS=ref``).  recurrentgemma-2b
smoke has a two-layer tail, whose cache leaves are ``(B, ...)`` and not
``(n_units, B, ...)``: the join of a request's state into its slot
must tell the two apart.  The paged scheduler's tokens equal the slotted
one's."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import DecodeScheduler as JScheduler
from repro.serving import GenerateSpec as JSpec
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                 reference_generate)
from repro_torch.serving.decode import _join_slot

torch.set_num_threads(2)
CACHE_LEN = 48
ARCHS = ("mamba2-780m", "recurrentgemma-2b")


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return tcfg, tm, tparams, jm, jparams


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n,))


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
def test_tokens_equal_reference(fam, concurrency):
    cfg, m, params, _, _ = fam
    sched = DecodeScheduler(m, params, n_slots=4, cache_len=CACHE_LEN)
    prompts = [_prompt(cfg, 20 + i, n) for i, n in enumerate((5, 8, 13, 21))]
    specs = [GenerateSpec(prompt=p, n_new=7, seed=i,
                          temperature=0.7 if i == 3 else 0.0)
             for i, p in enumerate(prompts)]
    got = ([sched.generate(s) for s in specs] if concurrency == 1
           else _concurrent(sched, specs))
    for p, s, r in zip(prompts, specs, got):
        assert r.tokens == reference_generate(
            m, params, p, n_new=7, seed=s.seed, temperature=s.temperature,
            cache_len=CACHE_LEN, device="cpu")
    assert 1 <= sched.stats()["max_occupancy"] <= concurrency
    assert sched.stats()["joined"] == 4 and sched.stats()["active"] == 0


def test_greedy_tokens_equal_jax_scheduler(fam):
    cfg, m, params, jm, jparams = fam
    prompts = [_prompt(cfg, 30 + i, 6 + 3 * i) for i in range(3)]
    jsched = JScheduler(jm, jparams, n_slots=3, cache_len=CACHE_LEN)
    want = [jsched.generate(JSpec(prompt=p.astype(np.int32), n_new=6)).tokens
            for p in prompts]
    sched = DecodeScheduler(m, params, n_slots=3, cache_len=CACHE_LEN)
    got = _concurrent(sched, [GenerateSpec(prompt=p, n_new=6)
                              for p in prompts])
    assert [r.tokens for r in got] == want


def test_join_slot_writes_tail_groups_on_their_batch_axis(fam):
    cfg, m, _, _, _ = fam
    big = m.init_cache(3, CACHE_LEN)
    one = m.init_cache(1, CACHE_LEN)
    for i, (_, leaf) in enumerate(ttransformer.tree_util.leaves_with_path(
            one)):
        leaf.fill_(i + 1.0)
    _join_slot(big, one, 2)
    for path, leaf in ttransformer.tree_util.leaves_with_path(big):
        rows = leaf[:, 2] if path[0].startswith("s") else leaf[2]
        others = (leaf[:, :2] if path[0].startswith("s") else leaf[:2])
        assert bool((rows != 0).all()), path
        assert bool((others == 0).all()), path
    assert any(k.startswith("t") for k in big) == (cfg.name.startswith(
        "recurrentgemma"))


def test_resume_from_injected_first_token(fam):
    """The cold-start path: the pipeline's own first token is injected,
    the prompt is prefilled for its state only, and generation resumes
    as if the scheduler had sampled that token itself."""
    cfg, m, params, _, _ = fam
    p = _prompt(cfg, 40, 11)
    want = reference_generate(m, params, p, n_new=6, cache_len=CACHE_LEN,
                              device="cpu")
    sched = DecodeScheduler(m, params, n_slots=2, cache_len=CACHE_LEN)
    got = sched.generate(GenerateSpec(prompt=p, n_new=6),
                         first_token=want[0], t_first=0.0)
    assert got.tokens == want


def test_paged_decode_raises_naming_its_roadmap_item(fam):
    """The paged scheduler serves both families (recurrentgemma pages its
    ``attn`` layer; mamba2 pages nothing, so its pool's pages cost 0
    bytes): the four prompts' tokens, one resumed from an injected first
    token, equal the slotted scheduler's, and no page stays pinned."""
    cfg, m, params, _, _ = fam
    assert m.kv_page_bytes(16) == (0 if cfg.name.startswith("mamba2")
                                   else 2 * 16 * cfg.dh * 4)
    prompts = [_prompt(cfg, 20 + i, n) for i, n in enumerate((5, 8, 13, 21))]
    specs = [GenerateSpec(prompt=p, n_new=7) for p in prompts]
    slotted = DecodeScheduler(m, params, n_slots=4, cache_len=CACHE_LEN)
    want = [slotted.generate(s).tokens for s in specs]
    paged = DecodeScheduler(m, params, n_slots=4, cache_len=CACHE_LEN,
                            kv_page_tokens=16)
    got = _concurrent(paged, specs[:3])
    got.append(paged.generate(specs[3], first_token=want[3][0],
                              t_first=0.0))
    assert [r.tokens for r in got] == want
    assert paged.stats()["kv_pages_pinned"] == 0
    paged.kvpool.check_invariants()
