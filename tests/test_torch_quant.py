"""The port's int8-resident (``compute_quant``) path against the JAX
package's, on the same seeded numpy inputs (f32, ``REPRO_PALLAS=ref``):
``quant.einsum`` (scale tiled across middle axes, ``n_contract=2``, the
head), ``gather_rows`` and ``QuantLeaf.astype`` (bit-equal to the plain
``weight_transform``), ``ref.quant_matmul`` on ``tests/test_kernels.py``'s
ragged shapes, ``QuantLeaf`` as a two-child tree node, and a
``compute_quant`` cold start from a JAX-deployed int8 smoke store (logits
within 1e-4, about a quarter of the f32 bytes, greedy tokens equal),
and bf16 compute on int8 weights drifting from f32 with depth no more
than the JAX package's does.  The CUDA kernel is held against its plain version by ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.core import ColdStartEngine as JEngine
from repro.kernels import ref as jref
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import DecodeScheduler as JScheduler
from repro.serving import GenerateSpec as JSpec
from repro.store import store as jstore
from repro_torch import quant as tquant
from repro_torch import tree as tree_util
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import DecodeScheduler, GenerateSpec
from torch_testlib import close, coldstart_setup, rand

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def qweight(rng, *shape):
    """int8 values at ``shape`` and positive f32 scales over its last
    axis, as numpy."""
    q = rng.integers(-127, 128, shape).astype(np.int8)
    s = (np.abs(rng.standard_normal(shape[-1])) * 0.02 + 1e-3).astype(
        np.float32)
    return q, s


def both(q, s):
    return (jquant.QuantLeaf(jnp.asarray(q), jnp.asarray(s)),
            tquant.QuantLeaf(torch.from_numpy(q), torch.from_numpy(s)))


@pytest.mark.parametrize("case", ["wq", "wo", "head"])
def test_einsum_matches_jax(case):
    """wq (d, H, dh): the (dh,) scale tiles H times; wo (H, dh, d):
    n_contract=2; the head (d, V)."""
    rng = np.random.default_rng(0)
    eq, xs, ws, nc = {
        "wq": ("bsd,dhk->bshk", (2, 5, 60), (60, 3, 20), 1),
        "wo": ("bshk,hkd->bsd", (2, 5, 3, 20), (3, 20, 60), 2),
        "head": ("bsd,dv->bsv", (2, 5, 60), (60, 512), 1)}[case]
    x = rand(rng, *xs)
    jw, tw = both(*qweight(rng, *ws))
    want = jquant.einsum(eq, jnp.asarray(x), jw, jnp.float32, n_contract=nc)
    got = tquant.einsum(torch.from_numpy(x), tw, torch.float32,
                        n_contract=nc)
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want, **TOL)
    # and the plain-tensor path is the dequantized weight's product
    close(tquant.einsum(torch.from_numpy(x), tw.astype(torch.float32),
                        torch.float32, n_contract=nc), want, **TOL)


def test_gather_rows_and_astype_bit_equal_weight_transform():
    rng = np.random.default_rng(1)
    q, s = qweight(rng, 48, 32)
    jw, tw = both(q, s)
    for dt in (torch.float32, torch.bfloat16):
        deq = tref.weight_transform(torch.from_numpy(q), torch.from_numpy(s),
                                    dt)
        assert torch.equal(tw.astype(dt), deq)
        idx = torch.tensor([[3, 0, 47, 3]])
        assert torch.equal(tquant.gather_rows(tw, idx, dt), deq[idx])
    np.testing.assert_array_equal(
        tw.astype(torch.float32).numpy(),
        np.asarray(jw.astype(jnp.float32)))


@pytest.mark.parametrize("m,k,n", [(100, 70, 33), (17, 300, 5)])
def test_ref_quant_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(m)
    x = rand(rng, m, k)
    q, s = qweight(rng, k, n)
    want = jref.quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                             jnp.float32)
    args = (torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    close(tref.quant_matmul(*args), want, **TOL)
    # the registry on CPU tensors: the plain version, leading dims kept
    got = tops.quant_matmul(args[0].reshape(1, m, k), *args[1:])
    assert tuple(got.shape) == (1, m, n)
    assert torch.equal(got[0], tqm.plain(*args))


def test_quantleaf_is_a_two_child_tree_node():
    rng = np.random.default_rng(2)
    leaves = [tquant.QuantLeaf(*map(torch.from_numpy, qweight(rng, 6, 3, 4)))
              for _ in range(3)]
    stacked = tree_util.tree_map(lambda *xs: torch.stack(xs), *leaves)
    assert isinstance(stacked, tquant.QuantLeaf)
    assert stacked.shape == (3, 6, 3, 4)
    assert tuple(stacked.scale.shape) == (3, 4)
    one = tree_util.tree_map(lambda a: a[1], {"attn": {"wq": stacked}})
    assert torch.equal(one["attn"]["wq"].q, leaves[1].q)
    assert torch.equal(one["attn"]["wq"].scale, leaves[1].scale)
    # one leaf under one name, as the store names it
    assert [p for p, _ in tree_util.leaves_with_path(one)] == [
        ("attn", "wq")]
    assert stacked.nbytes == 3 * (6 * 3 * 4 + 4 * 4)


# ---------------------------------------------------------------------------
# compute_quant cold start from a JAX-deployed int8 store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qsetup(tmp_path_factory):
    """The shared f32/int8 smoke stores, plus the JAX engine's
    compute_quant load of the int8 one (ref mode)."""
    setup = coldstart_setup(str(tmp_path_factory.mktemp("store")))
    tm, ts, batch, _ = setup
    jm = jtransformer.build(dataclasses.replace(
        jget_config("smollm-360m", smoke=True), compute_dtype=jnp.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        jres = JEngine(jm, "q", jstore.WeightStore(ts.root),
                       strategy="cicada", compute_quant=True).load(
            {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)})
    return setup, jm, jres


def tload(qsetup, strategy, **kw):
    (tm, ts, batch, _), _, _ = qsetup
    return TEngine(tm, "q", ts, strategy=strategy, chunk_bytes=1 << 14,
                   device="cpu", **kw).load(batch)


@pytest.mark.parametrize("strategy", ["cicada", "pisel"])
def test_compute_quant_cold_start_matches_jax(qsetup, strategy):
    _, _, jres = qsetup
    res = tload(qsetup, strategy, compute_quant=True)
    np.testing.assert_allclose(res.logits.numpy(),
                               np.asarray(jres.logits), **TOL)
    kinds = {"/".join(p): type(l).__name__
             for p, l in tree_util.leaves_with_path(res.params)}
    # every matrix stays int8 (7 per block, tok, head); norms stay f32
    assert sorted(n for n, k in kinds.items() if k == "QuantLeaf") == sorted(
        ["embed/tok", "final/head/w"] + [f"blocks/s0/{n}" for n in (
            "attn/wk", "attn/wo", "attn/wq", "attn/wv", "mlp/wd", "mlp/wg",
            "mlp/wu")])


def test_compute_quant_resident_bytes_about_a_quarter(qsetup):
    def nbytes(params):
        return sum(l.nbytes if tquant.is_quant(l)
                   else l.numel() * l.element_size()
                   for l in tree_util.leaves(params))

    qb = nbytes(tload(qsetup, "cicada", compute_quant=True).params)
    fb = nbytes(tload(qsetup, "cicada").params)
    assert 0.25 < qb / fb < 0.3


def test_compute_quant_greedy_tokens_equal_jax(qsetup):
    """The port's scheduler on its int8-resident params gives the JAX
    scheduler's greedy tokens on the JAX int8-resident params; the JAX
    tree also carries across through ``params_from_numpy``."""
    (tm, _, _, _), jm, jres = qsetup
    res = tload(qsetup, "cicada", compute_quant=True)
    prompt = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (8,))
    want = JScheduler(jm, jres.params, n_slots=2, cache_len=32).generate(
        JSpec(prompt=prompt.astype(np.int32), n_new=6)).tokens
    got = DecodeScheduler(tm, res.params, n_slots=2, cache_len=32).generate(
        GenerateSpec(prompt=prompt, n_new=6)).tokens
    assert got == want
    carried = ttransformer.params_from_numpy(
        tm.cfg, jax.tree.map(np.asarray, jres.params), device="cpu")
    assert tquant.is_quant(carried["blocks"]["s0"]["attn"]["wq"])
    batch = {"tokens": torch.as_tensor(prompt[None])}
    torch.testing.assert_close(tm.forward(carried, batch)[0],
                               tm.forward(res.params, batch)[0],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# bf16 compute on int8-resident weights: drift from f32 with depth
# ---------------------------------------------------------------------------

def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n_layers", [3, 32])
def test_bf16_drift_from_f32_no_worse_than_jax(tmp_path, n_layers):
    """bf16 compute drifts from f32 as depth grows, in both packages (the
    residual stream is rounded to bf16 after every block: at 32 layers of
    smoke width both drift about 12% of max |logit|).  On the same int8
    weights the port's drift stays within 15% of the JAX package's, so
    the port rounds to bf16 nowhere JAX keeps f32: norm statistics, rope
    or attention scores rounded to bf16 each take the port's drift to
    1.2-2.1x JAX's."""
    jcfg = dataclasses.replace(jget_config("smollm-360m", smoke=True),
                               n_layers=n_layers, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config("smollm-360m", smoke=True),
                               n_layers=n_layers, compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    js = jstore.WeightStore(str(tmp_path))
    jstore.deploy_model(js, jm, "q", jax.random.key(7), quant="int8")
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 32))
    jbatch = {"tokens": jnp.asarray(tok, jnp.int32)}
    jres = JEngine(jm, "q", js, strategy="cicada", compute_quant=True).load(
        jbatch)
    oracle = np.asarray(jres.logits, np.float32)            # JAX, f32
    jbf = jtransformer.build(dataclasses.replace(
        jcfg, compute_dtype=jnp.bfloat16)).forward(jres.params, jbatch)[0]
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jres.params), device="cpu")
    tbatch = {"tokens": torch.as_tensor(tok)}
    tf32 = ttransformer.build(tcfg, device="cpu").forward(tparams, tbatch)[0]
    tbf = ttransformer.build(dataclasses.replace(
        tcfg, compute_dtype=torch.bfloat16), device="cpu").forward(
        tparams, tbatch)[0]
    assert max_rel(tf32, oracle) <= 1e-4
    d_jax, d_port = max_rel(jbf, oracle), max_rel(tbf.float(), oracle)
    print(f"{n_layers} layers: bf16 drift from f32 of max |logit|, port "
          f"{d_port:.3e}, JAX {d_jax:.3e}")
    assert 1e-3 < d_jax                        # bf16 really was computed
    assert d_port <= 1.15 * d_jax, (d_port, d_jax)
