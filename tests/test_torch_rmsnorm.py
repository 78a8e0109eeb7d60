"""rmsnorm and the rows probe: the repair of the scheduler's bit-identity
with ``reference_generate`` on bf16-resident weights.

The probe (``kernels/ab.py::probe_rows``) runs one decode step at B = 1 and
at B = 4 with the same row in slot 0 and compares every torch op on that
row, each on repaired inputs.  On the card it found one op whose row
depended on the batch: the mean of rmsnorm (PyTorch sizes its reduction's
blocks from the number of rows).  ``csrc/rmsnorm.cu`` sums a row in an
order fixed by ``rmsnorm.plan``, which takes d and the dtypes and never
the row count: a thread's 16-byte chunks in order, the lanes of a warp by
a butterfly, the warps of a row in order.  That order is emulated here
(its fmas by one f64 rounding) and its rows are bit-equal at M in {1, 4,
16}, within 1e-5 of the plain version and of the JAX package's rmsnorm;
so is the backward's (pass 1 by the same plan, pass 2's fixed tree over
the blocks' partial rows), against ``plain_bwd`` and ``jax.vjp``.  The
plan covers every element of each config's width once, its block count
for the backward comes from the rows alone, and it mirrors the ``.cu``'s
constants.  On the CPU the wrapper takes the plain version, which is the
reference's op for op.  The probe itself is held to what it must see:
nothing on a row-independent model, and an op made to depend on the
batch."""
import dataclasses
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch import tree as tree_util
from repro_torch.kernels import ab, ops
from repro_torch.kernels import rmsnorm as trms
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config, list_archs

torch.set_num_threads(2)
CU = pathlib.Path(trms.__file__).parent / "csrc" / "rmsnorm.cu"


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def fma(a, b, c):
    """f32 fma: the product exact in f64, one rounding of the sum."""
    return (a.double() * b.double() + c.double()).float()


def chunks(t: torch.Tensor, v: int, threads: int) -> torch.Tensor:
    """(..., d) as (..., K, threads, v): element [k, i, j] is element j of
    chunk i + k threads (zero past d)."""
    d = t.shape[-1]
    k = -(-(-(-d // v)) // threads)           # chunks a thread: ceil(C / T)
    t = torch.nn.functional.pad(t, (0, k * threads * v - d))
    return t.reshape(*t.shape[:-1], k, threads, v)


def row_sum(a: torch.Tensor, b: torch.Tensor, threads: int) -> torch.Tensor:
    """The kernels' sum of a b over each row of (..., K, threads, v) f32:
    a thread's chunks in order, a chunk's elements in order, each term by
    an fma; the lanes by the butterfly xor 16, 8, 4, 2, 1; the row's warps
    in order."""
    s = torch.zeros(a.shape[:-3] + (threads,))
    for k in range(a.shape[-3]):
        for j in range(a.shape[-1]):
            s = fma(a[..., k, :, j], b[..., k, :, j], s)
    s = s.reshape(*s.shape[:-1], threads // 32, 32)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ off]
    total = torch.zeros(s.shape[:-2])
    for w in range(threads // 32):
        total = total + s[..., w, 0]
    return total


def inv(d: int) -> torch.Tensor:
    return torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(d), dtype=torch.float32)


def kernel_r(x: torch.Tensor, p: trms.Plan, eps: float):
    """r of every row of x as both kernels compute it, and x's chunks."""
    d = x.shape[-1]
    xc = chunks(x.float(), trms.chunk_elems(x.dtype), p.threads)
    total = row_sum(xc, xc, p.threads)
    return torch.rsqrt(fma(total, inv(d), torch.tensor(eps))), xc


def kernel_order(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """csrc/rmsnorm.cu's forward by rmsnorm.plan: r from the sum of
    squares in the kernel's order, then (x r)(1 + scale) rounded once."""
    p = trms.plan(x.shape[-1], x.dtype, scale.dtype)
    r, _ = kernel_r(x, p, eps)
    return ((x.float() * r[..., None]) * (1.0 + scale.float())).to(x.dtype)


def kernel_bwd(x, scale, g, eps: float = 1e-6):
    """csrc/rmsnorm.cu's backward by rmsnorm.plan on (M, d) rows: pass 1
    (r as the forward's, sum(g w x) in the same order, dx, each thread's
    g x r over its team's rows in row order in f32, the teams in team
    order in f64); pass 2 in f64 (warp w of a column's block adds partial
    rows w, w + 8, ... in order, then the warps in order), rounded once to
    f32.  Returns (dx, dscale f32, r)."""
    M, d = x.shape
    p = trms.plan(d, x.dtype, scale.dtype)
    v = trms.chunk_elems(x.dtype)
    r, xc = kernel_r(x, p, eps)
    gc = chunks(g.float(), v, p.threads)
    wc = chunks(1.0 + scale.float(), v, p.threads)
    u = row_sum(gc * wc, xc, p.threads)
    cf = ((r * r) * r) * (u * inv(d))
    xf, gf = x.float(), g.float()
    w = 1.0 + scale.float()
    dx = fma(-xf, cf[:, None], (r[:, None] * gf) * w).to(x.dtype)
    teams = trms.bwd_teams(p)
    per_team = p.bwd_rows // teams
    nb = trms.bwd_blocks(p, M)
    # row b bwd_rows + i teams + q is block b's team q's i-th (rows past M
    # add exact zeros)
    gx = torch.zeros(nb * p.bwd_rows, d)
    rp = torch.zeros(nb * p.bwd_rows, 1)
    gx[:M], rp[:M, 0] = gf * xf, r
    gx = gx.reshape(nb, per_team, teams, d)
    rp = rp.reshape(nb, per_team, teams, 1)
    acc = torch.zeros(nb, teams, d)
    for i in range(per_team):
        acc = fma(gx[:, i], rp[:, i], acc)
    part = acc[:, 0].double()                      # f64 from here on
    for q in range(1, teams):
        part = part + acc[:, q].double()
    rw = trms.REDUCE_WARPS
    pad = torch.zeros(-(-nb // rw) * rw, d, dtype=torch.float64)
    pad[:nb] = part
    pad = pad.reshape(-1, rw, d)
    s = torch.zeros(rw, d, dtype=torch.float64)
    for i in range(pad.shape[0]):
        s = s + pad[i]
    dscale = torch.zeros(d, dtype=torch.float64)
    for q in range(rw):
        dscale = dscale + s[q]
    return dx, dscale.float(), r


# the widths the configs normalise (d_model, mamba2's gated norm over
# ssm_expand * d_model), full and smoke
CONFIG_WIDTHS = sorted({w for arch in list_archs() for smoke in (False, True)
                        for cfg in [get_config(arch, smoke=smoke)]
                        if cfg.norm == "rmsnorm" and cfg.d_model
                        for w in (cfg.d_model, cfg.ssm_expand * cfg.d_model
                                  if cfg.ssm_state else cfg.d_model)})


@pytest.mark.parametrize("d", [20, 960, 2560, 3072, 4096, 8192, 1001])
def test_kernel_order_rows_bit_equal_and_close(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((16, d), dtype=np.float32)) * 3
    scale = torch.from_numpy(rng.standard_normal(d, dtype=np.float32)) * 0.1
    rows = torch.cat([kernel_order(x[i:i + 1], scale) for i in range(16)])
    for m in (1, 4, 16):
        assert torch.equal(kernel_order(x[:m], scale), rows[:m])
    torch.testing.assert_close(rows, trms.plain(x, scale), atol=1e-5,
                               rtol=1e-5)
    want = jlayers.rmsnorm(jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()))
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("d,dt", [(20, torch.float32), (960, torch.float32),
                                  (960, torch.bfloat16), (1001, torch.float32),
                                  (2560, torch.float32),
                                  (3072, torch.bfloat16),
                                  (8192, torch.float32)])
def test_kernel_bwd_order_rows_bit_equal_and_close(d, dt):
    """The backward's emulated order: dx rows bit-equal at M in {1, 4,
    16}, r the forward's bit for bit, dx and dscale within 1e-5 (f32) of
    plain_bwd and of jax.vjp of the reference's rmsnorm (bf16: one bf16
    step of dx against plain_bwd in bf16)."""
    rng = np.random.default_rng(d + 1)
    x = (torch.from_numpy(rng.standard_normal((21, d), dtype=np.float32))
         * 3).to(dt)
    scale = torch.from_numpy(rng.standard_normal(d, dtype=np.float32)) * 0.1
    g = torch.from_numpy(rng.standard_normal((21, d),
                                             dtype=np.float32)).to(dt)
    dx, dscale, r = kernel_bwd(x, scale, g)
    p = trms.plan(d, dt, scale.dtype)
    assert torch.equal(r, kernel_r(x, p, 1e-6)[0])
    for m in (1, 4, 16):
        assert torch.equal(kernel_bwd(x[:m], scale, g[:m])[0], dx[:m])
    assert torch.equal(kernel_bwd(x[5:6], scale, g[5:6])[0], dx[5:6])
    pdx, pds = trms.plain_bwd(x, scale, g)
    if dt == torch.float32:
        torch.testing.assert_close(dx, pdx, atol=1e-5, rtol=1e-5)
        _, vjp = jax.vjp(jlayers.rmsnorm, jnp.asarray(x.numpy()),
                         jnp.asarray(scale.numpy()))
        jdx, jds = vjp(jnp.asarray(g.numpy()))
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(dscale.numpy(), np.asarray(jds),
                                   atol=1e-5 * float(np.abs(jds).max()),
                                   rtol=1e-5)
    else:
        step = float(pdx.float().abs().max()) * 2 ** -7
        assert float((dx.float() - pdx.float()).abs().max()) <= step
    torch.testing.assert_close(dscale, pds.float(), rtol=1e-5,
                               atol=1e-5 * float(pds.abs().max()))


def test_plan_takes_no_row_count():
    """plan's arguments are (d, x_dtype, scale_dtype): a row's order, its
    threads and chunks, cannot follow the batch; the wrapper allocates
    the backward's partial rows by bwd_blocks from the rows alone."""
    assert list(inspect.signature(trms.plan).parameters) == [
        "d", "x_dtype", "scale_dtype"]
    assert list(inspect.signature(trms.bwd_blocks).parameters) == [
        "p", "rows"]
    for d in CONFIG_WIDTHS:
        for dt in (torch.float32, torch.bfloat16):
            p = trms.plan(d, dt, torch.float32)
            assert p == trms.plan(d, dt, torch.bfloat16)
            teams = trms.bwd_teams(p)
            assert p.bwd_rows % teams == 0
            assert max(p.rows, teams) * p.threads <= trms.BLOCK
            assert [trms.bwd_blocks(p, m) for m in (1, p.bwd_rows,
                                                    p.bwd_rows + 1)] == \
                [1, 1, 2]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plan_covers_every_element_once(dt):
    """Every config's width (and phase 3's 20): each thread's chunks t +
    k threads, k < the instance's chunks, each read in vec-wide pieces,
    cover every element of the row exactly once and nothing past it; the
    instance stays within MAX_CHUNKS; a wide plan has d a multiple of its
    16-byte vector."""
    assert {960, 1536, 2560, 3072, 3840, 4096, 7168, 8192, 60, 64} <= \
        set(CONFIG_WIDTHS)
    for d in CONFIG_WIDTHS + [20, 1001]:
        p = trms.plan(d, dt, torch.float32)
        v = trms.chunk_elems(dt)
        cpt = trms.chunks_a_thread(d, dt, p.threads)
        assert cpt <= trms.MAX_CHUNKS and p.vec in (1, v)
        assert p.vec == 1 or d % p.vec == 0
        seen = np.zeros(cpt * p.threads * v, dtype=np.int64)
        for t in range(p.threads):
            for k in range(cpt):
                c = t + k * p.threads
                if c * v >= d:
                    continue
                for j0 in range(0, v, p.vec):
                    n = min(p.vec, d - c * v - j0)
                    if n > 0:
                        seen[c * v + j0:c * v + j0 + n] += 1
        assert (seen[:d] == 1).all() and not seen[d:].any(), d
        # one warp a row up to WARP_CHUNKS chunks a thread, else as few
        # warps as keep a thread at ROW_CHUNKS
        c = -(-d // v)
        want = 32 if c <= 32 * trms.WARP_CHUNKS else next(
            (t for t in (64, 128) if c <= t * trms.ROW_CHUNKS), 256)
        assert p.threads == want


def test_bwd_blocks_do_not_depend_on_the_card(monkeypatch):
    """The backward's block count (and the partial's rows) come from the
    rows and the plan: no SM count is read, here or in the source."""
    def no_props(*a, **k):
        raise AssertionError("the card was asked")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_props)
    p = trms.plan(960, torch.bfloat16, torch.float32)
    assert trms.bwd_blocks(p, 8 * 512) == 8 * 512 // p.bwd_rows == 128
    assert trms.bwd_blocks(p, 21) == 1
    src = CU.read_text()
    for word in ("multiProcessorCount", "cudaDeviceGetAttribute",
                 "cudaGetDeviceProperties", "cudaOccupancy"):
        assert word not in src


def test_plan_mirrors_the_cu_constants():
    consts = dict(re.findall(r"constexpr int (\w+) = ([0-9* ]+);",
                             CU.read_text()))
    for name in ("BLOCK", "CHUNK_BYTES", "MAX_CHUNKS", "REDUCE_COLS",
                 "REDUCE_WARPS", "SMEM_LIMIT"):
        assert eval(consts[name]) == getattr(trms, name), name
    # the instances the entries dispatch to: every power of two up to
    # MAX_CHUNKS
    cases = {int(c) for c in re.findall(r"case (\d+): return Fn<",
                                        CU.read_text())}
    assert cases == {1 << i for i in range(trms.MAX_CHUNKS.bit_length())}
    # the backward's team sums fit its shared memory at every plan
    for d in CONFIG_WIDTHS + [20, 1001]:
        for dt in (torch.float32, torch.bfloat16):
            p = trms.plan(d, dt, dt)
            v = trms.chunk_elems(dt)
            teams = trms.bwd_teams(p)
            if teams > 1:
                assert teams * -(-d // v) * v * 4 <= trms.SMEM_LIMIT


def test_source_has_no_float_atomics_and_16_byte_accesses():
    src = re.sub(r"//.*", "", CU.read_text())          # the code alone
    assert "atomic" not in src.lower()
    assert re.search(r"__ldg\(reinterpret_cast<const uint4\*>", src)
    assert re.search(r"\*reinterpret_cast<uint4\*>\(p\) = ", src)
    assert "float4" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_reference_op_for_op(dtype):
    """The CPU path (layers.rmsnorm -> ops.rmsnorm -> plain) against the
    JAX rmsnorm: f32 within 1e-6, bf16 within one bf16 step."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64), dtype=np.float32))
    scale = torch.from_numpy(rng.standard_normal(64, dtype=np.float32)) * 0.1
    got = tlayers.rmsnorm(x.to(dtype), scale.to(dtype))
    assert got.dtype == dtype and torch.equal(
        got, trms.plain(x.to(dtype), scale.to(dtype)))
    want = jlayers.rmsnorm(jnp.asarray(x.to(dtype).float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(scale.to(dtype).float().numpy()))
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_registry_carries_rmsnorm():
    spec = ops.registry.spec("rmsnorm")
    assert spec.source.endswith("csrc/rmsnorm.cu")
    assert spec.replaces == "src/repro/models/layers.py:44"
    ops.registry.reset_counts()
    tlayers.rmsnorm(torch.ones(2, 8), torch.zeros(8))
    assert ops.registry.dispatch_snapshot()["rmsnorm"] == 0   # CPU: plain


def bf16_model(arch):
    cfg = get_config(arch, smoke=True)
    model = ttransformer.build(cfg, device="cpu")
    params = tree_util.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
        model.init(0))
    base = np.random.default_rng(0).integers(0, cfg.vocab_size, (40,))
    return model, params, [base[:s] for s in (40, 7, 13, 29)]


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
def test_probe_sees_no_batch_dependence_in_a_row_independent_step(arch):
    model, params, prompts = bf16_model(arch)
    r = ab.probe_rows(model, params, prompts, cache_len=64)
    assert r["misaligned"] is None and r["compared"] == r["ops"] > 100
    assert r["first"] is None and not r["sources"] and r["logits_equal"]


def test_probe_finds_an_op_that_depends_on_the_batch(monkeypatch):
    """A norm made to scale its rows by the batch size: the probe names
    its op and the line of the model that called it, and only that op
    (every later op is judged on repaired inputs)."""
    model, params, prompts = bf16_model("smollm-360m")

    def batch_norm(x, scale, eps=1e-6):
        return trms.plain(x, scale, eps) * (1.0 + 0.01 * (x.shape[0] - 1))

    monkeypatch.setattr(ops, "rmsnorm", batch_norm)
    r = ab.probe_rows(model, params, prompts, cache_len=64)
    n_norms = 2 * model.cfg.n_layers + 1
    assert r["first"] is not None and "models/layers.py" in r["first"]
    assert sum(r["sources"].values()) == n_norms
    assert all(w.startswith("mul at repro_torch/models/layers.py")
               for w in r["sources"])
