"""The redesigned weight_transform kernel's launch plan
(``weight_transform.plan``) and its walk, emulated on the CPU.

The dequant kernel gives each thread ``vec`` columns and walks it down the
rows; the cast gives each block one tile of float4 units.  ``walk`` below
repeats the kernels' index arithmetic (``csrc/weight_transform.cu``) in
numpy: which elements each launched thread writes.  The tests hold every element written
exactly once, the emulated result bit-equal to the JAX oracle under
``REPRO_PALLAS=ref`` at the path's column widths, and the plan of every
leaf of every config in ``list_archs()`` (shaped as ``_apply_leaves`` shapes
it) on a vector path within the card's limits.  The kernel itself is held
against its plain version on the card by ``chip_smoke.py`` phase 3.
"""
import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import tree as tree_util
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import weight_transform as twt
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config, list_archs

torch.set_num_threads(2)

ALIGNED = (0, 256, 512)        # w, scale, out pointers as torch allocates
GRID_X_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def walk(p: twt.Plan, n: int, m: int, cast: bool):
    """The launch's writes, in the kernels' index arithmetic: the flat
    offset of each element written, and the column whose scale the
    writing thread holds (the dequant's ``(gid % chunks) * vec + i``)."""
    G = p.grid * p.threads
    gid = np.arange(G, dtype=np.int64)
    total = n * m // p.vec                 # chunks (dequant), units (cast)
    lanes = np.arange(p.vec)
    if cast:                               # a tile of UNROLL * threads units
        T, U = p.threads, twt.UNROLL       # a block
        b, t = gid // T, gid % T
        k = (b * U * T + t)[:, None] + np.arange(U) * T
        k = k[k < total]
        offs = (k[:, None] * p.vec + lanes).ravel()
        if p.vec > 1:                      # the n * m % 4 tail
            tail = total * p.vec + gid
            offs = np.concatenate([offs, tail[tail < n * m]])
        return offs, None
    k = gid[:, None] + np.arange(-(-total // G), dtype=np.int64) * G
    held = np.broadcast_to(gid[:, None] % (m // p.vec), k.shape)
    live = k < total
    k, held = k[live], held[live]
    offs = (k[:, None] * p.vec + lanes).ravel()
    held = (held[:, None] * p.vec + lanes).ravel()
    return offs, held


def emulate(p: twt.Plan, w: torch.Tensor, scale, out_dtype) -> torch.Tensor:
    """The launch's result, element by element as the walk writes it, with
    the kernel's arithmetic (one f32 multiply by the scale the thread
    holds, then the output type)."""
    n, m = w.shape
    offs, held = walk(p, n, m, scale is None)
    offs = torch.from_numpy(offs)
    counts = torch.bincount(offs, minlength=n * m)
    assert counts.numel() == n * m and bool((counts == 1).all()), \
        "an element is written more or less than once"
    x = w.reshape(-1)[offs].float()
    if scale is not None:
        x = x * scale[torch.from_numpy(held)]
    out = torch.empty(n * m, dtype=out_dtype)
    out[offs] = x.to(out_dtype)
    return out.reshape(n, m)


def check_limits(p: twt.Plan, n: int, m: int, cast: bool = False):
    """The card's limits, and the walk's invariant for shapes too large to
    walk: a dequant grid's threads are a multiple of a row's chunks (each
    thread keeps its column) or cover the extent in one pass."""
    assert 1 <= p.grid <= GRID_X_MAX and p.threads == twt.THREADS
    G = p.grid * p.threads
    if cast:
        tiles = -(-max(1, n * m // p.vec) // (twt.UNROLL * p.threads))
        assert p.grid == tiles                     # one tile a block
        return
    chunks = m // p.vec
    assert chunks * p.vec == m
    assert G % chunks == 0 or G >= n * chunks
    # about STEPS chunks a thread: fewer only where a row's chunks round
    # the grid up
    unit = chunks // math.gcd(chunks, p.threads)
    assert -(-n * chunks // G) <= twt.STEPS
    assert G >= n * chunks or p.grid - unit < -(-n * chunks // (
        twt.STEPS * p.threads))


@pytest.mark.parametrize("m", [8, 120, 504, 1000, 14336])
def test_dequant_widths_bit_equal_to_jax(m):
    """The main path's column widths that are not multiples of 16
    (mixtral's router, h2o-danube's dh, hubert, the vision heads) and
    mixtral's expert width, at n 1, 3 and 33 rows: one 16-byte store a
    thread a row, four f32 or eight bf16."""
    for n in (1, 3, 33):
        rng = np.random.default_rng(n * m)
        w8 = rng.integers(-127, 128, (n, m)).astype(np.int8)
        sc = (np.abs(rng.standard_normal(m)) * 0.01 + 1e-4).astype(
            np.float32)
        w, s = torch.from_numpy(w8), torch.from_numpy(sc)
        for out in ("float32", "bfloat16"):
            dt = getattr(torch, out)
            want = np.asarray(jref.weight_transform(
                jnp.asarray(w8), jnp.asarray(sc), getattr(jnp, out)),
                np.float32)
            p = twt.plan(n, m, dt, *ALIGNED)
            assert p.path == {"float32": "v4", "bfloat16": "v8"}[out], p
            check_limits(p, n, m)
            got = emulate(p, w, s, dt)
            np.testing.assert_array_equal(got.float().numpy(), want)
            np.testing.assert_array_equal(
                twt.weight_transform(w, s, out_dtype=dt).float().numpy(),
                want)


@pytest.mark.parametrize("n,m,ptrs,paths", [
    (17, 300, (1, 256, 512), ("scalar", "scalar")),   # phase 3's buf[1:]
    (33, 1000, (0, 4, 512), ("scalar", "scalar")),    # scale at 4 mod 16
    (33, 960, (8, 256, 512), ("v8", "v4")),           # w at 8 mod 16
    (33, 960, (4, 256, 512), ("v4", "v4")),           # w at 4 mod 16
    (7, 300, ALIGNED, ("v4", "v4")),                  # m % 8 == 4
    (5, 1003, ALIGNED, ("scalar", "scalar")),         # m % 4 != 0
    (300, 8, ALIGNED, ("v8", "v4"))])                 # one chunk a row
def test_dequant_plan_paths(n, m, ptrs, paths):
    """The pointer and width cases each take the path they can (bf16,
    f32), and the walk covers the extent once, bit-equal to the JAX
    oracle."""
    rng = np.random.default_rng(m)
    w8 = rng.integers(-127, 128, (n, m)).astype(np.int8)
    sc = (np.abs(rng.standard_normal(m)) * 0.05).astype(np.float32)
    for path, dt, jdt in zip(paths, (torch.bfloat16, torch.float32),
                             (jnp.bfloat16, jnp.float32)):
        p = twt.plan(n, m, dt, *ptrs)
        assert p.path == path, (dt, p)
        check_limits(p, n, m)
        got = emulate(p, torch.from_numpy(w8), torch.from_numpy(sc), dt)
        want = jref.weight_transform(jnp.asarray(w8), jnp.asarray(sc), jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_cast_plan_walk():
    """The cast's walk, one tile a block, with a ragged tail of n*m % 4
    elements and from a w not aligned to 16 bytes, bit-equal to the JAX
    oracle."""
    for n, m, ptrs, path in ((50, 130, (0, None, 512), "v4"),
                             (3, 7, (0, None, 512), "v4"),
                             (700, 963, (0, None, 512), "v4"),
                             (2000, 963, (0, None, 512), "v4"),
                             (41, 33, (4, None, 512), "scalar")):
        w = np.random.default_rng(n).standard_normal((n, m)).astype(
            np.float32)
        p = twt.plan(n, m, torch.bfloat16, *ptrs)
        assert p.path == path, p
        check_limits(p, n, m, cast=True)
        got = emulate(p, torch.from_numpy(w), None, torch.bfloat16)
        want = jref.weight_transform(jnp.asarray(w), None, jnp.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("steps", [1, 2, 16, 256])
def test_walk_grid_any_steps(steps):
    """The dequant grids ``ab.py --sweep`` launches (``walk_grid`` at one
    pass up to 256 chunks a thread, the plan's columns) keep the kernel's
    rule: one pass, or a multiple of a row's chunks in threads; the walk
    covers the extent once, each thread on its one column, bit-equal to
    the JAX oracle."""
    rng = np.random.default_rng(steps)
    for n, m, dt, jdt in ((300, 120, torch.bfloat16, jnp.bfloat16),
                          (77, 1000, torch.float32, jnp.float32)):
        w8 = rng.integers(-127, 128, (n, m)).astype(np.int8)
        sc = (np.abs(rng.standard_normal(m)) * 0.05).astype(np.float32)
        p = twt.plan(n, m, dt, *ALIGNED)
        p = p._replace(grid=twt.walk_grid(n, m // p.vec, steps))
        chunks = m // p.vec
        G = p.grid * p.threads
        assert G % chunks == 0 or G >= n * chunks, p
        assert -(-n * chunks // G) <= steps
        got = emulate(p, torch.from_numpy(w8), torch.from_numpy(sc), dt)
        want = jref.weight_transform(jnp.asarray(w8), jnp.asarray(sc), jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def a_phase_extents(shape):
    """The (n, m) extents the A phase hands the kernel for one leaf, as
    ``ColdStartEngine._apply_leaves`` reshapes it: an int8 leaf (ndim >=
    2) as (-1, last), an ``apply_dtype`` cast as (first, -1) or (1, n)."""
    out = []
    if len(shape) >= 2:
        out.append(("dequant", math.prod(shape[:-1]), shape[-1]))
        out.append(("cast", shape[0], math.prod(shape[1:])))
    else:
        out.append(("cast", 1, math.prod(shape)))
    return out


def test_plan_every_leaf_of_every_config():
    """Every dequantized and cast leaf of every config of ``list_archs()``
    (full width, abstract units on the meta device): a vector path at
    aligned pointers, one 16-byte store a thread a row (V = 4 to f32, 8
    to bf16), the walk's invariant and the card's limits, also past 2^31
    elements (arctic's experts); no other output type."""
    extents = set()
    for name in list_archs():
        model = ttransformer.build(get_config(name), device="cpu")
        for unit in model.unit_names():
            for _, leaf in tree_util.leaves_with_path(
                    model.abstract_unit(unit)):
                assert leaf.device.type == "meta"
                extents.update(a_phase_extents(tuple(leaf.shape)))
    dequant_ms = {m for kind, _, m in extents if kind == "dequant"}
    assert all(m % 8 == 0 for m in dequant_ms), sorted(dequant_ms)
    assert {8, 120, 504, 1000} <= dequant_ms
    assert max(n * m for _, n, m in extents) > 2 ** 31
    for kind, n, m in sorted(extents):
        for dt in (torch.float32, torch.bfloat16):
            p = twt.plan(n, m, dt, ALIGNED[0],
                         ALIGNED[1] if kind == "dequant" else None,
                         ALIGNED[2])
            if kind == "dequant":
                assert p.vec == twt.VEC_MAX[dt], (n, m, dt)
            else:
                assert p.path == "v4", (n, m)
            check_limits(p, n, m, cast=kind == "cast")
    with pytest.raises(ValueError, match="float32, bfloat16"):
        twt.plan(4, 16, torch.float16, *ALIGNED)


def test_plan_past_two_to_the_31():
    """Arctic's full-width expert leaf (128 x 7168, 4864) and phase 3's
    (450000, 4864): rows and offsets past 2^31 elements reach the kernel
    as 64-bit values, and the grid stays in ``blockIdx.x``'s range, a
    multiple of the row's chunks in threads; the same walk at a smaller
    extent (a row whose 608 chunks round the grid up to 19 blocks) covers
    it once, each thread on its one column, bit-equal."""
    sig = cuda_lib.SIGNATURES
    assert sig["repro_wt_dequant"][3] is ctypes.c_longlong
    assert sig["repro_wt_cast"][2] is ctypes.c_longlong
    for n, m in ((128 * 7168, 4864), (450000, 4864)):
        assert n * m > 2 ** 31
        for dt in (torch.bfloat16, torch.float32):
            p = twt.plan(n, m, dt, *ALIGNED)
            assert p.path == f"v{twt.VEC_MAX[dt]}"
            check_limits(p, n, m)
            assert (p.grid * p.threads) % (m // p.vec) == 0
        pc = twt.plan(n, m, torch.bfloat16, ALIGNED[0], None, ALIGNED[2])
        check_limits(pc, n, m, cast=True)
    rng = np.random.default_rng(0)
    for n in (400, 40):
        w = torch.from_numpy(rng.integers(-127, 128, (n, 4864)).astype(
            np.int8))
        s = torch.from_numpy(rng.random(4864, dtype=np.float32))
        p = twt.plan(n, 4864, torch.bfloat16, *ALIGNED)
        check_limits(p, n, 4864)
        assert (p.grid * p.threads) % 608 == 0 and \
            p.grid * p.threads < n * 608, p
        assert torch.equal(emulate(p, w, s, torch.bfloat16),
                           twt.plain(w, s, out_dtype=torch.bfloat16))
