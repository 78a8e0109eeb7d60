"""Helpers shared by the ``test_torch_*`` files.

Each of those files holds at most 15 tests.  ``--dist loadfile`` hands
whole files to xdist workers, largest first; a port file larger than
``test_generate.py`` (16 tests) would push that file out of the first
round, onto a worker whose earlier files have already warmed the JAX
caches its cold-start TTFT assertion depends on.  Split a file that
outgrows the limit by topic, as the kernels and isolation files are."""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColdStartEngine as JEngine
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.store import store as jstore
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.store import store as tstore

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_files(*packages):
    """The port's ``.py`` files in the named subpackages; ``""`` names the
    package's top-level modules together with ``chip_smoke.py``."""
    out = []
    for pkg in packages:
        if pkg:
            out += sorted((PORT / pkg).rglob("*.py"))
        else:
            out += sorted(PORT.glob("*.py")) + [ROOT / "chip_smoke.py"]
    return out


class _Elsewhere(torch.Tensor):
    """A tensor that claims a device the port does not run on (no CPU, CUDA
    or meta): shape and dtype only, and any op on it raises."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a tensor of another device")


def elsewhere(*shape, dtype=torch.float32) -> torch.Tensor:
    return _Elsewhere(shape, dtype)


def path_id(path):
    return str(path.relative_to(ROOT))


def imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def assert_imports_no_jax_and_no_reference(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)


# ---------------------------------------------------------------------------
# kernel comparisons
# ---------------------------------------------------------------------------

KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or KERNEL_TOL))


# ---------------------------------------------------------------------------
# cold start on stores the JAX package deployed
# ---------------------------------------------------------------------------

COLDSTART_TOL = dict(atol=1e-4, rtol=1e-4)
COLDSTART_ARCH = "smollm-360m"

# (store, apply_dtype name) cases the JAX engine is run on once each
LOADS = {"f32": ("m", None), "int8": ("q", None), "bf16-cast": ("m",
                                                                "bfloat16")}


def coldstart_setup(store_dir, arch=COLDSTART_ARCH):
    """Deploy ``arch``'s smoke config (f32 and int8) with the JAX package,
    load every ``LOADS`` case with the JAX engine in ref mode, and return
    the port's model, a port store on the same directory, the batch, and
    the JAX engine's logits by case."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    js = jstore.WeightStore(store_dir)
    jstore.deploy_model(js, jm, "m", jax.random.key(7))
    jstore.deploy_model(js, jm, "q", jax.random.key(7), quant="int8")
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 16))
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        for case, (name, adt) in LOADS.items():
            eng = JEngine(jm, name, js, strategy="cicada",
                          apply_dtype=getattr(jnp, adt) if adt else None)
            res = eng.load({"tokens": jnp.asarray(tok, jnp.int32)})
            want[case] = np.asarray(res.logits, np.float32)
    tm = ttransformer.build(tcfg, device="cpu")
    ts = tstore.WeightStore(store_dir,
                            tstore.BandwidthModel(bandwidth_mbps=400))
    return tm, ts, {"tokens": torch.as_tensor(tok)}, want


def coldstart_load(setup, strategy, case="f32", **kw):
    """One port cold start on ``setup``; returns it with the JAX logits."""
    tm, ts, batch, want = setup
    name, adt = LOADS[case]
    eng = TEngine(tm, name, ts, strategy=strategy, chunk_bytes=1 << 14,
                  apply_dtype=getattr(torch, adt) if adt else None,
                  device="cpu")
    return eng.load(batch, **kw), want[case]
