"""The port's weight store against the JAX package's: same bytes on disk,
and each reads the other's stores leaf for leaf (f32 and int8)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.store import store as jstore
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.store import store as tstore

torch.set_num_threads(2)
QUANTS = [None, "int8"]


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _leaf_equal(t_leaves, j_leaves):
    assert sorted(t_leaves) == sorted(j_leaves)
    for name, (arr, scale) in j_leaves.items():
        tarr, tscale = t_leaves[name]
        np.testing.assert_array_equal(tarr.numpy(), np.asarray(arr))
        assert (scale is None) == (tscale is None), name
        if scale is not None:
            np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))


@pytest.fixture(scope="module")
def jax_units():
    m = jtransformer.build(jget_config("smollm-360m", smoke=True))
    keys = jax.random.split(jax.random.key(7), len(m.unit_names()))
    return m, {u: jax.tree.map(np.asarray, m.init_unit(u, k))
               for u, k in zip(m.unit_names(), keys)}


@pytest.mark.parametrize("quant", QUANTS)
def test_port_reads_reference_store(tmp_path, jax_units, quant):
    m, units = jax_units
    js = jstore.WeightStore(str(tmp_path))
    js.deploy("m", units, quant=quant)
    ts = tstore.WeightStore(str(tmp_path))
    assert ts.manifest("m") == js.manifest("m")
    for u in m.unit_names():
        _leaf_equal(ts.read_and_deserialize("m", u, chunk_bytes=1 << 12),
                    js.read_and_deserialize("m", u))


@pytest.mark.parametrize("quant", QUANTS)
def test_reference_reads_port_store(tmp_path, quant):
    cfg = tget_config("smollm-360m", smoke=True)
    m = ttransformer.build(cfg, device="cpu")
    ts = tstore.WeightStore(str(tmp_path))
    tstore.deploy_model(ts, m, "m", seed=3, quant=quant)
    js = jstore.WeightStore(str(tmp_path))
    for u in m.unit_names():
        _leaf_equal(ts.read_and_deserialize("m", u),
                    js.read_and_deserialize("m", u))
    if quant is None:       # f32 leaves read back as what was deployed
        gen = torch.Generator().manual_seed(ttransformer.unit_seed(3, 1))
        want = m.init_unit("block_000", gen)
        got = js.read_and_deserialize("m", "block_000")
        np.testing.assert_array_equal(np.asarray(got["attn/wq"][0]),
                                      want["attn"]["wq"].numpy())


@pytest.mark.parametrize("quant", QUANTS)
def test_same_params_same_bytes(tmp_path, jax_units, quant):
    """Both packages deploy one parameter set to identical files."""
    m, units = jax_units
    jstore.WeightStore(str(tmp_path / "j")).deploy("m", units, quant=quant)
    tunits = {u: jax.tree.map(_tensor, t) for u, t in units.items()}
    tstore.WeightStore(str(tmp_path / "t")).deploy("m", tunits, quant=quant)
    for name in ["manifest.json"] + [f"{u}.bin" for u in m.unit_names()]:
        with open(tmp_path / "j" / "m" / name, "rb") as a, \
                open(tmp_path / "t" / "m" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_crc_mismatch_raises(tmp_path, jax_units):
    m, units = jax_units
    jstore.WeightStore(str(tmp_path)).deploy("m", units)
    path = tmp_path / "m" / "block_000.bin"
    raw = bytearray(path.read_bytes())
    raw[0] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc mismatch"):
        tstore.WeightStore(str(tmp_path)).read_and_deserialize("m",
                                                               "block_000")


def test_gated_read_waits_and_reports_progress(tmp_path, jax_units):
    """A read parks between chunks while its gate is cleared."""
    import threading
    m, units = jax_units
    ts = tstore.WeightStore(str(tmp_path))
    ts.deploy("m", units)
    gate = threading.Event()
    seen = []
    out = []
    t = threading.Thread(target=lambda: out.append(ts.read_unit(
        "m", "embed", chunk_bytes=1 << 10, gate=gate,
        on_progress=lambda d, n: seen.append(d))))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not seen
    gate.set()
    t.join(10)
    assert not t.is_alive()
    assert seen[-1] == ts.unit_nbytes("m", "embed") == out[0].numel()
    assert seen == sorted(seen)


def test_manifest_layout_is_aligned(tmp_path, jax_units):
    m, units = jax_units
    man = tstore.WeightStore(str(tmp_path)).deploy(
        "m", {u: jax.tree.map(_tensor, t) for u, t in units.items()},
        quant="int8")
    with open(os.path.join(tmp_path, "m", "manifest.json")) as f:
        assert json.load(f) == man
    for rec in man["units"]["block_000"]["extents"]:
        assert rec["offset"] % tstore.ALIGN == 0
