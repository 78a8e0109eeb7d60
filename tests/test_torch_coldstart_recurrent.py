"""The port's ColdStartEngine on mamba2-780m and recurrentgemma-2b smoke
stores the JAX package deployed (f32 compute, ``REPRO_PALLAS=ref``):
every strategy's in-pipeline logits match the JAX ``ColdStartEngine``'s
within 1e-4, for an f32 store, an int8 store (dequantized at A) and an
f32 store cast to bf16 at A (which casts the recurrent blocks' 1-D f32
leaves, ``lam``, ``a_log``, ``d_skip`` and the rest, as the JAX engine
does); ``compute_quant`` keeps the int8 leaves resident."""
import numpy as np
import pytest
import torch

from repro_torch.core import STRATEGIES, ColdStartEngine
from repro_torch.quant import QuantLeaf
from torch_testlib import COLDSTART_TOL as TOL
from torch_testlib import coldstart_setup
from torch_testlib import coldstart_load as load

torch.set_num_threads(2)
ARCHS = ("mamba2-780m", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    return {a: coldstart_setup(str(tmp_path_factory.mktemp(a)), arch=a)
            for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_strategy_matches_reference_engine(setups, arch, strategy):
    res, want = load(setups[arch], strategy)
    np.testing.assert_allclose(res.logits.numpy(), want, **TOL)
    tm, _, batch, _ = setups[arch]
    warm, _ = tm.forward(res.params, batch)
    torch.testing.assert_close(warm, res.logits, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["int8", "bf16-cast"])
def test_cicada_transformed_loads_match(setups, arch, case):
    res, want = load(setups[arch], "cicada", case)
    np.testing.assert_allclose(res.logits.numpy(), want, **TOL)
    if case == "bf16-cast":
        one_d = [v for k, v in res.params["blocks"]["s0"].items()
                 if k in ("ssd", "rglru")][0]
        assert all(v.dtype == torch.bfloat16 for v in one_d.values()
                   if isinstance(v, torch.Tensor))


def test_compute_quant_raises_for_the_recurrent_families(setups):
    """``compute_quant`` loads both families from the int8 store (the
    int8 leaves stay resident as ``QuantLeaf``s), and the logits equal
    the JAX engine's dequant-at-A load of that store within 1e-4."""
    for arch in ARCHS:
        tm, ts, batch, want = setups[arch]
        res = ColdStartEngine(tm, "q", ts, strategy="cicada",
                              compute_quant=True, device="cpu").load(batch)
        np.testing.assert_allclose(res.logits.numpy(), want["int8"], **TOL)
        assert isinstance(res.params["embed"]["tok"], QuantLeaf)
