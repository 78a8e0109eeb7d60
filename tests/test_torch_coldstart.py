"""The port's ColdStartEngine on stores the JAX package deployed: every
strategy's in-pipeline logits match the JAX ``ColdStartEngine`` within
1e-4 (smollm-360m smoke, f32 compute, ``REPRO_PALLAS=ref``), for an f32
store, an int8 store and an f32 store cast with ``apply_dtype``; and the
assembled params' ``forward`` equals the in-pipeline logits.  The
pipeline trace's structure is checked in ``test_torch_coldstart_trace.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import STRATEGIES
from torch_testlib import COLDSTART_TOL as TOL
from torch_testlib import LOADS, coldstart_setup
from torch_testlib import coldstart_load as load

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return coldstart_setup(str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_strategy_matches_reference_engine(setup, strategy):
    res, want = load(setup, strategy)
    np.testing.assert_allclose(res.logits.numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["int8", "bf16-cast"])
def test_cicada_transformed_loads_match(setup, case):
    res, want = load(setup, "cicada", case)
    np.testing.assert_allclose(res.logits.numpy(), want, **TOL)


@pytest.mark.parametrize("case", sorted(LOADS))
def test_assembled_params_forward_equals_pipeline(setup, case):
    tm, _, batch, _ = setup
    res, _ = load(setup, "cicada", case)
    warm, _ = tm.forward(res.params, batch)
    torch.testing.assert_close(warm, res.logits, rtol=0, atol=0)
