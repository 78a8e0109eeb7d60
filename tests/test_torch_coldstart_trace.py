"""The port's ColdStartEngine's pipeline trace, on a store the JAX package
deployed (smollm-360m smoke, f32): every strategy gives every unit its
L, R, A and E events in dependency order, and ``on_logits`` fires inside
the final E with the logits the load returns."""
import time

import pytest
import torch

from repro_torch.core import STRATEGIES
from torch_testlib import coldstart_load as load
from torch_testlib import coldstart_setup

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return coldstart_setup(str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_every_unit_has_all_stages(setup, strategy):
    tm = setup[0]
    res, _ = load(setup, strategy)
    tr = res.trace
    units = set(tm.unit_names())
    for stage in "LRAE":
        assert set(tr.events_for(stage)) == units, stage
    L, A, E = (tr.events_for(s) for s in "LAE")
    for u in units:
        assert A[u].t_end >= L[u].t_end - 1e-6
        assert E[u].t_start >= A[u].t_end - 1e-6
    ee = [E[u] for u in tm.unit_names()]
    for a, b in zip(ee, ee[1:]):
        assert b.t_start >= a.t_end - 1e-6
    assert 0.0 < tr.utilization() <= 1.0


@pytest.mark.parametrize("strategy", ["cicada", "traditional"])
def test_on_logits_fires_inside_final_e(setup, strategy):
    seen = []
    res, _ = load(setup, strategy, on_logits=lambda lg: seen.append(
        (lg.clone(), time.monotonic())))
    assert len(seen) == 1
    e = res.trace.events_for("E")["final"]
    assert e.t_start <= seen[0][1] <= e.t_end
    torch.testing.assert_close(seen[0][0], res.logits, rtol=0, atol=0)
