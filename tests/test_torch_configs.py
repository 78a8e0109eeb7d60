"""The port's architecture configs against the JAX package's: every
assigned architecture names the same model, at full size and at smoke
size, field for field; the families the port does not build yet raise
with their ROADMAP item."""
import dataclasses

import jax.numpy as jnp
import pytest

from repro.models.api import get_config as jget_config
from repro_torch.configs import ASSIGNED
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import Family
from repro_torch.models.api import get_config as tget_config


@pytest.mark.parametrize("name", sorted(ASSIGNED))
def test_configs_name_the_same_model(name):
    for smoke in (False, True):
        j = jget_config(name, smoke=smoke)
        t = tget_config(name, smoke=smoke)
        for f in dataclasses.fields(j):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if f.name in ("param_dtype", "compute_dtype"):
                assert jnp.dtype(a).name == str(b).split(".")[-1]
            elif f.name == "family":
                assert a.value == b.value
            else:
                assert a == b, (name, f.name)


def test_other_families_name_their_roadmap_item():
    for name in ("mixtral-8x7b", "mamba2-780m", "recurrentgemma-2b",
                 "hubert-xlarge", "internvl2-76b"):
        cfg = tget_config(name, smoke=True)
        assert cfg.family != Family.DENSE
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            ttransformer.build(cfg, device="cpu")
