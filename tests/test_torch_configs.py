"""The port's architecture configs against the JAX package's: every
assigned architecture names the same model, at full size and at smoke
size, field for field and in its derived sizes (``active_param_count``
is the MoE-aware count); every config of ``list_archs()`` builds with the
reference's unit shapes; the recurrent families' paged decode raises
with its ROADMAP item."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.models.api import list_archs as jlist_archs
from repro_torch import tree as tree_util
from repro_torch.configs import ASSIGNED
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import Family
from repro_torch.models.api import get_config as tget_config
from repro_torch.models.api import list_archs as tlist_archs


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
        for helper in ("dh", "q_rep", "is_encoder", "attention_free",
                       "subquadratic"):
            assert getattr(t, helper) == getattr(j, helper), (name, helper)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_every_config_builds_with_the_reference_shapes():
    """Every config of ``list_archs()``, full and smoke, builds on the CPU
    (the LM families and the vision family alike), with the reference's
    units and, unit by unit, its abstract tree's leaf names and shapes."""
    assert tlist_archs() == jlist_archs()
    for name in tlist_archs():
        for smoke in (False, True):
            jm = jtransformer.build(jget_config(name, smoke=smoke))
            tm = ttransformer.build(tget_config(name, smoke=smoke),
                                    device="cpu")
            assert tm.unit_names() == jm.unit_names(), name
            for unit in jm.unit_names():
                want = {jax.tree_util.keystr(p): tuple(leaf.shape)
                        for p, leaf in jax.tree_util.tree_flatten_with_path(
                            jm.abstract_unit(unit))[0]}
                got = {"".join(f"[{k!r}]" if not k.isdigit() else f"[{k}]"
                               for k in p): tuple(leaf.shape)
                       for p, leaf in tree_util.leaves_with_path(
                           tm.abstract_unit(unit))}
                assert got == want, (name, smoke, unit)


def test_other_families_name_their_roadmap_item():
    """The recurrent families build; their paged decode waits for ROADMAP
    queue 1 item 12, and says so.  The other LM families page."""
    for name in ("mamba2-780m", "recurrentgemma-2b"):
        m = ttransformer.build(tget_config(name, smoke=True), device="cpu")
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 12"):
            m.paged_kinds()
    for name in ("smollm-360m", "arctic-480b", "hubert-xlarge",
                 "internvl2-76b"):
        cfg = tget_config(name, smoke=True)
        assert cfg.family != Family.VISION
        assert ttransformer.build(cfg, device="cpu").paged_kinds()
