"""The port's architecture configs against the JAX package's: every
assigned architecture names the same model, at full size and at smoke
size, field for field and in its derived sizes (``active_param_count``
is the MoE-aware count); every config of ``list_archs()`` builds with the
reference's unit shapes; every LM config pages the layers the
reference pages."""
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
    """Every LM config pages as the reference pages it: the same paged
    kinds, prefix-cache support and page bytes, full and smoke.  Only
    full-attention layers page: mamba2 none (0 bytes a page),
    recurrentgemma its 8 ``attn`` layers."""
    for name in tlist_archs():
        for smoke in (False, True):
            cfg = tget_config(name, smoke=smoke)
            if cfg.family == Family.VISION:
                continue
            tm = ttransformer.build(cfg, device="cpu")
            jm = jtransformer.build(jget_config(name, smoke=smoke))
            assert tm.paged_kinds() == sorted(jm.paged_kinds()), name
            assert tm.supports_prefix_cache == jm.supports_prefix_cache
            assert tm.kv_page_bytes(16) == jm.kv_page_bytes(16), name
    mamba = ttransformer.build(tget_config("mamba2-780m"), device="cpu")
    assert mamba.paged_kinds() == [] and mamba.kv_page_bytes(16) == 0
    full = ttransformer.build(tget_config("recurrentgemma-2b"), device="cpu")
    assert full.paged_kinds() == ["attn"]
    assert full.kv_page_bytes(16) == 8 * 2 * 1 * 16 * 256 * 2
