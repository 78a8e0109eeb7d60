"""The port's shape cells and abstract values against the JAX package's:
``SHAPES``, ``smoke_cell`` and ``supported`` for every assigned arch and
cell; ``LM.abstract_cache`` and ``LM.input_specs`` (meta tensors) leaf for
leaf against the reference's ``jax.eval_shape`` / ``ShapeDtypeStruct``s
in shape and dtype; ``miniloader.n_params`` for every arch; and the
pipeline trace's ``memory_total_bytes`` and ``gantt_rows`` on scripted
events and on one resnet50-smoke MiniLoader cold start from a store the
JAX package deployed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import ColdStartEngine as JEngine
from repro.core import miniloader as jminiloader
from repro.core import pipeline as jpipeline
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.models.api import list_archs
from repro.store import store as jstore
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.core import miniloader as tminiloader
from repro_torch.core import pipeline as tpipeline
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.store.store import WeightStore

torch.set_num_threads(2)


def jspecs(tree):
    """{path: (shape, dtype name)} of a JAX abstract tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): (tuple(leaf.shape), jnp.dtype(
                         leaf.dtype).name)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def tspecs(tree):
    """{path: (shape, dtype name)} of a port tree, all of it on meta."""
    leaves = list(tree_util.leaves_with_path(tree))
    assert all(leaf.device.type == "meta" for _, leaf in leaves)
    return {"/".join(p): (tuple(leaf.shape),
                          str(leaf.dtype).replace("torch.", ""))
            for p, leaf in leaves}


def test_shape_cells_match_reference():
    assert set(tconfigs.SHAPES) == set(jconfigs.SHAPES)
    for name, cell in jconfigs.SHAPES.items():
        assert dataclasses.astuple(tconfigs.SHAPES[name]) == \
            dataclasses.astuple(cell)
    for kind in ("train", "prefill", "decode"):
        assert dataclasses.astuple(tconfigs.smoke_cell(kind)) == \
            dataclasses.astuple(jconfigs.smoke_cell(kind))
    with pytest.raises(KeyError):
        tconfigs.smoke_cell("serve")


def test_supported_matches_reference():
    skipped = 0
    for arch in jconfigs.ASSIGNED:
        for smoke in (False, True):
            jcfg = jget_config(arch, smoke=smoke)
            tcfg = tget_config(arch, smoke=smoke)
            for name, cell in jconfigs.SHAPES.items():
                want = jconfigs.supported(jcfg, cell)
                assert tconfigs.supported(tcfg, tconfigs.SHAPES[name]) == \
                    want, (arch, smoke, name)
                skipped += not want[0]
    assert skipped > 0 and set(tconfigs.ASSIGNED) == set(jconfigs.ASSIGNED)


@pytest.mark.parametrize("arch", sorted(jconfigs.ASSIGNED))
def test_abstract_cache_and_input_specs_match_reference(arch):
    jm = jtransformer.build(jget_config(arch, smoke=True))
    tm = ttransformer.build(tget_config(arch, smoke=True), device="cpu")
    for batch, cache_len in ((2, 64), (1, 7)):
        got = tspecs(tm.abstract_cache(batch, cache_len))
        assert got == jspecs(jm.abstract_cache(batch, cache_len))
        real = {"/".join(p): (tuple(leaf.shape),
                              str(leaf.dtype).replace("torch.", ""))
                for p, leaf in tree_util.leaves_with_path(
                    tm.init_cache(batch, cache_len))}
        assert got == real
    for kind in ("train", "prefill", "decode"):
        cell = tconfigs.smoke_cell(kind)
        for seq, batch in ((cell.seq, cell.batch), (600, 3)):
            got = tspecs(tm.input_specs(kind, seq, batch))
            assert got == jspecs(jm.input_specs(kind, seq, batch)), \
                (kind, seq, batch)


def test_n_params_matches_reference():
    for arch in list_archs():
        for smoke in (False, True):
            jm = jtransformer.build(jget_config(arch, smoke=smoke))
            tm = ttransformer.build(tget_config(arch, smoke=smoke),
                                    device="cpu")
            want = jminiloader.n_params(jm.abstract())
            assert tminiloader.n_params(tm.abstract()) == want, (arch, smoke)
            name = tm.unit_names()[-1]
            assert tminiloader.n_params(tm.abstract_unit(name)) == \
                jminiloader.n_params(jm.abstract_unit(name)), (arch, name)


EVENTS = [("L", "embed", 0.1, 0.5), ("R", "embed", 0.2, 2.0),
          ("L", "block_000", 0.5, 1.0), ("R", "block_000", 0.3, 2.5),
          ("A", "embed", 2.0, 2.2), ("E", "embed", 2.3, 2.4),
          ("A", "block_000", 2.5, 3.0), ("E", "block_000", 3.5, 4.0),
          ("T", "block_000", 2.4, 2.6, {"shard": 1})]
MEMORY = [("embed", 1000, 0.5, 2.2), ("block_000", 500, 1.0, 3.0),
          ("final", 24, 3.1, 3.2)]


def scripted(mod, t0):
    tr = mod.PipelineTrace()
    tr.t0 = t0
    for ev in EVENTS:
        tr.add_event(*ev)
    for m in MEMORY:
        tr.record_memory(*m)
    return tr


def test_trace_memory_total_and_gantt_rows_match_reference():
    # the rows count from t0, or from the first event where t0 is unset
    for t0 in (0.0, None):
        t, j = scripted(tpipeline, t0), scripted(jpipeline, t0)
        assert t.memory_total_bytes() == j.memory_total_bytes() == 1524
        assert t.gantt_rows() == pytest.approx(j.gantt_rows())
    assert [g["stage"] for g in t.gantt_rows()] == \
        ["L", "R", "R", "L", "A", "E", "T", "A", "E"]


def rows_by_unit_row(trace):
    """{Gantt row: [(stage, layer), ...] in start order}: the interleaving
    of the rows is the threads' and varies from run to run, each row's
    own order does not."""
    out = {}
    for g in trace.gantt_rows():
        out.setdefault(g["row"], []).append((g["stage"], g["layer"]))
    return out


def test_mini_load_trace_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")
    jm = jtransformer.build(jget_config("resnet50", smoke=True))
    js = jstore.WeightStore(str(tmp_path))
    jstore.deploy_model(js, jm, "m", jax.random.key(0))
    img = np.random.default_rng(0).standard_normal(
        (1, 3, jm.cfg.img_res, jm.cfg.img_res)).astype(np.float32)
    want = JEngine(jm, "m", js, strategy="mini").load(
        {"image": jnp.asarray(img)}).trace
    tm = ttransformer.build(tget_config("resnet50", smoke=True),
                            device="cpu")
    got = TEngine(tm, "m", WeightStore(str(tmp_path)), strategy="mini",
                  device="cpu").load({"image": torch.as_tensor(img)}).trace
    assert got.memory_total_bytes() == want.memory_total_bytes() > 0
    assert got.memory_total_bytes() == sum(
        -(-tminiloader.n_params(tm.abstract_unit(n)) // 8)
        for n in tm.unit_names())
    assert rows_by_unit_row(got) == rows_by_unit_row(want)
    rows = got.gantt_rows()
    assert len(rows) == len(got.events) == 4 * len(tm.unit_names())
    starts = [g["start"] for g in rows]
    assert starts == sorted(starts) and starts[0] >= 0
    assert all(g["end"] >= g["start"] for g in rows)
