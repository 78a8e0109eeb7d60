"""The port's parameter trees walk lists as ``jax.tree_util`` does: in
numeric index order (``blocks/10`` after ``blocks/9``).  The vision unit
trees (ResNet ``{"blocks": [...]}``, VGG ``{"convs": [...]}``) name and
order their leaves as the JAX package's ``tree_flatten_with_path``
through ``leaf_path_name``, and a resnet101-smoke store the JAX package
deployed (int8) reads back through the port's ``WeightStore`` and
``unflatten_unit`` with every leaf's bytes equal; the port deploys the
same parameters to the same bytes."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.store import store as jstore
from repro_torch import tree as tree_util
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.store import store as tstore

torch.set_num_threads(2)


def test_lists_and_tuples_walk_in_numeric_index_order():
    tree = {"b": [{"w": 1}, (2, 3)] + [{"w": i} for i in range(4, 14)],
            "a": 0}
    paths = [p for p, _ in tree_util.leaves_with_path(tree)]
    assert paths[:4] == [("a",), ("b", "0", "w"), ("b", "1", "0"),
                         ("b", "1", "1")]
    assert paths[-2:] == [("b", "10", "w"), ("b", "11", "w")]
    assert tree_util.leaves(tree) == list(range(14))
    # the order jax flattens the same tree in, names through the store's
    # leaf_path_name
    want = [jstore.leaf_path_name(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert ["/".join(p) for p in paths] == want
    doubled = tree_util.tree_map(lambda x, y: x + y, tree, tree)
    assert type(doubled["b"]) is list and type(doubled["b"][1]) is tuple
    assert tree_util.leaves(doubled) == [2 * i for i in range(14)]
    named = {"/".join(p): -v for p, v in tree_util.leaves_with_path(tree)}
    back = tree_util.unflatten(tree, named)
    assert tree_util.tree_map(lambda x: -x, back) == tree
    assert type(back["b"]) is list and type(back["b"][1]) is tuple


@pytest.mark.parametrize("arch", ["resnet101", "vgg16", "vit_b_16"])
def test_vision_unit_leaves_match_jax(arch):
    """Per unit of the smoke config: the port's abstract leaves carry the
    JAX abstract tree's names, order, shapes and dtypes."""
    jm = jtransformer.build(jget_config(arch, smoke=True))
    tm = ttransformer.build(tget_config(arch, smoke=True), device="cpu")
    jab = jm.abstract()
    assert tm.unit_names() == jm.unit_names()
    assert sorted(tm.abstract()) == sorted(jab)
    for name in jm.unit_names():
        want = [(jstore.leaf_path_name(p), tuple(a.shape), str(a.dtype))
                for p, a in jax.tree_util.tree_flatten_with_path(
                    jab[name])[0]]
        got = [(tstore.leaf_path_name(p), tuple(a.shape),
                str(a.dtype).split(".")[-1])
               for p, a in tree_util.leaves_with_path(
                   tm.abstract_unit(name))]
        assert got == want, name
    if arch == "resnet101":                     # the 23-block stage
        blocks = [tstore.leaf_path_name(p).split("/")[1]
                  for p, _ in tree_util.leaves_with_path(
                      tm.abstract_unit("stage3"))]
        assert blocks == sorted(blocks, key=int)
        assert len(set(blocks)) == 23


def test_resnet101_int8_store_round_trips(tmp_path):
    """A resnet101-smoke int8 store deployed by the JAX package: the port
    reads each unit, its leaves byte-equal to the JAX reader's, rebuilt
    into the port's unit trees (lists in index order); the port's deploy
    of the same parameters writes the same bytes."""
    cfg = jget_config("resnet101", smoke=True)
    jm = jtransformer.build(cfg)
    keys = jax.random.split(jax.random.key(5), len(jm.unit_names()))
    units = {n: jax.tree_util.tree_map(np.asarray, jm.init_unit(n, k))
             for n, k in zip(jm.unit_names(), keys)}
    js = jstore.WeightStore(str(tmp_path / "j"))
    js.deploy(cfg.name, units, quant="int8")
    tm = ttransformer.build(tget_config("resnet101", smoke=True),
                            device="cpu")
    ts = tstore.WeightStore(str(tmp_path / "j"))
    for name in jm.unit_names():
        got = ts.read_and_deserialize(cfg.name, name)
        want = js.read_and_deserialize(cfg.name, name)
        assert list(got) == list(want)
        for leaf, (arr, scale) in got.items():
            warr, wscale = want[leaf]
            assert arr.numpy().tobytes() == np.asarray(warr).tobytes(), leaf
            assert (scale is None) == (wscale is None), leaf
            if scale is not None:
                assert scale.numpy().tobytes() == \
                    np.asarray(wscale).tobytes(), leaf
        abstract = tm.abstract_unit(name)
        shapes = {tstore.leaf_path_name(p): tuple(a.shape)
                  for p, a in tree_util.leaves_with_path(abstract)}
        tree = tstore.unflatten_unit(
            abstract, {k: a.reshape(shapes[k]) for k, (a, _) in got.items()})
        if name.startswith("stage"):
            assert type(tree["blocks"]) is list
            assert len(tree["blocks"]) == len(units[name]["blocks"])
    ts.deploy("port", units, quant="int8")
    for name in jm.unit_names():
        with open(os.path.join(tmp_path, "j", cfg.name, f"{name}.bin"),
                  "rb") as a, open(os.path.join(tmp_path, "j", "port",
                                                f"{name}.bin"), "rb") as b:
            assert a.read() == b.read(), name
    assert ts.manifest("port")["units"] == js.manifest(cfg.name)["units"]
