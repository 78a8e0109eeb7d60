"""The JAX package's shard plans as JSON: the oracle of
``tests/test_torch_sharding.py``.

It needs a mesh of four devices, so it runs in a process of its own, which
the test starts:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        REPRO_PALLAS=ref PYTHONPATH=src python tests/torch_shard_oracle.py \\
        STORE_DIR OUT.json

Every case's store is deployed under STORE_DIR by the JAX package (weights
drawn with numpy from a seed: a plan reads only the manifest).  For each
case, mesh shape and ``apply_dtype``, it writes each unit's leaf specs,
index maps, shard plan (pieces per shard with their byte runs, commit,
transformed, out dtype) and tag; per case and mesh, the specs of the
stacked parameter tree; per mesh, the tags of both rule sets; the
training half's ``cache_specs`` (each case's decode cache) and
``batch_specs`` (:data:`BATCHES`) under both rule sets; and the byte
runs of random slices.  The encoders below take the port's objects
as well as the reference's, so the test encodes the port's the same way.
"""
from __future__ import annotations

import json
import sys

import numpy as np

# case -> (arch, config overrides, store quant)
CASES = {
    "smollm": ("smollm-360m", {}, None),
    "smollm-q": ("smollm-360m", {}, "int8"),
    "mixtral": ("mixtral-8x7b", {}, None),
    "mixtral-q": ("mixtral-8x7b", {}, "int8"),
    "rgemma": ("recurrentgemma-2b", {}, None),
    "rgemma-q": ("recurrentgemma-2b", {}, "int8"),
    # int8 leaves whose column runs clear RUN_FLOOR_BYTES at one byte an
    # element (d_ff / 4 = 1024-byte runs), as the reference's int8 tests
    "wide-q": ("smollm-360m", dict(name="wide-q", d_ff=4096,
                                   vocab_size=4096), "int8"),
    # every sharded dim indivisible by 4: the whole plan replicates
    "odd": ("smollm-360m", dict(name="odd", d_model=54, n_heads=3,
                                n_kv_heads=1, d_ff=150, vocab_size=510),
            None),
}
MESHES = ((1, 2), (1, 4), (2, 2))
# batch leaf shapes for batch_specs: divisible by 2 and 4, by 2 only, odd
BATCHES = {"tokens": (8, 16), "labels": (6, 16), "img": (3, 8, 32),
           "pos": (4,)}
CACHE_SHAPE = (4, 32)           # (batch, cache_len) of the decode caches
APPLY = (None, "bfloat16")
N_RUN_CASES = 64


def run_cases():
    """Random (shape, itemsize, index) cases for ``slice_byte_runs``."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(N_RUN_CASES):
        shape = tuple(int(d) for d in rng.integers(1, 9, rng.integers(1, 5)))
        index = []
        for dim in shape:
            if rng.random() < 0.4:
                index.append([None, None])
            else:
                a = int(rng.integers(0, dim))
                index.append([a, int(rng.integers(a + 1, dim + 1))])
        out.append((list(shape), int(rng.choice([1, 2, 4])), index))
    return out


def as_index(enc):
    return tuple(slice(a, b) for a, b in enc)


def dtype_name(dt):
    if dt is None:
        return None
    s = str(dt)
    return s.split(".", 1)[1] if s.startswith("torch.") \
        else np.dtype(dt).name


def enc_spec(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def enc_tree(specs):
    """{leaf path: encoded spec} of a tree of NamedShardings, the
    reference's or the port's (JAX walks both; ``None`` leaves drop)."""
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): enc_spec(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}


def enc_index(idx):
    return None if idx is None else [[s.start, s.stop] for s in idx]


def enc_plan(plan, slice_byte_runs):
    devices = list(plan.mesh.devices.flat)
    pos = {d: i for i, d in enumerate(devices)}
    runs = {}
    pieces = []
    for shard, ps in enumerate(plan.pieces):
        pieces.append([[p.leaf, enc_index(p.index), p.nbytes,
                        [pos[d] for d in p.devices]] for p in ps])
        for p in ps:
            if p.index is not None:
                item = 1 if plan.quant[p.leaf] \
                    else np.dtype(plan.dtypes[p.leaf]).itemsize
                runs[f"{p.leaf}@{shard}"] = [
                    list(r) for r in slice_byte_runs(
                        plan.shapes[p.leaf], item, p.index)]
    return {
        "pieces": pieces, "runs": runs, "tag": plan.tag,
        "commit": plan.commit, "transformed": plan.transformed,
        "out_dtype": {k: dtype_name(v) for k, v in plan.out_dtype.items()},
        "specs": {k: enc_spec(s.spec) for k, s in plan.specs.items()},
        "imaps": {k: [enc_index(s.devices_indices_map(plan.shapes[k])[d])
                      for d in devices]
                  for k, s in plan.specs.items()},
    }


def main(store_dir: str, out_path: str):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.core.shards import plan_tag, plan_unit
    from repro.distributed.sharding import (batch_specs, cache_specs,
                                            param_specs, serve_rules,
                                            train_rules)
    from repro.launch.mesh import make_serving_mesh
    from repro.models import transformer
    from repro.models.api import get_config
    from repro.store.store import WeightStore, slice_byte_runs

    assert jax.device_count() >= 4, jax.devices()
    store = WeightStore(store_dir)
    rules = serve_rules()
    meshes = {"x".join(map(str, s)): make_serving_mesh(s) for s in MESHES}
    out = {"plans": {}, "stacked": {}, "tags": {}, "runs": [],
           "cache": {}, "batch": {}}
    all_rules = {"serve": serve_rules(), "train": train_rules()}
    rng = np.random.default_rng(7)
    for case, (arch, over, quant) in CASES.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
        model = transformer.build(cfg)
        units = {}
        for u in model.unit_names():
            units[u] = jax.tree.map(
                lambda a: rng.standard_normal(a.shape).astype(a.dtype),
                model.abstract_unit(u))
        store.deploy(case, units, quant=quant)
        for mk, mesh in meshes.items():
            for rn, rl in all_rules.items():
                out["cache"][f"{case}/{mk}/{rn}"] = enc_tree(cache_specs(
                    model.abstract_cache(*CACHE_SHAPE), mesh, rl))
            out["stacked"][f"{case}/{mk}"] = {
                "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): enc_spec(s.spec)
                for path, s in jax.tree_util.tree_flatten_with_path(
                    param_specs(model.abstract(), mesh, rules))[0]}
            for adt in APPLY:
                for u in model.unit_names():
                    plan = plan_unit(store, case, u, model.abstract_unit(u),
                                     mesh, rules,
                                     apply_dtype=getattr(jnp, adt)
                                     if adt else None)
                    out["plans"][f"{case}/{mk}/{adt}/{u}"] = enc_plan(
                        plan, slice_byte_runs)
    for mk, mesh in meshes.items():
        out["tags"][mk] = {"serve": plan_tag(mesh, serve_rules()),
                           "train": plan_tag(mesh, train_rules())}
        for rn, rl in all_rules.items():
            out["batch"][f"{mk}/{rn}"] = enc_tree(batch_specs(
                {k: jax.ShapeDtypeStruct(v, jnp.int32)
                 for k, v in BATCHES.items()}, mesh, rl))
    for shape, item, index in run_cases():
        out["runs"].append([list(r) for r in slice_byte_runs(
            tuple(shape), item, as_index(index))])
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
