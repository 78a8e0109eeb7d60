"""The JAX package's dry-run cells, specs only, as JSON: the oracle of
``tests/test_torch_dryrun.py``.

It needs the 16 x 16 production mesh, 256 devices, so it runs in a
process of its own, which the test starts:

    XLA_FLAGS=--xla_force_host_platform_device_count=256 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_dryrun_oracle.py OUT.json

The backend starts (with those 256 devices) before ``repro.launch.dryrun``
is imported, so the module's own 512-device flag finds it started.  For
each cell of :data:`CELLS` it calls the reference's ``build_cell`` (which
builds abstract values and shardings and compiles nothing) and writes the
bytes a device holds of each argument group: ``params``, ``opt``,
``cache`` and ``batch``, each leaf's shard shape by its sharding.
"""
from __future__ import annotations

import json
import sys

import jax
import numpy as np

# (arch, shape): every family's train, prefill and decode cells, the big
# models' FSDP serving rule (yi-9b, codeqwen, internvl2, arctic) and the
# encoder's prefill
CELLS = (("smollm-360m", "train_4k"), ("smollm-360m", "prefill_32k"),
         ("smollm-360m", "decode_32k"), ("yi-9b", "train_4k"),
         ("yi-9b", "decode_32k"), ("codeqwen1.5-7b", "prefill_32k"),
         ("mixtral-8x7b", "decode_32k"), ("arctic-480b", "prefill_32k"),
         ("internvl2-76b", "train_4k"), ("hubert-xlarge", "prefill_32k"),
         ("recurrentgemma-2b", "long_500k"), ("mamba2-780m", "train_4k"),
         ("mamba2-780m", "long_500k"))


def shard_bytes(args, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(args)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda s: isinstance(s, jax.sharding.Sharding))
    assert len(leaves) == len(shs), (len(leaves), len(shs))
    return int(sum(np.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
                   for a, s in zip(leaves, shs)))


def main(out_path: str):
    assert len(jax.devices()) >= 256, jax.devices()
    from repro.configs import SHAPES
    from repro.launch.dryrun import build_cell
    from repro.launch.mesh import make_production_mesh
    from repro.models.api import get_config

    mesh = make_production_mesh()
    out = {}
    for arch, shape in CELLS:
        cfg, cell = get_config(arch), SHAPES[shape]
        _, args, in_sh, _, _, _, _ = build_cell(cfg, cell, mesh)
        if cell.kind == "train":
            groups = {"params": (args[0], in_sh[0]),
                      "opt": (args[1], in_sh[1]),
                      "batch": (args[2], in_sh[2])}
        elif cell.kind == "prefill":
            groups = {"params": (args[0], in_sh[0]),
                      "batch": (args[1], in_sh[1])}
            if len(args) > 2:
                groups["cache"] = (args[2], in_sh[2])
        else:
            groups = {"params": (args[0], in_sh[0]),
                      "cache": (args[1], in_sh[1]),
                      "batch": ((args[2], args[3]), (in_sh[2], in_sh[3]))}
        out[f"{arch}/{shape}"] = {k: shard_bytes(*v)
                                  for k, v in groups.items()}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main(sys.argv[1])
