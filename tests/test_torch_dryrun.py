"""The port's dry run (``repro_torch.launch.dryrun``), its cost accounting
(``launch/cost_analysis.py``) and roofline (``launch/roofline.py``)
against the JAX package and against counts written out by hand.

* One step counts the same FLOPs, bytes and kernel calls on meta tensors
  as on the CPU, exactly, for every family's train, prefill and decode
  smoke cells; the MoE counts combined from one and two units equal the
  full depth's.
* The smoke dense prefill's FLOPs equal a count from the config's widths.
* Skips and their reasons match ``repro.configs.supported`` for all 40
  cells; ``model_flops`` the reference's formula over its
  ``active_param_count``.
* The bytes a device holds of params, optimizer state, cache and batch
  equal those of the reference's ``build_cell`` on its 16 x 16 mesh,
  computed in a subprocess with 256 simulated host devices
  (``tests/torch_dryrun_oracle.py``: specs only, nothing compiles); the
  reference's ``repro.launch.dryrun`` is never imported in this process,
  since it sets ``XLA_FLAGS`` when imported.
* ``python -m repro_torch.launch.dryrun --all --smoke`` exits 0.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import repro.configs as jconfigs
from repro.models.api import get_config as jget_config
from repro_torch.configs import ASSIGNED, SHAPES, smoke_cell
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import cuda_lib
from repro_torch.launch import cost_analysis, dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh, make_serving_mesh
from repro_torch.models.api import get_config
from torch_testlib import ROOT

torch.set_num_threads(2)
CELLS = [(a, s) for a in ASSIGNED for s in SHAPES]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's bytes a device by argument group, per cell."""
    out = tmp_path_factory.mktemp("dryrun-oracle") / "cells.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable,
                    str(ROOT / "tests" / "torch_dryrun_oracle.py"),
                    str(out)], env=env, check=True, timeout=300)
    with open(out) as f:
        return json.load(f)


FAMILIES = ("smollm-360m", "mixtral-8x7b", "mamba2-780m",
            "recurrentgemma-2b", "hubert-xlarge", "internvl2-76b")
SMOKE = [(a, k) for a in FAMILIES for k in ("train", "prefill", "decode")
         if not (a == "hubert-xlarge" and k == "decode")]


def _count(cfg, cell, device):
    c = dryrun.build_cell(cfg, cell, make_production_mesh(), device=device)
    return cost_analysis.count_step(c.step)


@pytest.mark.parametrize("arch,kind", SMOKE,
                         ids=[f"{a}-{k}" for a, k in SMOKE])
def test_meta_and_cpu_count_the_same_step(arch, kind):
    cfg, cell = get_config(arch, smoke=True), smoke_cell(kind)
    meta, cpu = (_count(cfg, cell, d) for d in ("meta", "cpu"))
    for key in ("flops", "bytes", "kernels"):
        assert meta[key] == cpu[key], key
    assert meta["flops"] > 0 and meta["kernels"]
    assert meta["peak_live_bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_units_combined_equal_full_depth(kind):
    """The MoE cells' counts from one and two units are the full step's."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              n_layers=4)
    cell = smoke_cell(kind)
    assert dryrun.by_units(cfg, kind)
    full = _count(cfg, cell, "meta")
    combined = dryrun.trace(cfg, cell, make_production_mesh())
    for key in ("flops", "bytes", "kernels"):
        assert combined[key] == full[key], key


def test_smoke_dense_prefill_flops_match_a_count_by_hand():
    cfg = get_config("smollm-360m", smoke=True)
    B, S = 2, 32
    d, H, K, dh, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                          cfg.d_ff, cfg.vocab_size)
    T = B * S
    layer = (2 * T * d * H * dh                  # q
             + 2 * 2 * T * d * K * dh            # k, v
             + 4 * dh * (S * (S + 1) // 2) * H * B   # causal attention
             + 2 * T * H * dh * d                # o
             + 3 * 2 * T * d * ff                # gate, up, down
             + 2 * 4 * T * d)                    # two rmsnorms
    want = cfg.n_layers * layer + 4 * T * d + 2 * T * d * V
    cell = dataclasses.replace(SHAPES["prefill_32k"], seq=S, batch=B)
    got = _count(cfg, cell, "meta")
    assert got["flops"] == want
    assert got["kernels"] == {"flash_attention": cfg.n_layers,
                              "rmsnorm": 2 * cfg.n_layers + 1}


def test_skips_match_the_reference_for_every_cell():
    for arch, shape in CELLS:
        jok, jreason = jconfigs.supported(jget_config(arch),
                                          jconfigs.SHAPES[shape])
        if jok:
            assert dryrun.supported(get_config(arch), SHAPES[shape]) == \
                (True, None)
            continue
        for mp in (False, True):
            rec = dryrun.dryrun_cell(arch, shape, multi_pod=mp)
            assert (rec["status"], rec["skip_reason"]) == ("skip", jreason)


def test_model_flops_match_the_reference_formula():
    for arch, shape in CELLS:
        n = jget_config(arch).active_param_count()
        cell = jconfigs.SHAPES[shape]
        want = {"train": 6.0 * n * cell.seq * cell.batch,
                "prefill": 2.0 * n * cell.seq * cell.batch,
                "decode": 2.0 * n * cell.batch}[cell.kind]
        assert roofline.model_flops(arch, shape) == want


def test_bytes_a_device_match_the_reference_specs(ref):
    mesh = make_production_mesh()
    sb = cost_analysis.shard_bytes
    assert len(ref) >= 12
    for key, want in sorted(ref.items()):
        arch, shape = key.split("/")
        c = dryrun.build_cell(get_config(arch), SHAPES[shape], mesh)
        got = {"params": sb(c.params, c.param_specs),
               "batch": sb(c.batch, c.batch_specs)}
        if c.opt_state is not None:
            got["opt"] = sb(c.opt_state, c.opt_specs)
        if c.cache is not None:
            got["cache"] = sb(c.cache, c.cache_specs)
        assert got == want, key
        rec = dryrun.memory_record(c, {"peak_live_bytes": 0})
        assert rec["params_bytes_per_device"] == want["params"]


def test_collective_bytes_from_the_specs():
    """On a (data 2, model 2) mesh: a stacked block leaf sharded over data
    is gathered twice a microbatch and its gradient reduce-scattered; a
    replicated leaf's gradient is all-reduced over data."""
    mesh = make_serving_mesh((2, 2), device="cpu")
    rules = shd.train_rules()
    params = {"blocks": {"s0": {"mlp": {"wg": torch.empty(
                  (2, 8, 4), device="meta")}}},
              "final": {"norm": {"scale": torch.empty(8, device="meta")}}}
    specs = shd.param_specs(params, mesh, rules)
    rec = cost_analysis.collective_bytes(params, specs, mesh, rules,
                                         kind="train", micro_batches=3)
    s = 2 * 4 * 2 * 4                       # wg's block: (2, 4, 2) f32
    assert rec == {"all-gather": 3 * 2 * 2 * s, "reduce-scatter": 3 * s,
                   "all-reduce": 3 * 8 * 4, "total": 3 * (5 * s + 32),
                   "_counts": {"all-gather": 6, "reduce-scatter": 3,
                               "all-reduce": 3},
                   "scope": "params_and_grads"}
    serve = cost_analysis.collective_bytes(params, specs, mesh, rules,
                                           kind="decode", dtype=torch.bfloat16)
    assert serve["all-gather"] == 2 * 4 * 2 * 2 * 2 and \
        serve["total"] == serve["all-gather"]


def test_record_and_roofline_of_a_cell():
    rec = dryrun.dryrun_cell("smollm-360m", "decode_32k")
    assert rec["status"] == "ok" and rec["devices"] == 256
    c, mem = rec["cost_per_device"], rec["memory"]
    assert c["flops"] == c["global"]["flops"] / 256
    assert c["bytes"] == c["global"]["bytes"] / 256
    assert c["kernels"] == {"decode_attention": 32, "rmsnorm": 65}
    assert c["collectives"] == {"_counts": {}, "total": 0,
                                "scope": "params_and_grads"}
    assert mem["fits_hbm_80g"] and mem["live_bytes_per_device"] == sum(
        v for k, v in mem.items() if k.endswith(("per_device", "estimate"))
        and k != "live_bytes_per_device")
    a = roofline.analyze(rec)
    assert a["dominant"] == "memory"
    assert a["t_memory_s"] == c["bytes"] / roofline.HBM_BPS
    assert a["model_flops"] == roofline.model_flops("smollm-360m",
                                                    "decode_32k")


def test_counting_is_one_context_and_leaves_nothing_installed():
    assert cuda_lib._tally is None
    with cost_analysis.counting():
        with pytest.raises(RuntimeError, match="already active"):
            with cost_analysis.counting():
                pass
        assert cuda_lib._tally is not None
    assert cuda_lib._tally is None


def test_dryrun_all_smoke_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--all", "--smoke"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == len(CELLS)
    assert sum(" ok " in ln for ln in lines) == 33
    assert sum(" skip " in ln for ln in lines) == 7
