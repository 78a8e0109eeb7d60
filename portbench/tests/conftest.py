"""Shared set-up of the benchmark's own tests (``python -m pytest
portbench/tests -q`` from the root of the checkout): the import path and
small versions of the cells that a CPU run can hold.  Every test runs on
the CPU; what only the card can show is the runs' own."""
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


# Each cell at a width and load a CPU run holds: the shapes shrink, the
# code paths, the weights' rules and the limits of ``correct`` stay.
SMALL = {
    "danube-cold": {
        "cfg": {"n_layers": 4, "d_model": 480, "n_heads": 8,
                "n_kv_heads": 2, "head_dim": 60, "d_ff": 1280},
        "mix": {"prompt": {"dist": "loguniform", "lo": 32, "hi": 256}},
        "wl": {"entry": {"store_mbps": 400}},
        "seconds": 3.0},
    "mixtral-chat": {
        "cfg": {"n_layers": 8, "d_model": 512, "n_heads": 8,
                "n_kv_heads": 2, "head_dim": 64, "d_ff": 1792},
        "mix": {"prompt": {"dist": "loguniform", "lo": 32, "hi": 128},
                "output": {"dist": "loguniform", "lo": 8, "hi": 24}},
        "wl": {"load": {"rate_per_s": 2.0, "preroll_s": 1.0},
               "entry": {"gen_slots": 4, "workers": 4}},
        "seconds": 4.0},
    "danube-docqa": {
        "cfg": {"n_layers": 6, "d_model": 480, "n_heads": 8,
                "n_kv_heads": 2, "head_dim": 60, "d_ff": 1280,
                "sliding_window": 256},
        "mix": {"prompt": {"dist": "loguniform", "lo": 200, "hi": 600},
                "output": {"dist": "loguniform", "lo": 8, "hi": 32}},
        "wl": {"load": {"rate_per_s": 1.0},
               "entry": {"gen_slots": 4, "workers": 4}},
        "seconds": 3.0},
}


def small_cell(cell):
    """(cfg, mix, wl, seconds) of ``cell`` at its CPU size."""
    from portbench import spec
    wl = copy.deepcopy(spec.workload(cell))
    cfg = dict(spec.config(wl["config"]), **SMALL[cell]["cfg"])
    mix = dict(spec.mix(wl["traffic"]), **SMALL[cell]["mix"])
    for k, v in SMALL[cell]["wl"].items():
        wl[k].update(v)
    return cfg, mix, wl, SMALL[cell]["seconds"]


def run_small(cell, seed=11, control=False):
    """One run of ``cell`` at its CPU size, past the look for a card."""
    import torch
    from portbench import bench
    cfg, mix, wl, seconds = small_cell(cell)
    torch.manual_seed(0)
    return bench.run_cell(cell, seed, seconds, False,
                          device=torch.device("cpu"), cfg_override=cfg,
                          mix_override=mix, wl_override=wl,
                          control=control)
