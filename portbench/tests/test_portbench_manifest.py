"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it against the files the harness finds it by."""
import json
import os
import re

import pytest

from portbench import spec

M = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ALL_METRICS = M["end_to_end"] + M["per_layer"]
WIDTH_WORDS = ("d_model", "d_ff", "head_dim", "n_heads", "n_kv_heads",
               "top_k", "vocab_size", "sliding_window")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("entry", [*M["configs"], *M["workloads"],
                                   *ALL_METRICS], ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (M["configs"], M["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_run_budget_fits_24_cells():
    per_run = M["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("m", M["end_to_end"], ids=lambda e: e["name"])
def test_bounds(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda e: e["name"])
def test_config_files(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    body = spec.config(cfg["name"])
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    # every key cut is named in both places, with its reason, and no
    # width is ever cut
    assert sorted(body["reduced"]) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert key not in WIDTH_WORDS and not key.endswith(("_dim",
                                                            "_rank"))
        assert body[key] != body["published"][key]
    for key, val in body["published"].items():
        if key not in cfg["reduced"]:
            assert body[key] == val, key
    assert body["deployment"] and body["serving"]


@pytest.mark.parametrize("wl", M["workloads"], ids=lambda e: e["name"])
def test_cells(wl):
    assert wl["chips"] == 1
    with open(os.path.join(spec.HERE, "workloads",
                           wl["name"] + ".json")) as f:
        own = json.load(f)
    assert not set(own) & set(wl)       # the manifest's keys stay there
    body = spec.workload(wl["name"])
    spec.config(wl["config"])
    mix = spec.mix(wl["traffic"])
    spec.module("traffic", mix["generator"])
    spec.module("drivers", body["driver"])
    assert all(v is not None for v in body["check"]["limits"].values())
    e2e = spec.metrics_for(wl["name"], trace=False)
    per = spec.metrics_for(wl["name"], trace=True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per


def test_each_config_used():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda e: e["name"])
def test_per_layer_moves(m):
    """Each per-layer metric moves one end-to-end metric that every cell
    it lists reports, and has a reader."""
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert hasattr(spec.reader(m["name"], per_layer=True), "read")
    if m["name"].split(".")[0].endswith("_roofline"):
        assert m["unit"] == "%" and m["source"] == "device_trace"


@pytest.mark.parametrize("m", M["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_readers(m):
    if m["name"] != "setup_s":
        assert hasattr(spec.reader(m["name"], per_layer=False), "read")


def test_layers_named_alike():
    """Metrics of one layer give the same layer name, and each layer is
    in PERF.md's list."""
    with open(os.path.join(spec.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in M["per_layer"]}:
        assert layer in perf, layer


def test_manifest_small():
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
