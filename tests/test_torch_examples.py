"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
at smoke size through their ``main`` with ``--device cpu``, and say what
their JAX twins say: the cold start's logits equal a warm forward's; the
pool scales out and keep-alive reclaims it; a second cluster node's cold
start reads nothing from the origin; each strategy replays the trace;
training lowers the loss and resumes from its checkpoint; the component
ablation cold-starts under the five strategies, MiniLoader's placeholders
24-32x below full buffers."""
import importlib.util

import pytest
import torch

from torch_testlib import ROOT

torch.set_num_threads(2)


def _example(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    out = _example("quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out["warm_matches"] is True
    assert out["cicada"].strategy == "cicada"
    assert out["pisel"].strategy == "pisel"
    assert "warm forward matches in-pipeline logits: True" in text
    assert text.count("Compute  |") == 2


def test_router_serving(capsys):
    out = _example("router_serving").main(["--device", "cpu"])
    text = capsys.readouterr().out
    st = out["pool"]
    assert (st.size, st.cold_starts, st.cold_starts + st.warm_hits) == \
        (2, 2, 4)
    assert out["gens"][0].cold and all(r.n_generated == 12
                                       for r in out["gens"])
    cluster = out["cluster"]
    n0, n1 = cluster.nodes
    n_units = cluster.placement.snapshot()["models"]["demo"]["keys"]
    assert (n0.origin_reads(), n0.peer_reads()) == (n_units, 0)
    assert (n1.origin_reads(), n1.peer_reads()) == (0, n_units)
    r0, r1, r2 = out["responses"]
    assert r0.cold and r1.cold and not r2.cold
    assert (r0.node, r1.node) == ("node0", "node1")
    assert "served entirely by its peer" in text


def test_serve_trace(capsys):
    out = _example("serve_trace").main(["--device", "cpu",
                                        "--invocations", "6"])
    text = capsys.readouterr().out
    assert sorted(out) == ["cicada", "pisel"]
    assert all(len(v) == 6 for v in out.values())
    assert "mean-latency speedup cicada vs pisel" in text


def test_train_smollm(capsys):
    out = _example("train_smollm").main(["--device", "cpu", "--steps", "4",
                                         "--resume-steps", "2"])
    text = capsys.readouterr().out
    assert out["train"]["step"] == [1] and out["resumed"]["step"] == [5]
    assert "resumed from step 4" in text and "trained 4 steps" in text


def test_ablation_components(capsys):
    traces = _example("ablation_components").main(["--device", "cpu",
                                                   "--smoke"])
    text = capsys.readouterr().out
    assert list(traces) == ["traditional", "pisel", "mini", "preload",
                            "cicada"]
    # MiniLoader's 1-bit placeholders against full f32 buffers, in total
    # (the peak depends on how many coexist)
    for full, mini in (("pisel", "mini"), ("preload", "cicada")):
        ratio = (traces[full].memory_total_bytes()
                 / traces[mini].memory_total_bytes())
        assert 24 < ratio <= 32.5, (full, mini, ratio)
    assert all(t.total_time() > 0 and 0 < t.utilization() <= 1
               for t in traces.values())
    assert "resnet50-smoke on cpu" in text and text.count("vs pisel") == 3


def test_examples_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart", "router_serving", "serve_trace",
                 "train_smollm", "ablation_components"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _example(name).main([])
