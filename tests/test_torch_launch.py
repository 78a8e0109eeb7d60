"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU at
smoke size, held against the JAX package's launcher on the same
arguments: per strategy, the same cold/warm mix and pool counts, for
the LMs, for the MoE, audio and VLM families, for the recurrent families
paged and int8-resident, and for a vision model served one-shot; and
``--autoscale``, whose
background autoscaler prewarms instances during the replay."""
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

torch.set_num_threads(2)

ARGS = ["--invocations", "6", "--duration", "120", "--keep-alive", "20",
        "--bandwidth-mbps", "0"]


def _pools(out: str):
    return sorted(line for line in out.splitlines()
                  if line.startswith("pool["))


@pytest.mark.parametrize("workload,extra", [
    ("oneshot", ["--cache-budget-mb", "0"]),
    ("generate", ["--n-new", "3", "--prompt-len", "5", "--concurrency",
                  "1"]),
], ids=["oneshot", "generate"])
def test_launcher_matches_reference(tmp_path, capsys, workload, extra):
    args = ARGS + ["--workload", workload] + extra
    strategies = ["cicada", "pisel"] if workload == "generate" \
        else ["cicada"]
    got = tserve.main(args + ["--store", str(tmp_path / "t"), "--device",
                              "cpu", "--strategy", *strategies])
    tout = capsys.readouterr().out
    assert sorted(got) == sorted(strategies)
    for strategy in strategies:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "ref")
            want = jserve.main(args + ["--store", str(tmp_path / "j"),
                                       "--strategy", strategy])
        jout = capsys.readouterr().out
        assert [r.cold for r in got[strategy]] == [r.cold for r in want]
        assert [(r.req_id, r.model) for r in got[strategy]] == \
            [(r.req_id, r.model) for r in want]
        assert 0 < sum(r.cold for r in want) < len(want)
        assert set(_pools(jout)) <= set(_pools(tout))
        if workload == "generate":
            assert all(r.n_generated == 3 for r in got[strategy])
    assert tout.splitlines()[1].startswith("trace: ")
    assert sum(line.startswith("strategy=") for line in tout.splitlines()) \
        == len(strategies)


def test_launcher_serves_a_vision_model_oneshot(tmp_path, capsys):
    """resnet50 smoke, one-shot, on the CPU: the example batch is the
    reference's (1, 3, 32, 32) image, and the replay's cold/warm mix and
    pool counts are the JAX launcher's."""
    args = ARGS + ["--models", "resnet50", "--workload", "oneshot",
                   "--cache-budget-mb", "0"]
    got = tserve.main(args + ["--store", str(tmp_path / "t"), "--device",
                              "cpu"])["cicada"]
    tout = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        want = jserve.main(args + ["--store", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    assert [r.cold for r in got] == [r.cold for r in want]
    assert 0 < sum(r.cold for r in got) < len(got)
    assert all(r.tokens is None for r in got)
    assert _pools(tout) == _pools(jout)
    cfg = tserve.get_config("resnet50", smoke=True)
    batch = tserve.example_batch(cfg)
    np.testing.assert_array_equal(
        batch["image"].numpy(),
        np.asarray(jserve.example_batch(jserve.get_config(
            "resnet50", smoke=True))["image"]))
    assert batch["image"].shape == (1, 3, 32, 32)


def test_launcher_serves_the_moe_audio_and_vlm_families(tmp_path, capsys):
    """``--models mixtral-8x7b hubert-xlarge internvl2-76b --smoke``, one-shot,
    on the CPU: each model's example batch (tokens; bf16 frames; image rows
    and tokens) is served through its pool, and the replay's cold/warm mix
    and pool counts are the JAX launcher's."""
    args = ARGS + ["--models", "mixtral-8x7b", "hubert-xlarge",
                   "internvl2-76b", "--smoke", "--workload", "oneshot",
                   "--keep-alive", "60"]
    got = tserve.main(args + ["--store", str(tmp_path / "t"), "--device",
                              "cpu"])["cicada"]
    tout = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        want = jserve.main(args + ["--store", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    assert [(r.model, r.cold) for r in got] == \
        [(r.model, r.cold) for r in want]
    assert {r.model for r in got} == {"mixtral-8x7b", "hubert-xlarge",
                                      "internvl2-76b"}
    assert 0 < sum(r.cold for r in got) < len(got)
    assert _pools(tout) == _pools(jout)


def test_launcher_pages_the_recurrent_families_int8_resident(tmp_path,
                                                              capsys):
    """``--models recurrentgemma-2b mamba2-780m --smoke --workload generate
    --kv-page-tokens 16 --compute-quant`` on the CPU: both families serve
    paged and int8-resident, and the replay's cold/warm mix and pool
    counts are the JAX launcher's."""
    args = ARGS + ["--models", "recurrentgemma-2b", "mamba2-780m", "--smoke",
                   "--workload", "generate", "--kv-page-tokens", "16",
                   "--compute-quant", "--n-new", "3", "--prompt-len", "5",
                   "--concurrency", "1"]
    got = tserve.main(args + ["--store", str(tmp_path / "t"), "--device",
                              "cpu"])["cicada"]
    tout = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        want = jserve.main(args + ["--store", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    assert [(r.model, r.cold) for r in got] == \
        [(r.model, r.cold) for r in want]
    assert {r.model for r in got} == {"recurrentgemma-2b", "mamba2-780m"}
    assert 0 < sum(r.cold for r in got) < len(got)
    assert all(r.n_generated == 3 for r in got)
    assert _pools(tout) == _pools(jout)


def test_launcher_refuses_unported_options_and_needs_a_device(tmp_path,
                                                               monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.main(["--mesh", "2", "--store", str(tmp_path)])
    # the reference's refusals with --nodes (the cluster is ported): the
    # autoscaler is a per-node policy, and neither int8-resident serving
    # nor paged KV is plumbed through the cluster
    for flag, msg in ((["--autoscale"], "per-node"),
                      (["--compute-quant"], "single device"),
                      (["--kv-page-tokens", "16"], "not yet plumbed")):
        with pytest.raises(SystemExit, match=msg):
            tserve.main(flag + ["--nodes", "2", "--store", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--store", str(tmp_path)])


def test_launcher_autoscale_prewarms_on_the_cpu(tmp_path, capsys,
                                               monkeypatch):
    """``--autoscale`` runs the replay with the autoscaler ticking in the
    background and reports the pool's prewarms.  The ticks come every
    10 ms here (the launcher's default is the autoscaler's 0.5 s), so a
    tick lands while the replay's first cold start loads: with a budget
    of 0.01 rps an instance, its target is the pool's two instances, and
    the second is prewarmed off the request path."""
    class FastTicks(tserve.ServerlessPlatform):
        def __init__(self, *a, autoscale=None, **kw):
            assert autoscale == {"rps_per_instance": 0.01}
            super().__init__(*a, autoscale=dict(autoscale, interval_s=0.01),
                             **kw)

    monkeypatch.setattr(tserve, "ServerlessPlatform", FastTicks)
    got = tserve.main(ARGS + ["--workload", "oneshot", "--autoscale",
                              "--rps-per-instance", "0.01",
                              "--max-instances", "2", "--store",
                              str(tmp_path), "--device", "cpu"])["cicada"]
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines()
             if line.startswith("autoscaler[")]
    assert len(lines) == 1
    prewarms = int(lines[0].split("prewarms=")[1])
    assert prewarms >= 1
    assert len(got) == 6
    # a prewarm is no served request: the responses count every load the
    # requests paid, the prewarms the rest
    pool = [line for line in out.splitlines() if line.startswith("pool[")][0]
    cold = int(pool.split("cold=")[1].split()[0])
    warm = int(pool.split("warm=")[1].split()[0])
    assert cold == sum(r.cold for r in got) and cold + warm == len(got)
