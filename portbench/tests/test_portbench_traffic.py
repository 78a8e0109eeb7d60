"""The traffic generators: the same seed gives the same requests, and
every seed the same sizes in another order."""
from collections import Counter

import numpy as np
import pytest

from portbench import spec
from portbench.traffic import closed_loop, open_loop, sizes

BIG = 2 ** 31 + 12345          # the driver's seeds pass 32 signed bits


def _flat(streams):
    return [r for s in streams for r in s]


@pytest.mark.parametrize("mix,clients", [("cold_serial", 1),
                                         ("cold_serial", 4)])
def test_closed_loop_deterministic(mix, clients):
    m = spec.mix(mix)
    a = closed_loop.generate(m, {"clients": clients}, BIG, 32000)
    b = closed_loop.generate(m, {"clients": clients}, BIG, 32000)
    c = closed_loop.generate(m, {"clients": clients}, BIG + 1, 32000)
    assert len(a) == clients
    for x, y in zip(_flat(a), _flat(b)):
        assert x["n_prompt"] == y["n_prompt"] and x["n_new"] == y["n_new"]
        assert np.array_equal(x["prompt"], y["prompt"])
    # the same prompt lengths and the same output lengths, in another
    # order
    for k in ("n_prompt", "n_new"):
        assert Counter(r[k] for r in _flat(a)) == \
            Counter(r[k] for r in _flat(c))
    assert [r["n_prompt"] for r in _flat(a)] != \
        [r["n_prompt"] for r in _flat(c)]


@pytest.mark.parametrize("mix,prompt,output", [
    ("chat_poisson", (32, 512), (64, 512)),
    ("docqa_poisson", (2048, 8192), (8, 48))])
def test_open_loop_sizes_in_range(mix, prompt, output):
    m = spec.mix(mix)
    for r in open_loop.generate(m, {"rate_per_s": 2.0}, 7, 32000, 76):
        assert prompt[0] <= r["n_prompt"] <= prompt[1]
        assert output[0] <= r["n_new"] <= output[1]
        assert r["prompt"].shape == (r["n_prompt"],)
        assert r["prompt"].min() >= 0 and r["prompt"].max() < 32000


def test_closed_loop_sizes_in_range():
    m = spec.mix("cold_serial")
    for r in _flat(closed_loop.generate(m, {"clients": 1}, 7, 32000)):
        assert 256 <= r["n_prompt"] <= 4096 and r["n_new"] == 16


def test_open_loop_deterministic():
    m = spec.mix("docqa_poisson")
    load = {"rate_per_s": 2.0}
    a = open_loop.generate(m, load, BIG, 32000, 51)
    b = open_loop.generate(m, load, BIG, 32000, 51)
    assert [r["due_s"] for r in a] == [r["due_s"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"])
               for x, y in zip(a, b))
    assert a[0]["due_s"] == 0.0 and a[-1]["due_s"] < 51
    assert all(2048 <= r["n_prompt"] <= 8192 for r in a)


def test_open_loop_rate_steady_across_seeds():
    """Stratified gaps: every seed offers nearly the same load."""
    m = spec.mix("docqa_poisson")
    counts = [len(open_loop.generate(m, {"rate_per_s": 2.0}, s, 32000, 51))
              for s in range(5)]
    assert max(counts) - min(counts) <= 4
    assert abs(sum(counts) / 5 - 102) <= 8


def test_stratified_quantiles():
    rng = np.random.default_rng(0)
    d = {"dist": "loguniform", "lo": 128, "hi": 2048}
    v = sizes.stratified(d, 24, 8, rng)
    q = sorted(sizes.quantiles(d, 8))
    for i in range(3):
        assert sorted(v[8 * i:8 * i + 8]) == q
    assert sizes.quantiles({"dist": "fixed", "value": 16}, 3).tolist() == \
        [16, 16, 16]
    with pytest.raises(ValueError):
        sizes.quantiles({"dist": "zipf"}, 3)
