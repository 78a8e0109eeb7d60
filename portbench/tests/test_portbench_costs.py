"""``portbench/costs`` against counts by hand for one danube layer and
one mixtral layer."""
import pytest

from portbench import spec
from portbench.costs import decoder

DANUBE = dict(spec.config("h2o-danube-3-4b-l12"), n_layers=1)
MIXTRAL = dict(spec.config("mixtral-8x7b-l8"), n_layers=1)


def test_visible_pairs():
    assert decoder.visible_pairs(10, 0) == 55
    assert decoder.visible_pairs(10, 16) == 55
    assert decoder.visible_pairs(5000, 4096) == 4096 * 4097 // 2 + 904 * 4096


def test_danube_layer_products():
    """One danube layer and the head at 3 rows: q (3840x3840), k and v
    (3840x960), o (3840x3840), the SwiGLU's 3840x10240 twice and
    10240x3840, the head 3840x32000; int8 weights, f32 column scales,
    bf16 rows in and out."""
    mats = [(3840, 3840), (3840, 960), (3840, 960), (3840, 3840),
            (3840, 10240), (3840, 10240), (10240, 3840), (3840, 32000)]
    ops = sum(2 * 3 * k * n for k, n in mats)
    nbytes = sum(2 * 3 * k + k * n + 4 * n + 2 * 3 * n for k, n in mats)
    assert decoder.products(DANUBE, 3) == (pytest.approx(ops),
                                           pytest.approx(nbytes))
    assert ops == 2 * 3 * (154_828_800 + 3840 * 32000)


def test_mixtral_layer_products():
    """One mixtral layer and the head at 4 rows: 8 routed rows reach all
    8 experts, each expert's three 4096x14336 products read once; the
    operations are those of the 8 routed rows alone."""
    attn = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096)]
    ops = sum(2 * 4 * k * n for k, n in attn)
    nbytes = sum(2 * 4 * k + k * n + 4 * n + 2 * 4 * n for k, n in attn)
    ops += 2 * 8 * 4096 * 14336 * 3
    nbytes += 8 * (3 * 4096 * 14336 + 4 * (2 * 14336 + 4096)) \
        + 2 * 8 * 3 * (4096 + 14336)
    ops += 2 * 4 * 4096 * 32000
    nbytes += 2 * 4 * 4096 + 4096 * 32000 + 4 * 32000 + 2 * 4 * 32000
    got = decoder.products(MIXTRAL, 4)
    assert got == (pytest.approx(ops), pytest.approx(nbytes))
    # one row reaches 2 experts at most
    one = decoder.products(MIXTRAL, 1)
    assert one[1] < got[1] - 5 * 3 * 4096 * 14336


def test_model_flops():
    d, f, V = 3840, 10240, 32000
    per = 2 * (3840 * 3840 * 2 + 2 * 3840 * 960) + 2 * 3 * d * f
    assert decoder.model_flops_token(DANUBE, 0) == \
        pytest.approx(per + 4 * 32 * 120 * 1 + 2 * d * V)
    assert decoder.model_flops_token(DANUBE, 9999) == \
        pytest.approx(per + 4 * 32 * 120 * 4096 + 2 * d * V)
    # a prompt's sum over positions
    S = 6000
    want = sum(decoder.model_flops_token(DANUBE, p) for p in range(S))
    assert decoder.model_flops_prefill(DANUBE, S) == pytest.approx(want)
    moe = 2 * (4096 * 8 + 2 * 3 * 4096 * 14336)
    attn = 2 * (4096 * 4096 * 2 + 2 * 4096 * 1024)
    assert decoder.model_flops_token(MIXTRAL, 0) == pytest.approx(
        attn + moe + 4 * 32 * 128 + 2 * 4096 * V)


def test_flash_prefill():
    ops, nbytes = decoder.flash_prefill(DANUBE, 8192)
    pairs = 4096 * 4097 // 2 + 4096 * 4096
    assert ops == pytest.approx(4 * 120 * 32 * pairs)
    assert nbytes == 2 * (2 * 8192 * 32 * 120 + 2 * 8192 * 8 * 120)


def test_weight_transform_load():
    ops, nbytes = decoder.weight_transform_load(DANUBE)
    two_d = {"embed": [(32000, 3840)],
             "block": [(3840, 3840), (3840, 960), (3840, 960),
                       (3840, 3840), (3840, 10240), (3840, 10240),
                       (10240, 3840)],
             "final": [(3840, 32000)]}
    n = sum(a * b for group in two_d.values() for a, b in group)
    # one scale a column of each leaf's last axis: wq, wk, wv are
    # (d, heads, 120), wo (32, 120, d)
    cols = 3840 + (3 * 120 + 3840 + 2 * 10240 + 3840) + 32000
    one_d = 3 * 3840                    # two norms a block, the final norm
    assert ops == n
    assert nbytes == n * 3 + 4 * cols + 6 * one_d
