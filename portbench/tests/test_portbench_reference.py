"""The plain references against the port's CPU forward on the models'
``-smoke`` variants, in float32: the prompt's prefill and then decoding
through the cache (the served tokens fed back) against the reference's
whole forward over prompt and tokens.  The test imports both; the
reference modules import nothing of the port."""
import numpy as np
import pytest
import torch

from portbench import weights as W
from portbench.drivers import common
from portbench.reference.decoder import Reference
from portbench.reference.quant import fp8, int8_roundtrip


def cfg_of(name, **over):
    from repro_torch.models.api import get_config
    a = get_config(name, smoke=True)
    cfg = {"name": a.name, "family": a.family.value, "n_layers": a.n_layers,
           "d_model": a.d_model, "n_heads": a.n_heads,
           "n_kv_heads": a.n_kv_heads, "head_dim": a.dh, "d_ff": a.d_ff,
           "vocab_size": a.vocab_size, "sliding_window": a.sliding_window,
           "rope_theta": a.rope_theta, "n_experts": a.n_experts,
           "top_k": a.top_k, "capacity_factor": a.capacity_factor,
           "serving": {"weights": "float", "compute_dtype": "float32"}}
    cfg.update(over)
    return cfg


def port_logits(cfg, seed, prompt, served):
    """The port's prefill of ``prompt`` and its decode steps over the
    served tokens but the last: the logits of the positions that
    predict each served token."""
    from repro_torch.models import transformer
    dev = torch.device("cpu")
    model = transformer.build(common.arch(cfg), dev)
    units = {u: W.nest(W.float_unit(cfg, u, i, seed, dev))
             for i, u in enumerate(W.unit_names(cfg))}
    params = model.assemble(units)
    S = len(prompt)
    cache = model.init_cache(1, S + len(served))
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(prompt)[None]}, cache)
        rows = [logits[0, -1].float()]
        for k, t in enumerate(served[:-1]):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[t]]),
                torch.tensor([S + k], dtype=torch.int32))
            rows.append(logits[0, -1].float())
    return torch.stack(rows)


def reference_logits(cfg, seed, prompt, served, precision="f32"):
    get = lambda unit, i: W.float_unit(cfg, unit, i, seed, "cpu")  # noqa
    toks = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    return Reference(cfg, get, precision=precision).served_logits(
        [(toks, len(prompt))])[0]


@pytest.mark.parametrize("name,over", [
    ("h2o-danube-3-4b", {}),
    ("mixtral-8x7b", {}),
    # capacity 1.0: the prefill drops tokens past each expert's capacity
    ("mixtral-8x7b", {"capacity_factor": 1.0}),
], ids=["danube", "mixtral", "mixtral-drops"])
def test_reference_matches_port(name, over):
    cfg = cfg_of(name, **over)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg["vocab_size"], 40)   # past the window 16
    served = rng.integers(0, cfg["vocab_size"], 12)
    got = port_logits(cfg, 5, prompt, served)
    want = reference_logits(cfg, 5, prompt, served)
    assert got.shape == want.shape == (12, cfg["vocab_size"])
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-5 * scale


def test_control_is_further_off():
    """The control's operands in float8 move the logits far more than
    the program's float32 does."""
    cfg = cfg_of("mixtral-8x7b")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg["vocab_size"], 40)
    served = rng.integers(0, cfg["vocab_size"], 12)
    want = reference_logits(cfg, 5, prompt, served)
    low = reference_logits(cfg, 5, prompt, served, precision="fp8")
    got = port_logits(cfg, 5, prompt, served)
    assert (low - want).abs().max() > 100 * (got - want).abs().max()


def test_int8_roundtrip_is_the_stores():
    from repro_torch.store.store import quantize_int8
    w = torch.randn(7, 3, 50, generator=torch.Generator().manual_seed(1))
    q, s = quantize_int8(w)
    want = torch.from_numpy(q).float() * torch.from_numpy(s)
    assert torch.equal(int8_roundtrip(w).reshape(-1, 50), want)
    x = torch.randn(5, 9)
    assert (fp8(x, -1) - x).abs().max() <= x.abs().max() / 8
