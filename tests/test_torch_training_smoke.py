"""The port's twin of ``tests/test_models.py::test_smoke_forward_and_train_step``:
every assigned arch at its smoke config (the default compute dtype) runs
one forward with the right logits shape and no NaN, then one
``make_train_step`` with AdamW(lr=1e-3): the loss is finite and positive
and the params move.  The VLM's logits count its image rows; its labels
are cut or padded to them as the reference's test does."""
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ASSIGNED
from repro_torch.models import transformer
from repro_torch.models.api import Family, get_config
from repro_torch.training.optim import AdamW
from repro_torch.training.train import make_train_step

torch.set_num_threads(2)


def make_batch(cfg, B=2, S=24, seed=1):
    """The reference's ``conftest.make_batch`` in numpy: frames (audio),
    S - min(8, S // 2) tokens after as many image rows (VLM), else tokens;
    labels (B, S)."""
    r = np.random.default_rng(seed)
    fam = cfg.family
    if fam == Family.AUDIO:
        b = {"frames": torch.as_tensor(r.standard_normal(
            (B, S, cfg.frontend_dim)), dtype=torch.float32).to(
                torch.bfloat16)}
    elif fam == Family.VLM:
        n_img = min(8, S // 2)
        b = {"tokens": torch.as_tensor(r.integers(
                 0, cfg.vocab_size, (B, S - n_img)), dtype=torch.int32),
             "img": torch.as_tensor(r.standard_normal(
                 (B, n_img, cfg.frontend_dim)), dtype=torch.float32).to(
                     torch.bfloat16)}
    else:
        b = {"tokens": torch.as_tensor(r.integers(0, cfg.vocab_size, (B, S)),
                                       dtype=torch.int32)}
    b["labels"] = torch.as_tensor(r.integers(0, cfg.vocab_size, (B, S)),
                                  dtype=torch.int32)
    return b


@pytest.mark.parametrize("arch", list(ASSIGNED))
def test_smoke_forward_and_train_step(arch):
    cfg = get_config(arch, smoke=True)
    model = transformer.build(cfg, device="cpu")
    params = model.init(0)
    batch = make_batch(cfg)
    logits, aux = model.forward(params, batch)
    S_out = (24 if cfg.family != Family.VLM
             else batch["tokens"].shape[1] + batch["img"].shape[1])
    assert tuple(logits.shape) == (2, S_out, cfg.vocab_size)
    assert not torch.isnan(logits.float()).any()
    if cfg.family == Family.VLM:
        lab = batch["labels"]
        batch["labels"] = lab[:, :S_out] if S_out <= 24 else \
            torch.nn.functional.pad(lab, (0, S_out - 24))
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt)
    params2, _, metrics = step(params, opt.init(params), batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_util.leaves(params), tree_util.leaves(params2)))
