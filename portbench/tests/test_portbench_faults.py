"""``correct`` against the control and against planted faults.

Each test drives a whole run of a cell at a size a CPU run holds, past
the harness's look for a card (``conftest.run_small``), under the limits
of the cell's own file: a sound run is correct; the control (the plain
reference in float8 in the program's place) reads above the limit; and
with the timed path broken underneath, ``correct`` comes out false: a
token altered where the decode step produces it, and a decode step that
leaves its cache unchanged.  (The faults of a batch's mean and of an
exchange between chips belong to training and to several chips: these
cells have neither.)"""
import pytest
import torch

from conftest import run_small
from portbench import spec

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    """A control run holds the control's numbers to the cell's limits in
    the program's place and comes out not correct; the program's own
    numbers of the same run, printed beside them, hold."""
    res, lines = run_small(cell, control=True)
    assert not res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    limits = spec.workload(cell)["check"]["limits"]
    assert any(res["checks"][name]["value"] > limit
               for name, limit in limits.items()), lines
    assert all(res["readings"][name] <= limit
               for name, limit in limits.items()), lines


# the one-row fault where a cell's scheduler has more than one slot
ALTERED = [(c, "every") for c in CELLS] + [
    (c, "one") for c in CELLS
    if spec.workload(c)["entry"].get("gen_slots", 1) > 1]


@pytest.mark.parametrize("cell,rows", ALTERED)
def test_altered_token_fails(cell, rows, monkeypatch):
    """A token altered where the decode step samples it: in every row,
    or in the batch's second row alone, a fault of one slot that the
    sample has to reach across the slots."""
    from repro_torch.serving import decode
    real = decode.sample_tokens

    def altered(logits, *a, **kw):
        tok = real(logits, *a, **kw)
        bad = (tok + 1) % logits.shape[-1]
        if rows == "every" or tok.dim() == 0:
            return bad
        if tok.shape[0] < 2:
            return tok
        return torch.cat([tok[:1], bad[1:2], tok[2:]])
    monkeypatch.setattr(decode, "sample_tokens", altered)
    res, lines = run_small(cell)
    assert not res["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_step_that_leaves_its_cache_fails(cell, monkeypatch):
    from repro_torch import tree
    from repro_torch.models import transformer
    real = transformer.LM.decode_step

    def stale(self, params, cache, tok, pos):
        copy = tree.tree_map(lambda t: None if t is None else t.clone(),
                             cache)
        logits, _ = real(self, params, copy, tok, pos)
        return logits, cache
    monkeypatch.setattr(transformer.LM, "decode_step", stale)
    res, lines = run_small(cell)
    assert not res["correct"], lines
