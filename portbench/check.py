"""How ``correct`` is decided for a served model.

Once the window has closed, a sample of the finished requests is drawn
from the seed: the longest request (prompt and served tokens) whole,
and ``check.requests`` more, each cut to its first ``check.tokens_each``
served tokens (whole without it), so that the sample spans many of the
scheduler's slots and rows.  The reference runs once over each prompt
with its served tokens, and at every position that produced a served
token reads the gap by which the served token's logit lies below the
reference's best, in units of that row's standard deviation (so that
one limit holds whatever the logits' scale):

* ``gap_max``: the widest such gap over the sample;
* ``gap_mean``: the mean gap over the sample;
* ``miss_share``: the share of served tokens that are not the
  reference's best (a gap above 0).

A cell's file names the numbers it holds to a limit; the others are
printed as readings.

The control puts the reference in the program's place at the precision
below (:mod:`portbench.reference.quant`): at each of the same positions
the token the control puts first is read in the reference's logits the
same way, and a control run holds those numbers to the cell's limits in
place of the program's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference.decoder import Reference


def choose(requests: Sequence[Dict[str, Any]], seed: int, n: int,
           tokens_each: Optional[int] = None) -> List[Dict[str, Any]]:
    """The longest finished request whole and ``n`` more drawn from the
    seed, each cut to its first ``tokens_each`` served tokens."""
    done = [r for r in requests if r.get("tokens")]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["n_prompt"] + len(r["tokens"]),
                                       -r["id"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(int(seed) + 17).permutation(len(rest))
    cut = [dict(rest[i], tokens=rest[i]["tokens"][:tokens_each])
           for i in order[:n]]
    return [longest] + cut


def _sequences(sample, device):
    seqs = []
    for r in sample:
        served = list(r["tokens"])
        toks = np.concatenate([np.asarray(r["prompt"], np.int64),
                               np.asarray(served[:-1], np.int64)])
        seqs.append((torch.as_tensor(toks, device=device), r["n_prompt"]))
    return seqs


def _gaps(ref_rows: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    best = ref_rows.max(-1).values
    sd = ref_rows.std(-1)
    return (best - ref_rows.gather(1, picked[:, None])[:, 0]) / sd


def readings(cfg: Dict[str, Any], sample, weights: Callable, device, *,
             control: bool = False) -> Dict[str, float]:
    """The numbers compared, for the program's served tokens and, with
    ``control``, for the control's first choices (``control_<name>``)."""
    seqs = _sequences(sample, device)
    ref = Reference(cfg, weights).served_logits(seqs)
    served = [torch.as_tensor(np.asarray(r["tokens"], np.int64),
                              device=device) for r in sample]
    g = torch.cat([_gaps(a, s) for a, s in zip(ref, served)])
    out = dict(_numbers(g), tokens=int(g.numel()))
    if control:
        low = Reference(cfg, weights, precision="fp8").served_logits(seqs)
        c = torch.cat([_gaps(a, b.argmax(-1)) for a, b in zip(ref, low)])
        out.update({f"control_{k}": v for k, v in _numbers(c).items()})
    return out


def _numbers(g: torch.Tensor) -> Dict[str, float]:
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "miss_share": float((g > 0).float().mean())}
