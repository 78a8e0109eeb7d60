"""Kernels: ``quant_matmul``'s share of its roofline over the traced
window, its work every weight product of each prefill whose first token
came in there and of each decode step that ended there, at the step's
live rows."""
from portbench.costs import decoder
from portbench.layer_metrics._share import share
from portbench.records import decode_steps, in_trace, traced_prefills


def read(rec):
    cfg = rec["cfg"]
    ops = nbytes = 0.0
    for r in traced_prefills(rec):
        a, b = decoder.products(cfg, r["n_prompt"])
        ops, nbytes = ops + a, nbytes + b
    for t, rows in decode_steps(rec):
        if in_trace(rec, t):
            a, b = decoder.products(cfg, rows)
            ops, nbytes = ops + a, nbytes + b
    return share(rec, "quant_matmul", (ops, nbytes)) if nbytes else None
