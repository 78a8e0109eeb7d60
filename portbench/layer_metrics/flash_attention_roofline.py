"""Kernels: ``flash_attention``'s share of its roofline over the traced
window, its work the prefill of each request whose first token came in
there, every layer."""
from portbench.costs import decoder
from portbench.layer_metrics._share import share
from portbench.records import traced_prefills


def read(rec):
    ops = nbytes = 0.0
    for r in traced_prefills(rec):
        a, b = decoder.flash_prefill(rec["cfg"], r["n_prompt"])
        ops, nbytes = ops + a, nbytes + b
    return share(rec, "flash_attention", (ops, nbytes)) if nbytes else None
