"""Kernels: ``weight_transform``'s share of its roofline over the traced
window, its work every leaf of the model applied once for each cold
start whose first token came in there."""
from portbench.costs import decoder
from portbench.layer_metrics._share import share
from portbench.records import traced_prefills


def read(rec):
    loads = sum(1 for r in traced_prefills(rec) if r["cold"])
    if not loads:
        return None
    ops, nbytes = decoder.weight_transform_load(rec["cfg"])
    return share(rec, "weight_transform", (loads * ops, loads * nbytes))
