"""What the kernels' rooflines share: a family's device seconds in the
trace against the least time its counted work could take on the card
(the larger of operations over the bf16 peak and bytes over the HBM
bandwidth, ``peaks.json``)."""
from portbench.records import traced


def share(rec, family: str, work) -> float:
    t, peak = traced(rec), rec.get("peaks")
    secs = (t.get("family_s") or {}).get(family) if t else None
    if not secs or not peak or work is None or work[1] <= 0:
        return None
    least = max(work[0] / peak["bf16_flops_per_s"],
                work[1] / peak["hbm_bytes_per_s"])
    return 100.0 * least / secs
