"""Device: the model operations of every prompt and output token
processed in the window (the benchmark's count: prefills whose first
token came in the window, and each token a decode step took in there)
over the window and the card's bf16 peak, %."""
from portbench.costs import decoder
from portbench.records import decode_tokens


def read(rec):
    peak = rec.get("peaks")
    if not peak:
        return None
    cfg, t0, t1 = rec["cfg"], rec["t0"], rec["t1"]
    flops = sum(decoder.model_flops_prefill(cfg, r["n_prompt"])
                for r in rec["requests"]
                if r["t_first"] is not None and t0 <= r["t_first"] < t1)
    flops += sum(decoder.model_flops_token(cfg, pos)
                 for t, pos in decode_tokens(rec) if t0 <= t < t1)
    if flops <= 0:
        return None
    return 100.0 * flops / (t1 - t0) / peak["bf16_flops_per_s"]
