"""attn_roofline_pct: the least time the card needs for the traced
stretch's attention calls (`flops.attention_bound_s`, each call at its
padded batch) over the device time of the sm90 attention kernel in the
trace. Silent where the kernel's launches are not one a call."""
from portbench import flops, tracing

KERNEL = "attn_sm90_kernel"


def read(rec):
    trace = rec.get("trace")
    if not trace:
        return None
    bound, calls = 0.0, 0
    bs = rec["batch_size"]
    for s in rec["traced_scenes"]:
        enc, pairs = -(-s["images"] // bs), -(-s["pairs"] // bs)
        for B, h, nq, nk, d, count in flops.attention_calls(rec["arch"], s["height"], s["width"],
                                                            bs, enc, pairs):
            bound += count * flops.attention_bound_s(B, h, nq, nk, d)
            calls += count
    launches, seconds = tracing.kernel_time(trace, KERNEL)
    if launches != calls or seconds <= 0:
        return None
    return 100.0 * bound / seconds
