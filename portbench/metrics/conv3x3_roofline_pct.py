"""conv3x3_roofline_pct: the least time the card needs for the traced
stretch's conv3x3 calls (19 a DPT head on each pair batch, at its padded
batch; `flops.conv3x3_bound_s`) over the device time of the conv3x3 kernel
in the trace. Silent where the kernel's launches are not one a call."""
from portbench import flops, tracing

KERNEL = "conv3x3_sm90_kernel"


def read(rec):
    trace = rec.get("trace")
    if not trace or rec["arch"]["head_type"] != "dpt":
        return None
    bound, calls = 0.0, 0
    bs = rec["batch_size"]
    for s in rec["traced_scenes"]:
        batches = -(-s["pairs"] // bs)
        for M, cin, cout, bias in flops.conv3x3_calls(s["height"], s["width"], bs):
            bound += 2 * batches * flops.conv3x3_bound_s(M, cin, cout, bias)
            calls += 2 * batches
    launches, seconds = tracing.kernel_time(trace, KERNEL)
    if launches != calls or seconds <= 0:
        return None
    return 100.0 * bound / seconds
