"""device_idle_pct.infer: the share of the traced stretch in which no
kernel, copy or set ran on the device."""


def read(rec):
    trace = rec.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
