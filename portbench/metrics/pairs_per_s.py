"""pairs_per_s: every pair the window's scenes returned over the window's
seconds (from the first call to the wait that ends the last scene)."""


def read(rec):
    return sum(s["pairs"] for s in rec["scenes"]) / rec["window_s"]
