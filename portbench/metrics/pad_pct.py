"""pad_pct: the share of the engine's pair slots in the window that held
padding: pair batches times the batch size against the pairs sent."""


def read(rec):
    slots = rec["pair_batches"] * rec["batch_size"]
    if not slots:
        return None
    return 100.0 * (slots - sum(s["pairs"] for s in rec["scenes"])) / slots
