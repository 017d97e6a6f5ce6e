"""enc_pad_pct: the share of the engine's encoder slots in the window that
held padding: encoder batches times the batch size against the unique
images sent (each encoded once a scene)."""


def read(rec):
    slots = rec["encoder_batches"] * rec["batch_size"]
    if not slots:
        return None
    return 100.0 * (slots - sum(s["images"] for s in rec["scenes"])) / slots
