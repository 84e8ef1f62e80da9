"""enhance.pad_waste_pct (%): the share of the window's batches' padded
samples (rows x padded frames x hop) that hold no audio: what the entry
point's batching (``enhance._chunks``, padding to a multiple of 64 frames)
costs in work. From shapes."""


def read(ctx):
    w = ctx["window"]
    if not w.get("padded_samples"):
        return None
    return 100.0 * (1.0 - w["audio_samples"] / w["padded_samples"])
