"""enhance_long.waste_pct (%): the share of the samples the sampler enhanced in
the traced window's ``enhance_long`` calls (chunks x padded frames x hop: the
overlap, the last chunk's padding past the recording, the frame padding to a
multiple of 64) that hold no new input audio. Read from the port's counter,
``model.LONG_SERVED``; None where the port has none."""


def read(ctx):
    long = ctx["window"].get("long")
    if not long or not long["enhanced_samples"]:
        return None
    return 100.0 * (1.0 - long["input_samples"] / long["enhanced_samples"])
