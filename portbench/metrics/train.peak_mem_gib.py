"""train.peak_mem_gib (GiB): ``torch.cuda.max_memory_allocated`` over the
window (reset at its start)."""


def read(ctx):
    return ctx["peak"] / 2 ** 30 if ctx.get("peak") else None
