"""`torch.cuda.max_memory_allocated` over the run on the fullest card,
in MiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**20 if ctx["peak_bytes"] else None
