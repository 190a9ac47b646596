"""``torch.cuda.max_memory_allocated()`` over the run, set-up included, read
when the window closes (before the reference runs), in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
