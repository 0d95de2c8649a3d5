"""The device memory the window needs: ``torch.cuda.max_memory_allocated``
over the window, after a reset at its start, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 1024 ** 3 if ctx.peak_bytes else None
