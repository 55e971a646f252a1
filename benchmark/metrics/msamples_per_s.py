"""msamples_per_s: camera samples (pixels x samples per pixel) of every
pass completed in the window, over the whole window, in millions."""


def read(ctx):
    if not all("samples" in p for p in ctx.passes):
        return None
    return sum(p["samples"] for p in ctx.passes) / ctx.window_s / 1e6
