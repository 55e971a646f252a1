"""sppm_iters_per_s: SPPM iterations completed in the window, over the
whole window."""


def read(ctx):
    if not all("iterations" in p for p in ctx.passes):
        return None
    return sum(p["iterations"] for p in ctx.passes) / ctx.window_s
