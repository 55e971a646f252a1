"""loop.mrays_per_s: rays the entry reports (alive lanes summed over the
regeneration loop's steps) of every pass of the window, over the window,
in millions."""


def read(ctx):
    if not ctx.passes or not all("rays" in p for p in ctx.passes):
        return None
    return sum(p["rays"] for p in ctx.passes) / ctx.window_s / 1e6
