"""pass_s_p95: the 95th percentile of the wall time of every pass of the
window (each from its call to the device synchronise that ends it): the
wait between two updates of the progressive image."""

from harness import stats


def read(ctx):
    return stats.percentile([p["s"] for p in ctx.passes], 95)
