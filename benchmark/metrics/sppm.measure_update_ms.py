"""sppm.measure_update_ms: milliseconds per iteration of the measurement
pass, both photon queries and the update (``sppm_iteration(times=...)``'s
stages "measurement", "query global", "query caustic" and "update"), the
mean over the window's iterations."""

STAGES = ("measurement", "query global", "query caustic", "update")


def read(ctx):
    rows = ctx.stages or []
    if not rows:
        return None
    ms = [1e3 * sum(r.get(s, 0.0) for s in STAGES) for r in rows]
    return sum(ms) / len(ms)
