"""sppm.photon_pass_ms: milliseconds per iteration of the photon pass and
both photon maps (``sppm_iteration(times=...)``'s stage "photon pass",
which covers the grid builds on the CUDA graph, plus "grid build" where
it is timed apart), the mean over the window's iterations."""


def read(ctx):
    rows = ctx.stages or []
    if not rows:
        return None
    ms = [1e3 * (r.get("photon pass", 0.0) + r.get("grid build", 0.0))
          for r in rows]
    return sum(ms) / len(ms)
