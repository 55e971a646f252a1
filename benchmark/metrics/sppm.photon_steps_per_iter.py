"""sppm.photon_steps_per_iter: steps of the photon pass (the program's
counter ``photon.steps``, which an eager pass and every replay of the
captured pass add once: a bounce launch and the step's bookkeeping each)
over the traced stretch's SPPM iterations.

Nothing to read (None) where the program counted no photon step."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None:
        return None
    steps = rec["counters"].get("photon.steps", 0)
    its = recorder.iterations(ctx)
    if not steps or not its:
        return None
    return steps / its
