"""loop.dispatch_us_per_step: host microseconds a step of the
regeneration loop from its host read's return to its last launch's
return (the program's span ``regen.dispatch``: the uniform draw, the
wrapper's checks and packing, the launch), summed over the traced
stretch, over the loop's steps there (counter ``regen.steps``).

Nothing to read (None) where the program recorded no step."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None:
        return None
    steps = rec["counters"].get("regen.steps", 0)
    if not steps or "regen.dispatch" not in rec["spans"]:
        return None
    return 1e6 * recorder.span_s(rec, "regen.dispatch") / steps
