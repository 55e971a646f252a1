"""loop.steps_per_pass: steps of the regeneration loop (the program's
counter ``regen.steps``: one host read and one dispatch each) over the
traced stretch's passes.

Nothing to read (None) where the program recorded no step."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None or not ctx.trace.passes:
        return None
    steps = rec["counters"].get("regen.steps", 0)
    if not steps:
        return None
    return steps / len(ctx.trace.passes)
