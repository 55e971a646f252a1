"""kernel.bounce_ordered_roofline_pct: the least time of the ordered
bounce's triangle walk over the kernel's device time in the traced
stretch, in percent.

- device time: every ``bounce_ordered_kernel`` launch in the profiler's
  trace (``csrc/bounce_ordered.cu``; not the flat ``bounce_kernel``);
- least time: ``harness.roofline_ordered.walk_bound`` of the chunk bodies
  the program counted over the same stretch (its counter
  ``ordered.bodies``, which every ordered bounce adds to) and those
  launches, for the triangles of the configuration's meshes.

Nothing to read (None) where no such kernel ran or the program counts no
bodies."""

import re

from harness import recorder, roofline_ordered

KERNEL = re.compile(r"(^|[^A-Za-z0-9_])bounce_ordered_kernel($|[^A-Za-z0-9_])")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    rows = [v for k, v in t.ops.items() if KERNEL.search(k)]
    secs = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    rec = recorder.records(ctx)
    bodies = 0 if rec is None else rec["counters"].get("ordered.bodies", 0)
    triangles = sum(m.get("triangles", 0)
                    for m in ctx.cell.config["scene"].get("meshes", []))
    if not launches or secs <= 0 or not bodies or not triangles:
        return None
    b = roofline_ordered.walk_bound(bodies, launches, triangles)
    return 100.0 * b["bound_s"] / secs
