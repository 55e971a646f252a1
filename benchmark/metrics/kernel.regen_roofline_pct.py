"""kernel.regen_roofline_pct: the least time of the regeneration kernel's
work over its device time in the traced stretch, in percent.

- device time: every ``regen_kernel`` launch in the profiler's trace (the
  flat kernel of ``csrc/regen.cu``; not the ordered one);
- least time: ``harness.roofline.sweep_bound`` of the rays the entry
  reported for the stretch's passes, each tested against every primitive
  of the scene (counted by the reference's scene builder), and those
  launches' tables and the rays' lane state, against the published peaks.

Nothing to read (None) where no such kernel ran."""

import re

from harness import roofline
from reference import scenes

KERNEL = re.compile(r"(^|[^A-Za-z0-9_])regen_kernel($|[^A-Za-z0-9_])")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    rows = [v for k, v in t.ops.items() if KERNEL.search(k)]
    secs = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    rays = sum(p.get("rays", 0) for p in t.passes)
    if not launches or secs <= 0 or not rays:
        return None
    prims = scenes.build(ctx.cell.config, ctx.data_root).counts()
    b = roofline.sweep_bound(rays, launches, prims)
    return 100.0 * b["bound_s"] / secs
