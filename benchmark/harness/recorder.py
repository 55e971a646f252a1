"""The program's own spans and counters: what
``raytracer_tpu_torch.utils.timing`` recorded while the traced stretch's
profiler ran (the recorder records under any profiler session, and the
traced run opens one, around the stretch alone). A program without the
recorder, or a run that recorded nothing, gives None."""

from __future__ import annotations

SYNC = ".sync"          # the suffix of a span around a host read


def records(ctx):
    """``timing.recorded()`` of the traced stretch, or None."""
    if ctx.trace is None:
        return None
    from raytracer_tpu_torch.utils import timing
    recorded = getattr(timing, "recorded", None)
    if recorded is None:
        return None
    rec = recorded()
    return rec if rec["spans"] or rec["counters"] else None


def span_s(rec, name: str) -> float:
    """Seconds of the span ``name`` over the stretch (0 where absent)."""
    return rec["spans"].get(name, {}).get("s", 0.0)


def host_reads(rec) -> tuple:
    """(count, seconds) of the spans around host reads."""
    rows = [v for k, v in rec["spans"].items() if k.endswith(SYNC)]
    return sum(r["n"] for r in rows), sum(r["s"] for r in rows)


def iterations(ctx) -> int:
    """SPPM iterations of the stretch's passes."""
    return sum(p.get("iterations", 0) for p in ctx.trace.passes)
