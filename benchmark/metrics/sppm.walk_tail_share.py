"""sppm.walk_tail_share: the share of the traced stretch's SPPM iterations,
in %, whose measurement walk ran past its captured head and went on
eagerly (the program's counter ``walk.tail``, which every replay of the
head adds 0 or 1 to).

Nothing to read (None) where the program counts no ``walk.tail``: an
eager measurement, or a program without a captured head."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None or "walk.tail" not in rec["counters"]:
        return None
    its = recorder.iterations(ctx)
    if not its:
        return None
    return 100.0 * rec["counters"]["walk.tail"] / its
