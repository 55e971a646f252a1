"""sppm.host_reads_per_iter: the program's host reads of device data (its
spans named ``*.sync``: the measurement walk's per-step read, the
queries' and the loops' reads) over the traced stretch's SPPM
iterations.

Nothing to read (None) where the program recorded no iteration (span
``sppm.iteration``)."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None or "sppm.iteration" not in rec["spans"]:
        return None
    its = recorder.iterations(ctx)
    if not its:
        return None
    return recorder.host_reads(rec)[0] / its
