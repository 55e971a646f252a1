"""sppm.dispatch_ms_per_iter: host milliseconds an SPPM iteration spends
issuing work: the program's span ``sppm.iteration`` less its host reads
(spans ``*.sync``) and the photon graph's replay (span ``graph.replay``),
over the traced stretch's iterations.

Nothing to read (None) where the program recorded no iteration."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None or "sppm.iteration" not in rec["spans"]:
        return None
    its = recorder.iterations(ctx)
    if not its:
        return None
    s = (recorder.span_s(rec, "sppm.iteration")
         - recorder.host_reads(rec)[1]
         - recorder.span_s(rec, "graph.replay"))
    return 1e3 * s / its
