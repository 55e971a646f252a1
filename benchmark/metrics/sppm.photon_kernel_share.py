"""sppm.photon_kernel_share: the share, in %, of the traced stretch's photon
steps (the program's counter ``photon.steps``) that went through the
photon step kernel (its counter ``photon.kernel_steps``: the kernel's
launches, which an eager pass and every replay of the captured pass add
beside ``photon.steps``).

Nothing to read (None) where the program counts no ``photon.kernel_steps``
(a program without the kernel) or no photon step."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None or "photon.kernel_steps" not in rec["counters"]:
        return None
    steps = rec["counters"].get("photon.steps", 0)
    if not steps:
        return None
    return 100.0 * rec["counters"]["photon.kernel_steps"] / steps
