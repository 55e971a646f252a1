"""device.idle_pct.sppm: the share of the traced stretch in which no
operation ran on the card, 100 (1 - union of the device activities'
intervals / stretch), in the SPPM iteration cells."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
