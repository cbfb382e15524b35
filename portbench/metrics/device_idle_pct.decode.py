"""device_idle_pct.decode: the share of the traced window in which no
operation (kernel, copy, fill) ran on a card, averaged over the cell's
cards, in a decode cell, in %."""


def read(r):
    if r.trace is None or r.direction != "decode" or not r.trace.devices \
            or r.trace.mean_busy_s() <= 0:
        return None
    got = [r.trace.idle_pct(d) for d in r.trace.devices]
    return None if None in got else sum(got) / len(got)
