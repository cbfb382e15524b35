"""decode_ms_p95: the 95th percentile (nearest rank) of the time of every
decode call of the window, in ms."""

from portbench.window import percentile


def read(r):
    if r.direction != "decode":
        return None
    p = percentile(r.window.call_seconds, 95)
    return None if p is None else 1e3 * p
