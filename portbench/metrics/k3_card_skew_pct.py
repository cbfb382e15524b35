"""k3_card_skew_pct: how far the slowest card's K3 lags the others in a
meshed decode: each card's device time in kernel K3 (csrc/t1_decode.cu
t1_decode_kernel) over the traced calls, and 100 x (the slowest card's
time / the mean over the cards - 1), in %.  0 where the cards' shares of
K3's lanes take equal time.  None without a device trace, or with fewer
than two cards that ran K3."""

import re

KERNEL = re.compile(r"(?<![A-Za-z0-9_])t1_decode_kernel(?![A-Za-z0-9_])")


def card_seconds(trace) -> dict:
    """{card: seconds} of K3 launches that start in the traced window."""
    out = {}
    for dev, ops in trace.ops.items():
        s = sum(dur for ts, dur, name in ops
                if trace.t0 <= ts < trace.t1 and KERNEL.search(name))
        if s > 0:
            out[dev] = s * 1e-6
    return out


def read(r):
    if r.trace is None or r.direction != "decode":
        return None
    got = list(card_seconds(r.trace).values())
    if len(got) < 2:
        return None
    return 100.0 * (max(got) / (sum(got) / len(got)) - 1.0)
