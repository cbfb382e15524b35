"""Peaks of the card and the bytes a kernel must move.

The bytes are counted from the cell's own data (the streams and the
frames the benchmark made), the same whatever implements the kernel,
and never from the port's staged lanes.  A share of the roofline is the
least time, bytes over the peak bandwidth, divided by the kernel's
device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet (80 GB HBM3), dense rates, at the full
# power limit of 700 W; `run.py` prints the card's own limit beside it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops": 67e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def hbm_bytes_per_s(kind: str | None) -> float:
    """The card's peak memory bandwidth (the H100 SXM's where the card
    is not in the table)."""
    return PEAKS.get(kind or "", PEAKS[DEFAULT_CARD])["hbm_bytes_per_s"]


def decoder_bytes(stream_bytes: int, samples: int) -> int:
    """A block decoder's bytes (K1, K3): the batch's stream bytes read
    once and a 4-byte sample written for each decoded sample (width x
    height x components x frames)."""
    return int(stream_bytes) + 4 * int(samples)


def share_pct(nbytes: int, kernel_seconds: float, kind: str | None) -> \
        float | None:
    """The least time over the kernel's time, in %; None where the trace
    holds no time for the kernel."""
    if not kernel_seconds or kernel_seconds <= 0:
        return None
    return 100.0 * nbytes / hbm_bytes_per_s(kind) / kernel_seconds
