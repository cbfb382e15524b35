"""Per-block coding records and the Part-1 pass structure.

The port's copy of the pass bookkeeping of grok_tpu/t1/t1_scalar.py
(`PASS_*`, `pass_schedule`, `is_raw_pass`, `segment_pass_counts`,
PassInfo and EncodedBlock: what a block coder hands to Tier-2) and of
the significance types of grok_tpu/ops/t1_enc.py (`SIG_*`)."""

from __future__ import annotations

from dataclasses import dataclass, field

from grok_tpu_torch.core.params import CBLK_BYPASS, CBLK_HT, CBLK_TERMALL

PASS_SIG, PASS_REF, PASS_CLN = 0, 1, 2

# pass in which a sample became significant (the encoder's sigtype map)
SIG_NONE, SIG_SPP, SIG_CLN = 0, 1, 2


def pass_schedule(numbps: int) -> list[tuple[int, int]]:
    """[(pass_type, bitplane)] — cleanup at the MSB plane, then SPP/MRP/CUP."""
    if numbps <= 0:
        return []
    sched = [(PASS_CLN, numbps - 1)]
    for bp in range(numbps - 2, -1, -1):
        sched += [(PASS_SIG, bp), (PASS_REF, bp), (PASS_CLN, bp)]
    return sched


def is_raw_pass(passno: int, ptype: int, style: int) -> bool:
    return bool(style & CBLK_BYPASS) and passno >= 10 and ptype != PASS_CLN


def segment_pass_counts(numpasses: int, style: int) -> list[int]:
    """How coding passes group into codeword segments (termination pattern).

    Shared by T1 (encode/decode) and T2 (length signalling) — the decoder
    derives the segment count from numpasses + style alone (B.10.7).
    """
    if numpasses <= 0:
        return []
    if style & CBLK_HT:
        # HT passes (Cleanup, SigProp, MagRef) each terminate their own
        # codeword segment (ISO 15444-15 pass structure)
        return [1] * numpasses
    if style & CBLK_TERMALL:
        return [1] * numpasses
    if style & CBLK_BYPASS:
        segs = [min(10, numpasses)]
        rem = numpasses - segs[0]
        while rem:
            k = min(2, rem)           # raw SPP+MRP run
            segs.append(k)
            rem -= k
            if rem:
                segs.append(1)        # MQ cleanup
                rem -= 1
        return segs
    return [numpasses]


@dataclass
class PassInfo:
    rate: int          # cumulative bytes (over all segments) to decode through this pass
    dist: float        # cumulative distortion reduction (quantized-units^2)
    term: bool         # segment terminates after this pass


@dataclass
class EncodedBlock:
    data: bytes = b""
    numbps: int = 0                      # magnitude bitplanes actually coded
    passes: list[PassInfo] = field(default_factory=list)
    seg_lens: list[int] = field(default_factory=list)       # exact terminated lengths
    seg_passes: list[int] = field(default_factory=list)

    @property
    def numpasses(self) -> int:
        return len(self.passes)
