"""Per-block coding records (grok_tpu/t1/t1_scalar.py PassInfo and
EncodedBlock): what a block coder hands to Tier-2."""

from __future__ import annotations

from dataclasses import dataclass, field


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
