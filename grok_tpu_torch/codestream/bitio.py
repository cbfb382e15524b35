"""Bit-level reading of packet headers (ISO/IEC 15444-1 B.10.1).

The port's copy of the reader half of grok_tpu/codestream/bitio.py:
MSB-first bits with the JPEG 2000 stuffing rule (a byte following an
0xFF byte carries only 7 payload bits; its MSB is a stuffed 0).  Read by
the Python Tier-2 packet parse (t2/parse.py) in packet bodies and in
PPM/PPT packed headers.
"""

from __future__ import annotations


class BitReader:
    """MSB-first bit reader with the 0xFF stuffing rule."""

    __slots__ = ("data", "pos", "end", "_cur", "_nbits", "_prev")

    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else min(end, len(data))
        self._cur = 0
        self._nbits = 0
        self._prev = 0

    def read_bit(self) -> int:
        if self._nbits == 0:
            if self.pos >= self.end:
                raise EOFError("packet header bit reader ran out of data")
            nbits = 7 if self._prev == 0xFF else 8
            self._cur = self.data[self.pos]
            self._prev = self._cur
            self.pos += 1
            self._nbits = nbits
        self._nbits -= 1
        return (self._cur >> self._nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align(self):
        """Byte-align after a header; consume the stuffed byte after 0xFF."""
        self._nbits = 0
        if self._prev == 0xFF:
            if self.pos < self.end:
                self._prev = self.data[self.pos]
                self.pos += 1
            else:
                self._prev = 0
