"""Bit-level IO of packet headers (ISO/IEC 15444-1 B.10.1).

The port's copy of grok_tpu/codestream/bitio.py: MSB-first bits with the
JPEG 2000 stuffing rule (a byte following an 0xFF byte carries only 7
payload bits; its MSB is a stuffed 0).  Read by the Python Tier-2 packet
parse (t2/parse.py) in packet bodies and in PPM/PPT packed headers;
written by the Python packet encoder (t2/packet.py
PrecinctCtx.encode_packet) for POC-ordered and PPM streams.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer with 0xFF stuffing."""

    __slots__ = ("buf", "_cur", "_nbits")

    def __init__(self):
        self.buf = bytearray()
        self._cur = 0
        self._nbits = 0

    def _limit(self) -> int:
        return 7 if (self.buf and self.buf[-1] == 0xFF) else 8

    def write_bit(self, bit: int):
        self._cur = (self._cur << 1) | (bit & 1)
        self._nbits += 1
        if self._nbits == self._limit():
            self.buf.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def write_bits(self, value: int, n: int):
        for k in range(n - 1, -1, -1):
            self.write_bit((value >> k) & 1)

    def flush(self) -> bytes:
        """Pad to a byte boundary with 0 bits; a final 0xFF is followed by
        one 0x00 byte, so that a decoder aligning after the header does
        not misread."""
        if self._nbits:
            self._cur <<= self._limit() - self._nbits
            self.buf.append(self._cur)
            self._cur = 0
            self._nbits = 0
        if self.buf and self.buf[-1] == 0xFF:
            self.buf.append(0)
        return bytes(self.buf)


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
