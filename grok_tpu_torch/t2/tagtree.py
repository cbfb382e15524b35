"""Tag trees (ISO/IEC 15444-1 B.10.2).

The port's copy of grok_tpu/t2/tagtree.py: a 2D quad-tree over the
code-blocks of a precinct band, whose leaves (first inclusion layers,
zero-bitplane counts) are coded incrementally against rising
thresholds.  Read by the Python Tier-2 packet parse (t2/packet.py
PrecinctCtx.decode_packet), written by the Python packet encoder
(PrecinctCtx.encode_packet).
"""

from __future__ import annotations

from grok_tpu_torch.codestream.bitio import BitReader, BitWriter

_INF = 0x7FFFFFFF


class TagTree:
    def __init__(self, w: int, h: int):
        if w <= 0 or h <= 0:
            raise ValueError(f"tag tree dims must be positive, got {w}x{h}")
        self.w = w
        self.h = h
        # dims[0] = leaves (w, h) ... dims[-1] = the 1x1 root
        self.dims: list[tuple[int, int]] = []
        ww, hh = w, h
        while True:
            self.dims.append((ww, hh))
            if ww == 1 and hh == 1:
                break
            ww = (ww + 1) // 2
            hh = (hh + 1) // 2
        self.reset()

    def reset(self):
        self.value = [[_INF] * (ww * hh) for (ww, hh) in self.dims]
        self.low = [[0] * (ww * hh) for (ww, hh) in self.dims]
        self.known = [[False] * (ww * hh) for (ww, hh) in self.dims]

    # -- encoder side -------------------------------------------------------
    def set_value(self, x: int, y: int, v: int):
        """Set a leaf value and propagate min() up the tree."""
        for lvl, (ww, _hh) in enumerate(self.dims):
            idx = y * ww + x
            if self.value[lvl][idx] <= v:
                break
            self.value[lvl][idx] = v
            x >>= 1
            y >>= 1

    def _path(self, x: int, y: int):
        path = []
        for lvl, (ww, _hh) in enumerate(self.dims):
            path.append((lvl, y * ww + x))
            x >>= 1
            y >>= 1
        return reversed(path)  # root -> leaf

    def encode(self, bw: BitWriter, x: int, y: int, threshold: int):
        low = 0
        for lvl, idx in self._path(x, y):
            if low > self.low[lvl][idx]:
                self.low[lvl][idx] = low
            else:
                low = self.low[lvl][idx]
            while low < threshold:
                if low >= self.value[lvl][idx]:
                    if not self.known[lvl][idx]:
                        bw.write_bit(1)
                        self.known[lvl][idx] = True
                    break
                bw.write_bit(0)
                low += 1
            self.low[lvl][idx] = low

    # -- decoder side -------------------------------------------------------
    def decode(self, br: BitReader, x: int, y: int, threshold: int) -> bool:
        """True iff the leaf value is < threshold (resolved by these
        bits)."""
        low = 0
        leaf_lvl, leaf_idx = 0, y * self.dims[0][0] + x
        for lvl, idx in self._path(x, y):
            if low > self.low[lvl][idx]:
                self.low[lvl][idx] = low
            else:
                low = self.low[lvl][idx]
            while low < threshold and low < self.value[lvl][idx]:
                if br.read_bit():
                    self.value[lvl][idx] = low
                    break
                low += 1
            self.low[lvl][idx] = low
            leaf_lvl, leaf_idx = lvl, idx
        return self.value[leaf_lvl][leaf_idx] < threshold

    def leaf_value(self, x: int, y: int) -> int:
        return self.value[0][y * self.dims[0][0] + x]
