"""The per-block cleanup plane of HT code-blocks.

The port's copy of `derive_p` from grok_tpu/t1ht/scalar.py, the one
function of the scalar HT coder the port's decode needs: the encoder and
decoder agree on each block's cleanup plane without signalling it per
block.
"""

from __future__ import annotations


def derive_p(numpasses: int, numbps: int, ht_planes: int | None) -> int:
    """Per-block cleanup plane.

    Standard framing (ht_planes None/0): p = 1 when HT SigProp/MagRef
    follow (numpasses >= 2), else 0.  With the ht_planes extension the
    global plane P is signalled once (COM marker) and the per-block
    plane is min(P, numbps-1) — the encoder clamp, decoder-computable
    from the tag-tree numbps, so PCRD pass truncation stays decodable."""
    if ht_planes:
        return min(ht_planes, numbps - 1) if numbps > 1 else 0
    return 1 if numpasses >= 2 else 0
