"""k1_roofline: kernel K1 (csrc/ht_decode.cu ht_decode_kernel) against
its roofline: the least time, the traced calls' stream bytes and 4 bytes
a decoded sample over the card's peak bandwidth, over K1's device time
in those calls, in %."""

from portbench import roofline


def read(r):
    if r.trace is None or r.direction != "decode":
        return None
    nbytes = roofline.decoder_bytes(r.traced["stream_bytes"],
                                    r.traced["samples"])
    return roofline.share_pct(nbytes, r.trace.kernel_s("ht_decode_kernel"),
                              r.kind)
