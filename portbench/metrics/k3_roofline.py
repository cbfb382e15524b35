"""k3_roofline: kernel K3 (csrc/t1_decode.cu t1_decode_kernel) against
its roofline: the least time, the traced calls' stream bytes and 4 bytes
a decoded sample over the card's peak bandwidth, over K3's device time
in those calls summed over the cards, in %."""

from portbench import roofline


def read(r):
    if r.trace is None or r.direction != "decode":
        return None
    nbytes = roofline.decoder_bytes(r.traced["stream_bytes"],
                                    r.traced["samples"])
    return roofline.share_pct(nbytes, r.trace.kernel_s("t1_decode_kernel"),
                              r.kind)
