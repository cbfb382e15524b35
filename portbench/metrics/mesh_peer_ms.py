"""mesh_peer_ms: device ms a traced call in copies between cards (the
body and K3's lanes sent to each card, K3's outputs gathered back, the
synthesis rows split and gathered, the halos), summed over the cards.

It counts the device trace's memory copies named as peer-to-peer by
CUPTI ("Memcpy PtoP (Device -> Device)" on the H100: a copy between two
cards, whether it runs over NVLink or through the host); copies on one
card (DtoD), to or from the host (HtoD, DtoH), kernels and fills are
left out.  None without a device trace or a traced call, or on fewer
than two cards."""

PEER = "PtoP"


def read(r):
    t = r.trace
    if t is None or r.direction != "decode" or not t.calls \
            or len(t.devices) < 2:
        return None
    us = sum(dur for ops in t.ops.values() for ts, dur, name in ops
             if t.t0 <= ts < t.t1 and name.startswith("Memcpy")
             and PEER in name)
    return 1e-3 * us / t.calls
