"""decode_stage_ms: host ms a call in decode staging, the port's
api.stage_device_batch (C Tier-2 parse, HT scan, layer concatenation,
upload), from the benchmark's span around it."""


def read(r):
    return r.span_ms_per_call("decode_stage")
