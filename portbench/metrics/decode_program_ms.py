"""decode_program_ms: ms a call in the device program, the port's
pipeline/serve.py StagedBatch.run (block decoders, dequantization,
synthesis, MCT), ended by a synchronize of every card, from the
benchmark's span around it."""


def read(r):
    return r.span_ms_per_call("decode_program")
