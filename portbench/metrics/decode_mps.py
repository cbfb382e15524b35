"""decode_mps: image pixels (width x height, every frame) decoded in the
window over the window's seconds, in millions."""


def read(r):
    if r.direction != "decode":
        return None
    rate = r.window.rate()
    return None if rate is None else rate / 1e6
