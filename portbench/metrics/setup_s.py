"""setup_s: seconds from the process's start to the first timed call
(imports, the port's libraries, the pool made and encoded, warm-up)."""


def read(r):
    return r.setup_s
