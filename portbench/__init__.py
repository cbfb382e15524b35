"""The benchmark of the PyTorch and CUDA port (`grok_tpu_torch`).

One process runs one cell once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`:
the deployment's geometry, precision and coding parameters) and a
traffic mix (`traffic/<name>.json`: direction, frames a call, pool size,
mesh width).  Each metric of `BENCHMARK.json` is read by its own file,
`metrics/<name>.py`.  The harness finds all three by name, so a later
change adds a configuration, a mix or a metric by adding a file.

The yardstick lives here and nowhere in the port: the content generator
(`synth.py`), the window arithmetic (`window.py`), the reading of the
device trace (`devtrace.py`), the table of peaks and the byte counts of
the kernels (`roofline.py`), and the comparison that decides `correct`
(`check.py`, against the sources made from the seed).  Nothing here
imports JAX or the JAX package.
"""
