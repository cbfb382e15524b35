"""grok_tpu_torch: the PyTorch/CUDA port of grok_tpu's device path.

It imports the JAX package's jax-free host layers (codestream, T2, the C
runtime, the HT tables and serving plans) and ports what ran on the
device: today the batched HT serving decode, with the HT cleanup decoder
as a hand-written CUDA kernel for Hopper (csrc/ht_decode.cu).  Importing
the package builds nothing; the first launch on a CUDA tensor builds the
kernels (_build.py).
"""

from grok_tpu_torch.api import (decompress_device,  # noqa: F401
                                decompress_device_batch, stage_device_batch)
