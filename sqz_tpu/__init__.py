"""tpu-sqz: a block-parallel lossless compression framework for an accelerator.

Implements the two wire formats of the reference C library leok7v/sqz —
the DEFLATE-like adaptive-Huffman ``squeeze`` format
(reference attic/map_experiment/) and the adaptive-range-coder ``sqz4``
format (reference inc/sqz/sqz.h + src/sqz.c) — plus a new block-parallel
``sqzt`` container, with three interchangeable engines:

* ``sqz_tpu.oracle``  — scalar pure-Python reference (the differential oracle)
* ``sqz_tpu.native``  — C++ host runtime (fast CPU path, ctypes-bound)
* ``sqz_tpu.ops``     — the device path: JAX/XLA and the CUDA coders through
  ``jax.ffi`` (block-parallel; ``engine="tpu"``)

See FORMAT.md for the normative wire-format spec.
"""

from sqz_tpu.api import (  # noqa: F401
    compress,
    compress_resident,
    decompress,
    decompress_range,
    decompress_resident,
    Format,
    Engine,
)

__version__ = "0.3.0"
