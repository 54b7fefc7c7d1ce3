"""Device compute path: the block-parallel codec on the accelerator.

Design (see FORMAT.md §3, SURVEY.md §7 and PERF.md): the entropy coders are
serial *within* a block by construction — every token updates the adaptive
model the next token is coded with — so device throughput comes from coding
many independent blocks side by side, one block per lane.

* ``coder`` — the device sqz4 coders: one encoder and one decoder in
  ``native/sqz4_coder.h``, called through ``jax.ffi`` (CUDA on a GPU, the
  same source built for the host on the CPU).
* ``sqz4_jax`` / ``squeeze_jax`` / ``huffman_jax`` — the batched XLA scan
  formulation; bit-identical, one while-loop iteration per coder step. The
  plain XLA reference the device coders are measured against, and the
  shard_map scan paths of ``parallel/shard.py``.
* ``resident`` / ``lzparse`` / ``lz_restore`` — device-resident parses and
  restore assemblies around the coders.

x64 mode is required by the scan paths: the wire formats are defined over
exact 64-bit range-coder arithmetic (FORMAT.md §2.3).
"""

import jax

jax.config.update("jax_enable_x64", True)
