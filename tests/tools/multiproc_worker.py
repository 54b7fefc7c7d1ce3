"""Worker for the REAL 2-process jax.distributed exchange test
(tests/test_multihost.py::test_two_process_real_exchange, VERDICT r2 #3).

Each process brings up jax.distributed against a localhost coordinator,
builds the GLOBAL 8-device CPU mesh (4 virtual devices per process), runs
the sharded encode, and exercises the actual `process_allgather` branch of
gather_payloads_to_host0 (multihost.py) — the code path a single-process
test can never reach. Process 0 writes the ordered payload list; the
parent compares it byte-for-byte with the single-process result.
"""

import os
import pickle
import sys


def main() -> int:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")   # virtual CPU devices only
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc      # global device view

    from jax.sharding import Mesh

    from sqz_tpu.formats.constants import (
        SQZ4_MIN_LEN, SQZ4_MAX_LEN, sqz4_reject_short_far)
    from sqz_tpu.oracle.match import greedy_tokens
    from sqz_tpu.parallel.shard import encode_blocks_sharded
    from sqz_tpu.utils import corpus

    data = corpus.load("laozi.txt")[:8 * 1024]
    parts = [data[o:o + 1024] for o in range(0, len(data), 1024)]
    tokens = [greedy_tokens(p, 1 << 10, SQZ4_MIN_LEN, SQZ4_MAX_LEN,
                            reject=sqz4_reject_short_far) for p in parts]
    mesh = Mesh(jax.devices(), ("blocks",))
    payloads = encode_blocks_sharded(tokens, 10, mesh)
    if jax.process_index() == 0:
        assert payloads is not None
        with open(os.path.join(outdir, "payloads.pkl"), "wb") as f:
            pickle.dump(payloads, f)
    else:
        assert payloads is None                 # only host 0 assembles

    # device-LZ leg: the global-view plan stages + shard_map device
    # encoder run across BOTH processes; exercises the lane-sharded
    # payload extraction
    os.environ["SQZ_LZ_SORT_ROWS"] = "2"
    from sqz_tpu.parallel.shard import encode_lz_sharded
    lzdata = data[:4096] + bytes(256) + b"ab" * 256
    lzp = encode_lz_sharded(lzdata, 8, mesh, lanes=128)
    if jax.process_index() == 0:
        assert lzp is not None
        with open(os.path.join(outdir, "lz_payloads.pkl"), "wb") as f:
            pickle.dump(lzp, f)
    else:
        assert lzp is None
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
