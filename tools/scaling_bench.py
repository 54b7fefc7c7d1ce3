"""Block-parallel scaling-efficiency harness (BASELINE.md: >= 90 % at
N >= 2 hosts; the reference has nothing to compare — zero parallelism).

Runs the sharded host-fed encode (token plan + the device coder,
parallel/shard.encode_data_sharded) over 1 device and over N devices with
the same per-device load (weak scaling — block-parallel compression is
embarrassingly parallel, so efficiency is bounded only by the length-table
all-gather and the host-0 payload exchange), and reports
efficiency = T1 / TN for equal per-device work.

One process: `python tools/scaling_bench.py` uses all local devices (the
virtual CPU mesh under JAX_PLATFORMS=cpu, or every GPU of the host).
Several processes, one per GPU: launch each with JAX_COORDINATOR_ADDRESS
(localhost:<free port> on one host), JAX_NUM_PROCESSES, JAX_PROCESS_ID
and --processes N; each binds to its own card (--local-device-ids, by
default the card numbered by JAX_PROCESS_ID) so no process reserves
another's memory. The harness bootstraps jax.distributed, shards over the
global mesh, and process 0 prints the report.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqz_tpu.utils import devcache  # one persistent XLA cache with bench.py

devcache.enable()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=1,
                    help="expected jax.process_count() (sanity check)")
    ap.add_argument("--blocks-per-device", type=int, default=4)
    ap.add_argument("--blk-bits", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--local-device-ids", default=None,
                    help="comma list of this process's local devices "
                         "(default with --processes > 1: JAX_PROCESS_ID)")
    args = ap.parse_args()

    import jax
    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        # honor an explicit CPU request (virtual-mesh runs) the way
        # tests/conftest.py does — via the config, before backend init
        jax.config.update("jax_platforms", "cpu")

    from sqz_tpu.parallel import multihost
    local = None
    if args.local_device_ids:
        local = [int(x) for x in args.local_device_ids.split(",")]
    elif args.processes > 1:
        local = [int(os.environ["JAX_PROCESS_ID"])]
    multihost.bootstrap(local_device_ids=local)
    assert jax.process_count() == args.processes, (
        f"process_count {jax.process_count()} != --processes "
        f"{args.processes}")

    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import encode_data_sharded
    from sqz_tpu.utils import corpus

    n_dev = len(jax.devices())
    bs = 1 << args.blk_bits

    def run(n_devices: int) -> float:
        mesh = make_mesh(n_devices)
        data = corpus.mixed(args.blocks_per_device * n_devices * bs)
        encode_data_sharded(data, args.blk_bits, 1 << 15, mesh,
                            parse="fast")                    # compile
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            encode_data_sharded(data, args.blk_bits, 1 << 15, mesh,
                                parse="fast")
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = run(1)
    tn = run(n_dev)
    eff = t1 / tn if tn > 0 else 0.0
    if jax.process_index() == 0:
        rec = {
            "metric": "block_parallel_weak_scaling_efficiency",
            "devices": n_dev,
            "processes": jax.process_count(),
            "blk_bits": args.blk_bits,
            "t_1dev_s": round(t1, 4),
            "t_ndev_s": round(tn, 4),
            "value": round(eff, 4),
            "target": 0.9,
        }
        if jax.default_backend() == "cpu":
            rec["caveat"] = ("virtual CPU mesh: all 'devices' share the "
                             "host's cores, so weak-scaling efficiency is "
                             "structurally < 1 here; the number is "
                             "meaningful on real multi-chip hardware")
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
