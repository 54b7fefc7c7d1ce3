"""Multi-host machinery on the single-process virtual mesh.

The reference has zero parallelism (SURVEY.md §2.6); BASELINE.md requires a
multi-host path. Real pods are unavailable in CI, so these tests pin the
three pieces that make the path correct: (a) the per-process
addressable-shard extraction (identical code single- and multi-process),
(b) the fixed-shape variable-length payload exchange (simulated with two
hand-packed process rows), (c) bootstrap being a safe no-op without a
cluster.
"""

import numpy as np
import pytest

import jax

from sqz_tpu.parallel import multihost
from sqz_tpu.utils import corpus


def test_bootstrap_noop_without_cluster(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    multihost.bootstrap()          # must not raise or initialize anything
    assert jax.process_count() == 1


def test_exchange_rows_roundtrip_two_processes():
    """Simulate a 2-process exchange: each process packs its local blocks,
    host 0 unpacks the stacked rows into the global ordered list."""
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, int(n), np.uint8).tobytes()
                for n in rng.integers(1, 40, 9)]
    lens = np.array([len(p) for p in payloads], np.int64)
    # process 0 holds even blocks, process 1 odd ones (any split works)
    p0 = [(b, payloads[b]) for b in range(0, 9, 2)]
    p1 = [(b, payloads[b]) for b in range(1, 9, 2)]
    ids0, row0 = multihost.pack_exchange_row(p0)
    ids1, row1 = multihost.pack_exchange_row(p1)
    max_n = max(ids0.size, ids1.size)
    max_b = max(row0.size, row1.size)
    pad_ids = lambda i: np.concatenate(
        [i, np.full(max_n - i.size, -1, np.int64)])
    pad_buf = lambda r: np.concatenate(
        [r, np.zeros(max_b - r.size, np.uint8)])
    all_ids = np.stack([pad_ids(ids0), pad_ids(ids1)])
    all_buf = np.stack([pad_buf(row0), pad_buf(row1)])
    out = multihost.unpack_exchange_rows(all_ids, all_buf, lens, 9)
    assert out == payloads


def test_addressable_scan_extraction_matches_global():
    """Per-process addressable-shard extraction must reproduce exactly what
    a global device-to-host copy would have produced."""
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import encode_blocks_sharded

    mesh = make_mesh(4)
    blocks = [corpus.texty(100 + 13 * i, seed=i) for i in range(10)]
    tokens = [[("lit", b) for b in blk] for blk in blocks]
    payloads = encode_blocks_sharded(tokens, blk_bits=8, mesh=mesh)
    assert payloads is not None            # process 0 gets the full list
    for i, blk in enumerate(blocks):
        assert payloads[i] == sqz4_encode_payload(blk, 1 << 8, lz=False)


def test_gather_single_process_identity():
    pairs = [(2, b"cc"), (0, b"aaa"), (1, b"b")]
    lens = np.array([3, 1, 2])
    out = multihost.gather_payloads_to_host0(pairs, lens, 3)
    assert out == [b"aaa", b"b", b"cc"]


@pytest.mark.slow
def test_two_process_real_exchange(tmp_path):
    """Execute the REAL multi-process exchange (VERDICT r2 #3): two
    jax.distributed CPU processes on a localhost coordinator run the
    sharded encode over one GLOBAL 8-device mesh; host 0's assembly goes
    through the actual process_allgather branch of
    gather_payloads_to_host0, and must be byte-identical to the
    single-process result."""
    import pickle
    import socket
    import subprocess
    import sys as _sys
    from pathlib import Path

    from sqz_tpu.formats.constants import (
        SQZ4_MIN_LEN, SQZ4_MAX_LEN, sqz4_reject_short_far)
    from sqz_tpu.oracle.match import greedy_tokens
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload

    with socket.socket() as s:                  # free localhost port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = Path(__file__).parent / "tools" / "multiproc_worker.py"
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(Path(__file__).parent.parent)
    procs = [subprocess.Popen(
        [_sys.executable, str(worker), str(i), "2", str(port),
         str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("2-process run timed out\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    payloads = pickle.loads((tmp_path / "payloads.pkl").read_bytes())
    # reference: the same parse encoded single-process by the oracle
    data = corpus.load("laozi.txt")[:8 * 1024]
    parts = [data[o:o + 1024] for o in range(0, len(data), 1024)]
    want = [sqz4_encode_payload(p, 1 << 10, lz=True) for p in parts]
    assert payloads == want
    # device-LZ leg (round 5): the 2-process sharded LZ payloads must
    # byte-equal the single-device resident-LZ path under the same
    # sort-slice config
    import os as _os

    from sqz_tpu.ops.resident import encode_resident_blocks
    lz_payloads = pickle.loads((tmp_path / "lz_payloads.pkl").read_bytes())
    lzdata = data[:4096] + bytes(256) + b"ab" * 256
    old = _os.environ.get("SQZ_LZ_SORT_ROWS")
    _os.environ["SQZ_LZ_SORT_ROWS"] = "2"
    try:
        lz_want = encode_resident_blocks(lzdata, 8, "lz", lanes=128)
    finally:
        if old is None:
            _os.environ.pop("SQZ_LZ_SORT_ROWS", None)
        else:
            _os.environ["SQZ_LZ_SORT_ROWS"] = old
    assert lz_payloads == lz_want
