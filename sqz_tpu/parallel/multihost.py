"""Multi-host execution: bootstrap, per-process shard gather, host-0 assembly.

The reference library is strictly single-threaded C (SURVEY.md §2.6;
reference inc/rt/rt.h:26-28 only *includes* <threads.h>); multi-host
block parallelism is a new first-class subsystem here (BASELINE.md: >= 90 %
scaling efficiency at N >= 2 hosts). The design:

* every process runs the same jitted shard_map program over the global mesh
  (blocks axis spans all processes' devices);
* the per-block compressed-length table is all-gathered ON DEVICE and is
  therefore replicated — every
  process knows every block's length;
* payloads stay sharded; each process reads only its *addressable* shards
  (`jax.Array.addressable_shards`) — no global np.asarray, which would
  fail (or transfer the world) on a multi-host array;
* process 0 assembles the container: variable-length payloads are
  exchanged with one `multihost_utils.process_allgather` over a
  fixed-shape per-process byte buffer whose layout every process derives
  from the replicated length table (single-process: the exchange is the
  identity).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax


def bootstrap(coordinator_address: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Initialize jax.distributed for a multi-process run.

    No-op when neither arguments nor the standard environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)
    indicate one; nothing detects a cluster, so a multi-process run names
    its coordinator, process count and id. ``local_device_ids`` binds the
    process to its own accelerators (one process per GPU: otherwise every
    process would reserve most of the first card's memory); default: the
    id list in JAX_LOCAL_DEVICE_IDS, else all local devices. Safe to call
    twice (the second call is ignored).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if local_device_ids is None and os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        local_device_ids = [int(x) for x in
                            os.environ["JAX_LOCAL_DEVICE_IDS"].split(",")]
    if coordinator_address is None and num_processes is None:
        return                                     # single-process run
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the process count and this process's id")
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
    except RuntimeError as e:                      # already initialized
        # jax has raised both "...already initialized" and
        # "distributed.initialize should only be called once."
        msg = str(e).lower()
        if "already" not in msg and "once" not in msg:
            raise


def addressable_block_payloads(words, lens: np.ndarray,
                               n_blocks: int) -> List[Tuple[int, bytes]]:
    """Extract this process's compressed blocks from a sharded encoder
    output.

    ``words``: jax.Array of shape [G, Pw, LANES] (u32 big-endian payload
    words) sharded over the leading group axis; ``lens``: the REPLICATED
    [G * LANES, ...] or [NB] length table (np.ndarray on host). Returns
    (global_block_index, payload_bytes) pairs for every addressable block.
    """
    lens = np.asarray(lens).reshape(-1)
    out: List[Tuple[int, bytes]] = []
    lanes = words.shape[2]
    for shard in words.addressable_shards:
        g0 = shard.index[0].start or 0
        local = np.asarray(shard.data)             # [g_local, Pw, LANES]
        for gl in range(local.shape[0]):
            g = g0 + gl
            for lane in range(lanes):
                b = g * lanes + lane
                if b >= n_blocks:
                    continue
                n = int(lens[b])
                out.append((b, local[gl, :, lane].astype(">u4")
                            .tobytes()[:n]))
    return out


def addressable_lane_payloads(words, lens: np.ndarray,
                              n_blocks: int) -> List[Tuple[int, bytes]]:
    """Same extraction for the lane-sharded encoder layout: ``words`` is a
    jax.Array [1, Pw, B] (u32 big-endian payload words) sharded over the
    LAST (lane) axis — the device-LZ sharded path, where the plan stages
    keep blocks on the lane axis end-to-end."""
    lens = np.asarray(lens).reshape(-1)
    out: List[Tuple[int, bytes]] = []
    for shard in words.addressable_shards:
        b0 = shard.index[2].start or 0
        local = np.asarray(shard.data)             # [1, Pw, per]
        for lane in range(local.shape[2]):
            b = b0 + lane
            if b >= n_blocks:
                continue
            n = int(lens[b])
            out.append((b, local[0, :(n + 3) // 4, lane].astype(">u4")
                        .tobytes()[:n]))
    return out


def addressable_scan_payloads(payload, lens: np.ndarray,
                              n_blocks: int) -> List[Tuple[int, bytes]]:
    """Same extraction for the XLA-scan encoder layout: ``payload`` is a
    jax.Array [B_padded, cap] of u8 sharded over the block axis."""
    lens = np.asarray(lens).reshape(-1)
    out: List[Tuple[int, bytes]] = []
    for shard in payload.addressable_shards:
        b0 = shard.index[0].start or 0
        local = np.asarray(shard.data)             # [b_local, cap]
        for bl in range(local.shape[0]):
            b = b0 + bl
            if b >= n_blocks:
                continue
            out.append((b, local[bl, :int(lens[b])].tobytes()))
    return out


def gather_payloads_to_host0(local_blocks: Sequence[Tuple[int, bytes]],
                             lens: np.ndarray,
                             n_blocks: int) -> Optional[List[bytes]]:
    """Ordered gather of variable-length payloads onto process 0.

    Every process calls this collectively. Returns the full ordered payload
    list on process 0 and None elsewhere. Single-process: pure reshuffle.
    """
    lens = np.asarray(lens).reshape(-1)[:n_blocks]
    if jax.process_count() == 1:
        out: List[Optional[bytes]] = [None] * n_blocks
        for b, p in local_blocks:
            out[b] = p
        missing = [i for i, p in enumerate(out) if p is None]
        if missing:
            raise ValueError(
                f"blocks missing from local shards: {missing[:4]}")
        return out                                 # type: ignore[return-value]

    from jax.experimental import multihost_utils

    # fixed-shape exchange buffer: every process packs its blocks (sorted
    # by global index) into a byte row padded to the largest process load
    my_ids, buf_row = pack_exchange_row(local_blocks, lens)
    counts = multihost_utils.process_allgather(
        np.array([my_ids.size, buf_row.size], np.int64))
    max_n, max_bytes = int(counts[:, 0].max()), int(counts[:, 1].max())
    ids_row = np.full(max_n, -1, np.int64)
    ids_row[:my_ids.size] = my_ids
    buf_row = np.concatenate(
        [buf_row, np.zeros(max_bytes - buf_row.size, np.uint8)])
    all_ids = multihost_utils.process_allgather(ids_row)    # [P, max_n]
    all_buf = multihost_utils.process_allgather(buf_row)    # [P, max_bytes]
    if jax.process_index() != 0:
        return None
    return unpack_exchange_rows(all_ids, all_buf, lens, n_blocks)


def pack_exchange_row(
        local_blocks: Sequence[Tuple[int, bytes]],
        lens: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One process's exchange row: (sorted global ids, concatenated payload
    bytes in id order). ``lens`` (the replicated length table): each
    payload is padded to its table length so the unpack side's offsets
    stay aligned even when a block's bytes were clamped at the encoder
    buffer (the oversized-warm-block case — those blocks are re-encoded
    on host 0 afterwards, the exchange only has to keep neighbors intact)."""
    my_ids = np.array(sorted(b for b, _ in local_blocks), np.int64)
    by_id = dict(local_blocks)
    if lens is not None:
        lens = np.asarray(lens).reshape(-1)
        buf = b"".join(by_id[int(b)].ljust(int(lens[b]), b"\0")[:int(lens[b])]
                       for b in my_ids)
    else:
        buf = b"".join(by_id[int(b)] for b in my_ids)
    return my_ids, np.frombuffer(buf, np.uint8).copy()


def unpack_exchange_rows(all_ids: np.ndarray, all_buf: np.ndarray,
                         lens: np.ndarray, n_blocks: int) -> List[bytes]:
    """Inverse of pack_exchange_row over every process's gathered row,
    splitting each byte row with the replicated length table."""
    lens = np.asarray(lens).reshape(-1)
    out: List[Optional[bytes]] = [None] * n_blocks
    for pr in range(all_ids.shape[0]):
        off = 0
        for b in all_ids[pr]:
            if b < 0:
                break
            n = int(lens[b])
            out[int(b)] = all_buf[pr, off:off + n].tobytes()
            off += n
    missing = [i for i, p in enumerate(out) if p is None]
    if missing:
        raise ValueError(f"blocks missing from exchange: {missing[:4]}")
    return out                                     # type: ignore[return-value]
