"""Checkpoint pytrees through the device-resident codec.

The flagship use of the resident paths (ops/resident.py): a pytree of
device arrays (model/optimizer state) compresses WITHOUT the host
touching the data — each leaf is bitcast to bytes on-device, cell-parsed
and coded by the device encoder, and only payload bytes cross the link to
disk. Restore mirrors it: payload bytes upload once and the decoded
bytes are assembled on-device, bitcast back to the leaf dtype/shape.

File layout (versioned): magic ``SQZCKPT1`` + u32 metadata length + a
pickled metadata dict (treedef, per-leaf shape/dtype/nbytes/filters/
stream offset) + ONE sqzt container holding every leaf's filtered byte
stream concatenated on-device — small leaves share blocks and the whole
tree codes as one batched encoder dispatch instead of one underfilled
lane group per leaf.
"""

from __future__ import annotations

import pickle
import struct
from pathlib import Path

import jax
import numpy as np
from jax import numpy as jnp

MAGIC = b"SQZCKPT1"


def _leaf_bytes_device(x, shuffle: bool):
    """Device array of any dtype -> 1-D u8 device view (bitcast, no
    download). ``shuffle``: byte-plane transposition (the blosc trick) —
    for multi-byte dtypes, plane k holds every element's k-th byte, so
    the repetitive sign/exponent bytes of float data form long runs the
    cell parse catches. Returns (bytes_1d, itemsize_used_for_shuffle)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.uint8:
        return x.reshape(-1), 1
    if x.dtype == jnp.bool_:
        return x.astype(jnp.uint8).reshape(-1), 1
    by = jax.lax.bitcast_convert_type(x, jnp.uint8).reshape(-1,
                                                            x.dtype.itemsize)
    if shuffle and x.dtype.itemsize > 1 and by.shape[0] > 1:
        return by.transpose(1, 0).reshape(-1), x.dtype.itemsize
    return by.reshape(-1), 1


def _delta_device(flat):
    """Byte-wise delta (wrap-around) — after the shuffle, slowly-varying
    planes (float exponents of smooth data) become zero runs the cell
    parse matches. Inverse is a mod-256 cumsum."""
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint8), flat[:-1]])
    return flat - prev


def _undelta_device(flat):
    return (jnp.cumsum(flat.astype(jnp.int32)) % 256).astype(jnp.uint8)


def save_pytree(tree, path, blk_bits: int = 16, mode: str = "rle",
                shuffle: bool = True, delta: bool = True, mesh=None,
                lanes: int = None) -> dict:
    """Compress a pytree of (device) arrays to ``path`` via
    compress_resident. Returns a stats dict (raw/compressed bytes).

    Sparse training state (zero-heavy optimizer slots, padded embeddings)
    benefits most — the device RLE parse turns zero cells into dist-1
    matches (PERF.md). ``shuffle`` (default on) byte-plane-transposes
    multi-byte leaves on-device first, grouping float sign/exponent
    bytes into runs.

    ``mesh``: shard the concatenated byte stream's blocks over a
    jax.sharding.Mesh so every device parses + codes its own shards in
    parallel (the distributed-checkpoint case). In a multi-process mesh
    only process 0 writes the file (returns None elsewhere)."""
    import sqz_tpu
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    metas = []
    streams = []
    off = 0
    for leaf in leaves:
        arr = jnp.asarray(leaf)
        flat, shuf = _leaf_bytes_device(arr, shuffle)
        use_delta = bool(delta) and int(flat.shape[0]) > 1
        if use_delta:
            flat = _delta_device(flat)
        nbytes = int(flat.shape[0])
        metas.append(dict(shape=tuple(arr.shape), dtype=str(arr.dtype),
                          nbytes=nbytes, offset=off, shuffle=shuf,
                          delta=use_delta))
        if nbytes:
            streams.append(flat)
        off += nbytes
    raw = off
    stream = jnp.concatenate(streams) if streams \
        else jnp.zeros((0,), jnp.uint8)
    blob = sqz_tpu.compress_resident(stream, blk_bits=blk_bits,
                                     mode=mode, mesh=mesh, lanes=lanes)
    if blob is None:                    # non-zero process of a multi-host mesh
        return None
    meta = pickle.dumps(dict(treedef=treedef, leaves=metas,
                             blk_bits=blk_bits))
    out = bytearray(MAGIC)
    out += struct.pack("<I", len(meta))
    out += meta
    out += blob
    Path(path).write_bytes(bytes(out))
    return dict(raw_bytes=raw, compressed_bytes=len(blob),
                ratio=len(blob) / raw if raw else 0.0)


def load_pytree(path, mesh=None, lanes: int = None):
    """Restore a pytree saved by save_pytree: containers decode through
    the device-resident restore path (decompress_resident), leaves are
    bitcast back on-device. ``mesh``: restore with blocks sharded over
    the mesh (each device assembles its own shards)."""
    import sqz_tpu
    data = Path(path).read_bytes()
    if data[:8] != MAGIC:
        raise ValueError("not a sqz-tpu checkpoint")
    (mlen,) = struct.unpack("<I", data[8:12])
    meta = pickle.loads(data[12:12 + mlen])
    stream = sqz_tpu.decompress_resident(data[12 + mlen:], mesh=mesh,
                                         lanes=lanes)
    leaves = []
    for m in meta["leaves"]:
        dtype = jnp.dtype(m["dtype"])
        if m["nbytes"] == 0:
            leaves.append(jnp.zeros(m["shape"], dtype))
            continue
        flat = stream[m["offset"]:m["offset"] + m["nbytes"]]
        if m.get("delta"):
            flat = _undelta_device(flat)
        shuf = m.get("shuffle", 1)
        if shuf > 1:                      # undo the byte-plane transpose
            flat = flat.reshape(shuf, -1).transpose(1, 0).reshape(-1)
        if dtype == jnp.uint8:
            arr = flat.reshape(m["shape"])
        elif dtype == jnp.bool_:
            arr = flat.astype(jnp.bool_).reshape(m["shape"])
        else:
            itemsize = dtype.itemsize
            arr = jax.lax.bitcast_convert_type(
                flat.reshape(-1, itemsize), dtype).reshape(m["shape"])
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(meta["treedef"], leaves)
