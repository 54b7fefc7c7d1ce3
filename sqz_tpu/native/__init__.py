"""ctypes bindings for the native C++ host runtime (sqz_native.cpp).

The shared library is built on first use (``make -C sqz_tpu/native``); all
entry points return the produced byte count or -errno. Payload functions
operate on headerless block payloads (sqzt container framing); the
single-block functions add/parse the reference containers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from sqz_tpu.formats.constants import SQZ4_MAGIC

_DIR = Path(__file__).parent
_SO = _DIR / "libsqznative.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def build_locked(make_args, outputs, sources, directory: Path = _DIR):
    """Run ``make -C <directory> <make_args>`` unless every output is
    newer than every source, holding an exclusive lock on the Makefile so
    concurrent processes (test workers) never load a half-written
    library. Raises CalledProcessError / FileNotFoundError on failure."""
    import fcntl

    def fresh():
        return all(o.exists() for o in outputs) and all(
            o.stat().st_mtime >= s.stat().st_mtime
            for o in outputs for s in sources if s.exists())

    if fresh():
        return
    with open(directory / "Makefile") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not fresh():
            subprocess.run(["make", "-C", str(directory)] + list(make_args),
                           check=True, capture_output=True, text=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            build_locked(["libsqznative.so"], [_SO],
                         [_DIR / "sqz_native.cpp", _DIR / "sqz4_coder.h"])
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            _build_error = getattr(e, "stderr", str(e)) or str(e)
            return None
        lib = ctypes.CDLL(str(_SO))
        i64, u64, i32, u32 = (ctypes.c_int64, ctypes.c_uint64,
                              ctypes.c_int32, ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sqz_squeeze_compress.restype = i64
        lib.sqz_squeeze_compress.argtypes = [u8p, u64, i32, i32, u8p, u64]
        lib.sqz_squeeze_decompress.restype = i64
        lib.sqz_squeeze_decompress.argtypes = [u8p, u64, i32, u64, u8p, u64]
        lib.sqz_sqz4_compress.restype = i64
        lib.sqz_sqz4_compress.argtypes = [u8p, u64, u32, i32, u8p, u64]
        lib.sqz_sqz4_decompress.restype = i64
        lib.sqz_sqz4_decompress.argtypes = [u8p, u64, u64, u8p, u64]
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.sqz_tokenize.restype = i64
        lib.sqz_tokenize.argtypes = [u8p, u64, u32, i32, i32, i32, i32p, u64]
        lib.sqz_sqz4_model_stats.restype = i64
        lib.sqz_sqz4_model_stats.argtypes = [i32p, i32p, u64, u32p,
                                             u32p, u32p, u32p]
        lib.sqz_blocks_compress.restype = i64
        lib.sqz_blocks_compress.argtypes = [u8p, u64, i32, i32, i32, i32, i32,
                                            i32, i32, u8p, u64, i64p, u8p]
        lib.sqz_blocks_decompress.restype = i64
        lib.sqz_blocks_decompress.argtypes = [u8p, i64p, i64p, u64, i32, i32,
                                              i32, i32, i32, u8p, u8p, u64]
        u32p_ = ctypes.POINTER(ctypes.c_uint32)
        lib.sqz_sqz4_compress_s.restype = i64
        lib.sqz_sqz4_compress_s.argtypes = [u8p, u64, u32, i32, u32p_, u32p_,
                                            u8p, u64, u8p, u64]
        lib.sqz_sqz4_compress_f.restype = i64
        lib.sqz_sqz4_compress_f.argtypes = [u8p, u64, u32, i32, i32, u32p_,
                                            u32p_, u8p, u64, u8p, u64]
        lib.sqz_sqz4_decompress_s.restype = i64
        lib.sqz_sqz4_decompress_s.argtypes = [u8p, u64, u64, u32p_, u32p_,
                                              u8p, u64, u8p, u64]
        lib.sqz_squeeze_compress_s.restype = i64
        lib.sqz_squeeze_compress_s.argtypes = [u8p, u64, i32, i64p, i64p,
                                               u8p, u64, u8p, u64]
        lib.sqz_squeeze_compress_f.restype = i64
        lib.sqz_squeeze_compress_f.argtypes = [u8p, u64, i32, i32, i64p,
                                               i64p, u8p, u64, u8p, u64]
        lib.sqz_squeeze_decompress_s.restype = i64
        lib.sqz_squeeze_decompress_s.argtypes = [u8p, u64, u64, i64p, i64p,
                                                 u8p, u64, u8p, u64]
        lib.sqz_assemble_blocks.restype = i64
        lib.sqz_assemble_blocks.argtypes = [u32p, u64, u8p, u64, u32p, u64,
                                            i64p, i64p, u64, i32, u8p, u64,
                                            u8p, u64]
        lib.sqz4_tok_plan.restype = i64
        lib.sqz4_tok_plan.argtypes = [u8p, u64, u32, i32, i32, u64, u64,
                                      i32, i32, i32, u32p, u32p, u8p, i64p]
        lib.sqz_fnv1a64.restype = u64
        lib.sqz_fnv1a64.argtypes = [u8p, u64]
        lib.sqz4_pack_payloads.restype = i64
        lib.sqz4_pack_payloads.argtypes = [u8p, i64p, i64p, u64, u64, u64,
                                           i32, u32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def require():
    """Raise naming the failed build when the library is unavailable."""
    if _load() is None:
        raise RuntimeError(f"building libsqznative.so (make -C {_DIR}) "
                           f"failed:\n{_build_error}")


def _u8(buf) -> ctypes.POINTER(ctypes.c_uint8):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(rc: int) -> int:
    if rc < 0:
        raise OSError(-rc, f"native codec error: {os.strerror(-rc)}")
    return rc


def _cap_for(n: int) -> int:
    return 2 * n + 4096


# ------------------------------------------------------------- single block

def squeeze_compress(data: bytes, win_bits: int = 15) -> bytes:
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    out = np.empty(_cap_for(len(data)), dtype=np.uint8)
    rc = _check(lib.sqz_squeeze_compress(_u8(src), len(data), win_bits, 1,
                                         _u8(out), out.size))
    return out[:rc].tobytes()


def squeeze_decompress(blob: bytes) -> bytes:
    lib = _load()
    src = np.frombuffer(blob, dtype=np.uint8)
    size = _peek_squeeze_size(blob)
    # the claimed size is untrusted: every decoded byte costs >= 2 bits
    # per <= 258-byte match token, so a valid stream cannot expand past
    # ~1032x — reject instead of np.empty()ing an attacker-chosen size
    if size > max(len(blob), 16) * 1032:
        raise ValueError("squeeze header size exceeds the provable "
                         "expansion bound (EILSEQ)")
    out = np.empty(max(size, 1), dtype=np.uint8)
    rc = _check(lib.sqz_squeeze_decompress(_u8(src), len(blob), 1, 0,
                                           _u8(out), out.size))
    return out[:rc].tobytes()


def _peek_squeeze_size(blob: bytes) -> int:
    # header = 64 size bits + 8 win bits through the bitstream; the first
    # word is flushed big-endian so bit k of the stream is bit 63-k of word 0,
    # and write_bits emits the LSB of size first.
    word = int.from_bytes(blob[:8], "big")
    size = 0
    for k in range(64):
        size |= ((word >> (63 - k)) & 1) << k
    return size


def sqz4_compress(data: bytes, window: int = 1 << 15, lz: bool = True) -> bytes:
    payload = sqz4_compress_payload(data, window, lz=lz)
    return SQZ4_MAGIC + len(data).to_bytes(8, "little") + payload


def sqz4_decompress(blob: bytes) -> bytes:
    if blob[:8] != SQZ4_MAGIC:
        raise ValueError("bad squeeze4 magic")
    size = int.from_bytes(blob[8:16], "little")
    # no provable expansion bound exists for the range coder (adaptive
    # models make token cost sub-bit asymptotically), so cap the
    # untrusted header size at an operational limit instead of
    # allocating whatever a crafted container claims
    limit = int(os.environ.get("SQZ_MAX_DECODE_BYTES", 1 << 40))
    if size > limit:
        raise ValueError(f"claimed size {size} exceeds the decode limit "
                         f"({limit}; raise SQZ_MAX_DECODE_BYTES)")
    return sqz4_decompress_payload(blob[16:], size)


# --------------------------------------------------------- payload variants

SEED4_WORDS = 610        # sqz4 ModelSeed flat u32 words (FORMAT.md §3.1)
TREE_SEED_WORDS = (3 + 6 * 1023) + (3 + 6 * 63)   # squeeze TreeSeed i64 words


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _seed4_in(seed):
    """oracle ModelSeed (or flat seq / ndarray) -> u32[610] or None."""
    if seed is None:
        return None
    flat = getattr(seed, "flat", seed)
    a = np.ascontiguousarray(flat, dtype=np.uint32)
    if a.size != SEED4_WORDS:   # native reads exactly this many words
        raise ValueError(f"sqz4 seed must be {SEED4_WORDS} u32 words")
    return a


def _seed4_out(arr):
    from sqz_tpu.oracle.sqz4 import ModelSeed
    return ModelSeed(arr.tolist())


def _treeseed_in(seed):
    """oracle TreeSeed (lit+pos flat) -> i64[6522] or None."""
    if seed is None:
        return None
    if hasattr(seed, "lit"):
        flat = list(seed.lit) + list(seed.pos)
    else:
        flat = seed
    a = np.ascontiguousarray(flat, dtype=np.int64)
    if a.size != TREE_SEED_WORDS:
        raise ValueError(f"tree seed must be {TREE_SEED_WORDS} i64 words")
    return a


def _treeseed_out(arr):
    from sqz_tpu.oracle.squeeze import TreeSeed
    lit_words = 3 + 6 * 1023
    return TreeSeed(arr[:lit_words].tolist(), arr[lit_words:].tolist())


def _dict_in(dictionary):
    if not dictionary:
        return None, 0
    d = np.frombuffer(dictionary, dtype=np.uint8)
    return d, d.size


def squeeze_compress_payload(data: bytes, win_bits: int, seed=None,
                             return_state: bool = False,
                             dictionary: bytes = b"", parse: str = "exact",
                             depth: int = 32):
    """``parse="fast"``: bounded approximate matcher (sqzt-contract paths
    only — FORMAT.md §1.5's exact policy is normative for size parity of
    raw .sqz streams and stays the default)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    out = np.empty(_cap_for(len(data)), dtype=np.uint8)
    sin = _treeseed_in(seed)
    sout = np.zeros(TREE_SEED_WORDS, dtype=np.int64) if return_state else None
    d, dn = _dict_in(dictionary)
    if parse == "fast":
        rc = _check(lib.sqz_squeeze_compress_f(
            _u8(src), len(data), win_bits, depth,
            _i64p(sin) if sin is not None else None,
            _i64p(sout) if sout is not None else None,
            _u8(d) if d is not None else None, dn, _u8(out), out.size))
    else:
        rc = _check(lib.sqz_squeeze_compress_s(
            _u8(src), len(data), win_bits,
            _i64p(sin) if sin is not None else None,
            _i64p(sout) if sout is not None else None,
            _u8(d) if d is not None else None, dn, _u8(out), out.size))
    payload = out[:rc].tobytes()
    if return_state:
        return payload, _treeseed_out(sout)
    return payload


def squeeze_decompress_payload(payload: bytes, size: int, seed=None,
                               return_state: bool = False,
                               dictionary: bytes = b""):
    lib = _load()
    src = np.frombuffer(payload, dtype=np.uint8) if payload else np.zeros(1, np.uint8)
    out = np.empty(max(size, 1), dtype=np.uint8)
    sin = _treeseed_in(seed)
    sout = np.zeros(TREE_SEED_WORDS, dtype=np.int64) if return_state else None
    d, dn = _dict_in(dictionary)
    rc = _check(lib.sqz_squeeze_decompress_s(
        _u8(src), len(payload), size,
        _i64p(sin) if sin is not None else None,
        _i64p(sout) if sout is not None else None,
        _u8(d) if d is not None else None, dn, _u8(out), out.size))
    data = out[:rc].tobytes()
    if return_state:
        return data, _treeseed_out(sout)
    return data


def sqz4_compress_payload(data: bytes, window: int, lz: bool = True,
                          seed=None, return_state: bool = False,
                          dictionary: bytes = b"", parse: str = "exact",
                          depth: int = 32):
    """``parse="fast"`` uses the bounded approximate matcher (PERF.md
    round 3; ``depth`` hash-chain links): spec-valid streams, NOT
    byte-identical to the exact parse — sqzt-container paths only
    (round-trip + ratio contract, FORMAT.md §3)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    out = np.empty(_cap_for(len(data)), dtype=np.uint8)
    if parse == "fast" and lz:
        sin = _seed4_in(seed)
        sout = (np.zeros(SEED4_WORDS, dtype=np.uint32)
                if return_state else None)
        d, dn = _dict_in(dictionary)
        rc = _check(lib.sqz_sqz4_compress_f(
            _u8(src), len(data), window, int(lz), depth,
            _u32p(sin) if sin is not None else None,
            _u32p(sout) if sout is not None else None,
            _u8(d) if d is not None else None, dn, _u8(out), out.size))
        payload = out[:rc].tobytes()
        if return_state:
            return payload, _seed4_out(sout)
        return payload
    if seed is None and not return_state and not dictionary:
        rc = _check(lib.sqz_sqz4_compress(_u8(src), len(data), window,
                                          int(lz), _u8(out), out.size))
        return out[:rc].tobytes()
    sin = _seed4_in(seed)
    sout = np.zeros(SEED4_WORDS, dtype=np.uint32) if return_state else None
    d, dn = _dict_in(dictionary)
    rc = _check(lib.sqz_sqz4_compress_s(
        _u8(src), len(data), window, int(lz),
        _u32p(sin) if sin is not None else None,
        _u32p(sout) if sout is not None else None,
        _u8(d) if d is not None else None, dn, _u8(out), out.size))
    payload = out[:rc].tobytes()
    if return_state:
        return payload, _seed4_out(sout)
    return payload


def sqz4_decompress_payload(payload: bytes, size: int, seed=None,
                            return_state: bool = False,
                            dictionary: bytes = b""):
    lib = _load()
    src = np.frombuffer(payload, dtype=np.uint8) if payload else np.zeros(1, np.uint8)
    out = np.empty(max(size, 1), dtype=np.uint8)
    if seed is None and not return_state and not dictionary:
        rc = _check(lib.sqz_sqz4_decompress(_u8(src), len(payload), size,
                                            _u8(out), out.size))
        return out[:rc].tobytes()
    sin = _seed4_in(seed)
    sout = np.zeros(SEED4_WORDS, dtype=np.uint32) if return_state else None
    d, dn = _dict_in(dictionary)
    rc = _check(lib.sqz_sqz4_decompress_s(
        _u8(src), len(payload), size,
        _u32p(sin) if sin is not None else None,
        _u32p(sout) if sout is not None else None,
        _u8(d) if d is not None else None, dn, _u8(out), out.size))
    data = out[:rc].tobytes()
    if return_state:
        return data, _seed4_out(sout)
    return data


def sqz4_model_stats(m_ops: np.ndarray, s_ops: np.ndarray, seed=None):
    """Per-op (start, size, total) of the 36 adaptive sqz4 models, values
    taken before each op's update (one block's op stream). ``seed``
    warm-starts the models (FORMAT.md §3.1)."""
    lib = _load()
    t = len(m_ops)
    m = np.ascontiguousarray(m_ops, dtype=np.int32)
    s = np.ascontiguousarray(s_ops, dtype=np.int32)
    start = np.empty(t, dtype=np.uint32)
    size = np.empty(t, dtype=np.uint32)
    total = np.empty(t, dtype=np.uint32)
    sin = _seed4_in(seed)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    _check(lib.sqz_sqz4_model_stats(
        m.ctypes.data_as(i32p), s.ctypes.data_as(i32p), t,
        _u32p(sin) if sin is not None else None,
        start.ctypes.data_as(u32p), size.ctypes.data_as(u32p),
        total.ctypes.data_as(u32p)))
    return start, size, total


def tokenize(data: bytes, window: int, min_len: int, max_len: int,
             reject_short_far: bool = False) -> np.ndarray:
    """Greedy token triples (kind, a, b): 0=literal(byte) / 1=match(len,dist)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    toks = np.empty((max(len(data), 1), 3), dtype=np.int32)
    rc = _check(lib.sqz_tokenize(
        _u8(src), len(data), window, min_len, max_len, int(reject_short_far),
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), toks.shape[0]))
    return toks[:rc]


# ------------------------------------------------------- threaded block API

def blocks_compress(data: bytes, fmt: int, win_bits: int, blk_bits: int,
                    lz: bool = True, nthreads: int = 0,
                    warm: bool = False, parse: str = "exact",
                    depth: int = 32):
    """Compress independent 2^blk_bits blocks in parallel; returns payloads
    (cold) or (payloads, fresh_mask) (warm). Warm (sqzt v2, FORMAT.md
    §3.1): each block 1+ is coded both fresh and seeded from block 0's
    final state; the smaller wins and the mask records the choice.
    ``parse="fast"``: bounded approximate matcher on every block (both
    formats) — sqzt-contract paths only."""
    lib = _load()
    n = len(data)
    bs = 1 << blk_bits
    nblocks = max(1, (n + bs - 1) // bs)
    stride = _cap_for(bs)
    src = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    out = np.empty(nblocks * stride, dtype=np.uint8)
    sizes = np.zeros(nblocks, dtype=np.int64)
    flags = np.ones(nblocks, dtype=np.uint8)
    fast_depth = depth if (parse == "fast" and (fmt == 0 or lz)) else 0
    rc = _check(lib.sqz_blocks_compress(
        _u8(src), n, fmt, win_bits, blk_bits, int(lz), nthreads, int(warm),
        fast_depth,
        _u8(out), stride, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8(flags)))
    assert rc == nblocks
    payloads = [out[b * stride:b * stride + int(sizes[b])].tobytes()
                for b in range(nblocks)]
    if warm:
        return payloads, [bool(f) for f in flags]
    return payloads


def blocks_decompress(payloads: List[bytes], total_size: int, fmt: int,
                      blk_bits: int, nthreads: int = 0,
                      fresh_mask=None, win_bits: int = 15) -> bytes:
    """``fresh_mask`` (list of bool, sqzt v2): per-block fresh/warm choice;
    None = cold container. ``win_bits`` sizes the warm shared dictionary."""
    lib = _load()
    warm = fresh_mask is not None
    flat = b"".join(payloads)
    offsets = np.zeros(len(payloads), dtype=np.int64)
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:]) if len(payloads) > 1 else None
    src = np.frombuffer(flat, dtype=np.uint8) if flat else np.zeros(1, np.uint8)
    out = np.empty(max(total_size, 1), dtype=np.uint8)
    if warm and len(fresh_mask) != len(payloads):
        raise ValueError("fresh mask must cover every block "
                         "(native reads one flag per block)")
    fl = (np.asarray([1 if f else 0 for f in fresh_mask], dtype=np.uint8)
          if warm else None)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = _check(lib.sqz_blocks_decompress(
        _u8(src), offsets.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p),
        len(payloads), fmt, blk_bits, win_bits, nthreads, int(warm),
        _u8(fl) if fl is not None else None,
        _u8(out), total_size))
    assert rc == total_size
    return out[:total_size].tobytes()


def assemble_blocks(tok: np.ndarray, lit: np.ndarray, mrec: np.ndarray,
                    ntok: np.ndarray, sizes: np.ndarray, out_stride: int,
                    nthreads: int = 0, dictionary: bytes = b"") -> np.ndarray:
    """Reconstruct the device decoder's record streams: [B, *] row-major arrays
    (tok u32 words, lit u8 bytes, mrec u32 records) -> [B, out_stride] u8.
    ``dictionary``: shared warm preset history match records may reach
    into (FORMAT.md §3.1)."""
    lib = _load()
    B = tok.shape[0]
    tok = np.ascontiguousarray(tok, dtype=np.uint32)
    lit = np.ascontiguousarray(lit, dtype=np.uint8)
    mrec = np.ascontiguousarray(mrec, dtype=np.uint32)
    nt = np.ascontiguousarray(ntok, dtype=np.int64)
    sz = np.ascontiguousarray(sizes, dtype=np.int64)
    out = np.zeros((B, out_stride), dtype=np.uint8)
    d, dn = _dict_in(dictionary)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    _check(lib.sqz_assemble_blocks(
        tok.ctypes.data_as(u32p), tok.shape[1],
        _u8(lit), lit.shape[1],
        mrec.ctypes.data_as(u32p), mrec.shape[1],
        nt.ctypes.data_as(i64p), sz.ctypes.data_as(i64p),
        B, nthreads, _u8(d) if d is not None else None, dn,
        _u8(out), out_stride))
    return out


def sqz4_tok_plan(data: bytes, window: int, blk_bits: int, lz: bool,
                  tok_cap: int, lit_cap: int, nthreads: int = 0,
                  depth: int = 32, warm: bool = False):
    """Token planning for the device encoder (ops/coder.py): one u32 token
    per parse decision plus the dense literal bytes, per block.
    ``depth`` > 0: bounded matcher with that many hash-chain links;
    0: the exact reference-semantics matcher. ``warm`` (sqzt v2): blocks
    1+ match into block 0's tail and the returned seed holds block 0's
    final rescaled model state.

    Returns (toks [nblocks, tok_cap] u32, lits [nblocks, lit_cap] u8,
    counts [nblocks, 2] i64 (n_tok, n_lit), max n_tok, seed or None)."""
    lib = _load()
    n = len(data)
    bs = 1 << blk_bits
    nblocks = max(1, (n + bs - 1) // bs)
    src = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    toks = np.zeros((nblocks, tok_cap), dtype=np.uint32)
    lits = np.zeros((nblocks, lit_cap), dtype=np.uint8)
    counts = np.zeros((nblocks, 2), dtype=np.int64)
    seed_out = np.zeros(SEED4_WORDS, dtype=np.uint32) if warm else None
    i64p = ctypes.POINTER(ctypes.c_int64)
    mx = _check(lib.sqz4_tok_plan(
        _u8(src), n, window, blk_bits, int(lz), tok_cap, lit_cap, nthreads,
        depth, int(warm), _u32p(seed_out) if seed_out is not None else None,
        _u32p(toks), _u8(lits), counts.ctypes.data_as(i64p)))
    seed = _seed4_out(seed_out) if warm else None
    return toks, lits, counts, mx, seed


def sqz4_pack_payloads(payloads, lanes: int, pw: int,
                       nthreads: int = 0) -> np.ndarray:
    """Pack block payloads into the decoder's [G, pw, lanes] words."""
    lib = _load()
    nblocks = len(payloads)
    G = -(-nblocks // lanes)
    flat = b"".join(payloads)
    sizes = np.asarray([len(p) for p in payloads], dtype=np.int64)
    offsets = np.zeros(nblocks, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:]) if nblocks > 1 else None
    src = np.frombuffer(flat, dtype=np.uint8) if flat else np.zeros(1, np.uint8)
    words = np.zeros((G, pw, lanes), dtype=np.uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    _check(lib.sqz4_pack_payloads(
        _u8(src), offsets.ctypes.data_as(i64p), sizes.ctypes.data_as(i64p),
        nblocks, lanes, pw, nthreads,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))))
    return words


def fnv1a64(data: bytes) -> int:
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
    return int(lib.sqz_fnv1a64(_u8(src), len(data)))

