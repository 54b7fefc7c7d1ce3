"""The device sqz4 coders: one encoder and one decoder, called through
``jax.ffi`` (FORMAT.md §2).

Each block of the sqzt container is one serial range-coder state machine;
the coders run one block per lane, thousands side by side. The coder
source is ``native/sqz4_coder.h``, shared with the host codec: on a GPU
it runs as CUDA (``native/sqz4_ffi.cu``, one thread per block, the 610
model words in shared memory), on the CPU as the same code built with the
host compiler (``native/sqz4_ffi.cc``). JAX dispatches on the platform it
compiles for; a missing library is an error that names the failed build.
Payloads are byte-identical to the ``native`` and ``oracle`` engines for
the same parse (zero tolerance — the coders are integer-only).

Array layouts (lane = one block; ``[G, rows, B]`` arrays hold lane
``(g, b)`` in column ``b`` of group ``g``; words pack 4 bytes
big-endian):

* encoder in: tokens ``[G, Tt, B]`` u32 (native ``sqz4_tok_plan`` token
  words), literals ``[G, Lw, B]`` u32, an optional model seed (sqzt v2
  warm start) and a per-lane ``seeded`` flag; out: payload words
  ``[G, CW, B]`` u32 and byte counts ``lens [G, 1, B]`` i32.
* decoder in: payload words ``[G, Pw, B]`` u32 and ``meta [G, 4, B]`` i32
  (payload bytes, block size, dictionary length, seeded); out: literal
  bytes ``[G, LW, B]``, token bits ``[G, TW, B]`` (LSB-first, 1 = match),
  match records ``len << 24 | dist`` ``[G, MW, B]`` and
  ``counts [G, 8, B]`` (bytes produced, literals, tokens, matches, error
  code, payload bytes read, overflow flag, 0).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
I32 = jnp.int32

SEED_WORDS = 610          # ModelSeed flat words (FORMAT.md §3.1)
ENC_LANES = 4096          # blocks per encoder dispatch
DEC_LANES = 4096          # blocks per decoder dispatch
ROW_BUCKET = 256          # row granularity of staged streams (jit reuse)

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_lock = threading.Lock()
_registered: set = set()


def _build(target: str, lib: str, sources) -> Path:
    """Build ``lib`` with ``make -C native <target>`` when it is missing or
    older than a source; raise naming the failed build."""
    from sqz_tpu import native
    so = _NATIVE / lib
    try:
        native.build_locked([target, f"PYTHON={sys.executable}"], [so],
                            [_NATIVE / s for s in sources], _NATIVE)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(
            f"building {lib} (make -C {_NATIVE} {target}) failed:\n"
            f"{detail}") from e
    return so


def _register(so: Path, platform: str, enc_sym: str, dec_sym: str):
    lib = ctypes.CDLL(str(so))
    jax.ffi.register_ffi_target("sqz4_encode",
                                jax.ffi.pycapsule(getattr(lib, enc_sym)),
                                platform=platform)
    jax.ffi.register_ffi_target("sqz4_decode",
                                jax.ffi.pycapsule(getattr(lib, dec_sym)),
                                platform=platform)


def ensure_registered():
    """Build and register the coder targets this process can dispatch to:
    the CPU target always, the CUDA target when JAX has a GPU."""
    with _lock:
        if "cpu" not in _registered:
            so = _build("libsqz4ffi.so", "libsqz4ffi.so",
                        ("sqz4_ffi.cc", "sqz4_coder.h"))
            _register(so, "cpu", "Sqz4EncodeCpu", "Sqz4DecodeCpu")
            _registered.add("cpu")
        if "CUDA" not in _registered and any(
                d.platform == "gpu" for d in jax.devices()):
            so = _build("cuda", "libsqz4ffi_cuda.so",
                        ("sqz4_ffi.cu", "sqz4_coder.h"))
            _register(so, "CUDA", "Sqz4EncodeCuda", "Sqz4DecodeCuda")
            _registered.add("CUDA")


def cuda_lanes_per_sm() -> int:
    """Coder lanes resident per SM (occupancy of the CUDA coders)."""
    ensure_registered()
    lib = ctypes.CDLL(str(_NATIVE / "libsqz4ffi_cuda.so"))
    lib.sqz4_cuda_lanes_per_sm.restype = ctypes.c_int
    return int(lib.sqz4_cuda_lanes_per_sm())


def seed_words(seed) -> np.ndarray:
    """ModelSeed (or flat sequence) -> u32[610]; zeros for no seed."""
    if seed is None:
        return np.zeros(SEED_WORDS, np.uint32)
    a = np.asarray(getattr(seed, "flat", seed), dtype=np.uint32)
    if a.size != SEED_WORDS:
        raise ValueError(f"sqz4 seed must be {SEED_WORDS} u32 words")
    return a


def _seed_operand(seed):
    """A seed already on the device (or traced) passes through."""
    if isinstance(seed, jax.Array):
        return seed
    return jnp.asarray(seed_words(seed))


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cap_words_for(cap: int) -> int:
    """Payload word rows for a per-block byte capacity."""
    return -(-cap // 4)


def token_cap(bs: int) -> int:
    """Token slots that always hold a block's parse: at worst two tokens
    per three bytes (a literal run between 2-byte matches), plus EOS."""
    return 2 * bs // 3 + 4


# ------------------------------------------------------------- encoder

@partial(jax.jit, static_argnames=("cap_words", "lit_skip"))
def _encode_call(toks, lits, seed, seeded, cap_words: int, lit_skip: bool):
    G, _, B = toks.shape
    return jax.ffi.ffi_call(
        "sqz4_encode",
        (jax.ShapeDtypeStruct((G, cap_words, B), U32),
         jax.ShapeDtypeStruct((G, 1, B), I32)),
    )(toks, lits, seed, seeded, lit_skip=np.int32(lit_skip))


def encode(toks, lits, cap_words: int, lit_skip: bool = False, seed=None,
           seeded=None):
    """Code token streams to payload words (layouts in the module
    docstring). ``lit_skip``: the literal stream is each raw block and
    matches skip the bytes they cover (the resident parses). ``seeded``
    ``[G, 1, B]`` marks lanes that start from ``seed``; default: every
    lane when a seed is given. Returns ``(words, lens)``; a lane's lens
    past ``cap_words * 4`` overflowed its rows (check_lens)."""
    ensure_registered()
    G, _, B = toks.shape
    if seeded is None:
        seeded = jnp.full((G, 1, B), 0 if seed is None else 1, I32)
    return _encode_call(toks, lits, _seed_operand(seed),
                        jnp.asarray(seeded, I32), cap_words=cap_words,
                        lit_skip=bool(lit_skip))


def check_lens(lens_np: np.ndarray, cap_words: int, nb: int = None):
    """Raise for lanes that overflowed their payload rows or whose token
    stream the coder rejected."""
    ln = lens_np[:, 0, :nb] if nb is not None else lens_np[:, 0]
    if int(ln.max(initial=0)) > cap_words * 4:
        raise ValueError("compressed block exceeded the output capacity")
    if int(ln.min(initial=0)) < 0:
        raise ValueError("device encoder rejected a token stream")


def unpack_group_payloads(words: np.ndarray, lens: np.ndarray, nb: int):
    """[G, R, B] payload words + lens [G, 1, B] -> the first nb lanes'
    payload bytes (lane-major order)."""
    lanes = words.shape[2]
    payloads = []
    for b in range(nb):
        g, lane = divmod(b, lanes)
        n = int(lens[g, 0, lane])
        payloads.append(
            words[g, :(n + 3) // 4, lane].astype(">u4").tobytes()[:n])
    return payloads


def fetch_words_trimmed(words, lens_np: np.ndarray):
    """Download payload words cut to the longest lane's rows (bucketed so
    the slice shapes stay few)."""
    used = (int(lens_np[:, 0].max(initial=0)) + 3) // 4
    R = min(words.shape[1], max(ROW_BUCKET, round_up(used, ROW_BUCKET)))
    return np.asarray(words[:, :R])


@jax.jit
def stage_tokens(rows):
    """[n, Tt] u32 host token rows -> the encoder's [1, Tt, n] layout."""
    return rows.T[None]


@jax.jit
def pack_words(x8):
    """[..., B, R] u8 rows (R % 4 == 0) -> [..., R/4, B] u32 words, 4
    big-endian bytes each: the coders' literal and payload layout."""
    x = x8.astype(U32).reshape(x8.shape[:-1] + (x8.shape[-1] // 4, 4))
    w = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    return jnp.swapaxes(w, -1, -2)


def parse_mode(parse: str = "auto") -> str:
    """Resolve the sqzt-path parse policy: 'fast' (bounded approximate
    matcher, the throughput default) or 'exact' (reference-semantics
    matcher). SQZ_PARSE overrides; 'auto' = fast."""
    env = os.environ.get("SQZ_PARSE")
    if env in ("fast", "exact"):
        return env
    return "fast" if parse == "auto" else parse


def fast_depth() -> int:
    return int(os.environ.get("SQZ_FAST_DEPTH", "32"))


def plan_tokens(data: bytes, blk_bits: int, window: int, lz: bool,
                parse: str = "auto", warm: bool = False):
    """Host token parse of every block (native sqz4_tok_plan): returns
    (toks [NB, token_cap] u32, lits [NB, bs] u8, counts [NB, 2], seed or
    None)."""
    from sqz_tpu import native
    native.require()
    bs = 1 << blk_bits
    depth = fast_depth() if parse_mode(parse) == "fast" else 0
    return native.sqz4_tok_plan(data, window, blk_bits, lz, token_cap(bs),
                                bs, depth=depth, warm=warm)


def dispatch_tokens(toks, lits, counts, cap_words: int, seed=None,
                    seeded=None):
    """Upload one group's token rows and start the encoder (async).
    toks [n, *] / lits [n, *] host rows, counts [n, 2]; returns the
    (words, lens) device arrays."""
    Tt = round_up(max(1, int(counts[:, 0].max(initial=1))), ROW_BUCKET)
    Tt = min(Tt, toks.shape[1])
    lw = -(-int(counts[:, 1].max(initial=0)) // 4)
    Lw = min(round_up(max(lw, 1), ROW_BUCKET), lits.shape[1] // 4 or 1)
    larr = lits[:, :Lw * 4]
    if larr.shape[1] < Lw * 4:
        larr = np.pad(larr, ((0, 0), (0, Lw * 4 - larr.shape[1])))
    tdev = stage_tokens(jnp.asarray(np.ascontiguousarray(toks[:, :Tt])))
    ldev = pack_words(jnp.asarray(np.ascontiguousarray(larr))[None])
    return encode(tdev, ldev, cap_words, seed=seed, seeded=seeded)


def encode_data(data: bytes, blk_bits: int, window: int, lz: bool,
                cap: int, warm: bool = False, parse: str = "auto",
                lanes: int = ENC_LANES):
    """Whole-buffer encode: host token parse, then the device encoder in
    groups of ``lanes`` blocks. ``warm`` (sqzt v2, FORMAT.md §3.1): blocks
    1+ match into block 0's tail and start from its rescaled model state.
    Returns per-block payloads."""
    from sqz_tpu import native
    bs = 1 << blk_bits
    NB = max(1, -(-len(data) // bs))
    warm = warm and NB > 1
    toks, lits, counts, _mx, seed = plan_tokens(data, blk_bits, window, lz,
                                                parse, warm)
    if warm:
        # warm-seeded models can EXPAND a block whose content mismatches
        # block 0 (e.g. text seed, incompressible block) — give headroom
        cap = cap + bs // 4
    cap_words = cap_words_for(cap)
    pending = []
    for g0 in range(0, NB, lanes):
        n = min(lanes, NB - g0)
        seeded = None
        if warm:
            flag = np.ones((1, 1, n), np.int32)
            if g0 == 0:
                flag[0, 0, 0] = 0            # block 0 codes fresh
            seeded = flag
        words, lens = dispatch_tokens(toks[g0:g0 + n], lits[g0:g0 + n],
                                      counts[g0:g0 + n], cap_words,
                                      seed=seed if warm else None,
                                      seeded=seeded)
        pending.append((n, words, lens))
    payloads = []
    for n, words, lens in pending:
        lens_np = np.asarray(lens)
        if warm and int(lens_np[:, 0].max(initial=0)) > cap_words * 4:
            # pathological expansion (adversarially seed-mismatched
            # blocks): redo just the overflowed blocks on the host,
            # seeded identically
            g0 = len(payloads)
            grp = unpack_group_payloads(fetch_words_trimmed(words, lens_np),
                                        lens_np, n)
            dictionary = data[:bs][-window:] if lz else b""
            for i in np.nonzero(lens_np[0, 0, :n] > cap_words * 4)[0]:
                b = g0 + int(i)
                grp[i] = native.sqz4_compress_payload(
                    data[b * bs:(b + 1) * bs], window, lz=lz,
                    seed=seed if b else None,
                    dictionary=dictionary if b else b"",
                    parse=parse_mode(parse))
            payloads += grp
            continue
        check_lens(lens_np, cap_words, n)
        payloads += unpack_group_payloads(fetch_words_trimmed(words, lens_np),
                                          lens_np, n)
    return payloads


# ------------------------------------------------------------- decoder

@partial(jax.jit, static_argnames=("lw", "tw", "mw"))
def _decode_call(payload, meta, seed, lw: int, tw: int, mw: int):
    G, _, B = payload.shape
    return jax.ffi.ffi_call(
        "sqz4_decode",
        (jax.ShapeDtypeStruct((G, lw, B), U32),
         jax.ShapeDtypeStruct((G, tw, B), U32),
         jax.ShapeDtypeStruct((G, mw, B), U32),
         jax.ShapeDtypeStruct((G, 8, B), I32)),
    )(payload, meta, seed)


def decode(payload, meta, lw: int, tw: int, mw: int, seed=None):
    """Decode payload words to record streams (layouts in the module
    docstring). Lanes with meta row 3 set start from ``seed``. Returns
    (lit, tok, mrec, counts)."""
    ensure_registered()
    return _decode_call(payload, jnp.asarray(meta, I32),
                        _seed_operand(seed), lw=lw, tw=tw, mw=mw)


def make_meta(plens, sizes, dlen=0, seeded=0):
    """[B] payload lengths + [B] block sizes -> meta [1, 4, B] i32."""
    plens = jnp.asarray(plens, I32)
    z = jnp.zeros_like(plens)
    return jnp.stack([plens, jnp.asarray(sizes, I32), z + dlen,
                      z + seeded])[None]


def decode_dims(blk_bits: int) -> dict:
    """Decoder row counts at this block size: payload rows (longer
    payloads decode on the host), literal rows (every byte a literal),
    token rows (every byte a token) and match rows (a lane with more
    matches raises its overflow flag and decodes on the host)."""
    bs = 1 << blk_bits
    return dict(Pw=cap_words_for(bs + 4096), lw=max(bs // 4, 1),
                tw=bs // 32 + 1, mw=max(bs // 4, 1))


_DEC_TRIM_BUCKET = 2048   # coarse so the jit shape variants stay few


@partial(jax.jit, static_argnums=(3, 4, 5))
def _dec_outputs_T(lit, tok, mrec, lr: int, tr: int, mr: int):
    return (lit[:, :lr, :].transpose(0, 2, 1),
            tok[:, :tr, :].transpose(0, 2, 1),
            mrec[:, :mr, :].transpose(0, 2, 1))


def fetch_decode_host(res, trim: bool = True):
    """Download one decode dispatch's record streams, transposed to
    lane-major on the device and cut to the rows the counts show in use.
    Returns ([g, lanes, Wl] lit, [g, lanes, Wt] tok, [g, lanes, Wm] mrec,
    [g, 8, lanes] counts) numpy arrays for postprocess_decode."""
    lit, tok, mrec, counts = res
    cnt = np.asarray(counts)

    def _rows(used, W):
        if not trim:
            return W
        return min(W, round_up(max(int(used), 1), _DEC_TRIM_BUCKET))

    lr = _rows((int(cnt[:, 1, :].max(initial=0)) + 3) // 4, lit.shape[1])
    tr = _rows(int(cnt[:, 2, :].max(initial=0)) // 32 + 2, tok.shape[1])
    mr = _rows(int(cnt[:, 3, :].max(initial=0)), mrec.shape[1])
    lt, tt, mt = _dec_outputs_T(lit, tok, mrec, lr, tr, mr)
    return np.asarray(lt), np.asarray(tt), np.asarray(mt), cnt


def assemble_tokens_numpy(tok_bits: np.ndarray, lits: bytes,
                          mrecs: np.ndarray, ntok: int, size: int,
                          dictionary: bytes = b"") -> bytes:
    """Reference reconstruction of the decoder's record streams.
    ``dictionary``: warm shared preset history (FORMAT.md §3.1)."""
    out = bytearray(dictionary)
    dlen = len(out)
    li = 0
    mi = 0
    for tix in range(ntok):
        if (int(tok_bits[tix >> 5]) >> (tix & 31)) & 1:
            rec = int(mrecs[mi])
            mi += 1
            length, dist = rec >> 24, rec & 0xFFFFFF
            for _ in range(length):
                out.append(out[-dist])
        else:
            out.append(lits[li])
            li += 1
    if len(out) - dlen != size:
        raise ValueError(f"record streams produced {len(out) - dlen} of "
                         f"{size} bytes")
    return bytes(out[dlen:])


def pack_decode_chunk(payloads, sizes, Pw: int, dlen: int = 0,
                      seeded: bool = False):
    """Pack one decode dispatch's inputs: payload bytes -> [1, Pw, n]
    big-endian words and the [1, 4, n] meta table (decode_groups'
    per-chunk packer)."""
    from sqz_tpu import native
    native.require()
    n = len(payloads)
    meta = np.zeros((1, 4, n), dtype=np.int32)
    meta[0, 0] = [len(p) for p in payloads]
    meta[0, 1] = sizes
    meta[0, 2] = dlen
    meta[0, 3] = int(seeded)
    if max((len(p) for p in payloads), default=0) > 4 * Pw:
        raise ValueError("payload exceeds decoder buffer")
    buf = native.sqz4_pack_payloads(payloads, n, Pw)
    return buf, meta


def decode_groups(payloads, sizes, blk_bits: int, seed=None,
                  dictionary: bytes = b"", block_ids=None,
                  stats: dict = None, lanes: int = DEC_LANES):
    """payloads: list of NB payload byte strings; sizes: original lengths.

    ``seed``/``dictionary`` (sqzt v2 warm start, FORMAT.md §3.1): the model
    seed and shared preset history ALL blocks in this call were coded with.
    ``block_ids``: the caller's original index per block, used in error
    messages (defaults to positions). ``stats``: optional dict filled
    with per-stage wall seconds (pack_s, dispatch_s, fetch_s, assemble_s,
    wall_s); chunk c's fetch and assembly overlap chunk c+1's decode."""
    import time as _time

    from sqz_tpu import native
    st = stats if stats is not None else {}
    for k in ("pack_s", "dispatch_s", "fetch_s", "assemble_s"):
        st.setdefault(k, 0.0)
    t_wall0 = _time.perf_counter()
    NB = len(payloads)
    if NB == 0:
        return []
    ids = list(block_ids) if block_ids is not None else list(range(NB))
    bs = 1 << blk_bits
    dims = decode_dims(blk_bits)
    Pw = dims["Pw"]
    outs = [None] * NB
    # payloads past the decoder's stream rows (warm blocks whose content
    # mismatches the seed can expand) decode on the host
    keep = []
    for b, p in enumerate(payloads):
        if len(p) > 4 * Pw:
            outs[b] = native.sqz4_decompress_payload(
                p, sizes[b], seed=seed, dictionary=dictionary)
        else:
            keep.append(b)
    # group blocks by compressed size: a warp runs until its slowest
    # lane finishes, and decode steps track payload size
    order = sorted(keep, key=lambda b: len(payloads[b]))
    pending = []
    for c0 in range(0, len(order), lanes):
        idx = order[c0:c0 + lanes]
        t0 = _time.perf_counter()
        buf, meta = pack_decode_chunk([payloads[b] for b in idx],
                                      [sizes[b] for b in idx], Pw,
                                      len(dictionary), seed is not None)
        st["pack_s"] += _time.perf_counter() - t0
        t0 = _time.perf_counter()
        res = decode(jnp.asarray(buf), meta, dims["lw"], dims["tw"],
                     dims["mw"], seed=seed)
        st["dispatch_s"] += _time.perf_counter() - t0
        pending.append((idx, res))
    for idx, res in pending:
        t0 = _time.perf_counter()
        lt, tt, mt, cnt = fetch_decode_host(res)
        st["fetch_s"] += _time.perf_counter() - t0
        t0 = _time.perf_counter()
        got = postprocess_decode(lt, tt, mt, cnt,
                                 [payloads[b] for b in idx],
                                 [sizes[b] for b in idx], bs, seed=seed,
                                 dictionary=dictionary,
                                 block_ids=[ids[b] for b in idx])
        for b, v in zip(idx, got):
            outs[b] = v
        st["assemble_s"] += _time.perf_counter() - t0
    st["wall_s"] = _time.perf_counter() - t_wall0
    return outs


def postprocess_decode(lit, tok, mrec, counts, payloads, sizes, bs,
                       seed=None, dictionary: bytes = b"",
                       block_ids=None):
    """Host stage after one decode dispatch: lane-major record arrays
    (fetch_decode_host) -> per-block output bytes. Raises for error
    lanes, decodes overflow lanes on the host and assembles the rest.
    ``block_ids``: the caller's block index per position, for errors."""
    from sqz_tpu import native
    nb = len(payloads)
    g, lanes = lit.shape[0], lit.shape[1]
    litb = lit.reshape(g * lanes, -1)[:nb]
    tokb = tok.reshape(g * lanes, -1)[:nb]
    mrecb = mrec.reshape(g * lanes, -1)[:nb]
    litu8 = litb.astype(">u4").view(np.uint8).reshape(nb, -1)
    cnt = counts.transpose(0, 2, 1).reshape(g * lanes, 8)[:nb]
    optr, ntoks, err, ovf = cnt[:, 0], cnt[:, 2], cnt[:, 4], cnt[:, 6]
    szs_np = np.asarray(sizes, dtype=np.int64)
    ids = list(block_ids) if block_ids is not None else list(range(nb))
    bad = np.nonzero(err * (1 - ovf))[0]
    if bad.size:
        raise ValueError(
            f"corrupt sqz4 block(s) {[ids[b] for b in bad]} "
            f"(codes {err[bad].tolist()})")
    short = np.nonzero((optr != szs_np) & (ovf == 0))[0]
    if short.size:
        raise ValueError(f"block {ids[short[0]]}: produced "
                         f"{optr[short[0]]} of {szs_np[short[0]]}")
    outs: list = [None] * nb
    for b in np.nonzero(ovf)[0]:     # record rows overflowed: host codec
        outs[b] = native.sqz4_decompress_payload(
            payloads[b], sizes[b], seed=seed, dictionary=dictionary)
    live = np.nonzero(ovf == 0)[0]
    if live.size:
        asm = native.assemble_blocks(
            tokb[live], litu8[live], mrecb[live],
            ntoks[live].astype(np.int64), szs_np[live], bs,
            dictionary=dictionary)
        for i, b in enumerate(live):
            outs[b] = asm[i, :sizes[b]].tobytes()
    return outs
