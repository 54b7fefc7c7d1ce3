"""Block-parallel sqz4 codec as plain XLA scans (FORMAT.md §2).

Encoder: tokens are expanded into a flat stream of micro-ops
``(model_id, symbol)`` — one range-coder encode each — padded to a common
length across blocks; a single ``lax.scan`` then advances B independent
coder states per step, vectorized over blocks and the 256-symbol model axis.
Byte emission (renormalization, FORMAT.md §2.3) is a masked bounded loop
writing into per-block output cursors via dropped-out-of-range scatters.

Decoder: a ``lax.while_loop`` state machine decodes one micro-op per block
per step (FLAG → BYTE | SIZE → BITS → DIST-bits), places literal bytes
directly at their output positions, and appends back-references to a match
list; a second pass applies matches in order with the periodic-gather trick
(``src = dst - dist + (i mod dist)``), which resolves overlapped copies
(dist < len) without byte-serial work. Literal-only streams therefore decode
with zero serial copy work — the reference's byte-serial loops
(src/sqz.c:826-831) become two batched passes.

All state carries exact uint64 range-coder registers; model tables are
uint32 ``[B, 36, 256]`` (reference layout: src/sqz.c:550-565).
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sqz_tpu.formats.constants import (
    PM_LITERAL, PM_SIZE, PM_BYTE, PM_BITS, PM_DIST0, PM_ROWS, PM_SYMS,
    SQZ4_MIN_LEN, SQZ4_MAX_LEN, SQZ4_EOS,
)

MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)
OP_FLUSH = PM_ROWS          # micro-op id for one flush emission
OP_PAD = -1
EMIT_SLOTS = 16             # max bytes one encode micro-op can emit
RENORM_ITERS = 12           # bound for the same-top-byte loop (<=8 observed)

# decoder state machine
ST_FLAG, ST_BYTE, ST_SIZE, ST_BITS, ST_DIST, ST_DONE, ST_ERR = range(7)
# model consumed in each state (ST_DIST uses PM_DIST0 + bitpos dynamically)
_MODEL_FOR_STATE = np.array(
    [PM_LITERAL, PM_BYTE, PM_SIZE, PM_BITS, PM_DIST0, 0, 0], dtype=np.int32)


# --------------------------------------------------------------- micro-ops

def microops_from_tokens(tokens) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a token list into (model_id, symbol) micro-op arrays,
    including the EOS token and the 8 flush emissions (FORMAT.md §2.4)."""
    ms: list[int] = []
    ss: list[int] = []
    for tok in tokens:
        if tok[0] == "lit":
            ms += [PM_LITERAL, PM_BYTE]
            ss += [1, tok[1]]
        else:
            _, length, dist = tok
            nbits = int(dist).bit_length()
            ms += [PM_LITERAL, PM_SIZE, PM_BITS]
            ss += [0, length, nbits]
            d = dist
            for b in range(nbits - 1):
                ms.append(PM_DIST0 + b)
                ss.append(d & 1)
                d >>= 1
    ms += [PM_LITERAL, PM_SIZE] + [OP_FLUSH] * 8
    ss += [0, SQZ4_EOS] + [0] * 8
    return np.asarray(ms, dtype=np.int32), np.asarray(ss, dtype=np.int32)


def microops_from_token_array(toks: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized micro-op expansion from native tokenizer triples
    (kind, a, b) — same output as microops_from_tokens, numpy-speed."""
    if toks.size == 0:
        return microops_from_tokens([])
    kind = toks[:, 0]
    a = toks[:, 1]
    dist = toks[:, 2].astype(np.uint32)
    nbits = np.zeros(len(toks), dtype=np.int32)
    nz = dist > 0
    nbits[nz] = np.floor(np.log2(dist[nz])).astype(np.int32) + 1
    counts = np.where(kind == 0, 2, 3 + np.maximum(nbits - 1, 0))
    offs = np.concatenate([[0], np.cumsum(counts)])
    T = int(offs[-1]) + 2 + 8  # + EOS + flush
    ms = np.full(T, OP_PAD, dtype=np.int32)
    ss = np.zeros(T, dtype=np.int32)
    lit = kind == 0
    lo = offs[:-1][lit]
    ms[lo] = PM_LITERAL
    ss[lo] = 1
    ms[lo + 1] = PM_BYTE
    ss[lo + 1] = a[lit]
    mat = ~lit
    mo = offs[:-1][mat]
    ms[mo] = PM_LITERAL
    ss[mo] = 0
    ms[mo + 1] = PM_SIZE
    ss[mo + 1] = a[mat]
    ms[mo + 2] = PM_BITS
    ss[mo + 2] = nbits[mat]
    mdist, mbits = dist[mat], nbits[mat]
    for b in range(31):
        sel = mbits - 1 > b
        pos = mo[sel] + 3 + b
        ms[pos] = PM_DIST0 + b
        ss[pos] = (mdist[sel] >> b) & 1
    ms[offs[-1]:offs[-1] + 2] = [PM_LITERAL, PM_SIZE]
    ss[offs[-1]:offs[-1] + 2] = [0, SQZ4_EOS]
    ms[offs[-1] + 2:] = OP_FLUSH
    return ms, ss


def init_model_state(nblocks: int, seeds=None):
    """Fresh per-block model tables: freq[B, 36, 256] and totals[B, 36].
    ``seeds``: per-block oracle ModelSeed (or None for fresh) — sqzt v2
    warm start, FORMAT.md §3.1."""
    freq = np.zeros((nblocks, PM_ROWS, 256), dtype=np.uint32)
    for m, n in enumerate(PM_SYMS):
        freq[:, m, :n] = 1
    if seeds is not None:
        for b, seed in enumerate(seeds):
            if seed is None:
                continue
            f = np.asarray(seed.flat, dtype=np.uint32)
            freq[b, 0, :2] = f[0:2]
            freq[b, 1, :256] = f[2:258]
            freq[b, 2, :256] = f[258:514]
            freq[b, 3, :32] = f[514:546]
            for d in range(32):
                freq[b, 4 + d, 0] = f[546 + d]
                freq[b, 4 + d, 1] = f[578 + d]
    totals = freq.sum(axis=2, dtype=np.uint64)
    return jnp.asarray(freq), jnp.asarray(totals)


def seed_from_tokens(tokens) -> "object":
    """Block 0's final (rescaled) model seed derived from its token stream
    without running the coder — model updates are +1 per micro-op, so the
    seed is fresh-freqs + the op histogram (FORMAT.md §3.1)."""
    from sqz_tpu.oracle.sqz4 import ModelSeed
    ms, ss = microops_from_tokens(tokens)
    ms = np.asarray(ms, np.int64)
    ss = np.asarray(ss, np.int64)
    flat = np.ones(ModelSeed.WORDS, dtype=np.int64)
    valid = (ms >= 0) & (ms < 36)
    idx = np.where(ms == 0, ss,
          np.where(ms == 1, 2 + ss,
          np.where(ms == 2, 258 + ss,
          np.where(ms == 3, 514 + ss, 546 + 32 * ss + (ms - 4)))))
    np.add.at(flat, idx[valid], 1)
    r = ModelSeed._rescale
    out = (r(flat[0:2]) + r(flat[2:258]) + r(flat[258:514])
           + r(flat[514:546]))
    dist = [r([flat[546 + b], flat[578 + b]]) for b in range(32)]
    out += [d[0] for d in dist] + [d[1] for d in dist]
    return ModelSeed(out)


# ----------------------------------------------------------------- encoder

def _emit_one(do, low, rng, cnt, slots):
    """Masked single-byte emission: write low>>56 at per-block cursor cnt."""
    byte = (low >> np.uint64(56)).astype(jnp.uint8)
    onehot = (jnp.arange(EMIT_SLOTS)[None, :] == cnt[:, None])
    slots = jnp.where(onehot & do[:, None], byte[:, None], slots)
    cnt = cnt + do.astype(cnt.dtype)
    low = jnp.where(do, low << np.uint64(8), low)
    rng = jnp.where(do, rng << np.uint64(8), rng)
    return low, rng, cnt, slots


def encode_scan_impl(m_ops, s_ops, cap: int, model_state=None):
    """m_ops/s_ops: [B, T] int32. Returns (payload [B, cap] u8, lens [B]).

    Pure (unjitted) so parallel.shard / __graft_entry__ can wrap it in
    shard_map / jit directly. ``model_state``: optional (freq, totals)
    warm-start tables from init_model_state(seeds=...)."""
    B, T = m_ops.shape
    F, totals = init_model_state(B) if model_state is None else model_state
    bidx = jnp.arange(B)
    viota = jnp.arange(256, dtype=jnp.uint32)

    def step(carry, op):
        low, rng, F, totals, ptr, payload = carry
        m, s = op
        active = (m >= 0) & (m < PM_ROWS)
        flush = m == OP_FLUSH
        m_safe = jnp.where(active, m, 0)
        s_safe = jnp.where(active, s, 0)

        row = jnp.take_along_axis(
            F, m_safe[:, None, None], axis=1)[:, 0, :]          # [B, 256]
        total = jnp.take_along_axis(
            totals, m_safe[:, None], axis=1)[:, 0]              # [B] u64
        total = jnp.maximum(total, np.uint64(1))
        start = jnp.sum(
            jnp.where(viota[None, :] < s_safe[:, None].astype(jnp.uint32),
                      row, 0), axis=1).astype(jnp.uint64)
        size = jnp.take_along_axis(
            row, s_safe[:, None], axis=1)[:, 0].astype(jnp.uint64)
        size = jnp.maximum(size, np.uint64(1))

        # range-coder arithmetic (FORMAT.md §2.3), masked by `active`
        rng_div = rng // total
        low1 = low + start * rng_div
        rng1 = rng_div * size
        low = jnp.where(active, low1, low)
        rng = jnp.where(active, rng1, rng)

        # adaptive model update (strictly after coding)
        F = F.at[bidx, m_safe, s_safe].add(active.astype(jnp.uint32))
        totals = totals.at[bidx, m_safe].add(active.astype(jnp.uint64))

        # renormalization: emit while the top byte is pinned
        slots = jnp.zeros((B, EMIT_SLOTS), dtype=jnp.uint8)
        cnt = jnp.zeros((B,), dtype=jnp.int32)
        still = active

        def renorm(_, st):
            low, rng, cnt, slots, still = st
            same = (low >> np.uint64(56)) == ((low + rng) >> np.uint64(56))
            still = still & same
            low, rng, cnt, slots = _emit_one(still, low, rng, cnt, slots)
            return low, rng, cnt, slots, still

        low, rng, cnt, slots, _ = jax.lax.fori_loop(
            0, RENORM_ITERS, renorm, (low, rng, cnt, slots, still))

        # underflow escape: two forced emissions, then re-inflate the range
        uf = active & (rng < total + np.uint64(1))
        low, rng, cnt, slots = _emit_one(uf, low, rng, cnt, slots)
        low, rng, cnt, slots = _emit_one(uf, low, rng, cnt, slots)
        rng = jnp.where(uf, MASK64 - low, rng)

        # flush micro-op: one forced emission with range pinned to max
        rng = jnp.where(flush, MASK64, rng)
        low, rng, cnt, slots = _emit_one(flush, low, rng, cnt, slots)

        # write the emitted bytes at each block's output cursor
        idx = ptr[:, None] + jnp.arange(EMIT_SLOTS)[None, :]
        idx = jnp.where(jnp.arange(EMIT_SLOTS)[None, :] < cnt[:, None],
                        idx, cap)                                # drop invalid
        payload = payload.at[bidx[:, None], idx].set(slots, mode="drop")
        ptr = ptr + cnt.astype(ptr.dtype)
        return (low, rng, F, totals, ptr, payload), None

    carry0 = (
        jnp.zeros((B,), dtype=jnp.uint64),            # low
        jnp.full((B,), MASK64, dtype=jnp.uint64),     # range
        F, totals,
        jnp.zeros((B,), dtype=jnp.int32),             # output cursor
        jnp.zeros((B, cap), dtype=jnp.uint8),
    )
    ops = (m_ops.T, s_ops.T)                          # scan over T
    (low, rng, F, totals, ptr, payload), _ = jax.lax.scan(step, carry0, ops)
    return payload, ptr


_encode_scan = partial(jax.jit, static_argnames=("cap",))(encode_scan_impl)


def encode_scan_stats_impl(start, size, total, cap: int):
    """Lean encode scan fed by host-precomputed model statistics.

    On the encode side every model value is known in advance (the symbol
    stream determines all adaptive updates — sqz_tpu.native.sqz4_model_stats
    computes (start, size, total) per op), so the device carries only the
    u64 coder registers: ~30 scalar u64 ops per block per step. Per-step
    emissions are stacked as scan outputs (sequential stores) and compacted
    with ONE bulk scatter afterwards instead of indexed stores inside the
    loop. Streams are byte-identical to encode_scan_impl (and to the
    device coders, ops/coder.py). Inputs: [B, T] uint32 each; total==0 marks a pad op, and
    size==0 with total!=0 marks a flush emission.
    """
    B, T = start.shape
    bidx = jnp.arange(B)
    SLOTS = 10  # max bytes per op: <=8 renorm + 2 underflow
    pre_lows, cnts = _stats_scan(start, size, total)      # [T, B] each

    # bulk byte extraction + one compaction scatter for the whole stream
    cnts_bt = cnts.T.astype(jnp.int32)                    # [B, T]
    lows_bt = pre_lows.T                                  # [B, T] u64
    starts = jnp.cumsum(cnts_bt, axis=1) - cnts_bt        # exclusive
    j = jnp.arange(SLOTS)
    sh = np.uint64(56) - (jnp.minimum(j, 7).astype(jnp.uint64) << np.uint64(3))
    vals = ((lows_bt[:, :, None] >> sh[None, None, :])
            & np.uint64(0xFF)).astype(jnp.uint8)
    vals = jnp.where(j[None, None, :] < 8, vals, 0)       # overflow bytes = 0
    idx = starts[:, :, None] + j[None, None, :]
    idx = jnp.where(j[None, None, :] < cnts_bt[:, :, None], idx, cap)
    payload = jnp.zeros((B, cap), jnp.uint8)
    payload = payload.at[bidx[:, None],
                         idx.reshape(B, T * SLOTS)].set(
        vals.reshape(B, T * SLOTS), mode="drop")
    lens = starts[:, -1] + cnts_bt[:, -1]
    return payload, lens.astype(jnp.int32)


def _stats_scan(start, size, total):
    B, T = start.shape

    def step(carry, op):
        low, rng = carry
        st32, sz32, tt32 = op
        active = (tt32 != 0) & (sz32 != 0)
        flush = (tt32 != 0) & (sz32 == 0)
        st64 = st32.astype(jnp.uint64)
        sz64 = jnp.maximum(sz32, 1).astype(jnp.uint64)
        tt64 = jnp.maximum(tt32, 1).astype(jnp.uint64)

        rng_div = rng // tt64
        low = jnp.where(active, low + st64 * rng_div, low)
        rng = jnp.where(active, rng_div * sz64, rng)

        # The while-renorm emits the top byte while low and low+range agree
        # there; since shifting is a ring homomorphism mod 2^64, the k-th
        # check compares byte 7-k of the ORIGINAL low and low+range. The
        # whole loop is therefore cnt = count-of-leading-equal-bytes =
        # clz(low ^ (low+range)) / 8, and every emitted byte is a leading
        # byte of pre-renorm low — extracted in bulk after the scan.
        pre_low = low
        x = low ^ (low + rng)
        cnt = jnp.where(active,
                        (jax.lax.clz(x) >> np.uint64(3)).astype(jnp.int32), 0)
        shift = (cnt.astype(jnp.uint64) << np.uint64(3))
        # clz==64 (x==0) is unreachable for valid streams (range != 0);
        # shifts of >=64 are UB in XLA, so clamp defensively
        shift = jnp.minimum(shift, np.uint64(63))
        full = cnt >= 8
        low = jnp.where(full, 0, low << shift)
        rng = jnp.where(full, 0, rng << shift)

        # underflow escape: two more emissions — bytes cnt, cnt+1 of pre_low
        # (zeros when the window ran off the end), then re-inflate
        uf = active & (rng < tt64 + np.uint64(1))
        uf_shift = jnp.minimum(shift + np.uint64(16), np.uint64(63))
        low = jnp.where(uf, jnp.where(cnt >= 6, 0, pre_low << uf_shift), low)
        rng = jnp.where(uf, MASK64 - low, rng)
        cnt = cnt + jnp.where(uf, 2, 0)

        # flush op: exactly one emission of the current top byte
        cnt = jnp.where(flush, 1, cnt)
        low = jnp.where(flush, pre_low << np.uint64(8), low)

        return (low, rng), (pre_low, cnt.astype(jnp.int8))

    carry0 = (
        jnp.zeros((B,), dtype=jnp.uint64),
        jnp.full((B,), MASK64, dtype=jnp.uint64),
    )
    xs = (start.T, size.T, total.T)
    _, (pre_lows, cnts) = jax.lax.scan(step, carry0, xs)  # [T, B], [T, B]
    return pre_lows, cnts


_encode_scan_stats = partial(
    jax.jit, static_argnames=("cap",))(encode_scan_stats_impl)


def stats_for_ops(ms: np.ndarray, ss: np.ndarray, seed=None):
    """Host model-stats for one block's op stream, flush ops marked as
    (0, 0, 1) so the device sees total!=0, size==0. ``seed`` warm-starts
    the simulated models (FORMAT.md §3.1)."""
    from sqz_tpu import native
    start, size, total = native.sqz4_model_stats(ms, ss, seed=seed)
    is_flush = ms == OP_FLUSH
    start = np.where(is_flush, 0, start).astype(np.uint32)
    size = np.where(is_flush, 0, size).astype(np.uint32)
    total = np.where(is_flush, 1, total).astype(np.uint32)
    return start, size, total


def encode_blocks(token_lists: Sequence[list], blk_bits: int,
                  seeds=None) -> List[bytes]:
    """Encode pre-tokenized blocks in lock-step on the device.
    ``seeds``: per-block ModelSeed/None (sqzt v2 warm start)."""
    ops = [microops_from_tokens(toks) for toks in token_lists]
    T = max(len(m) for m, _ in ops)
    B = len(ops)
    m_ops = np.full((B, T), OP_PAD, dtype=np.int32)
    s_ops = np.zeros((B, T), dtype=np.int32)
    for b, (m, s) in enumerate(ops):
        m_ops[b, :len(m)] = m
        s_ops[b, :len(s)] = s
    cap = (1 << blk_bits) * 2 + 4096
    from sqz_tpu import native
    if native.available():
        # fast path: host model stats + lean device scan + device compaction
        # (one bulk scatter; shipping the raw emission record to the host
        # costs ~18 bytes per input byte over the host link)
        stats = [stats_for_ops(m_ops[b], s_ops[b],
                               seed=seeds[b] if seeds else None)
                 for b in range(B)]
        payload, lens = _encode_scan_stats(
            jnp.asarray(np.stack([x[0] for x in stats])),
            jnp.asarray(np.stack([x[1] for x in stats])),
            jnp.asarray(np.stack([x[2] for x in stats])), cap)
        payload = np.asarray(payload)
        lens = np.asarray(lens)
        if int(lens.max(initial=0)) > cap:
            raise ValueError("compressed block exceeded the output "
                             "capacity (ENOBUFS)")
        return [payload[b, :lens[b]].tobytes() for b in range(B)]
    state = init_model_state(B, seeds) if seeds else None
    payload, lens = _encode_scan(jnp.asarray(m_ops), jnp.asarray(s_ops), cap,
                                 state)
    payload = np.asarray(payload)
    lens = np.asarray(lens)
    if int(lens.max(initial=0)) > cap:
        raise ValueError("compressed block exceeded the output capacity "
                         "(ENOBUFS)")
    return [payload[b, :lens[b]].tobytes() for b in range(B)]


# ----------------------------------------------------------------- decoder

@partial(jax.jit, static_argnames=("out_cap", "t_max", "m_max"))
def _decode_scan(payloads, plens, sizes, out_cap: int, t_max: int,
                 m_max: int, models0=None, dict_arr=None):
    """payloads: [B, P] u8 (padded); plens/sizes: [B].

    Returns (out [B, dlen+out_cap+pad] u8, out_lens, matches [B, m_max, 3],
    mlens, err [B]). ``models0``: warm model tables (Flit, Fsize, Fbyte,
    Fbits, Fdist); ``dict_arr`` [dlen] u8: warm shared dictionary — the
    output buffer is dict-prefixed so distance checks and match
    application need no other change (FORMAT.md §3.1).
    """
    B, P = payloads.shape
    bidx = jnp.arange(B)
    WIN = 16  # stream-byte window per step (max consumes: 2 underflow + renorm)
    iota256 = jnp.arange(256, dtype=jnp.int32)
    iota32 = jnp.arange(32, dtype=jnp.int32)
    dlen = 0 if dict_arr is None else dict_arr.shape[0]

    # class-split model tables — dense (gather-free) per-step math instead
    # of a padded [B,36,256] layout. Initial freqs per reference sqz_init
    # (src/sqz.c:550-565).
    if models0 is not None:
        Flit0, Fsize0, Fbyte0, Fbits0, Fdist0 = models0
    else:
        Flit0 = jnp.ones((B, 2), jnp.uint32)
        Fsize0 = jnp.ones((B, 256), jnp.uint32)
        Fbyte0 = jnp.ones((B, 256), jnp.uint32)
        Fbits0 = jnp.ones((B, 32), jnp.uint32)
        Fdist0 = jnp.ones((B, 32, 2), jnp.uint32)

    def cond(st):
        t = st[0]
        state = st[6]
        return (t < t_max) & jnp.any((state != ST_DONE) & (state != ST_ERR))

    def step(st):
        (t, low, rng, code, rptr, models, state,
         psize, pbits, pdist, bitpos, out, optr, matches, mptr) = st
        Flit, Fsize, Fbyte, Fbits, Fdist = models
        active = (state != ST_DONE) & (state != ST_ERR)
        is_flag = active & (state == ST_FLAG)
        is_byte = active & (state == ST_BYTE)
        is_size = active & (state == ST_SIZE)
        is_bits = active & (state == ST_BITS)
        is_dist = active & (state == ST_DIST)
        is256 = is_byte | is_size

        # dense row selection: one 256-wide row (byte|size) and one 32-wide
        # row (flag|bits|dist-bit) per block
        row256 = jnp.where(is_byte[:, None], Fbyte, Fsize)
        distrow = jnp.sum(
            jnp.where((iota32[None, :] == bitpos[:, None])[:, :, None],
                      Fdist, 0), axis=1)                          # [B, 2]
        small = jnp.where(is_bits[:, None], 0,
                          jnp.where(is_flag[:, None], Flit, distrow))
        row32 = jnp.where(is_bits[:, None], Fbits,
                          jnp.pad(small, ((0, 0), (0, 30))))
        csum256 = jnp.cumsum(row256, axis=1).astype(jnp.uint64)
        csum32 = jnp.cumsum(row32, axis=1).astype(jnp.uint64)
        total = jnp.where(is256, csum256[:, -1], csum32[:, -1])
        total = jnp.maximum(total, np.uint64(1))
        widx = jnp.clip(rptr[:, None] + jnp.arange(WIN)[None, :], 0, P - 1)
        window = jnp.where(
            rptr[:, None] + jnp.arange(WIN)[None, :] < plens[:, None],
            payloads[bidx[:, None], widx], 0)                    # [B, WIN] u8
        # the window as two big-endian u64 words: all stream-byte consumption
        # below is pure shifts on these (no per-byte gathers in the hot loop)
        wu = window.astype(jnp.uint64)
        sh8 = (np.uint64(56) - (jnp.arange(8, dtype=jnp.uint64)
                                << np.uint64(3)))
        w0 = jnp.sum(wu[:, :8] << sh8[None, :], axis=1)
        w1 = jnp.sum(wu[:, 8:] << sh8[None, :], axis=1)

        # pre-decode underflow escape (FORMAT.md §2.3): consume 2 bytes
        uf = active & (rng < total)
        code = jnp.where(uf, (code << np.uint64(16)) | (w0 >> np.uint64(48)),
                         code)
        low = jnp.where(uf, low << np.uint64(16), low)
        rng = jnp.where(uf, MASK64 - low, rng)
        wpos = jnp.where(uf, 2, 0)

        rng_div = jnp.maximum(rng // total, np.uint64(1))
        cum = (code - low) // rng_div
        bad = active & (cum >= total)
        cum = jnp.minimum(cum, total - np.uint64(1))

        sym256 = jnp.minimum(jnp.sum(
            (csum256 <= cum[:, None]).astype(jnp.int32), axis=1), 255
        ).astype(jnp.int32)
        sym32 = jnp.minimum(jnp.sum(
            (csum32 <= cum[:, None]).astype(jnp.int32), axis=1), 31
        ).astype(jnp.int32)
        sym = jnp.where(is256, sym256, sym32)
        oh256 = (iota256[None, :] == sym256[:, None])
        oh32 = (iota32[None, :] == sym32[:, None])
        size = jnp.where(
            is256,
            jnp.sum(jnp.where(oh256, row256, 0), axis=1),
            jnp.sum(jnp.where(oh32, row32, 0), axis=1))
        csum_at = jnp.where(
            is256,
            jnp.sum(jnp.where(oh256, csum256, 0), axis=1),
            jnp.sum(jnp.where(oh32, csum32, 0), axis=1))
        start = csum_at - size.astype(jnp.uint64)
        size64 = jnp.maximum(size.astype(jnp.uint64), np.uint64(1))

        low = jnp.where(active, low + start * rng_div, low)
        rng = jnp.where(active, rng_div * size64, rng)

        # dense adaptive updates (one masked add per class)
        u32 = jnp.uint32
        Fbyte = Fbyte + (oh256 & is_byte[:, None]).astype(u32)
        Fsize = Fsize + (oh256 & is_size[:, None]).astype(u32)
        Fbits = Fbits + (oh32 & is_bits[:, None]).astype(u32)
        Flit = Flit + (oh32[:, :2] & is_flag[:, None]).astype(u32)
        Fdist = Fdist + ((iota32[None, :] == bitpos[:, None])[:, :, None]
                         & oh32[:, None, :2]
                         & is_dist[:, None, None]).astype(u32)

        # renorm-consume, collapsed to one clz (same ring-homomorphism
        # argument as the encoder): cnt leading equal bytes of low vs
        # low+range → shift registers by cnt bytes and splice cnt stream
        # bytes into code
        x = low ^ (low + rng)
        cnt = jnp.where(active,
                        (jax.lax.clz(x) >> np.uint64(3)).astype(jnp.int32), 0)
        shift = jnp.minimum(cnt.astype(jnp.uint64) << np.uint64(3),
                            np.uint64(63))
        full = cnt >= 8
        # first 8 window bytes starting at wpos (wpos is 0 or 2)
        wtop = jnp.where(wpos == 0, w0,
                         (w0 << np.uint64(16)) | (w1 >> np.uint64(48)))
        amount = jnp.clip(np.uint64(64) - shift, np.uint64(1), np.uint64(63))
        consumed = jnp.where(full, wtop, wtop >> amount)
        code = jnp.where(cnt > 0,
                         jnp.where(full, consumed, (code << shift) | consumed),
                         code)
        low = jnp.where(full, 0, low << shift)
        rng = jnp.where(full, 0, rng << shift)
        rptr = rptr + wpos + cnt

        # ---- state machine transitions + token outputs
        nstate = state
        nstate = jnp.where(is_flag, jnp.where(sym == 1, ST_BYTE, ST_SIZE), nstate)

        # literal byte: place directly at its output position
        out = out.at[bidx, jnp.where(is_byte, optr, out.shape[1] - 1)].set(
            sym.astype(jnp.uint8), mode="drop")
        optr = optr + is_byte.astype(optr.dtype)
        nstate = jnp.where(is_byte, ST_FLAG, nstate)

        eos = is_size & (sym == SQZ4_EOS)
        bad_size = is_size & ~eos & ((sym < SQZ4_MIN_LEN) | (sym > SQZ4_MAX_LEN))
        psize = jnp.where(is_size & ~eos, sym, psize)
        nstate = jnp.where(is_size, jnp.where(eos, ST_DONE, ST_BITS), nstate)

        # bits symbol: nbits-1 explicit low bits follow; nbits<=1 means the
        # distance is complete immediately (dist = 1 << (nbits-1))
        done_now = is_bits & (sym <= 1)
        bad_bits = is_bits & (sym == 0)
        pbits = jnp.where(is_bits, sym, pbits)
        pdist = jnp.where(is_bits, 0, pdist)
        bitpos = jnp.where(is_bits, 0, bitpos)
        nstate = jnp.where(is_bits, jnp.where(done_now, ST_FLAG, ST_DIST), nstate)

        pdist = jnp.where(is_dist, pdist | (sym << bitpos), pdist)
        bitpos = jnp.where(is_dist, bitpos + 1, bitpos)
        dist_done = is_dist & (bitpos == pbits - 1)
        nstate = jnp.where(dist_done, ST_FLAG, nstate)

        emit_match = (done_now | dist_done) & ~bad_bits
        dist = pdist | (1 << jnp.maximum(pbits - 1, 0))
        bad_dist = emit_match & (dist.astype(jnp.int64) > optr.astype(jnp.int64))
        emit_ok = emit_match & ~bad_dist
        mslot = jnp.where(emit_ok, mptr, m_max)
        matches = matches.at[bidx, mslot].set(
            jnp.stack([optr, psize, dist], axis=1).astype(jnp.int32),
            mode="drop")
        mptr = mptr + emit_ok.astype(mptr.dtype)
        optr = optr + jnp.where(emit_ok, psize, 0)

        overrun = active & (optr > sizes + dlen)
        err = bad | bad_size | bad_bits | bad_dist | overrun
        nstate = jnp.where(err, ST_ERR, nstate)

        i32 = jnp.int32
        return (t + 1, low, rng, code, rptr.astype(i32),
                (Flit, Fsize, Fbyte, Fbits, Fdist), nstate.astype(i32),
                psize.astype(i32), pbits.astype(i32), pdist.astype(i32),
                bitpos.astype(i32), out, optr.astype(i32), matches,
                mptr.astype(i32))

    # prime `code` with 8 stream bytes — code only, low/range untouched
    # (src/sqz.c:794-797)
    code = jnp.zeros((B,), dtype=jnp.uint64)
    low = jnp.zeros((B,), dtype=jnp.uint64)
    rng = jnp.full((B,), MASK64, dtype=jnp.uint64)
    rptr = jnp.zeros((B,), dtype=jnp.int32)
    for k in range(8):
        byte = jnp.where(k < plens, payloads[bidx, min(k, P - 1)],
                         0).astype(jnp.uint64)
        code = (code << np.uint64(8)) + byte
    rptr = rptr + 8

    out0 = jnp.zeros((B, dlen + out_cap + 257), jnp.uint8)
    if dlen:
        out0 = out0.at[:, :dlen].set(
            jnp.broadcast_to(dict_arr[None, :], (B, dlen)))
    st0 = (
        jnp.zeros((), jnp.int32), low, rng, code, rptr,
        (Flit0, Fsize0, Fbyte0, Fbits0, Fdist0),
        jnp.full((B,), ST_FLAG, jnp.int32),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
        out0,
        jnp.full((B,), dlen, jnp.int32),
        jnp.zeros((B, m_max + 1, 3), jnp.int32),
        jnp.zeros((B,), jnp.int32),
    )
    st = jax.lax.while_loop(cond, step, st0)
    state, out, optr, matches, mptr = st[6], st[11], st[12], st[13], st[14]
    return out, optr - dlen, matches, mptr, state == ST_ERR


def _apply_matches(out, matches, mlens, m_max: int):
    from sqz_tpu.ops.lz_apply import apply_matches
    return apply_matches(out, matches[:, :m_max], SQZ4_MAX_LEN)


def decode_blocks(payloads: Sequence[bytes], sizes: Sequence[int],
                  blk_bits: int, seed=None,
                  dictionary: bytes = b"") -> List[bytes]:
    """``seed``/``dictionary``: warm start shared by ALL blocks in this
    call (the warm container's block 0 is decoded separately first)."""
    B = len(payloads)
    P = max(max((len(p) for p in payloads), default=0), 8)
    P = 1 << (P - 1).bit_length()   # bucket the padded width: one compile
    #                                 per size class, not per stream length
    buf = np.zeros((B, P), dtype=np.uint8)
    for b, p in enumerate(payloads):
        buf[b, :len(p)] = np.frombuffer(p, dtype=np.uint8)
    plens = np.asarray([len(p) for p in payloads], dtype=np.int32)
    out_cap = 1 << blk_bits
    t_max = 17 * out_cap // 4 + 64
    m_max = out_cap // 2 + 1
    models0 = None
    if seed is not None:
        F, _ = init_model_state(B, [seed] * B)
        F = np.asarray(F)
        models0 = (jnp.asarray(F[:, 0, :2]), jnp.asarray(F[:, 1, :256]),
                   jnp.asarray(F[:, 2, :256]), jnp.asarray(F[:, 3, :32]),
                   jnp.asarray(np.ascontiguousarray(F[:, 4:36, :2])))
    dict_arr = (jnp.asarray(np.frombuffer(dictionary, dtype=np.uint8))
                if dictionary else None)
    dlen = len(dictionary)
    out, optr, matches, mptr, err = _decode_scan(
        jnp.asarray(buf), jnp.asarray(plens),
        jnp.asarray(np.asarray(sizes, dtype=np.int32)),
        out_cap, t_max, m_max, models0, dict_arr)
    if bool(jnp.any(err)):
        raise ValueError(f"corrupt sqz4 block(s): {np.nonzero(np.asarray(err))[0]}")
    # apply only the occupied match slots (padded to a power of two so the
    # jitted apply pass compiles once per size class, not per stream)
    m_used = int(np.asarray(mptr).max())
    m_pad = 1 << max(m_used - 1, 1).bit_length() if m_used else 0
    if m_pad:
        out = _apply_matches(out, matches, mptr, min(m_pad, m_max))
    out = np.asarray(out)
    optr = np.asarray(optr)
    for b, s in enumerate(sizes):
        if optr[b] != s:
            raise ValueError(f"block {b}: produced {optr[b]} of {s} bytes")
    return [out[b, dlen:dlen + sizes[b]].tobytes() for b in range(B)]
