"""Bounded on-device LZ matcher for general content (VERDICT r3 #1).

The host fast parse (hash chains) leaves general-content encode
host-bound on few-core hosts; this module parses raw device-resident
blocks INTO the token stream the device encoder (ops/coder.py) consumes,
entirely with XLA ops — no per-element gathers, no scatters, no hash
tables:

  1. **Candidates by sort.** For gram sizes k in {4, 8, 16}: sort
     (gram value words..., position) lexicographically per block
     (jax.lax.sort) —
     identical grams become sort-neighbors with positions ascending, so
     the NEAREST previous occurrence of each position's gram is its left
     neighbor, value-verified by construction (no fingerprint can lie,
     collision-free). One more sort by position returns the candidate
     distance array to position order.
  2. **Extension by agreement chaining.** cand[p+1] == cand[p] (same
     distance at the next position) proves one more matching byte —
     equal values chain transitively, so a log-doubling run-length over
     the agreement mask (static shifts only) gives byte-granular match
     lengths; the cross-table MIN distance chains the same way. Every
     claimed (len, dist) is therefore EXACT — the stream is spec-valid
     by construction (measured ~0.9 pp of ratio vs true-LCP extension,
     tools/lz_dev_lab.py).
  3. **Parse by segment-greedy scan with one-step lazy.** Segments of
     S=256 parse independently (matches clip at the segment boundary);
     a lax.scan over the S in-segment offsets walks every (block,
     segment) lane's cursor in parallel. Lazy: a strictly longer match
     at cursor+1 defers the current one.
  4. **Token compaction by sort.** Match tokens at match starts, length
     <=255 literal-run tokens at run starts, EOS at the block length —
     one (key=position, payload=token) sort packs them into the dense
     zero-terminated stream; the literal stream stays the RAW block
     (the encoder's lit_skip mode skips match spans).

Blocks whose token count exceeds the static slot budget demote to the
literal-only parse on device (their tokens always fit; ratio-only cost).

Ratio on the tiled reference corpus: +1.1 pp vs the host fast parse
(depth-32 hash chains), -13 pp vs literal-only (tools/lz_dev_lab.py;
the sim there mirrors these rules 1:1 and round-trip-verifies every
config). Reference parse semantics: squeeze.h:340-358 (greedy longest),
src/sqz.c:678-685 (short-far reject rule) — the sqzt container contract
is round-trip + ratio, not decision parity (FORMAT.md §3).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax import numpy as jnp

from sqz_tpu.ops import coder
from sqz_tpu.ops.resident import (
    EOS_TOKEN, _lit_word_dim, _pack_literal_words, _token_dim,
    _tokens_from_lengths,
)

I32 = jnp.int32
U32 = jnp.uint32

GRAM_SIZES = (4, 8, 16)
SEG = 256                 # parse segment (matches clip at its end)
WIN_MASK = (1 << 15) - 1  # format max distance (sqz_max_win_bits)
MAX_LEN = 254             # format max match length (sqz_max_len)


def _gram_words(blocks, k: int):
    """[B, n] u8 -> list of ceil(k/4) [B, n] i32 words: the EXACT bytes
    at p..p+k (zero-padded past the end; validity handled by the
    caller's length mask). Static shifts only."""
    B, n = blocks.shape
    words = []
    x = blocks.astype(jnp.uint32)
    for w in range(-(-k // 4)):
        v = jnp.zeros((B, n), U32)
        for j in range(4 * w, min(4 * w + 4, k)):
            sh = x if j == 0 else jnp.pad(x[:, j:], ((0, 0), (0, j)))
            v = (v << 8) | sh
        words.append(v.astype(I32))
    return words


def _gram_hash(words):
    """Mix the gram words into ONE i32 sort key. Collisions (~2^-32 per
    neighbor pair) only LOSE a candidate — `same` below still compares
    the exact words, so no collision can ever fabricate a match."""
    h = jnp.zeros_like(words[0], U32)
    for w in words:
        h = (h ^ w.astype(U32)) * jnp.asarray(0x9E3779B1, U32)
        h = h ^ (h >> 15)
    return h.astype(I32)


def _sorted_neighbor_dists_slim(words, pos, lengths, k: int):
    """Whole-row fast path (round 5, hardware-priced): the ``valid``
    operand never rides the sort — validity is recomputable from the
    sorted positions (pos + k <= len, lengths are per-row) — and for
    k == 4 the exact gram word IS the sort key (collision-free, so the
    sort carries just 2 operands instead of 4). Results are identical
    to the carry path (a g4 hash collision could only LOSE a candidate;
    the exact key cannot)."""
    B, n = pos.shape
    if len(words) == 1:
        s = jax.lax.sort((words[0], pos), dimension=1, num_keys=1,
                         is_stable=True)
        sp_, sw = s[1], (s[0],)
    else:
        s = jax.lax.sort((_gram_hash(words), pos) + tuple(words),
                         dimension=1, num_keys=1, is_stable=True)
        sp_, sw = s[1], s[2:]
    same = jnp.ones(sp_.shape, bool)
    for w in sw:
        same = same & jnp.pad(w[:, 1:] == w[:, :-1], ((0, 0), (1, 0)))
    sv = sp_ + k <= lengths[:, None].astype(I32)
    prev_pos = jnp.pad(sp_[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    prev_ok = jnp.pad(sv[:, :-1], ((0, 0), (1, 0)))
    d = jnp.where(same & prev_ok & sv, sp_ - prev_pos, 0)
    d = jnp.where((d > 0) & (d <= WIN_MASK), d, 0)
    _, dist = jax.lax.sort((sp_, d), dimension=1, num_keys=1)
    return dist


def _sorted_neighbor_dists(hsh, pos, valid, words, verify: str):
    """Shared core: sort rows by hash, compare each element with its left
    sort-neighbor (exact word verify), return per-position distances in
    position order. Rows are whatever segmentation the caller chose."""
    if verify == "carry":
        # words ride through the sort as extra operands
        ops = (hsh, pos, valid.astype(I32)) + tuple(words)
        s = jax.lax.sort(ops, dimension=1, num_keys=1, is_stable=True)
        sp_, sv, sw = s[1], s[2], s[3:]
    else:
        # slim sort (3 operands); re-derive the neighbor words by an
        # in-row gather at the sorted positions
        s = jax.lax.sort((hsh, pos, valid.astype(I32),
                          jnp.broadcast_to(
                              jnp.arange(hsh.shape[1], dtype=I32)[None],
                              hsh.shape)),
                         dimension=1, num_keys=1, is_stable=True)
        sp_, sv, idx = s[1], s[2], s[3]
        sw = [jnp.take_along_axis(w, idx, axis=1) for w in words]
    same = jnp.ones(sp_.shape, bool)
    for w in sw:
        same = same & jnp.pad(w[:, 1:] == w[:, :-1], ((0, 0), (1, 0)))
    prev_pos = jnp.pad(sp_[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    prev_ok = jnp.pad(sv[:, :-1] > 0, ((0, 0), (1, 0)))
    d = jnp.where(same & prev_ok & (sv > 0), sp_ - prev_pos, 0)
    d = jnp.where((d > 0) & (d <= WIN_MASK), d, 0)
    # unsort: one more sort keyed by position
    _, dist = jax.lax.sort((sp_, d), dimension=1, num_keys=1)
    return dist


def _table_dists(blocks, lengths, k: int, seg: int = 0,
                 verify: str = "carry"):
    """Nearest previous EXACT k-gram occurrence distance per position
    (0 = none), via two sorts. Invalid positions (p + k > len) neither
    source nor receive candidates.

    The sort key is a single mixed i32 hash, NOT the lexicographic word
    tuple: one key keeps the comparator (and its compile) small.
    lax.sort is stable, so equal-hash runs keep ascending position order
    for free, and the word payloads value-verify each neighbor pair
    exactly (assume-then-verify: a hash collision between sort neighbors
    drops that candidate, never lies).

    ``seg``: 0 sorts whole rows (candidates anywhere in the block);
    seg > 0 sorts overlapped segments of that length instead — two
    interleaved partitions offset by seg/2, nearest distance of the two —
    so every candidate at distance <= seg/2 is always found and the sort
    rows shrink from n to seg (the sort's cost driver). ``verify``:
    'carry' rides the gram words through the sort; 'gather' sorts 3 slim
    operands and re-derives neighbor words by in-row gathers."""
    B, n = blocks.shape
    words = _gram_words(blocks, k)
    pos = jnp.broadcast_to(jnp.arange(n, dtype=I32)[None], (B, n))
    valid = pos + k <= lengths[:, None].astype(I32)
    if (not seg or seg >= n) and verify == "carry":
        return _sorted_neighbor_dists_slim(words, pos, lengths, k)
    hsh = _gram_hash(words)
    if not seg or seg >= n:
        return _sorted_neighbor_dists(hsh, pos, valid, words, verify)
    if n % seg or seg % 2:
        raise ValueError("sort segment must divide the block length")

    def _one(off):
        def cut(x, fill):
            if off:
                x = jnp.pad(x[:, :n - off], ((0, 0), (off, 0)),
                            constant_values=fill)
            return x.reshape(B * (n // seg), seg)
        # pos pad = -1: pads must sort strictly before every real entry
        # in the unsort (a real position-0 entry exists in the first
        # offset segment) and stay in their own slots
        d = _sorted_neighbor_dists(
            cut(hsh, 0), cut(pos, -1), cut(valid, False),
            [cut(w, 0) for w in words], verify).reshape(B, n)
        if off:
            d = jnp.pad(d[:, off:], ((0, 0), (0, off)))
        return d

    d0, d1 = _one(0), _one(seg // 2)
    return jnp.where((d1 > 0) & ((d0 == 0) | (d1 < d0)), d1, d0)


def _runlen(agree, cap: int):
    """Consecutive True runs starting at each position (log-doubling,
    static shifts)."""
    rl = agree.astype(I32)
    s = 1
    while s < cap:
        sh = jnp.pad(rl[:, s:], ((0, 0), (0, s)))
        rl = jnp.where(rl == s, s + sh, rl)
        s *= 2
    return jnp.minimum(rl, cap)


def _best_match(blocks, lengths, seg: int = 0, verify: str = "carry"):
    """(ml, dist) per position: best chained candidate across the gram
    tables and the cross-table min-distance chain."""
    B, n = blocks.shape
    pos = jnp.arange(n, dtype=I32)[None]
    rem = jnp.maximum(lengths[:, None].astype(I32) - pos, 0)
    tabs = [(k, _table_dists(blocks, lengths, k, seg, verify))
            for k in GRAM_SIZES]
    m = jnp.zeros((B, n), I32)
    for _, dd in tabs:
        m = jnp.where((dd > 0) & ((m == 0) | (dd < m)), dd, m)
    chains = [(k, dd) for k, dd in tabs] + [(GRAM_SIZES[0], m)]
    ml = jnp.zeros((B, n), I32)
    dist = jnp.zeros((B, n), I32)
    for base, dd in chains:
        v = dd > 0
        agree = jnp.pad(v[:, :-1] & v[:, 1:] & (dd[:, 1:] == dd[:, :-1]),
                        ((0, 0), (0, 1)))
        rl = _runlen(agree, MAX_LEN - base)
        mlt = jnp.minimum(jnp.where(v, base + rl, 0),
                          jnp.minimum(rem, MAX_LEN))
        take = v & ((mlt > ml) | ((mlt == ml) & (dd < dist)))
        ml = jnp.where(take, mlt, ml)
        dist = jnp.where(take, dd, dist)
    return ml, dist


def _greedy_flags(ml, dist, S: int, lazy: bool = True):
    """Segment-greedy cursor walk (scan over the S in-segment offsets):
    returns the match-start mask [B, n]. Matches clip at segment ends;
    accept length >= 4, or >= 2 at distance <= 7 (the reject-rule floor,
    src/sqz.c:678-685); one-step lazy deferral."""
    B, n = ml.shape
    nseg = n // S
    ml_r = ml.reshape(B, nseg, S)
    d_r = dist.reshape(B, nseg, S)

    def step(cur, t):
        active = cur == t
        mlt = jnp.minimum(ml_r[:, :, t], S - t)
        dt = d_r[:, :, t]
        minl = jnp.where(dt <= 7, 2, 4)
        ok = active & (dt > 0) & (mlt >= minl)
        if lazy:
            tn = jnp.minimum(t + 1, S - 1)
            nl = jnp.minimum(ml_r[:, :, tn], S - tn)
            defer = (t + 1 < S) & (d_r[:, :, tn] > 0) & (nl > mlt)
            ok = ok & ~defer
        cur = jnp.where(ok, t + mlt, jnp.where(active, t + 1, cur))
        return cur, ok

    cur0 = jnp.zeros((B, nseg), I32)
    _, flags = jax.lax.scan(step, cur0, jnp.arange(S, dtype=I32))
    return flags.transpose(1, 2, 0).reshape(B, n)     # [S,B,nseg]->[B,n]


def _bit_length(x):
    nb = jnp.zeros_like(x)
    for i in range(16):
        nb = nb + (x >= (1 << i)).astype(I32)
    return nb


def _tokens_from_flags(mstart, ml, dist, lengths, S: int, Tt: int):
    """Match-start flags -> dense [B, Tt] u32 token stream (compaction
    sort) + per-lane ntok. Literal runs split at 255."""
    B, n = mstart.shape
    pos = jnp.broadcast_to(jnp.arange(n, dtype=I32)[None], (B, n))
    L = lengths[:, None].astype(I32)
    seg_end = (pos // S + 1) * S
    mlen = jnp.where(mstart, jnp.minimum(ml, seg_end - pos), 0)
    # covered[p]: inside a match (match spans never nest/overlap: the
    # cursor jumped past them) — prefix max of (start + len) beats p
    span_end = jnp.where(mstart, pos + mlen, -1)
    run_end = jax.lax.associative_scan(jnp.maximum, span_end, axis=1)
    covered = pos < run_end                          # true inside matches
    lit = (pos < L) & ~covered & ~mstart
    # literal run starts + 255-splits
    litp = jnp.pad(lit[:, :-1], ((0, 0), (1, 0)))
    rstart0 = lit & ~litp
    srt = jax.lax.associative_scan(
        jnp.maximum, jnp.where(rstart0, pos, -1), axis=1)
    rel = pos - srt
    rstart = lit & (rel % 255 == 0)
    # run token length: distance to the next non-literal position
    nxt = jax.lax.associative_scan(
        jnp.minimum, jnp.where(lit, n + 1, pos), axis=1, reverse=True)
    rlen = jnp.minimum(jnp.where(rstart, nxt - pos, 0), 255)
    rlen = jnp.minimum(rlen, L - pos)
    nb = _bit_length(dist)
    mtok = (mlen.astype(U32) | jnp.asarray(1 << 8, U32)
            | (nb.astype(U32) << 9) | (dist.astype(U32) << 16))
    tok = jnp.where(mstart, mtok, jnp.where(rstart, rlen.astype(U32), 0))
    istok = mstart | rstart
    key = jnp.where(istok, pos, n + 2)
    # EOS slot at key = block length (after every real token)
    key = jnp.concatenate([key, L[:, :1]], axis=1)
    tok = jnp.concatenate(
        [tok, jnp.full((B, 1), EOS_TOKEN, U32)], axis=1)
    _, toks = jax.lax.sort((key, tok.astype(I32)), dimension=1, num_keys=1)
    toks = toks[:, :Tt].astype(U32)
    ntok = jnp.sum(istok, axis=1) + 1
    return toks, ntok


@partial(jax.jit, static_argnames=("k", "seg", "verify"))
def _table_stage(blocks, lengths, k: int, seg: int, verify: str):
    return _table_dists(blocks, lengths, k, seg, verify)


@partial(jax.jit, static_argnames=("grams",))
def _select_stage(lengths, *dists, grams=GRAM_SIZES):
    """Combine the per-gram candidate tables into the best (ml, dist)
    per position — _best_match's tail, with the tables precomputed.
    ``grams`` names the table sizes (one per dists entry)."""
    B, n = dists[0].shape
    pos = jnp.arange(n, dtype=I32)[None]
    rem = jnp.maximum(lengths[:, None].astype(I32) - pos, 0)
    m = jnp.zeros((B, n), I32)
    for dd in dists:
        m = jnp.where((dd > 0) & ((m == 0) | (dd < m)), dd, m)
    chains = list(zip(grams, dists)) + [(grams[0], m)]
    ml = jnp.zeros((B, n), I32)
    dist = jnp.zeros((B, n), I32)
    for base, dd in chains:
        v = dd > 0
        agree = jnp.pad(v[:, :-1] & v[:, 1:] & (dd[:, 1:] == dd[:, :-1]),
                        ((0, 0), (0, 1)))
        rl = _runlen(agree, MAX_LEN - base)
        mlt = jnp.minimum(jnp.where(v, base + rl, 0),
                          jnp.minimum(rem, MAX_LEN))
        take = v & ((mlt > ml) | ((mlt == ml) & (dd < dist)))
        ml = jnp.where(take, mlt, ml)
        dist = jnp.where(take, dd, dist)
    return ml, dist


@partial(jax.jit, static_argnames=("Tt", "S", "lazy", "Lw"))
def _parse_stage(blocks, ml, dist, lengths, Tt: int, S: int, lazy: bool,
                 Lw: int):
    """Greedy cursor walk + token compaction + literal packing + the
    slot-budget demotion — everything after candidate selection."""
    mstart = _greedy_flags(ml, dist, S, lazy)
    toks, ntok = _tokens_from_flags(mstart, ml, dist, lengths, S, Tt)
    # slot-budget demotion: blocks with more tokens than Tt re-parse as
    # literal-only (always fits: ceil(bs/255)+1 slots)
    lit_toks = _tokens_from_lengths(lengths, Tt)[0].transpose(1, 0)
    demote = ntok > Tt
    toks = jnp.where(demote[:, None], lit_toks, toks)
    lits = _pack_literal_words(blocks, Lw)
    return toks.transpose(1, 0)[None], lits, demote


def _grams_env() -> tuple:
    """Gram-table sizes from SQZ_LZ_GRAMS (comma list, default 4,8,16) —
    the fewer-tables throughput lever (ROADMAP #3): each table costs two
    sorts per slice; the 8-gram-only config loses little ratio in the
    lab (tools/lz_dev_lab.py) at a third of the sort cost."""
    import os
    raw = os.environ.get("SQZ_LZ_GRAMS", "")
    if not raw:
        return GRAM_SIZES
    try:
        grams = tuple(sorted({int(x) for x in raw.split(",") if x}))
    except ValueError:
        raise ValueError(f"SQZ_LZ_GRAMS={raw!r} is not a comma list of ints")
    if not grams or any(g < 2 or g > 64 for g in grams):
        raise ValueError(f"SQZ_LZ_GRAMS entries must be in 2..64: {raw!r}")
    return grams


def sort_rows() -> int:
    """Rows per parse slice, SQZ_LZ_SORT_ROWS (default 64), validated."""
    import os
    raw = os.environ.get("SQZ_LZ_SORT_ROWS", "64")
    try:
        rows = int(raw)
    except ValueError:
        raise ValueError(f"SQZ_LZ_SORT_ROWS={raw!r} is not an integer")
    if rows < 1:
        raise ValueError(f"SQZ_LZ_SORT_ROWS must be >= 1, got {rows}")
    return rows


def lz_plan_device(blocks, lengths, Tt: int, S: int = SEG,
                   lazy: bool = True, seg: int = 0,
                   verify: str = "carry", rows: int = None,
                   grams: tuple = None):
    """Device parse pass: raw [B, bs] u8 blocks (+ per-lane lengths) ->
    ([1, Tt, B] u32 token streams, [1, Lw, B] raw literal words, [B]
    demoted-to-literal mask). ``seg``/``verify``: sort segmentation +
    neighbor-verify strategy (_table_dists).

    Deliberately NOT one fused jit: each stage is its own program with
    at most two lax.sort HLOs, which keeps every compile small;
    intermediates stay on device, so steady-state cost is dispatch-only.

    ``rows`` (SQZ_LZ_SORT_ROWS, default 64): the batch is parsed in
    slices of this many rows; slices reuse the same compiled programs
    and their outputs concatenate on device."""
    B, bs = blocks.shape
    Lw = _lit_word_dim(bs)
    if grams is None:
        grams = _grams_env()
    if rows is None:
        rows = sort_rows()
    outs = []
    for i in range(0, B, rows):
        blk, ln = blocks[i:i + rows], lengths[i:i + rows]
        n = blk.shape[0]
        if n != rows:
            # pad the final slice to the full row count with zero-length
            # lanes (EOS-only tokens) so every slice reuses the same
            # compiled sort programs
            blk = jnp.pad(blk, ((0, rows - n), (0, 0)))
            ln = jnp.pad(ln, (0, rows - n))
        dists = [_table_stage(blk, ln, k, seg, verify)
                 for k in grams]
        ml, dist = _select_stage(ln, *dists, grams=grams)
        out = _parse_stage(blk, ml, dist, ln, Tt, S, lazy, Lw)
        if n != rows:
            out = (out[0][:, :, :n], out[1][:, :, :n], out[2][:n])
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    return (jnp.concatenate([o[0] for o in outs], axis=2),
            jnp.concatenate([o[1] for o in outs], axis=2),
            jnp.concatenate([o[2] for o in outs], axis=0))


def lz_group_args(blk_bits: int, cap: int = None) -> dict:
    """Static kwargs for the LZ-mode encode group. SQZ_LZ_SORT_SEG /
    SQZ_LZ_VERIFY pick the sort segmentation (0 = whole rows) and the
    neighbor-verify strategy (carry|gather)."""
    import os
    bs = 1 << blk_bits
    if cap is None:
        cap = bs + 2048
    # token slot budget: a quarter of the block size (min-length-4 text
    # can approach it); blocks past it demote to the literal-only parse
    Tt = max(_token_dim(bs), bs // 4 + 64)
    return dict(Tt=Tt, cap_words=coder.cap_words_for(cap),
                seg=int(os.environ.get("SQZ_LZ_SORT_SEG", "0")),
                verify=os.environ.get("SQZ_LZ_VERIFY", "carry"))


def encode_lz_group(blocks, lengths, Tt: int, cap_words: int,
                    seg: int = 0, verify: str = "carry"):
    """One lane group through the device-LZ path: sort-based parse +
    lit_skip encoder over the RAW literal stream. Returns (words, lens)
    device arrays; payloads are ordinary sqz4 streams."""
    toks, lits, _dem = lz_plan_device(blocks, lengths, Tt, seg=seg,
                                      verify=verify)
    return coder.encode(toks, lits, cap_words, lit_skip=True)
