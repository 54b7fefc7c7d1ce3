"""Device-resident sqz4 literal-only encode/decode — zero host planning.

The reference HEAD encoder emits literals only (src/sqz.c:591 zeroes the
match map at function entry), so its exact stream semantics need no match
finder. That makes the literal-only mode fully device-resident: the token
stream (one run token per <=255 literals + EOS, the layout of
native sqz4_tok_plan's lz=0 branch) and the packed literal stream are
computed from the raw bytes by fused XLA ops, and the device encoder
(ops/coder.py) does the coding. No per-byte host work, no host->device
token traffic — the input is already in device memory (the
checkpoint-shard / activation-buffer use case) and only compressed bytes
ever need to cross the link.

Decode mirrors it: the encoder's output word layout IS the decoder's
payload input layout, and for literal-only streams the decoder's dense
literal stream IS the output, so a round trip never leaves the device.

Streams are bit-identical to the host/oracle coders' lz=False payloads
(asserted in tests/test_resident.py against sqz4_compress_payload).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax import numpy as jnp

from sqz_tpu.ops import coder

I32 = jnp.int32
U32 = jnp.uint32

EOS_TOKEN = np.uint32(0x1FF)         # 0xFF | (1 << 8): match flag + len 255


_round_up = coder.round_up


def _token_dim(bs: int) -> int:
    # run tokens + EOS
    return -(-bs // 255) + 1


def _lit_word_dim(bs: int) -> int:
    return -(-bs // 4)


def _tokens_from_lengths(lengths, Tt: int):
    """[B] i32 block lengths -> [1, Tt, B] u32 literal-run token streams
    (run tokens of 255 then the remainder, EOS, zero-terminated) — the
    exact lz=0 layout of native sqz4_tok_plan."""
    B = lengths.shape[0]
    t = jax.lax.broadcasted_iota(I32, (Tt, B), 0)
    L = lengths[None, :].astype(I32)
    runs = (L + 254) // 255
    rem = jnp.clip(L - t * 255, 0, 255)
    tok = jnp.where(t < runs, rem.astype(U32), jnp.asarray(0, U32))
    return jnp.where(t == runs, jnp.asarray(EOS_TOKEN, U32), tok)[None]


def _pack_literal_words(blocks, Lw: int):
    """[B, bs] u8 blocks -> [1, Lw, B] u32 (4 big-endian bytes per word,
    zero-padded to Lw rows) — the encoder's literal stream layout."""
    B, bs = blocks.shape
    x = blocks.astype(U32).reshape(B, bs // 4, 4)
    w = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    w = w.transpose(1, 0)
    if Lw > w.shape[0]:
        w = jnp.pad(w, ((0, Lw - w.shape[0]), (0, 0)))
    return w[None]


@partial(jax.jit, static_argnames=("Tt", "Lw", "cap_words"))
def encode_literal_group(blocks, lengths, Tt: int, Lw: int, cap_words: int):
    """One lane group, fully on-device: raw [B, bs] u8 blocks (+ per-lane
    valid lengths) -> (payload words [1, cap_words, B] u32, lens
    [1, 1, B] i32)."""
    toks = _tokens_from_lengths(lengths, Tt)
    lits = _pack_literal_words(blocks, Lw)
    return coder.encode(toks, lits, cap_words)


def _words_to_bytes(w):
    """[..., W] u32/i32 words -> [..., W*4] bytes (big-endian within each
    word — the coders' stream layout). Single definition for every
    unpack in this module."""
    w = w.astype(I32)
    by = jnp.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF,
                    (w >> 8) & 0xFF, w & 0xFF], axis=-1)
    return by.reshape(by.shape[:-2] + (by.shape[-2] * 4,))


def _unpack_literal_bytes(lit_words, sizes, bs: int):
    """[1, LW, B] u32 decoder literal stream -> [B, bs] u8 output blocks
    (bytes past each lane's size zeroed). Literal-only streams have no
    match records, so the literal stream is the decoded data."""
    _, LW, B = lit_words.shape
    by = _words_to_bytes(lit_words[0].transpose(1, 0))     # [B, LW*4]
    by = by[:, :bs].astype(jnp.uint8)
    pos = jax.lax.broadcasted_iota(I32, (B, bs), 1)
    return jnp.where(pos < sizes[:, None], by, jnp.asarray(0, jnp.uint8))


@partial(jax.jit, static_argnames=("Pw", "lw", "tw", "mw", "bs"))
def decode_literal_group(words, lens, sizes, Pw: int, lw: int, tw: int,
                         mw: int, bs: int):
    """Mirror of encode_literal_group, fully on-device: encoder output
    (words, lens) + expected sizes -> ([B, bs] u8 blocks, counts
    [1, 8, B] i32). counts rows: 0 produced bytes, 4 error code, 6
    overflow flag — callers wanting validation download this small row
    block, not the data."""
    meta = coder.make_meta(lens[0, 0, :], sizes)
    lit, _tok, _mrec, counts = coder.decode(words[:, :Pw, :], meta, lw, tw,
                                            mw)
    return _unpack_literal_bytes(lit, sizes, bs), counts


def encode_literal_blocks(data: bytes, blk_bits: int,
                          lanes: int = coder.ENC_LANES, cap: int = None):
    """Host-facing convenience wrapper: bytes -> per-block payloads via
    the device-resident path (the only host work is the one raw upload
    and the trimmed payload download)."""
    return encode_resident_blocks(data, blk_bits, "lit", lanes, cap)


CELL = 128
# candidate periods for the device cell parse: dist-d matches with d a
# power of two <= CELL (nbits = bit_length(d); smaller d preferred —
# fewer distance-bit pairs and a warmer pm_dist model)
RLE_DISTS = (1, 2, 4, 8, 16, 32, 64, 128)


def _match_token(dist: int) -> np.uint32:
    nbits = int(dist).bit_length()
    return np.uint32(CELL | (1 << 8) | (nbits << 9) | (dist << 16))


def _rle_tokens_from_blocks(blocks, lengths, Tt: int):
    """Cell-granular periodic parse, entirely on-device: a 128-byte cell
    that continues a period-d repeat (bytes[i] == bytes[i-d] for the
    whole cell, d in RLE_DISTS — the overlapped-copy semantics of
    src/sqz.c:826-831) becomes one len-128/dist-d match token (a few coder
    steps instead of 256; d=1 is plain RLE, d=4 the reference's classic
    4-byte-pattern synthetic case); an all-zero cell with no periodic
    predecessor copies the nearest previous all-zero cell instead
    (dist = k*CELL, k <= 255 — the isolated-zero-cell case sparse
    checkpoints hit); other full cells are 128-literal run tokens, the
    partial tail is a literal run, EOS closes. Returns [1, Tt, B] u32
    tokens."""
    B, bs = blocks.shape
    C = bs // CELL
    c = jnp.arange(C, dtype=I32)[None, :]
    cells = blocks.reshape(B, C, CELL)
    cell_tok = jnp.full((B, C), CELL, U32)              # literal default
    matched = jnp.zeros((B, C), bool)
    # cell [s, s+128) continues period d iff bytes[i] == bytes[i-d]
    # across it; split cell-aligned: (a) intra-cell periodicity, (b) the
    # first d bytes stitch to the previous cell's last d bytes
    for d in reversed(RLE_DISTS):                       # small d wins
        if d < CELL:
            intra = jnp.all(cells[:, :, d:] == cells[:, :, :-d], axis=2)
            stitch = jnp.all(
                cells[:, 1:, :d] == cells[:, :-1, CELL - d:], axis=2)
        else:                                           # d == CELL
            intra = jnp.ones((B, C), bool)
            stitch = jnp.all(cells[:, 1:, :] == cells[:, :-1, :], axis=2)
        ok = intra & jnp.concatenate(
            [jnp.zeros((B, 1), bool), stitch], axis=1)  # cell 0 never
        cell_tok = jnp.where(ok, jnp.asarray(_match_token(d), U32),
                             cell_tok)
        matched = matched | ok
    L = lengths[:, None].astype(I32)
    full = (c > 0) & ((c + 1) * CELL <= L)              # full cells only
    # far zero-cell copies: an all-zero cell whose predecessor does not
    # end in zeros (so no small-d periodic match exists) still copies any
    # previous all-zero full cell verbatim — dist = k*CELL to the nearest
    # one (k <= 255 keeps dist < 2^15). The resident decoder assumes such
    # copies are zero and VERIFIES the source cell after assembly
    # (decode_rle_group), so foreign streams can never decode wrongly.
    fullsrc = ((c + 1) * CELL <= L)                     # incl. cell 0
    iszero = fullsrc & jnp.all(cells == 0, axis=2)
    zidx = jnp.where(iszero, c, -1)
    prevz = jax.lax.associative_scan(jnp.maximum, zidx, axis=1)
    prevz = jnp.concatenate(
        [jnp.full((B, 1), -1, I32), prevz[:, :-1]], axis=1)   # exclusive
    k = c - prevz
    farok = iszero & ~matched & (c > 0) & (prevz >= 0) & (k <= 255)
    fdist = k * CELL
    fnb = jnp.zeros_like(fdist)
    for i in range(16):                                 # bit_length(fdist)
        fnb = fnb + (fdist >= (1 << i)).astype(I32)
    ftok = (jnp.asarray(CELL | (1 << 8), U32)
            | (fnb.astype(U32) << 9) | (fdist.astype(U32) << 16))
    cell_tok = jnp.where(farok, ftok, cell_tok)
    matched = matched | farok
    # generic far cell dedup (nonzero contents): a full cell identical to
    # an earlier LITERAL full cell within 255 cells copies it with the
    # same cell-aligned-dist token. The resident decoder fills such cells
    # from its pass-2 literal preplacement at the SOURCE cell and
    # verifies out[c] == out[src] after assembly, so sources must decode
    # as literal cells: restricting sources to the EARLIEST non-matched
    # occurrence of each content guarantees it — a source that were
    # itself a far copy would need an earlier identical eligible cell,
    # contradicting earliest. Candidates come from a keyed u32
    # fingerprint; emission is gated on an exact byte compare of the
    # gathered source cell, so a fingerprint collision only costs a
    # missed match.
    eligible = fullsrc & ~matched
    kw = ((np.arange(CELL, dtype=np.uint64) * 0x9E3779B1 + 1)
          & 0xFFFFFFFF).astype(np.uint32)
    fp = jnp.sum(cells.astype(U32) * jnp.asarray(kw)[None, None, :],
                 axis=2)                                    # [B, C] u32
    c_s = jnp.arange(C, dtype=I32)
    BIGC = C + 1
    CH = min(64, C)
    src_chunks, ver_chunks = [], []
    for c0 in range(0, C, CH):
        n = min(CH, C - c0)
        out_i = c_s[c0:c0 + n]
        ok = ((fp[:, c0:c0 + n, None] == fp[:, None, :])
              & eligible[:, None, :]
              & (c_s[None, None, :] < out_i[None, :, None]))
        cand = jnp.where(ok, c_s[None, None, :], BIGC)
        src_c = jnp.min(cand, axis=2)                       # [B, n]
        got = jnp.take_along_axis(
            cells, jnp.minimum(src_c, C - 1)[:, :, None], axis=1)
        ver_chunks.append(jnp.all(got == cells[:, c0:c0 + n, :], axis=2))
        src_chunks.append(src_c)
    dsrc = jnp.concatenate(src_chunks, axis=1)              # [B, C]
    dver = jnp.concatenate(ver_chunks, axis=1)
    kd = c - dsrc
    dupok = full & ~matched & dver & (kd >= 1) & (kd <= 255)
    ddist = jnp.where(dupok, kd * CELL, 0)
    dnb = jnp.zeros_like(ddist)
    for i in range(16):
        dnb = dnb + (ddist >= (1 << i)).astype(I32)
    dtok = (jnp.asarray(CELL | (1 << 8), U32)
            | (dnb.astype(U32) << 9) | (ddist.astype(U32) << 16))
    cell_tok = jnp.where(dupok, dtok, cell_tok)
    matched = matched | dupok
    isrun = matched & full
    cell_tok = jnp.where(isrun, cell_tok, jnp.asarray(CELL, U32))
    nfull = lengths.astype(I32) // CELL
    rem = lengths.astype(I32) - nfull * CELL
    eslot = nfull + (rem > 0)
    t = jax.lax.broadcasted_iota(I32, (Tt, B), 0)
    ct = jnp.concatenate(
        [cell_tok.transpose(1, 0),
         jnp.zeros((Tt - C, B), U32)], axis=0)          # slot t = cell t
    tok = jnp.where(t < nfull[None, :], ct, jnp.asarray(0, U32))
    tok = jnp.where((t == nfull[None, :]) & (rem[None, :] > 0),
                    rem[None, :].astype(U32), tok)
    tok = jnp.where(t == eslot[None, :], jnp.asarray(EOS_TOKEN, U32), tok)
    return tok[None]


@partial(jax.jit, static_argnames=("Tt",))
def rle_plan_device(blocks, lengths, Tt: int):
    """Device parse pass: (tokens, raw literal words)."""
    toks = _rle_tokens_from_blocks(blocks, lengths, Tt)
    lits = _pack_literal_words(blocks, _lit_word_dim(blocks.shape[1]))
    return toks, lits


def rle_group_args(blk_bits: int, cap: int = None) -> dict:
    """Static kwargs for the RLE-mode encode group (token dim covers one
    slot per cell + tail + EOS)."""
    bs = 1 << blk_bits
    if cap is None:
        cap = bs + 2048
    return dict(Tt=bs // CELL + 2, cap_words=coder.cap_words_for(cap))


def encode_rle_group(blocks, lengths, Tt: int, cap_words: int):
    """One lane group through the RLE-resident path: device parse +
    lit_skip encoder over the RAW literal stream (no compaction
    anywhere). Returns (words, lens) device arrays; the payloads are
    ordinary sqz4 streams."""
    toks, lits = rle_plan_device(blocks, lengths, Tt)
    return coder.encode(toks, lits, cap_words, lit_skip=True)


def _prep_blocks(data, blk_bits: int, lanes: int, multiple: int = None):
    """bytes OR a 1-D u8 array (host or device-resident) -> ([rows, bs]
    device u8 blocks, [rows] np.int32 valid lengths, NB, total bytes).
    rows is NB rounded up to ``multiple`` when given; otherwise NB, or NB
    rounded up to whole groups of ``lanes`` when there is more than one
    group. Device arrays are padded/reshaped on-device — no download."""
    bs = 1 << blk_bits

    def _rows(NB):
        if multiple:
            return _round_up(NB, multiple)
        return NB if NB <= lanes else _round_up(NB, lanes)

    if isinstance(data, (bytes, bytearray, memoryview)):
        n = len(data)
        NB = max(1, -(-n // bs))
        rows = _rows(NB)
        arr = np.zeros((rows, bs), np.uint8)
        arr.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
        blocks = jnp.asarray(arr)
    else:
        flat = jnp.asarray(data, dtype=jnp.uint8).reshape(-1)
        n = int(flat.shape[0])
        NB = max(1, -(-n // bs))
        rows = _rows(NB)
        blocks = jnp.pad(flat, (0, rows * bs - n)).reshape(rows, bs)
    lengths = np.zeros((rows,), np.int32)
    lengths[:NB] = np.clip(n - np.arange(NB, dtype=np.int64) * bs, 0, bs)
    return blocks, lengths, NB, n


MAX_BLK_BITS = 20        # 1 MiB blocks: the largest the resident paths size


def check_blk_bits(blk_bits: int):
    if not 1 <= blk_bits <= MAX_BLK_BITS:
        raise ValueError(f"resident paths support blk_bits "
                         f"1..{MAX_BLK_BITS}, got {blk_bits}")


def encode_resident_blocks(data, blk_bits: int, mode: str = "rle",
                           lanes: int = coder.ENC_LANES, cap: int = None):
    """Resident-path encode of bytes or a (device) u8 array to per-block
    sqz4 payloads. ``mode``: 'lit' = literal-only (reference HEAD
    semantics, fully plan-free); 'rle' = the device periodic cell parse
    on top of it; 'lz' = the bounded general-content device matcher
    (ops/lzparse.py — sort-based exact-gram candidates + chained
    extension). The only downloads are the payload bytes."""
    check_blk_bits(blk_bits)
    if mode not in ("lit", "rle", "lz"):
        raise ValueError(f"unknown resident mode {mode!r}")
    if mode == "rle" and (1 << blk_bits) < CELL:
        mode = "lit"    # blocks smaller than a cell: no matches possible
    from sqz_tpu.ops import lzparse
    if mode == "lz" and (1 << blk_bits) < lzparse.SEG:
        mode = "lit"    # blocks smaller than one parse segment
    blocks, lengths, NB, _n = _prep_blocks(data, blk_bits, lanes)
    if mode == "rle":
        gargs = rle_group_args(blk_bits, cap)
    elif mode == "lz":
        gargs = lzparse.lz_group_args(blk_bits, cap)
    else:
        gargs = encode_group_args(blk_bits, cap)
    payloads: list = []
    for g0 in range(0, blocks.shape[0], lanes):
        grp = blocks[g0:g0 + lanes]
        glen = lengths[g0:g0 + lanes]
        if mode == "rle":
            words, lens = encode_rle_group(grp, jnp.asarray(glen), **gargs)
        elif mode == "lz":
            words, lens = lzparse.encode_lz_group(grp, jnp.asarray(glen),
                                                  **gargs)
        else:
            words, lens = encode_literal_group(grp, jnp.asarray(glen),
                                               **gargs)
        lens_np = np.asarray(lens)
        nb_g = min(lanes, NB - g0)
        coder.check_lens(lens_np, gargs["cap_words"], nb_g)
        payloads += coder.unpack_group_payloads(
            coder.fetch_words_trimmed(words, lens_np[:, :, :nb_g]),
            lens_np, nb_g)
    return payloads


def encode_rle_blocks(data: bytes, blk_bits: int,
                      lanes: int = coder.ENC_LANES, cap: int = None):
    """Host-facing wrapper for the RLE-resident path: bytes -> per-block
    sqz4 payloads (bit-exact with a host coder given the same cell
    parse — asserted against the scan engine in tests)."""
    return encode_resident_blocks(data, blk_bits, "rle", lanes, cap)


# ------------------------------------- resident RLE decode (restore path)

def _row_u32_at(words, idx):
    """words [R, B], idx [B] i32 -> per-lane words[idx[b], b] as i32 (0
    past the last row)."""
    R = words.shape[0]
    got = jnp.take_along_axis(words.astype(I32),
                              jnp.clip(idx, 0, R - 1)[None, :], axis=0)[0]
    return jnp.where(idx < R, got, 0)


def _classify_cells(tokw, mrecw, sizes, C: int):
    """Pass 1: walk cells through the decoder's token-bit stream. A cell
    is a match-cell iff its first token is a match; a match must be a
    len-128 cell match at a power-of-2 dist <= 128 (periodic fill) or a
    cell-aligned dist (far zero-cell copy — content verified after
    assembly) or the stream is not cell-parsed (bad -> host fallback).
    Returns (ismatch [C,B], dist [C,B], bad [B], tcur [B]).

    tokw: [TW, B] u32 token-bit words (LSB-first, one bit per decoded
    token); mrecw: [MW, B] match records (len<<24|dist) in match order.
    """
    B = tokw.shape[1]

    def step(carry, c):
        tcur, mcur, bad = carry
        remaining = jnp.maximum(sizes.astype(I32) - c * CELL, 0)
        active = remaining > 0
        word = _row_u32_at(tokw, tcur >> 5)
        bit = (word >> (tcur & 31)) & 1
        ismatch = active & (bit == 1)
        rec = _row_u32_at(mrecw, mcur)
        dist = rec & 0xFFFFFF
        mlen = (rec >> 24) & 0xFF
        okd = (dist > 0) & (dist <= CELL) & ((dist & (dist - 1)) == 0)
        okfar = ((dist > CELL) & (dist % CELL == 0)
                 & (dist <= c * CELL))
        bad = bad | (ismatch & ((mlen != CELL) | ~(okd | okfar)
                                | (remaining < CELL)))
        tcur = tcur + jnp.where(ismatch, jnp.asarray(1, I32),
                                jnp.where(active,
                                          jnp.minimum(remaining, CELL),
                                          jnp.asarray(0, I32)))
        mcur = mcur + ismatch.astype(I32)
        return (tcur, mcur, bad), (ismatch, jnp.where(ismatch, dist, 0))

    z = jnp.zeros((B,), I32)
    (tcur, _, bad), (ism, dist) = jax.lax.scan(
        step, (z, z, jnp.zeros((B,), bool)), jnp.arange(C, dtype=I32))
    return ism, dist, bad, tcur


def _gather_cells(src, values, mask=None):
    """Gather along the cell axis: values[src[c, b], :, b] for each
    (c, b) as [C, W, B]; ``mask`` (optional [C, B] bool) zeroes
    unselected output cells."""
    C = values.shape[0]
    idx = jnp.broadcast_to(jnp.clip(src, 0, C - 1)[:, None, :],
                           (src.shape[0],) + values.shape[1:])
    got = jnp.take_along_axis(values, idx, axis=0)
    if mask is not None:
        got = jnp.where(mask[:, None, :], got, jnp.zeros_like(got))
    return got


def _preplace_literal_cells(litw, islit, C: int):
    """Pass 2: place the decoder's dense literal stream at its output
    cells. Literal cells appear in stream order, so output cell c reads
    source literal cell cumsum_excl(islit)[c] — a _gather_cells gather.
    Returns [C, B, CELL] u8 (match cells zero)."""
    LW, B = litw.shape
    by = _words_to_bytes(litw[:C * 32].reshape(C, 32, B)
                         .transpose(0, 2, 1))                # [C, B, 128]
    lit_cells = by.transpose(0, 2, 1).astype(jnp.uint8)      # [C, CELL, B]
    isl = islit.astype(I32)
    src = jnp.cumsum(isl, axis=0) - isl                       # [C, B]
    pre = _gather_cells(src, lit_cells, mask=islit)           # [C, CELL, B]
    return pre.transpose(0, 2, 1)                             # [C, B, CELL]


def _fill_cells(pre, ismatch, dist, farfill):
    """Pass 3: resolve periodic fills cell-by-cell (a match cell's bytes
    derive from the previous OUTPUT cell's tail — an inherent chain, but
    only C steps of [B, CELL] work). dist is a power of two <= CELL, so
    each candidate fill is a static tile + select; far cell-aligned
    dists (> CELL) take ``farfill`` — the pass-2 literal preplacement at
    the source cell (zeros when the source is not a literal cell, which
    covers the zero-rule copies) — then decode_rle_group VERIFIES
    out[c] == out[src] after assembly (mismatch -> host fallback)."""
    B = pre.shape[1]

    def step(prev, xs):
        pre_c, ism, d, far_c = xs
        fill = pre_c
        for dc in RLE_DISTS:
            tiled = jnp.tile(prev[:, CELL - dc:], (1, CELL // dc))
            fill = jnp.where((d == dc)[:, None], tiled, fill)
        fill = jnp.where((d > CELL)[:, None], far_c, fill)
        out = jnp.where(ism[:, None], fill, pre_c)
        return out, out

    zero = jnp.zeros((B, CELL), pre.dtype)
    _, out = jax.lax.scan(step, zero, (pre, ismatch, dist, farfill))
    return out                                                # [C, B, CELL]


@partial(jax.jit, static_argnames=("Pw", "lw", "tw", "mw", "bs"))
def decode_rle_group(buf, plens, sizes, Pw: int, lw: int, tw: int, mw: int,
                     bs: int):
    """Device-resident decode of CELL-parsed sqz4 payloads: the device
    decoder, then the three-pass device assembly. Returns ([B, bs] u8
    blocks, counts [1,8,B], bad [B] — lanes whose stream is not
    cell-parsed (host fallback) or errored)."""
    B = buf.shape[2]
    lit, tok, mrec, counts = coder.decode(
        buf[:, :Pw, :], coder.make_meta(plens, sizes), lw, tw, mw)
    C = bs // CELL
    ism, dist, bad, tcur = _classify_cells(tok[0], mrec[0], sizes, C)
    # completeness: the cell model predicts exactly ntok tokens; a stream
    # with matches NOT at cell starts consumes fewer (each covers >1
    # byte), so equality here proves every cell was classified exactly
    bad = bad | (tcur != counts[0, 2])
    c_i = jnp.arange(C, dtype=I32)
    active = (c_i[:, None] * CELL) < sizes[None, :].astype(I32)
    islit = active & ~ism
    pre = _preplace_literal_cells(lit[0], islit, C)
    isfar = ism & (dist > CELL)
    src = jnp.clip(c_i[:, None] - dist // CELL, 0, C - 1)     # [C, B]
    # far cell-aligned copies fill from the preplacement at the SOURCE
    # cell — its final bytes when the source is literal (the encoder's
    # dedup rule guarantees that), zeros otherwise (the zero-rule case:
    # pre[] of any non-literal cell is zeros by the preplace mask)
    farfill = _gather_cells(src, pre.transpose(0, 2, 1), mask=isfar)
    farfill = farfill.transpose(0, 2, 1)                      # [C, B, CELL]
    out = _fill_cells(pre, ism, dist, farfill)                # [C, B, CELL]
    # far fills ASSUMED the source assembles to exactly those bytes (true
    # for this repo's encoder); verify out[c] == out[src] exactly — by
    # induction over cell index, a passing verify implies spec-correct
    # bytes (the copy's mandated content IS the assembled source cell)
    # even for foreign streams; any mismatch decodes on the host
    out_c = out.transpose(0, 2, 1)                            # [C, CELL, B]
    got = _gather_cells(src, out_c, mask=isfar)
    mism = jnp.any(got != out_c, axis=1)                      # [C, B]
    bad = bad | jnp.any(isfar & mism, axis=0)
    blocks = out.transpose(1, 0, 2).reshape(B, bs)
    pos = jax.lax.broadcasted_iota(I32, (B, bs), 1)
    blocks = jnp.where(pos < sizes[:, None].astype(I32), blocks,
                       jnp.asarray(0, jnp.uint8))
    bad = bad | (counts[0, 4] != 0) | (counts[0, 6] != 0)
    return blocks, counts, bad


def unpack_cold_container(blob: bytes):
    """Shared restore-path scaffolding (also used by
    parallel.shard.decompress_resident_sharded): unpack + validate a
    cold sqz4 sqzt container -> (blk_bits, osize, payloads, sizes)."""
    from sqz_tpu.formats import container as sqzt
    from sqz_tpu.formats.constants import SQZT_FORMAT_SQZ4
    code, _win_bits, blk_bits, osize, payloads, _csum, fresh, _anch = \
        sqzt.unpack(blob)
    if code != SQZT_FORMAT_SQZ4 or fresh is not None:
        raise ValueError("resident decode supports cold sqz4 containers")
    bs = 1 << blk_bits
    sizes = [min(bs, osize - b * bs) for b in range(len(payloads))]
    return blk_bits, osize, payloads, sizes


def pack_payload_group(grp, gsz, Pw: int, lanes: int):
    """Shared restore-path scaffolding: payload bytes -> ([1, Pw, lanes]
    u32 big-endian words, plens, szs, oversized mask). Payloads past the
    decoder buffer get a zero lane (the device flags it; the host
    fallback decodes the real bytes)."""
    n = len(grp)
    buf = np.zeros((1, Pw, lanes), np.uint32)
    plens = np.zeros((lanes,), np.int32)
    szs = np.zeros((lanes,), np.int32)
    over = np.zeros((lanes,), bool)
    for i, p in enumerate(grp):
        if len(p) > 4 * Pw:
            over[i] = True
            continue
        wv = np.frombuffer(p.ljust(-(-len(p) // 4) * 4, b"\0"),
                           dtype=">u4")
        buf[0, :len(wv), i] = wv
        plens[i] = len(p)
    szs[:n] = gsz
    return buf, plens, szs, over


def host_decode_blocks(payloads, sizes, idx, blocks_np):
    """Shared host fallback: decode blocks ``idx`` with the native (or
    oracle) codec into the writable [n, bs] array."""
    from sqz_tpu import native
    for i in idx:
        if native.available():
            out = native.sqz4_decompress_payload(payloads[i], sizes[i])
        else:
            from sqz_tpu.oracle.sqz4 import sqz4_decode_payload
            out = sqz4_decode_payload(payloads[i], sizes[i])
        blocks_np[i, :sizes[i]] = np.frombuffer(out, np.uint8)


def decompress_resident(blob: bytes, lanes: int = coder.DEC_LANES,
                        assembly: str = "auto"):
    """Restore path: an sqzt sqz4 container -> a device-resident 1-D u8
    array. Payload bytes upload once; assembly runs on-device.

    ``assembly`` picks the on-device assembly:
      * "cell"    — the three-pass cell assembly (fastest; streams that
                    are not cell-parsed fall back to the host decoder);
      * "general" — the exact sort/scan/pointer-doubling assembly
                    (ops/lz_restore.py) that restores ANY spec-valid
                    stream — incl. compress_resident(mode="lz")
                    containers — with zero host byte assembly;
      * "auto"    — cell first, then the general assembly for lanes the
                    cell model rejects, host only for decoder-flagged
                    errors (i.e. genuinely corrupt blocks)."""
    if assembly not in ("auto", "cell", "general"):
        raise ValueError(f"unknown assembly {assembly!r}")
    blk_bits, osize, payloads, sizes = unpack_cold_container(blob)
    bs = 1 << blk_bits
    NB = len(payloads)
    if blk_bits < 7:
        # blocks smaller than a cell: the cell model is empty — decode on
        # the host (tiny blocks are host-cheap) and upload once
        out = np.zeros((NB, bs), np.uint8)
        host_decode_blocks(payloads, sizes, range(NB), out)
        return jnp.asarray(out.reshape(-1)[:osize])
    from sqz_tpu.ops import lz_restore
    dargs = dict(coder.decode_dims(blk_bits), bs=bs)
    outs = []
    for g0 in range(0, NB, lanes):
        grp = payloads[g0:g0 + lanes]
        gsz = sizes[g0:g0 + lanes]
        n = len(grp)
        buf, plens, szs, over = pack_payload_group(grp, gsz, dargs["Pw"], n)
        bufd, plensd, szsd = (jnp.asarray(buf), jnp.asarray(plens),
                              jnp.asarray(szs))
        decode = (lz_restore.decode_lz_group if assembly == "general"
                  else decode_rle_group)
        blocks, _counts, bad = decode(bufd, plensd, szsd, **dargs)
        bad_np = np.asarray(bad)[:n] | over[:n]
        if bad_np.any() and assembly == "auto":
            # not cell-parsed: the general assembly restores it on device
            # (one more decoder pass over the group; rare by construction)
            gblocks, _gc, gbad = lz_restore.decode_lz_group(
                bufd, plensd, szsd, **dargs)
            sel = jnp.asarray(bad_np & ~np.asarray(gbad)[:n])
            blocks = jnp.where(sel[:, None], gblocks[:n], blocks[:n])
            bad_np = bad_np & np.asarray(gbad)[:n]
        if bad_np.any():
            # decoder-flagged (or oversized) blocks: genuinely corrupt —
            # the host decoder raises the precise errno, or decodes the
            # rare oversized-payload block
            fixed = np.array(blocks[:n])        # writable host copy
            host_decode_blocks(grp, gsz, np.nonzero(bad_np)[0], fixed)
            blocks = jnp.asarray(fixed)
        # only the final block can be short, so flatten-and-trim is exact
        outs.append(blocks[:n].reshape(-1))
    return jnp.concatenate(outs)[:osize]


def encode_group_args(blk_bits: int, cap: int = None) -> dict:
    """Static kwargs for encode_literal_group at this block size."""
    bs = 1 << blk_bits
    if cap is None:
        cap = bs + 2048
    return dict(Tt=_token_dim(bs), Lw=_lit_word_dim(bs),
                cap_words=coder.cap_words_for(cap))


def decode_group_args(blk_bits: int, cap_words: int) -> dict:
    """Static kwargs for decode_literal_group matching an encode group."""
    dims = coder.decode_dims(blk_bits)
    return dict(dims, Pw=min(cap_words, dims["Pw"]), bs=1 << blk_bits)


def roundtrip_literal_device(blocks, lengths, blk_bits: int,
                             cap: int = None):
    """Device-resident round trip: [B, bs] u8 blocks -> encode -> decode,
    returning (payload_lens [B] i32, out_blocks [B, bs] u8, counts) as
    DEVICE arrays. Used by bench.py's device-resident row and the tests;
    nothing crosses the link between the two coders."""
    B, bs = blocks.shape
    assert bs == 1 << blk_bits
    eargs = encode_group_args(blk_bits, cap)
    words, lens = encode_literal_group(blocks, lengths, **eargs)
    dargs = decode_group_args(blk_bits, eargs["cap_words"])
    out, counts = decode_literal_group(words, lens, lengths, **dargs)
    return lens[0, 0, :], out, counts
