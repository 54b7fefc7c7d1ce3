"""Public API: compress/decompress across formats, engines, and containers.

Engines:
  * ``oracle`` — scalar pure-Python (always available; slow; the ground truth)
  * ``native`` — C++ host runtime via ctypes (fast CPU path)
  * ``tpu``    — the device engine: the CUDA coders through jax.ffi on a
                 GPU (their CPU build elsewhere); requires the sqzt container

Single-block formats mirror the reference containers exactly; the ``sqzt``
container (blocks=True) is the parallel framing all engines share.
"""

from __future__ import annotations

import enum
from typing import Optional

from sqz_tpu.formats import container as sqzt
from sqz_tpu.formats.constants import (
    SQZT_FORMAT_SQUEEZE, SQZT_FORMAT_SQZ4,
)


class Format(str, enum.Enum):
    SQUEEZE = "squeeze"
    SQZ4 = "sqz4"


class Engine(str, enum.Enum):
    ORACLE = "oracle"
    NATIVE = "native"
    TPU = "tpu"


def _native():
    from sqz_tpu import native
    if not native.available():
        raise RuntimeError("native engine not built; run `make -C sqz_tpu/native`")
    return native


def compress(data: bytes, fmt: Format | str = Format.SQUEEZE,
             engine: Engine | str = Engine.NATIVE,
             win_bits: int = 15, lz: bool = True,
             blocks: bool = False, blk_bits: int = 16,
             checksum: bool = True, warm: "bool | str" = False,
             parse: str = "auto", anchor_beam: int = 4) -> bytes:
    """``warm`` (sqzt v2, FORMAT.md §3.1): blocks 1+ start from block 0's
    final rescaled model state instead of fresh models, recovering most of
    the per-block reset ratio penalty. Requires ``blocks=True``.
    ``warm="anchors"`` (sqzt v3, FORMAT.md §3.2) additionally lets each
    warm block anchor on the nearest previous fresh block instead of
    block 0 (1 recorded bit/block) and plans the fresh/anchor choices
    with a beam search of width ``anchor_beam`` (formats/anchors.py) —
    higher ratio on drifting or long-period data for ~beam× encode cost.

    ``parse`` ('auto' | 'fast' | 'exact'; sqz4, blocks=True): the sqzt
    container's contract is round-trip + ratio, so the device engine
    defaults to the bounded approximate matcher ('fast', ~20x planning
    throughput, ratio within ~0.5 pp); 'exact' restores the
    reference-semantics parse (streams byte-identical to the native
    engine). The native engine defaults to 'exact'; an explicit 'fast'
    runs its bounded matcher too (~4-5x encode throughput, incl. the warm
    double-encode and the v3 anchor planner) — for squeeze as well, where
    §1.5's exact policy only binds raw .sqz streams, not sqzt containers.
    The oracle always parses exactly. SQZ_PARSE overrides."""
    fmt, engine = Format(fmt), Engine(engine)
    if not 10 <= win_bits <= 15:
        # squeeze's header field and the sqz4 window share this range
        # (reference squeeze.h:19-20,113-115; sqzt stores win_bits verbatim)
        raise ValueError(f"win_bits {win_bits} outside 10..15")
    if warm not in (False, True, "anchors"):
        raise ValueError(f"warm must be bool or 'anchors', got {warm!r}")
    if blocks and not 1 <= blk_bits <= 40:
        # unpack() rejects anything else — never emit an undecodable blob
        raise ValueError(f"blk_bits {blk_bits} outside 1..40")
    if not blocks and parse not in (None, "auto"):
        raise ValueError("parse applies to sqzt containers (blocks=True); "
                         "raw reference streams are always exact-parse "
                         "(FORMAT.md §1.5)")
    if blocks:
        parts = sqzt.split_blocks(data, blk_bits)
        warm = warm if len(parts) > 1 else False
        anchor_mask = None
        if warm == "anchors":
            payloads, fresh_mask, anchor_mask = _compress_anchored(
                parts, fmt, engine, win_bits, lz, anchor_beam, parse)
        else:
            res = _compress_blocks(parts, fmt, engine, win_bits, lz, warm,
                                   blk_bits, parse)
            payloads, fresh_mask = res if warm else (res, None)
        code = SQZT_FORMAT_SQUEEZE if fmt is Format.SQUEEZE else SQZT_FORMAT_SQZ4
        csum = sqzt.fnv1a64(data) if checksum else None
        return sqzt.pack(code, win_bits, blk_bits, len(data), payloads, csum,
                         warm=bool(warm), fresh_mask=fresh_mask,
                         anchor_mask=anchor_mask)
    if warm:
        raise ValueError("warm start requires blocks=True (sqzt container)")
    if engine is Engine.TPU:
        raise ValueError("tpu engine requires blocks=True (sqzt container)")
    if fmt is Format.SQUEEZE:
        if engine is Engine.ORACLE:
            from sqz_tpu.oracle import squeeze_compress
            return squeeze_compress(data, win_bits)
        return _native().squeeze_compress(data, win_bits)
    else:
        if engine is Engine.ORACLE:
            from sqz_tpu.oracle import sqz4_compress
            return sqz4_compress(data, window=1 << win_bits, lz=lz)
        return _native().sqz4_compress(data, window=1 << win_bits, lz=lz)


def _warm_dictionary(block0: bytes, win_bits: int) -> bytes:
    """Shared preset history for warm blocks 1+ (FORMAT.md §3.1): the last
    min(2^win_bits, len(block 0)) bytes of block 0."""
    return block0[-(1 << win_bits):]


def _encoder_for(fmt, engine, win_bits, lz, parse="exact"):
    """Per-block payload encoder ``(part, seed, dict, want_state) ->
    payload | (payload, state)`` for the given format/engine.
    ``parse="fast"`` (sqz4 + native only) uses the bounded approximate
    matcher — spec-valid streams, sqzt-contract paths only."""
    def encode_one(p, use_seed, use_dict, want_state):
        if fmt is Format.SQUEEZE:
            if engine is Engine.ORACLE:
                from sqz_tpu.oracle.squeeze import squeeze_encode_payload
                from sqz_tpu.oracle.bitstream import BitWriter
                bw = BitWriter()
                st = squeeze_encode_payload(p, win_bits, bw, seed=use_seed,
                                            return_state=want_state,
                                            dictionary=use_dict)
                return (bw.getvalue(), st) if want_state else bw.getvalue()
            return _native().squeeze_compress_payload(
                p, win_bits, seed=use_seed, return_state=want_state,
                dictionary=use_dict, parse=parse)
        if engine is Engine.ORACLE:
            from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
            return sqz4_encode_payload(p, 1 << win_bits, lz=lz,
                                       seed=use_seed,
                                       return_state=want_state,
                                       dictionary=use_dict)
        return _native().sqz4_compress_payload(
            p, 1 << win_bits, lz=lz, seed=use_seed,
            return_state=want_state, dictionary=use_dict, parse=parse)
    return encode_one


def _host_parse(parse: str, engine) -> str:
    """Parse policy for host-engine sqzt paths (mirrors
    coder.parse_mode for the device path): 'auto' = fast on the device
    engine (its sqzt contract is round-trip + ratio), exact on native/
    oracle (cross-engine bit-identical defaults). SQZ_PARSE overrides."""
    import os
    env = os.environ.get("SQZ_PARSE")
    if env in ("fast", "exact"):
        return env
    if parse == "auto":
        return "fast" if engine is Engine.TPU else "exact"
    return parse


def _compress_anchored(parts, fmt, engine, win_bits, lz, beam,
                       parse="auto"):
    """sqzt v3 planner entry (FORMAT.md §3.2). The beam planner runs on
    a host engine; per-block payloads are engine-bit-identical (the
    cross-engine invariant), hence a device-engine caller gets
    byte-identical containers from the native fast path. ``parse``: the
    device engine
    defaults to the ~5x-cheaper bounded matcher for pricing AND payloads
    (still engine-bit-identical — both run the same native code); host
    engines default to exact.

    Beam costs are priced with a PREFIX-encode proxy (first
    SQZ_ANCHOR_PRICE_PREFIX bytes, default 4 KiB; 0 = exact full-block
    pricing): only each block's chosen variant is fully encoded, making
    the planner ~encode-speed instead of 2-3 encodes per block
    (VERDICT r3 #5; quality delta measured on the warm_anchor_lab
    corpora, tools/warm_anchor_lab.py --proxy)."""
    import os

    from sqz_tpu import native
    from sqz_tpu.formats.anchors import plan_anchored
    enc_engine = engine
    if engine is Engine.TPU:
        enc_engine = Engine.NATIVE if native.available() else Engine.ORACLE
    use_parse = _host_parse(parse, engine)
    if enc_engine is not Engine.NATIVE or (fmt is Format.SQZ4 and not lz):
        use_parse = "exact"   # the fast matcher is native-only
    encode_one = _encoder_for(fmt, enc_engine, win_bits, lz, parse=use_parse)
    pfx = int(os.environ.get("SQZ_ANCHOR_PRICE_PREFIX", str(4096)))
    price_one = None
    if pfx > 0 and max(len(p) for p in parts) > pfx:
        def price_one(p, seed, dictionary):
            return len(encode_one(p[:pfx], seed, dictionary, False))
    from sqz_tpu.formats.constants import warm_gate_mask
    return plan_anchored(parts, encode_one,
                         lambda blk: _warm_dictionary(blk, win_bits),
                         beam=beam,
                         gate_of=lambda d: warm_gate_mask(parts, d),
                         price_one=price_one)


def _compress_blocks(parts, fmt, engine, win_bits, lz, warm=False,
                     blk_bits=None, parse="auto"):
    """Cold: returns payloads. Warm: returns (payloads, fresh_mask) — per
    block the encoder codes BOTH fresh and seeded and keeps the smaller
    (FORMAT.md §3.1), so warm never loses to cold beyond the bitmap byte
    per 8 blocks."""
    if blk_bits is None:  # block size as framed by the caller's container
        blk_bits = sqzt.infer_blk_bits(parts)
    if engine is Engine.TPU:
        from sqz_tpu.ops import engine as tpu_engine
        return tpu_engine.compress_blocks(parts, fmt, win_bits, lz, warm,
                                          blk_bits=blk_bits, parse=parse)
    host_parse = _host_parse(parse, engine)
    if engine is not Engine.NATIVE or (fmt is Format.SQZ4 and not lz):
        host_parse = "exact"   # the fast matcher is native-only
    if engine is Engine.NATIVE:
        # the native threaded executor handles both the cold batch and
        # the whole warm schedule (per-block seeded/fresh pick) itself —
        # byte-identical to the per-block loop below, block-parallel on
        # many-core hosts
        code = 0 if fmt is Format.SQUEEZE else 1
        return _native().blocks_compress(b"".join(parts), code, win_bits,
                                         blk_bits, lz=lz, warm=bool(warm),
                                         parse=host_parse)
    seed = None
    dictionary = b""
    out = []
    fresh_mask = [True] + [False] * (len(parts) - 1)
    gate = [False] * len(parts)
    if warm:
        from sqz_tpu.formats.constants import warm_gate_mask
        gate = warm_gate_mask(parts, _warm_dictionary(parts[0], win_bits))

    encode_one = _encoder_for(fmt, engine, win_bits, lz, parse=host_parse)

    for i, p in enumerate(parts):
        want_state = warm and i == 0
        r = encode_one(p, None, b"", want_state)
        if want_state:
            r, seed = r
            dictionary = _warm_dictionary(p, win_bits)
        if warm and i > 0:
            if gate[i]:   # seeded pass only for gate candidates (#5)
                w = encode_one(p, seed, dictionary, False)
                if len(w) < len(r):
                    r = w
                else:
                    fresh_mask[i] = True
            else:
                fresh_mask[i] = True
        out.append(r)
    if warm:
        return out, fresh_mask
    return out


def compress_resident(data, blk_bits: int = 16, mode: str = "rle",
                      checksum: bool = False, mesh=None,
                      lanes: int = None) -> bytes:
    """Compress bytes OR a device-resident 1-D uint8 array into a
    standard ``sqzt`` container via the zero-host-planning resident path
    (ops/resident.py): literal-only reference HEAD semantics
    (src/sqz.c:591) with, in ``mode="rle"``, the device periodic cell
    parse layered on top, and in ``mode="lz"`` the device LZ parse
    (ops/lzparse.py). For device-resident data (checkpoint shards,
    activation buffers) nothing but the compressed payload bytes crosses
    the host link. The result decodes with every engine
    (``decompress`` / ``decompress_range``).

    ``checksum`` requires hashing the ORIGINAL bytes on the host — for
    device arrays that forces a full download, so it defaults off here;
    the per-block decoder validations (EILSEQ/size/bounds) still apply.

    ``mesh``: a jax.sharding.Mesh — blocks shard over it and every
    device parses + codes its own shards in parallel
    (parallel/shard.encode_resident_sharded). ``lanes``: the blocks per
    encoder call (per-device under a mesh); None = the path's default. In a multi-process mesh only process 0 receives the
    container (returns None elsewhere).
    """
    from sqz_tpu.ops import coder, resident
    resident.check_blk_bits(blk_bits)
    if mesh is not None:
        from sqz_tpu.parallel.shard import encode_resident_sharded
        payloads = encode_resident_sharded(data, blk_bits, mesh, mode,
                                           lanes or coder.ENC_LANES)
        if payloads is None:                # non-zero process of the mesh
            return None
    else:
        payloads = resident.encode_resident_blocks(
            data, blk_bits, mode, lanes=lanes or coder.ENC_LANES)
    if isinstance(data, (bytes, bytearray, memoryview)):
        raw = bytes(data)
        osize = len(raw)
    else:
        osize = int(data.size)
        raw = None
    csum = None
    if checksum:
        if raw is None:
            import numpy as _np
            raw = _np.asarray(data, dtype=_np.uint8).tobytes()
        csum = sqzt.fnv1a64(raw)
    return sqzt.pack(SQZT_FORMAT_SQZ4, 15, blk_bits, osize, payloads,
                     csum)


def decompress_resident(blob: bytes, mesh=None, lanes: int = None,
                        assembly: str = "auto"):
    """Restore path for compress_resident: decode an sqzt sqz4 container
    to a DEVICE-RESIDENT 1-D uint8 array with zero host byte assembly —
    the device decoder plus an on-device assembly
    (ops/resident.py): the three-pass cell assembly for cell-parsed
    streams (mode="lit"/"rle" containers) and the exact general assembly
    (ops/lz_restore.py — compaction sort + pointer doubling) for
    everything else, incl. ``compress_resident(mode="lz")`` containers
    and foreign spec-valid streams. ``assembly``: "auto" (cell first,
    general for the rest), "cell", or "general"; only decoder-flagged
    corrupt blocks ever reach the host decoder.

    The container checksum is NOT verified here (hashing would require
    downloading the decoded bytes); per-block decoder validations still
    apply — use decompress() for a verified host-side read.

    ``mesh``: restore with blocks sharded over the mesh instead (each
    device assembles its own shards; parallel/shard mirror)."""
    from sqz_tpu.ops import coder, resident
    if mesh is not None:
        if assembly != "auto":
            raise ValueError("a mesh restore always uses assembly='auto'")
        from sqz_tpu.parallel.shard import decompress_resident_sharded
        return decompress_resident_sharded(blob, mesh,
                                           lanes or coder.DEC_LANES)
    return resident.decompress_resident(blob, lanes=lanes or coder.DEC_LANES,
                                        assembly=assembly)


def decompress(blob: bytes, fmt: Optional[Format | str] = None,
               engine: Engine | str = Engine.NATIVE) -> bytes:
    engine = Engine(engine)
    if blob[:8] == sqzt.SQZT_MAGIC:
        code, win_bits, blk_bits, osize, payloads, csum, fresh, anch = \
            sqzt.unpack(blob)
        warm = fresh is not None
        fmt = Format.SQUEEZE if code == SQZT_FORMAT_SQUEEZE else Format.SQZ4
        sizes = _block_sizes(osize, blk_bits, len(payloads))
        if engine is Engine.TPU:
            from sqz_tpu.ops import engine as tpu_engine
            data = tpu_engine.decompress_blocks(payloads, sizes, fmt, fresh,
                                                win_bits, anchor_mask=anch,
                                                blk_bits=blk_bits)
        elif engine is Engine.NATIVE and anch is None:
            # the native threaded executor handles the cold batch and the
            # v2 (block-0 anchor) schedule itself; v3 runs the anchored
            # python schedule below
            code = 0 if fmt is Format.SQUEEZE else 1
            data = _native().blocks_decompress(list(payloads), osize, code,
                                               blk_bits,
                                               fresh_mask=fresh if warm
                                               else None,
                                               win_bits=win_bits)
        elif warm:
            data = _decompress_anchored(payloads, sizes, fmt, engine,
                                        win_bits, fresh, anch)
        else:
            data = b"".join(
                _decode_one(payload, size, fmt, engine)
                for payload, size in zip(payloads, sizes))
        if csum is not None and sqzt.fnv1a64(data) != csum:
            raise ValueError("sqzt checksum mismatch (EILSEQ)")
        return data
    # single-block reference containers
    if engine is Engine.TPU:
        # mirror compress(): the tpu engine operates on sqzt containers;
        # silently substituting native here would misreport the engine
        raise ValueError("tpu engine requires an sqzt container")
    if fmt is None:
        fmt = Format.SQZ4 if blob[:8] == b"squeeze4" else Format.SQUEEZE
    fmt = Format(fmt)
    if fmt is Format.SQUEEZE:
        if engine is Engine.ORACLE:
            from sqz_tpu.oracle import squeeze_decompress
            return squeeze_decompress(blob)
        return _native().squeeze_decompress(blob)
    else:
        if engine is Engine.ORACLE:
            from sqz_tpu.oracle import sqz4_decompress
            return sqz4_decompress(blob)
        return _native().sqz4_decompress(blob)


def decompress_range(blob: bytes, start: int, length: int,
                     engine: Engine | str = Engine.NATIVE) -> bytes:
    """Random-access decode of ``[start, start+length)`` from an ``sqzt``
    container — the checkpoint/resume hook the per-block length table
    enables (FORMAT.md §3): only the covering blocks are decoded (plus
    block 0 once for warm containers, which re-derives the shared seed).

    The container checksum covers the whole payload and is NOT verified
    here (the full data is never materialized); use decompress() for
    verified full reads. Warm-specific caveat: for warm containers the
    seed/dictionary are derived from block 0, so an undetected corruption
    of block 0's payload can silently change the bytes returned for warm
    blocks in range (a corrupt payload usually fails the decoder's EILSEQ
    validations, but not always) — integrity-sensitive readers should
    verify the container once with decompress() first.
    """
    engine = Engine(engine)
    if engine is Engine.TPU:
        raise ValueError("decompress_range is a host feature; "
                         "use engine='native' or 'oracle'")
    if blob[:8] != sqzt.SQZT_MAGIC:
        raise ValueError("decompress_range requires an sqzt container")
    code, win_bits, blk_bits, osize, payloads, _csum, fresh, anch = \
        sqzt.unpack(blob)
    warm = fresh is not None
    fmt = Format.SQUEEZE if code == SQZT_FORMAT_SQUEEZE else Format.SQZ4
    if start < 0 or length < 0 or start + length > osize:
        raise ValueError(f"range [{start}, {start + length}) outside "
                         f"[0, {osize})")
    if length == 0:
        return b""
    sizes = _block_sizes(osize, blk_bits, len(payloads))
    b_lo = start >> blk_bits
    b_hi = (start + length - 1) >> blk_bits
    anchors = sqzt.resolve_anchors(fresh, anch) if warm \
        else [None] * len(payloads)
    # anchors whose state a covering warm block needs (v2: always block 0)
    needed = {anchors[b] for b in range(b_lo, b_hi + 1)
              if anchors[b] is not None}
    states = {}
    decoded = {}
    for a in sorted(needed):
        blk, seed = _decode_one(payloads[a], sizes[a], fmt, engine,
                                return_state=True)
        decoded[a] = blk
        states[a] = (seed, _warm_dictionary(blk, win_bits))
    out = bytearray()
    for b in range(b_lo, b_hi + 1):
        if b in decoded:
            out += decoded[b]
        elif anchors[b] is not None:
            seed, dictionary = states[anchors[b]]
            out += _decode_one(payloads[b], sizes[b], fmt, engine,
                               seed=seed, dictionary=dictionary)
        else:
            out += _decode_one(payloads[b], sizes[b], fmt, engine)
    off = start - (b_lo << blk_bits)
    return bytes(out[off:off + length])


def _decompress_anchored(payloads, sizes, fmt, engine, win_bits,
                         fresh, anch) -> bytes:
    """Warm-container decode, v2 and v3 alike (FORMAT.md §3.1-3.2): fresh
    blocks decode cold first (capturing seed/dict state of every block
    used as an anchor), then warm blocks decode off their anchors. Both
    passes are block-parallel for a parallel executor; this host reference
    schedule runs them serially."""
    anchors = sqzt.resolve_anchors(fresh, anch)
    needed = {a for a in anchors if a is not None}
    outs = [None] * len(payloads)
    states = {}
    for b in range(len(payloads)):                 # pass 1: fresh blocks
        if fresh[b]:
            if b in needed:
                outs[b], seed = _decode_one(payloads[b], sizes[b], fmt,
                                            engine, return_state=True)
                states[b] = (seed, _warm_dictionary(outs[b], win_bits))
            else:
                outs[b] = _decode_one(payloads[b], sizes[b], fmt, engine)
    for b, a in enumerate(anchors):                # pass 2: warm blocks
        if a is not None:
            seed, dictionary = states[a]
            outs[b] = _decode_one(payloads[b], sizes[b], fmt, engine,
                                  seed=seed, dictionary=dictionary)
    return b"".join(outs)


def _block_sizes(osize: int, blk_bits: int, nblocks: int):
    bs = 1 << blk_bits
    sizes = []
    remaining = osize
    for _ in range(nblocks):
        sizes.append(min(bs, remaining))
        remaining -= sizes[-1]
    return sizes


def _decode_one(payload: bytes, size: int, fmt: Format, engine: Engine,
                seed=None, return_state: bool = False,
                dictionary: bytes = b""):
    if fmt is Format.SQUEEZE:
        if engine is Engine.ORACLE:
            from sqz_tpu.oracle.bitstream import BitReader
            from sqz_tpu.oracle.squeeze import squeeze_decode_payload
            return squeeze_decode_payload(BitReader(payload), size,
                                          seed=seed,
                                          return_state=return_state,
                                          dictionary=dictionary)
        return _native().squeeze_decompress_payload(
            payload, size, seed=seed, return_state=return_state,
            dictionary=dictionary)
    else:
        if engine is Engine.ORACLE:
            from sqz_tpu.oracle.sqz4 import sqz4_decode_payload
            return sqz4_decode_payload(payload, size, seed=seed,
                                       return_state=return_state,
                                       dictionary=dictionary)
        return _native().sqz4_decompress_payload(
            payload, size, seed=seed, return_state=return_state,
            dictionary=dictionary)
