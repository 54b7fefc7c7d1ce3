"""Device engine entry points used by sqz_tpu.api (engine="tpu"; sqzt
container required).

sqz4: match finding (tokenization) runs on the host native runtime —
block-parallel CPU work — and the serial-by-construction range coding runs
on the device through the FFI coders (ops/coder.py), on whichever platform
JAX compiles for. squeeze: adaptive-Huffman coding is pointer-chasing with
data-dependent tree restructuring, so both directions run on the threaded
native executor (PERF.md records the measured device packer it replaced).
A missing native or coder library raises an error naming the failed build.
"""

from __future__ import annotations

from typing import List, Sequence

def _pick_smaller(cold: List[bytes], warm: List[bytes], gate=None):
    """Per-block fresh/warm choice (FORMAT.md §3.1). Block 0 is always the
    cold payload (the warm pass codes it fresh too — identical bytes).
    ``gate``: warm-gate candidacy (VERDICT r2 #5) — non-candidates stay
    fresh even when a seeded payload exists (policy parity with executors
    that never coded one)."""
    out, mask = [], []
    for b, (c, w) in enumerate(zip(cold, warm)):
        fresh = (b == 0 or len(c) <= len(w)
                 or (gate is not None and not gate[b]))
        out.append(c if fresh else w)
        mask.append(fresh)
    return out, mask


def compress_blocks(parts: Sequence[bytes], fmt, win_bits: int,
                    lz: bool, warm: bool = False, blk_bits: int = None,
                    parse: str = "auto"):
    """Cold: payloads. Warm: (payloads, fresh_mask) — both a fresh and a
    seeded pass run, keeping the smaller payload per block.

    ``parse``: 'fast' approximate matcher (the 'auto' default — sqzt's
    contract is round-trip + ratio, FORMAT.md §3) or 'exact'
    reference-semantics parse; SQZ_PARSE env overrides."""
    from sqz_tpu.api import Format, _warm_dictionary
    from sqz_tpu.formats.constants import warm_gate_mask
    if blk_bits is None:
        # single source of truth for the container framing rule
        from sqz_tpu.formats.container import infer_blk_bits
        blk_bits = infer_blk_bits(parts)
    warm = warm and len(parts) > 1
    dictionary = _warm_dictionary(parts[0], win_bits) if warm else b""
    gate = warm_gate_mask(parts, dictionary) if warm else None
    no_cand = warm and not any(gate)
    if not lz:
        dictionary = b""
    from sqz_tpu import native
    from sqz_tpu.ops import coder
    native.require()
    data = b"".join(parts)
    if not all(len(p) == 1 << blk_bits for p in parts[:-1]):
        raise ValueError("every block but the last must be full")
    host_parse = coder.parse_mode(parse)
    if fmt is Format.SQZ4:
        cap = (1 << blk_bits) + 2048
        if len(parts) > coder.ENC_LANES:
            # multi-group input: planner-thread / device overlap for the
            # cold pass (ops/pipeline.py) — payloads are byte-identical
            # to the serial path for the same parse
            from sqz_tpu.ops import pipeline
            cold = pipeline.encode_data_pipelined(
                data, blk_bits, 1 << win_bits, lz, cap=cap, parse=parse)
        else:
            cold = coder.encode_data(data, blk_bits, 1 << win_bits, lz,
                                     cap=cap, parse=parse)
        if not warm:
            return cold
        if no_cand:
            return cold, [True] * len(parts)
        if sum(gate) <= len(parts) // 4:
            # few candidates (the common case, VERDICT r2 #5): host
            # threads encode just those seeded, against the seed the
            # decoder derives from the coded block 0; same parse policy
            # as the cold pass
            _blk0, seed = native.sqz4_decompress_payload(
                cold[0], len(parts[0]), return_state=True)
            warm_p = list(cold)
            for b in range(1, len(parts)):
                if gate[b]:
                    warm_p[b] = native.sqz4_compress_payload(
                        parts[b], 1 << win_bits, lz=lz, seed=seed,
                        dictionary=dictionary, parse=host_parse)
            return _pick_smaller(cold, warm_p, gate)
        warm_p = coder.encode_data(data, blk_bits, 1 << win_bits, lz,
                                   cap=cap, warm=True, parse=parse)
        return _pick_smaller(cold, warm_p, gate)
    # squeeze: the threaded native executor (warm: fresh and seeded per
    # gate candidate, the smaller kept — the native engine's policy)
    return native.blocks_compress(data, 0, win_bits, blk_bits, warm=warm,
                                  parse=host_parse)


def _warm_scatter(payloads, sizes, fresh_mask, anchor_mask, decode_batch,
                  decode_anchor, win_bits: int) -> bytes:
    """Decode a warm container's blocks as parallel batches: anchor blocks
    host-side first (their model state must be captured — v2: just block 0;
    v3: every fresh block some warm block anchors on, FORMAT.md §3.2),
    then one cold device batch for the remaining fresh blocks and one
    seeded device batch per distinct anchor."""
    from sqz_tpu.api import _warm_dictionary
    from sqz_tpu.formats.container import resolve_anchors
    anchors = resolve_anchors(fresh_mask, anchor_mask)
    needed = sorted({a for a in anchors if a is not None})
    outs = [None] * len(payloads)
    states = {}
    for a in needed:
        outs[a], seed = decode_anchor(payloads[a], sizes[a])
        states[a] = (seed, _warm_dictionary(outs[a], win_bits))
    cold_idx = [b for b in range(len(payloads))
                if fresh_mask[b] and b not in states]
    batches = [(cold_idx, None)] + [
        ([b for b, a in enumerate(anchors) if a == anc], anc)
        for anc in needed]
    for idx, anc in batches:
        if not idx:
            continue
        seed, dictionary = states[anc] if anc is not None else (None, b"")
        batch = decode_batch([payloads[b] for b in idx],
                             [sizes[b] for b in idx], seed, dictionary)
        for b, blk in zip(idx, batch):
            outs[b] = blk
    return b"".join(outs)


def decompress_blocks(payloads: Sequence[bytes], sizes: Sequence[int],
                      fmt, fresh_mask=None, win_bits: int = 15,
                      anchor_mask=None, blk_bits: int = None) -> bytes:
    """``fresh_mask`` (sqzt v2, FORMAT.md §3.1): per-block fresh/warm
    choice; None = cold container. Warm blocks decode seeded from their
    anchor (v2: block 0; v3 ``anchor_mask``: possibly a later fresh
    block, FORMAT.md §3.2), anchors decoded host-side first; each anchor
    group and the fresh set run as separate device batches.

    ``blk_bits``: the container's block size (api.decompress passes it);
    derived from the largest size otherwise — correct only while every
    non-final block is full (split_blocks guarantees that)."""
    from sqz_tpu.api import Format
    from sqz_tpu import native
    if blk_bits is None:
        blk_bits = max(max(s - 1 for s in sizes), 1).bit_length()
    warm = (fresh_mask is not None and len(payloads) > 1
            and not all(fresh_mask))
    native.require()
    if fmt is Format.SQZ4:
        from sqz_tpu.ops import coder

        def decode_batch(pls, szs, seed=None, dictionary=b""):
            if not pls:
                return []
            return coder.decode_groups(pls, list(szs), blk_bits, seed=seed,
                                       dictionary=dictionary)

        if not warm:
            return b"".join(decode_batch(list(payloads), sizes))

        def decode_anchor(pl, sz):
            return native.sqz4_decompress_payload(pl, sz, return_state=True)
        return _warm_scatter(payloads, sizes, fresh_mask, anchor_mask,
                             decode_batch, decode_anchor, win_bits)
    if anchor_mask is None:
        # v2 (or cold) containers: the threaded executor knows the block-0
        # warm schedule
        return native.blocks_decompress(
            list(payloads), sum(sizes), 0, blk_bits,
            fresh_mask=fresh_mask if warm else None, win_bits=win_bits)

    def decode_batch_nat(pls, szs, seed=None, dictionary=b""):
        return [native.squeeze_decompress_payload(
                    p, s, seed=seed, dictionary=dictionary)
                for p, s in zip(pls, szs)]

    def decode_anchor_nat(pl, sz):
        return native.squeeze_decompress_payload(pl, sz, return_state=True)
    return _warm_scatter(payloads, sizes, fresh_mask, anchor_mask,
                         decode_batch_nat, decode_anchor_nat, win_bits)
