"""Chunked device decode (coder.decode_groups with ``lanes`` below the block
count): every chunk's download + assembly overlaps the next chunk's
decode, and the output must be identical to one dispatch of all blocks —
chunking only batches dispatches; blocks are independent (SURVEY §2.6).
130 tiny 32-byte blocks give 2 chunks at lanes=128 and 5 at lanes=32, on
the decoder's CPU target."""

from __future__ import annotations

import pytest

from sqz_tpu import native
from sqz_tpu.ops import coder
from sqz_tpu.utils.corpus import load

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime unavailable")

NB, BS = 130, 32


@pytest.fixture(params=[128, 32], ids=["lanes128", "lanes32"])
def lanes(request):
    """Chunk widths: one full chunk plus a 2-block tail, and five chunks."""
    return request.param


def test_pipelined_decode_matches_decode_groups(lanes):
    data = bytes(load("laozi.txt"))[:NB * BS]
    payloads = native.blocks_compress(data, 1, 10, 5)
    sizes = [BS] * NB
    ref = coder.decode_groups(payloads, sizes, blk_bits=5, lanes=NB)
    got = coder.decode_groups(payloads, sizes, blk_bits=5, lanes=lanes)
    assert got == ref
    assert b"".join(got) == data


def test_pipelined_decode_seeded_chunks(lanes):
    """Warm batches (one seed/dictionary for every block in the call) go
    through the same chunked path."""
    raw = bytes(load("confucius.txt"))[:(NB + 1) * BS]
    blk0 = raw[:BS]
    _, seed = native.sqz4_compress_payload(blk0, 1 << 10, lz=True,
                                           return_state=True)
    dic = blk0
    blocks = [raw[i:i + BS] for i in range(BS, len(raw), BS)]
    payloads = [native.sqz4_compress_payload(b, 1 << 10, lz=True,
                                             seed=seed, dictionary=dic)
                for b in blocks]
    sizes = [len(b) for b in blocks]
    got = coder.decode_groups(payloads, sizes, blk_bits=5, seed=seed,
                              dictionary=dic, lanes=lanes)
    assert b"".join(got) == b"".join(blocks)


def test_pipelined_decode_corrupt_block_raises(lanes):
    data = bytes(load("laozi.txt"))[:NB * BS]
    payloads = native.blocks_compress(data, 1, 10, 5)
    bad = list(payloads)
    mid = bytearray(bad[129])                  # the last block
    mid[len(mid) // 2] ^= 0x10
    bad[129] = bytes(mid)
    with pytest.raises(ValueError, match=r"\[129\]"):
        coder.decode_groups(bad, [BS] * NB, blk_bits=5, lanes=lanes)


def test_pipelined_decode_all_payloads_oversized(lanes):
    """Every payload past the decoder's stream rows (the pathological
    warm-expansion rule): the chunked path must return the host-decoded
    blocks instead of dispatching an empty chunk. Oversize is forced by
    padding valid payloads with trailing junk — the decoder stops at EOS,
    so the host decode still yields the original bytes."""
    data = bytes(load("laozi.txt"))[:4 * BS]
    blocks = [data[i:i + BS] for i in range(0, len(data), BS)]
    Pw = coder.decode_dims(5)["Pw"]
    over_pl = [native.sqz4_compress_payload(b, 1 << 10, lz=True)
               .ljust(4 * Pw + 8, b"\0") for b in blocks]
    assert all(len(p) > 4 * Pw for p in over_pl)
    got = coder.decode_groups(over_pl, [BS] * len(blocks), blk_bits=5,
                              lanes=lanes)
    assert got == blocks
