"""Bounded on-device LZ matcher (ops/lzparse.py): general content parses
INTO spec-valid sqz4 token streams entirely on the device — candidates by
value sort, extension by agreement chaining, segment-greedy parse, token
compaction by sort. Contract (FORMAT.md §3): round-trip + ratio, NOT
decision parity with the host matchers."""

import numpy as np
import pytest

import sqz_tpu
from sqz_tpu import native
from sqz_tpu.ops import lzparse, resident
from sqz_tpu.utils import corpus

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")


def _mixed(n: int) -> bytes:
    text = corpus.texty(n, seed=5)
    rng = np.random.default_rng(5)
    rnd = rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()
    return (text[:n // 2] + b"\x00" * (n // 8) + b"abcd" * (n // 16)
            + rnd)[:n]


def test_lz_resident_roundtrip_all_decoders():
    data = _mixed(6 * 512 + 123)            # tail block shorter than bs
    blob = sqz_tpu.compress_resident(data, blk_bits=9, mode="lz")
    assert sqz_tpu.decompress(blob, engine="native") == data
    assert sqz_tpu.decompress(blob, engine="oracle") == data


def test_lz_beats_literal_only_on_repetitive_content():
    data = (corpus.texty(2048, seed=1) * 3)[:4096]
    lz = resident.encode_resident_blocks(data, 10, mode="lz")
    lit = resident.encode_resident_blocks(data, 10, mode="lit")
    parts = [data[o:o + 1024] for o in range(0, len(data), 1024)]
    for b, p in enumerate(lz):
        assert native.sqz4_decompress_payload(p, len(parts[b])) == parts[b]
    assert sum(map(len, lz)) < 0.9 * sum(map(len, lit))


def test_lz_token_budget_demotes_to_literal():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    # incompressible block: every position becomes a literal-run token
    # boundary only at 255-splits, but a tiny Tt still can't hold a
    # match-heavy worst case — force it with alternating 4-grams
    blk = (b"abcdwxyz" * 64)[:512]
    arr = np.zeros((8, 512), np.uint8)
    arr[0] = np.frombuffer(blk, np.uint8)
    arr[1] = rng.integers(0, 256, 512, dtype=np.uint8)
    lens = np.full((8,), 512, np.int32)
    toks, lits, demote = lzparse.lz_plan_device(
        jnp.asarray(arr), jnp.asarray(lens), Tt=4)
    dem = np.asarray(demote)
    assert dem.any(), "tiny token budget must demote some lane"
    lit_toks = resident._tokens_from_lengths(jnp.asarray(lens), 4)[0]
    got = np.asarray(toks)[0].transpose(1, 0)
    want = np.asarray(lit_toks).transpose(1, 0)
    for i in np.nonzero(dem)[0]:
        assert np.array_equal(got[i], want[i])


def test_lz_blocks_smaller_than_segment_fall_back_to_literal():
    data = corpus.texty(700, seed=2)
    got = resident.encode_resident_blocks(data, 7, mode="lz")
    want = resident.encode_resident_blocks(data, 7, mode="lit")
    assert got == want


@pytest.mark.parametrize("seg,verify", [(512, "carry"), (512, "gather"),
                                        (256, "gather"), (0, "gather")])
def test_lz_segmented_sort_and_gather_verify_roundtrip(seg, verify):
    """Sort-shape knobs (SQZ_LZ_SORT_SEG / SQZ_LZ_VERIFY): overlapped
    segmented sorts and the slim gather-verify sort must stay exact —
    round-trip through the native decoder — and segmentation must not
    lose near matches (distance <= seg/2 guaranteed visible)."""
    import jax.numpy as jnp
    data = _mixed(8 * 1024)
    bs = 1 << 10
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    arr = np.zeros((128, bs), np.uint8)         # one encoder lane group
    arr[:len(parts)] = np.frombuffer(data, np.uint8).reshape(-1, bs)
    lanes = np.zeros((128,), np.int32)
    lanes[:len(parts)] = bs
    lens = jnp.asarray(lanes)
    gargs = lzparse.lz_group_args(10)
    gargs.update(seg=seg, verify=verify)
    words, lens_out = lzparse.encode_lz_group(jnp.asarray(arr), lens,
                                              **gargs)
    from sqz_tpu.ops import coder
    lens_np = np.asarray(lens_out)
    payloads = coder.unpack_group_payloads(
        coder.fetch_words_trimmed(words, lens_np), lens_np, len(parts))
    for b, p in enumerate(payloads):
        assert native.sqz4_decompress_payload(p, bs) == parts[b]
    if seg >= bs // 2:
        # near matches survive segmentation (distance <= seg/2 always
        # visible): ratio within 1.5 pp of the full-row sort on this
        # corpus; shorter segments trade more ratio and are covered by
        # the round-trip assertion above
        g0 = dict(gargs, seg=0, verify="carry")
        w0, l0 = lzparse.encode_lz_group(jnp.asarray(arr), lens, **g0)
        l0np = np.asarray(l0)
        full = coder.unpack_group_payloads(
            coder.fetch_words_trimmed(w0, l0np), l0np, len(parts))
        d = (sum(map(len, payloads)) - sum(map(len, full))) / len(data)
        assert d <= 0.015, f"segmented sort lost {d*100:.2f} pp"


def test_lz_matches_are_exact_on_adversarial_near_repeats():
    # near-periodic content where a sloppy (fingerprint-trusting) parse
    # would emit wrong matches: period-4 runs with single-byte edits
    base = bytearray(b"abcd" * 256)
    for i in range(13, 1024, 97):
        base[i] ^= 0x55
    data = bytes(base) * 2
    blob = sqz_tpu.compress_resident(data, blk_bits=10, mode="lz")
    assert sqz_tpu.decompress(blob, engine="native") == data


def test_lz_group_pads_unaligned_lane_counts():
    # encode_lz_group takes any lane count: direct callers need not
    # align B to anything
    import jax.numpy as jnp

    from sqz_tpu.ops import coder
    bs = 512
    B = 40                                   # not a multiple of 32
    data = _mixed(B * bs)
    arr = np.frombuffer(data, np.uint8).reshape(B, bs)
    lens = jnp.asarray(np.full((B,), bs, np.int32))
    gargs = lzparse.lz_group_args(9)
    words, lzlens = lzparse.encode_lz_group(jnp.asarray(arr), lens,
                                            **gargs)
    assert words.shape[-1] == B and lzlens.shape[-1] == B
    lnp = np.asarray(lzlens)
    payloads = coder.unpack_group_payloads(
        coder.fetch_words_trimmed(words, lnp), lnp, B)
    for b, p in enumerate(payloads):
        assert native.sqz4_decompress_payload(
            p, bs) == data[b * bs:(b + 1) * bs], f"lane {b}"
