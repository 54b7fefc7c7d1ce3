"""The device sqz4 coders (ops/coder.py) on the CPU target: the same coder
source (native/sqz4_coder.h) the CUDA kernels compile, built with the host
compiler and registered for XLA's CPU backend. Payloads must be
byte-identical to the native and oracle codecs for the same parse, and the
decoder must reject exactly what the native decoder rejects.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sqz_tpu import native
from sqz_tpu.ops import coder
from sqz_tpu.oracle.sqz4 import sqz4_decode_payload, sqz4_encode_payload
from sqz_tpu.utils.corpus import load, random_bytes


def _mixed(n: int, seed: int = 0) -> bytes:
    """Text, zero runs, periodic and incompressible bytes."""
    part = max(n // 4, 1)
    data = (load("laozi.txt")[:part] + b"\0" * part
            + (b"abcd" * part)[:part] + random_bytes(part, seed=seed))
    return data[:n]


def _blocks(data: bytes, blk_bits: int):
    bs = 1 << blk_bits
    return [data[o:o + bs] for o in range(0, len(data), bs)] or [b""]


@pytest.mark.parametrize("blk_bits,lz,parse", [
    (8, False, "exact"), (8, True, "exact"), (12, True, "fast"),
    (12, True, "exact"), (16, True, "fast"), (16, False, "fast")])
def test_encoder_matches_native(blk_bits, lz, parse):
    data = _mixed(3 * (1 << blk_bits) + 77, seed=blk_bits)
    got = coder.encode_data(data, blk_bits, 1 << 15, lz,
                            cap=(1 << blk_bits) + 2048, parse=parse)
    want = [native.sqz4_compress_payload(p, 1 << 15, lz=lz, parse=parse)
            for p in _blocks(data, blk_bits)]
    assert got == want


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 97), (2, 200)])
def test_encoder_matches_oracle(seed, n):
    rng = np.random.default_rng(seed)
    # low-entropy bytes so the renorm/underflow paths all fire
    data = bytes(rng.integers(0, 4, size=n, dtype=np.uint8))
    for lz in (False, True):
        got = coder.encode_data(data, 8, 1 << 10, lz, cap=2 * n + 2048,
                                parse="exact")
        want = [sqz4_encode_payload(p, 1 << 10, lz=lz)
                for p in _blocks(data, 8)]
        assert got == want


def test_encoder_and_decoder_roundtrip():
    rng = np.random.default_rng(7)
    datas = [
        bytes(rng.integers(0, 4, 60, np.uint8)),
        b"abcabcabcabcXYZ" * 4,                   # overlapped matches
        b"\0" * 150,                              # RLE
        bytes(rng.integers(0, 256, 90, np.uint8)),  # high entropy
    ]
    wants = [sqz4_encode_payload(d, 1 << 10, lz=True) for d in datas]
    payloads = [coder.encode_data(d, 8, 1 << 10, True, cap=512,
                                  parse="exact")[0] for d in datas]
    assert payloads == wants
    outs = coder.decode_groups(payloads, [len(d) for d in datas], 8)
    assert outs == list(datas)


def test_blk_bits_17_is_exact():
    """Model totals pass 2^17 in a 128 KiB block: the integer coder has
    no divider range, so payloads stay identical to native."""
    data = _mixed(1 << 17, seed=5) + b"\x07" * 4000
    got = coder.encode_data(data, 17, 1 << 15, True, cap=(1 << 17) + 2048,
                            parse="fast")
    want = [native.sqz4_compress_payload(p, 1 << 15, lz=True, parse="fast")
            for p in _blocks(data, 17)]
    assert got == want
    sizes = [len(p) for p in _blocks(data, 17)]
    assert b"".join(coder.decode_groups(got, sizes, 17)) == data


def test_exact_parse_matches_native_executor():
    data = load("laozi.txt")[:1024]
    ref = native.blocks_compress(data, 1, 10, 9)    # 2 blocks of 512
    got = coder.encode_data(data, 9, 1 << 10, True, cap=512 + 2048,
                            parse="exact")
    assert got == ref


def test_fast_parse_streams_decode_everywhere():
    """parse='fast' (bounded matcher) emits different tokens but
    spec-valid sqz4 streams: the native decoder and the device decoder
    must both reproduce the data, and the size must stay close to the
    exact parse (the sqzt contract is round-trip + ratio)."""
    data = load("confucius.txt")[:2048]
    fast = coder.encode_data(data, 9, 1 << 10, True, cap=512 + 2048,
                             parse="fast")
    exact = coder.encode_data(data, 9, 1 << 10, True, cap=512 + 2048,
                              parse="exact")
    sizes = [512, 512, 512, 512]
    got = b"".join(native.sqz4_decompress_payload(p, s)
                   for p, s in zip(fast, sizes))
    assert got == data
    outs = coder.decode_groups(fast, sizes, 9)
    assert b"".join(outs) == data
    # bounded search may lose a little ratio, never more than ~1.5 pp here
    assert sum(map(len, fast)) <= sum(map(len, exact)) + len(data) * 15 // 1000


@pytest.mark.parametrize("lanes", [1, 3, 4096])
def test_decoder_matches_oracle_streams(lanes):
    """Oracle-coded payloads decode through the device decoder, in
    dispatch chunks of any lane count."""
    data = (b"a rose is a rose is a rose\x00\x01" * 12)[:256]
    payloads = [sqz4_encode_payload(data, 1 << 10, lz=True),
                sqz4_encode_payload(data[::-1], 1 << 10, lz=True),
                sqz4_encode_payload(data[:100], 1 << 10, lz=False)]
    outs = coder.decode_groups(payloads, [256, 256, 100], 8, lanes=lanes)
    assert outs == [data, data[::-1], data[:100]]


def test_decoder_record_streams():
    """The raw decoder contract: literal words, token bits, match
    records len << 24 | dist and the counts rows, reassembled by the
    numpy reference."""
    rng = np.random.default_rng(9)
    datas = [b"tea for two and two for tea " * 8,
             bytes(rng.integers(0, 256, 120, np.uint8))]
    payloads = [sqz4_encode_payload(d, 1 << 10, lz=True) for d in datas]
    sizes = [len(d) for d in datas]
    buf, meta = coder.pack_decode_chunk(payloads, sizes, 96)
    lit, tok, mrec, counts = map(np.asarray, coder.decode(
        jnp.asarray(buf), meta, lw=96, tw=32, mw=64))
    for b, d in enumerate(datas):
        assert counts[0, 4, b] == 0, f"block {b} error {counts[0, 4, b]}"
        assert counts[0, 0, b] == len(d)
        assert counts[0, 5, b] >= len(payloads[b])
        got = coder.assemble_tokens_numpy(
            tok[0, :, b], lit[0, :, b].astype(">u4").tobytes(),
            mrec[0, :, b], int(counts[0, 2, b]), len(d))
        assert got == d, f"block {b} mismatch"


def test_decoder_overflow_lanes_fall_back():
    """A lane with more matches than its record rows raises the overflow
    flag and decodes on the host."""
    data = b"ab" * 200
    payload = sqz4_encode_payload(data, 1 << 10, lz=True)
    buf, meta = coder.pack_decode_chunk([payload], [len(data)], 64)
    res = coder.decode(jnp.asarray(buf), meta, lw=4, tw=1, mw=1)
    counts = np.asarray(res[3])
    assert counts[0, 6, 0] == 1 and counts[0, 4, 0] == 0
    lt, tt, mt, cnt = coder.fetch_decode_host(res)
    assert coder.postprocess_decode(lt, tt, mt, cnt, [payload], [len(data)],
                                    1 << 9) == [data]


def test_decoder_rejects_corrupt():
    data = b"refrain refrain refrain!" * 4
    payload = sqz4_encode_payload(data, 1 << 10, lz=True)
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        coder.decode_groups([bytes(bad)], [len(data)], 8)


def test_corrupt_mutants_agree_with_native():
    """Seeded corrupt mutants: the device decoder produces exactly what
    the native decoder produces, or rejects exactly when it rejects."""
    rng = np.random.default_rng(21)
    data = _mixed(1 << 10, seed=2)
    clean = native.sqz4_compress_payload(data, 1 << 10, lz=True)
    mutants = []
    for _ in range(60):
        m = bytearray(clean)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
        if rng.random() < 0.2:
            m = m[:int(rng.integers(1, len(m)))]
        mutants.append(bytes(m))
    buf, meta = coder.pack_decode_chunk(mutants, [len(data)] * len(mutants),
                                        coder.decode_dims(10)["Pw"])
    dims = coder.decode_dims(10)
    res = coder.decode(jnp.asarray(buf), meta, dims["lw"], dims["tw"],
                       dims["mw"])
    lt, tt, mt, cnt = coder.fetch_decode_host(res)
    rejected = 0
    for i, m in enumerate(mutants):
        try:
            want = native.sqz4_decompress_payload(m, len(data))
            want = want if len(want) == len(data) else None
        except OSError:
            want = None
        try:
            got = coder.postprocess_decode(
                lt[:, i:i + 1], tt[:, i:i + 1], mt[:, i:i + 1],
                cnt[:, :, i:i + 1], [m], [len(data)], 1 << 10)[0]
        except ValueError:
            got = None
        assert got == want, f"mutant {i}"
        rejected += want is None
    assert rejected > 0


def test_seeded_lanes_match_native():
    """Per-lane seeding (sqzt v2 warm start): lanes flagged seeded start
    from the seed; block 0 stays fresh; all equal the native coder."""
    data = _mixed(4 * 512, seed=8)
    got = coder.encode_data(data, 9, 1 << 10, True, cap=512 + 2048,
                            warm=True, parse="exact")
    _blk0, seed = native.sqz4_decompress_payload(got[0], 512,
                                                 return_state=True)
    dictionary = data[:512][-(1 << 10):]
    want = [native.sqz4_compress_payload(data[:512], 1 << 10)]
    want += [native.sqz4_compress_payload(p, 1 << 10, seed=seed,
                                          dictionary=dictionary)
             for p in _blocks(data, 9)[1:]]
    assert got == want
    outs = coder.decode_groups(got[1:], [512] * 3, 9, seed=seed,
                               dictionary=dictionary)
    assert b"".join(outs) == data[512:]


def test_lit_skip_reads_the_raw_block():
    """lit_skip: with the raw block as the literal stream, matches move
    the literal cursor past their bytes — same payload as the compacted
    literal stream."""
    data = _mixed(1 << 10, seed=4)
    toks, lits, counts, _mx, _seed = coder.plan_tokens(
        data, 10, 1 << 10, True, "exact")
    cap_words = coder.cap_words_for((1 << 10) + 2048)
    tdev = coder.stage_tokens(jnp.asarray(toks))
    packed = coder.encode(tdev, coder.pack_words(jnp.asarray(lits)[None]),
                          cap_words)
    raw = np.frombuffer(data, np.uint8)[None]
    skipped = coder.encode(tdev, coder.pack_words(jnp.asarray(raw)[None]),
                           cap_words, lit_skip=True)
    a = coder.unpack_group_payloads(*map(np.asarray, (packed[0],)),
                                    np.asarray(packed[1]), 1)
    b = coder.unpack_group_payloads(np.asarray(skipped[0]),
                                    np.asarray(skipped[1]), 1)
    assert a == b == [native.sqz4_compress_payload(data, 1 << 10)]


@pytest.mark.parametrize("nb,lanes", [(1, 4096), (3, 2), (37, 8)])
def test_group_padding_for_odd_block_counts(nb, lanes):
    """Block counts that do not fill the last group, a short last block,
    and lanes without a block (token 0: nothing coded)."""
    data = _mixed(nb * 256 - 13, seed=nb)
    got = coder.encode_data(data, 8, 1 << 10, True, cap=256 + 2048,
                            lanes=lanes, parse="fast")
    want = [native.sqz4_compress_payload(p, 1 << 10, parse="fast")
            for p in _blocks(data, 8)]
    assert got == want
    toks = jnp.zeros((1, 4, 3), jnp.uint32)       # three empty lanes
    words, lens = coder.encode(toks, jnp.zeros((1, 1, 3), jnp.uint32), 8)
    assert np.asarray(lens).tolist() == [[[0, 0, 0]]]


def test_encoder_rejects_overflowing_capacity():
    data = random_bytes(300, seed=1)
    with pytest.raises(ValueError, match="capacity"):
        coder.encode_data(data, 9, 1 << 10, False, cap=100, parse="fast")


def test_pipelined_encode_matches_serial():
    """The pipelined engine (planner thread + per-group async dispatch,
    ops/pipeline.py) must emit the same payloads as the serial path for
    the same parse mode — grouping only batches dispatches."""
    from sqz_tpu.ops.pipeline import encode_data_pipelined
    data = load("laozi.txt")[:2560]          # 10 blocks of 256
    for parse in ("exact", "fast"):
        serial = coder.encode_data(data, 8, 1 << 10, True, cap=256 + 2048,
                                   parse=parse)
        piped = encode_data_pipelined(data, 8, 1 << 10, True,
                                      cap=256 + 2048, lanes=3, parse=parse)
        assert piped == serial


def test_missing_library_names_the_build(monkeypatch, tmp_path):
    """A coder library that cannot be built raises an error naming the
    build instead of falling back to another engine."""
    monkeypatch.setattr(coder, "_NATIVE", tmp_path)
    (tmp_path / "Makefile").write_text("x:\n\tfalse\n")
    with pytest.raises(RuntimeError, match="libsqz4ffi"):
        coder._build("libsqz4ffi.so", "libsqz4ffi.so", ("sqz4_ffi.cc",))


def test_squeeze_engine_matches_native():
    """engine='tpu' squeeze payloads come from the threaded native
    executor (the device bit packer was removed, PERF.md)."""
    import sqz_tpu
    rng = np.random.default_rng(11)
    data = (b"she sells sea shells by the sea shore " * 20
            + bytes(rng.integers(0, 256, 700, np.uint8)))
    for parse in ("exact", "fast"):
        blob = sqz_tpu.compress(data, fmt="squeeze", engine="tpu",
                                win_bits=10, blocks=True, blk_bits=10,
                                parse=parse)
        ref = sqz_tpu.compress(data, fmt="squeeze", engine="native",
                               win_bits=10, blocks=True, blk_bits=10,
                               parse=parse)
        assert blob == ref
        assert sqz_tpu.decompress(blob, engine="tpu") == data
