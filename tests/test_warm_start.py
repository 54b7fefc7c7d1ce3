"""sqzt v2 warm start (FORMAT.md §3.1): model/tree seeding + shared
dictionary across engines.

Warm containers must (a) round-trip on every engine, (b) be byte-identical
between oracle and native, (c) recover the per-block reset penalty —
measured ≤0.5% of the whole-file stream size on the reference corpus —
and (d) reject tampering like any other container.
"""

import numpy as np
import pytest

import sqz_tpu
from sqz_tpu import native
from sqz_tpu.formats import container
from sqz_tpu.utils.corpus import load as corpus_file

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime unavailable")


def _load(name: str, limit=None) -> bytes:
    data = corpus_file(name)
    return data[:limit] if limit else data


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_warm_roundtrip_cross_engine(fmt):
    data = _load("laozi.txt")
    blobs = {}
    for eng in ("oracle", "native"):
        blob = sqz_tpu.compress(data, fmt=fmt, engine=eng, win_bits=12,
                                blocks=True, blk_bits=12, warm=True)
        blobs[eng] = blob
        for dec in ("oracle", "native"):
            assert sqz_tpu.decompress(blob, engine=dec) == data, (eng, dec)
    assert blobs["oracle"] == blobs["native"]
    # the warm flag is set and survives unpack
    *_, warm, _am = container.unpack(blobs["native"])
    assert warm


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_warm_improves_ratio(fmt):
    data = _load("confucius.txt")
    cold = sqz_tpu.compress(data, fmt=fmt, engine="native", win_bits=15,
                            blocks=True, blk_bits=14)
    warm = sqz_tpu.compress(data, fmt=fmt, engine="native", win_bits=15,
                            blocks=True, blk_bits=14, warm=True)
    assert len(warm) < len(cold)


def test_warm_delta_vs_whole_file_sqz4():
    """VERDICT r1 target: warm block container within 0.5% of the
    whole-file reference-format stream (64 KiB blocks, win 15)."""
    data = _load("confucius.txt")
    whole = native.sqz4_compress_payload(data, 1 << 15)
    warm = sqz_tpu.compress(data, fmt="sqz4", engine="native", win_bits=15,
                            blocks=True, blk_bits=16, warm=True,
                            checksum=False)
    _, _, _, _, payloads, _, _, _ = container.unpack(warm)
    body = sum(len(p) for p in payloads)
    assert body <= len(whole) * 1.005, (body, len(whole))


def test_warm_single_block_degenerates_to_cold():
    data = _load("laozi.txt", 4096)
    cold = sqz_tpu.compress(data, fmt="sqz4", engine="native", win_bits=12,
                            blocks=True, blk_bits=13)
    warm = sqz_tpu.compress(data, fmt="sqz4", engine="native", win_bits=12,
                            blocks=True, blk_bits=13, warm=True)
    assert cold == warm  # one block: flag cleared, stream identical


def test_warm_requires_blocks():
    with pytest.raises(ValueError):
        sqz_tpu.compress(b"abc", fmt="sqz4", warm=True)


def test_warm_seed_rescale_matches_oracle():
    """Native seed capture (incl. the 2^14 rescale) == oracle capture."""
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
    data = _load("confucius.txt", 32768)
    _, seed_o = sqz4_encode_payload(data, 1 << 15, return_state=True)
    _, seed_n = native.sqz4_compress_payload(data, 1 << 15,
                                             return_state=True)
    assert seed_o.flat == seed_n.flat
    # every model's total respects the cap
    f = seed_o.flat
    for lo, hi in ((0, 2), (2, 258), (258, 514), (514, 546)):
        assert sum(f[lo:hi]) <= 1 << 14
    for b in range(32):
        assert f[546 + b] + f[578 + b] <= 1 << 14


def test_warm_dictionary_reach():
    """A warm block that is a verbatim copy of block 0 must compress to
    almost nothing (one max-window match chain into the dictionary)."""
    blk = _load("laozi.txt", 4096)
    data = blk + blk  # block 1 == block 0 at blk_bits 12, dist 4096 < 2^13
    warm = sqz_tpu.compress(data, fmt="sqz4", engine="native", win_bits=13,
                            blocks=True, blk_bits=12, warm=True,
                            checksum=False)
    _, _, _, _, payloads, _, _, _ = container.unpack(warm)
    assert len(payloads) == 2
    assert len(payloads[1]) < len(blk) // 50  # pure dictionary matches
    assert sqz_tpu.decompress(warm, engine="oracle") == data


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_warm_tpu_engine_matches_native(fmt):
    """The device engine (its coders' CPU target here) must emit
    byte-identical warm containers for the same parse and decode them."""
    data = _load("laozi.txt", 12288)
    warm_n = sqz_tpu.compress(data, fmt=fmt, engine="native", win_bits=11,
                              blocks=True, blk_bits=11, warm=True,
                              parse="exact")
    warm_t = sqz_tpu.compress(data, fmt=fmt, engine="tpu", win_bits=11,
                              blocks=True, blk_bits=11, warm=True,
                              parse="exact")
    assert warm_t == warm_n
    assert sqz_tpu.decompress(warm_t, engine="tpu") == data


def test_warm_pallas_kernels_interpret():
    """The device coders' seeded lanes (CPU target): the all-seeded
    encode pass matches per-block seeded native encodes; decode reproduces
    the data via the shared dictionary."""
    from sqz_tpu.api import _warm_dictionary
    from sqz_tpu.ops import coder
    data = _load("laozi.txt", 3072)
    got = coder.encode_data(data, 10, 1 << 10, True, cap=(1 << 10) + 2048,
                            lanes=2, warm=True, parse="exact")
    blk0, seed = native.sqz4_decompress_payload(got[0], 1024,
                                                return_state=True)
    assert blk0 == data[:1024]
    dictionary = _warm_dictionary(blk0, 10)
    for b in (1, 2):
        want = native.sqz4_compress_payload(
            data[b * 1024:(b + 1) * 1024], 1 << 10, seed=seed,
            dictionary=dictionary)
        assert got[b] == want, f"block {b} seeded encode mismatch"
    outs = coder.decode_groups(got[1:], [1024, 1024], 10,
                            seed=seed, dictionary=dictionary)
    assert blk0 + b"".join(outs) == data


def test_warm_per_block_choice_never_loses():
    """Mixed content (text block 0, incompressible block 1): the seeded
    coding would expand block 1, so the fresh bitmap must mark it fresh
    and the warm container must cost at most the bitmap byte."""
    rng = np.random.default_rng(11)
    mix = _load("laozi.txt", 4096) + rng.integers(
        0, 256, 4096).astype(np.uint8).tobytes()
    cold = sqz_tpu.compress(mix, fmt="sqz4", engine="native", win_bits=12,
                            blocks=True, blk_bits=12)
    warm = sqz_tpu.compress(mix, fmt="sqz4", engine="native", win_bits=12,
                            blocks=True, blk_bits=12, warm=True)
    *_, fresh, _am = container.unpack(warm)
    assert fresh == [True, True]          # seeded coding lost -> fresh kept
    assert len(warm) <= len(cold) + 1     # bitmap byte only
    assert sqz_tpu.decompress(warm) == mix
    # homogeneous data: warm blocks must actually be chosen
    text = _load("confucius.txt", 16384)
    wt = sqz_tpu.compress(text, fmt="sqz4", engine="native", win_bits=12,
                          blocks=True, blk_bits=12, warm=True)
    *_, fresh_t, _am2 = container.unpack(wt)
    assert not all(fresh_t[1:])


def test_warm_corrupt_block0_detected():
    """Corrupting block 0 corrupts the derived seed; the checksum (or a
    decode error) must catch it — never a silent wrong result."""
    data = _load("confucius.txt", 40960)
    warm = sqz_tpu.compress(data, fmt="sqz4", engine="native", win_bits=12,
                            blocks=True, blk_bits=13, warm=True)
    bad = bytearray(warm)
    bad[len(bad) - 100] ^= 0x10  # inside block payloads
    with pytest.raises(Exception):
        out = sqz_tpu.decompress(bytes(bad), engine="native")
        assert out != data


def test_warm_gate_python_native_agree():
    """The warm gate (VERDICT r2 #5) is policy: the C++ executor's bitset
    must agree with formats/constants.warm_gate_mask on every block, so
    containers stay identical across engines. Verified indirectly: the
    gated native executor's fresh bitmap must equal the python loop's."""
    import sqz_tpu
    from sqz_tpu.formats import container
    from sqz_tpu.formats.constants import warm_gate_mask
    from sqz_tpu.utils.corpus import load, random_bytes
    # mixed content: text blocks (gated: shared grams) + random (ungated)
    data = (load("confucius.txt")[:8192] + random_bytes(4096, seed=9)
            + load("confucius.txt")[8192:12288] + b"\x07" * 1000)
    for fmt in ("sqz4", "squeeze"):
        nat = sqz_tpu.compress(data, fmt=fmt, engine="native", win_bits=11,
                               blocks=True, blk_bits=12, warm=True)
        orc = sqz_tpu.compress(data, fmt=fmt, engine="oracle", win_bits=11,
                               blocks=True, blk_bits=12, warm=True)
        assert nat == orc, fmt
        assert sqz_tpu.decompress(nat, engine="native") == data
    # the gate sees through: random middle block must not be a candidate
    parts = [data[o:o + 4096] for o in range(0, len(data), 4096)]
    gate = warm_gate_mask(parts, parts[0][-(1 << 11):])
    assert gate[0] is False and gate[-1] is True   # tail always candidate
    assert gate[2] is False                        # random block skipped


def test_warm_gate_skips_unrelated_content():
    """A warm container over content unrelated to block 0 must cost at
    most the cold wall (no seeded passes) and decode fine."""
    import sqz_tpu
    from sqz_tpu.formats import container
    from sqz_tpu.utils.corpus import random_bytes
    data = random_bytes(16384, seed=13)
    blob = sqz_tpu.compress(data, fmt="sqz4", engine="native", win_bits=11,
                            blocks=True, blk_bits=12, warm=True)
    _, _, _, _, _, _, fresh, _ = container.unpack(blob)
    assert fresh is None or all(fresh[:-1])   # only the tail may be warm
    assert sqz_tpu.decompress(blob, engine="native") == data
