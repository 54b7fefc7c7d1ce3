"""Structured decoder fuzzing with cross-engine agreement (FORMAT.md §4).

Thousands of seeded mutations — bit flips, byte substitutions, truncations,
extensions, splices, forged container length tables — against both formats.
The policy under test: every engine must agree on every corrupt stream —
either all reject, or all produce identical bytes. Divergent acceptance
between the scalar oracle, the native runtime, and the device formulations
(e.g. via the device's f32-estimate division) is exactly the bug class this
hunts; the decoders' validation points mirror the reference
(src/sqz.c:811-834, squeeze.h:449-451).
"""

from __future__ import annotations

import numpy as np
import pytest

import sqz_tpu
from sqz_tpu import native
from sqz_tpu.oracle.bitstream import BitReader
from sqz_tpu.oracle.squeeze import squeeze_decode_payload
from sqz_tpu.oracle.sqz4 import sqz4_decode_payload
from sqz_tpu.utils.corpus import load

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime unavailable")

DATA = load("laozi.txt")[:2048]
SIZE = len(DATA)


def _decode(fmt: str, engine: str, payload: bytes):
    """Returns ('ok', bytes) or ('err', None) — never raises."""
    try:
        if fmt == "sqz4":
            if engine == "oracle":
                out = sqz4_decode_payload(payload, SIZE)
            elif engine == "native":
                out = native.sqz4_decompress_payload(payload, SIZE)
            else:
                from sqz_tpu.ops import sqz4_jax
                out = sqz4_jax.decode_blocks([payload], [SIZE], 11)[0]
        else:
            if engine == "oracle":
                out = squeeze_decode_payload(BitReader(payload), SIZE)
            elif engine == "native":
                out = native.squeeze_decompress_payload(payload, SIZE)
            else:
                from sqz_tpu.ops import squeeze_jax
                out = squeeze_jax.decode_blocks([payload], [SIZE], 11)[0]
        return ("ok", out)
    except Exception:
        return ("err", None)


def _mutants(payload: bytes, rng: np.random.Generator, n: int):
    """Seeded structured mutations of one payload."""
    p = np.frombuffer(payload, dtype=np.uint8).copy()
    for _ in range(n):
        kind = rng.integers(0, 5)
        m = p.copy()
        if kind == 0:      # single bit flip
            i = int(rng.integers(0, len(m)))
            m[i] ^= np.uint8(1 << int(rng.integers(0, 8)))
        elif kind == 1:    # byte substitution burst
            i = int(rng.integers(0, len(m)))
            w = int(rng.integers(1, 5))
            m[i:i + w] = rng.integers(0, 256, size=len(m[i:i + w]))
        elif kind == 2:    # truncation
            m = m[:int(rng.integers(0, len(m)))]
        elif kind == 3:    # extension with junk
            m = np.concatenate(
                [m, rng.integers(0, 256, size=int(rng.integers(1, 64)),
                                 dtype=np.uint8).astype(np.uint8)])
        else:              # splice: move a chunk elsewhere
            if len(m) > 16:
                a = int(rng.integers(0, len(m) - 8))
                b = int(rng.integers(0, len(m) - 8))
                w = int(rng.integers(4, 9))
                m[a:a + w] = p[b:b + w]
        yield m.tobytes()


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_fuzz_oracle_native_agree(fmt):
    """500 mutations per format: oracle and native must reject-or-produce
    identically (the full cross-engine acceptance policy)."""
    payload = (native.sqz4_compress_payload(DATA, 1 << 11) if fmt == "sqz4"
               else native.squeeze_compress_payload(DATA, 11))
    rng = np.random.default_rng(0xC0FFEE)
    diverged = []
    for i, mut in enumerate(_mutants(payload, rng, 500)):
        so, out_o = _decode(fmt, "oracle", mut)
        sn, out_n = _decode(fmt, "native", mut)
        if (so, out_o) != (sn, out_n):
            diverged.append((i, so, sn))
    assert not diverged, f"{fmt}: oracle/native diverged on {diverged[:5]}"


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_fuzz_device_scan_agrees(fmt):
    """A subsample through the device (XLA scan) decoder: where the host
    engines accept, the device must produce the same bytes; where they
    reject, the device must not silently return the original data."""
    payload = (native.sqz4_compress_payload(DATA, 1 << 11) if fmt == "sqz4"
               else native.squeeze_compress_payload(DATA, 11))
    rng = np.random.default_rng(0xFEED)
    checked = 0
    for mut in _mutants(payload, rng, 60):
        sn, out_n = _decode(fmt, "native", mut)
        sd, out_d = _decode(fmt, "device", mut)
        if sn == "ok":
            assert sd == "ok" and out_d == out_n, "device rejects valid-ish"
        else:
            # the device may *detect* corruption at a different token (its
            # validation points match, but a mutated stream can decode to
            # a same-length token sequence); it must never silently yield
            # the pristine data
            assert not (sd == "ok" and out_d == DATA), \
                "device accepted a stream the host rejected, as original"
        checked += 1
    assert checked == 60


def test_fuzz_pallas_decoder_interpret():
    """A small corrupt-stream sample through the device decoder (its CPU
    target): it must reproduce exactly what the native host decoder
    produces, and reject exactly when the host rejects."""
    from sqz_tpu.ops import coder
    small = DATA[:256]
    payload = native.sqz4_compress_payload(small, 1 << 10)
    rng = np.random.default_rng(0xD1CE)
    for mut in _mutants(payload, rng, 12):
        try:
            out_n = native.sqz4_decompress_payload(mut, 256)
            sn = "ok"
        except Exception:
            sn, out_n = "err", None
        try:
            out_d = coder.decode_groups([mut], [256], 8)[0]
            sd = "ok"
        except Exception:
            sd, out_d = "err", None
        if sn == "ok" and len(out_n) == 256:
            assert sd == "ok" and out_d == out_n
        else:
            assert sd == "err"


def test_fuzz_container_forgery():
    """Forged sqzt length tables / flags: never a silent wrong answer."""
    blob = sqz_tpu.compress(DATA * 4, fmt="sqz4", engine="native",
                            win_bits=11, blocks=True, blk_bits=11)
    rng = np.random.default_rng(7)
    for _ in range(200):
        m = bytearray(blob)
        field = rng.integers(0, 4)
        if field == 0:    # length-table entry
            off = 32 + 8 * int(rng.integers(0, 4))
            m[off:off + 8] = int(rng.integers(0, 1 << 20)).to_bytes(8, "little")
        elif field == 1:  # block count
            m[24:32] = int(rng.integers(0, 64)).to_bytes(8, "little")
        elif field == 2:  # original size
            m[16:24] = int(rng.integers(0, 1 << 20)).to_bytes(8, "little")
        else:             # flags byte
            m[11] = int(rng.integers(0, 256))
        try:
            out = sqz_tpu.decompress(bytes(m), engine="native")
        except AssertionError:
            raise
        except Exception:
            continue  # rejection is the expected outcome
        # acceptance is only legal when the result is actually right
        assert out == DATA * 4, "silent wrong answer from forged container"


def test_nyt_escape_of_present_symbol_rejected_all_engines():
    """A crafted stream that codes an NYT escape naming an ALREADY-present
    symbol is malformed (encoders escape unseen symbols only); inserting a
    linked node would corrupt the adaptive tree, so every engine must
    reject it instead of returning garbage as success."""
    from sqz_tpu.oracle.bitstream import BitWriter
    from sqz_tpu.oracle.squeeze import _new_trees, _write_huffman
    from sqz_tpu.formats.constants import SQUEEZE_LIT_NYT

    bw = BitWriter()
    lit, _pos = _new_trees()
    # literal 'A' via its first-occurrence escape (inserts it) ...
    _write_huffman(bw, lit, SQUEEZE_LIT_NYT)
    bw.write_bits(ord("A"), 9)
    lit.insert(ord("A"))
    # ... then a second escape naming 'A' again: malformed
    _write_huffman(bw, lit, SQUEEZE_LIT_NYT)
    bw.write_bits(ord("A"), 9)
    bw.flush()
    payload = bw.getvalue()
    global SIZE
    size_was = SIZE
    try:
        # the stream "claims" 2 bytes of output
        import test_fuzz as _self
        _self.SIZE = 2
        so, _ = _decode("squeeze", "oracle", payload)
        sn, _ = _decode("squeeze", "native", payload)
        sj, _ = _decode("squeeze", "device", payload)
        assert (so, sn, sj) == ("err", "err", "err"), (so, sn, sj)
    finally:
        _self.SIZE = size_was


def test_forged_header_fields_rejected():
    """unpack() is the untrusted-input validation point: forged header
    fields that would flow into native block math (blk_bits), unknown
    flags, reserved bytes, inconsistent block counts, and non-canonical
    bitmap padding must all reject cleanly."""
    import struct

    import sqz_tpu
    from sqz_tpu.formats import container

    blob = sqz_tpu.compress(DATA, fmt="sqz4", engine="native", blocks=True,
                            blk_bits=10, checksum=False)
    container.unpack(blob)                       # sane baseline

    def mutate(off, val):
        m = bytearray(blob)
        m[off] = val
        return bytes(m)

    for off, val in ((8, 9),      # fmt
                     (9, 9),      # win_bits
                     (10, 63),    # blk_bits (the OOB-write vector)
                     (10, 11),    # blk_bits inconsistent with nblocks
                     (11, 0x88),  # unknown flag bit
                     (12, 1)):    # reserved byte
        with pytest.raises(ValueError):
            container.unpack(mutate(off, val))
    # block count inconsistent with original size
    m = bytearray(blob)
    struct.pack_into("<Q", m, 24, 1)             # nblocks = 1 (real: 2)
    with pytest.raises(ValueError):
        container.unpack(bytes(m))
    # warm bitmap padding bits must be zero
    wblob = sqz_tpu.compress(DATA, fmt="sqz4", engine="native", blocks=True,
                             blk_bits=10, warm=True, checksum=False)
    *_, fresh, _anch = container.unpack(wblob)
    nbm = (len(fresh) + 7) // 8
    pad_off = len(wblob) - sum(
        s for s in [len(p) for p in container.unpack(wblob)[4]]) - nbm
    m = bytearray(wblob)
    m[pad_off + nbm - 1] |= 0x80                 # bit past nblocks
    if len(fresh) % 8:                           # only when padding exists
        with pytest.raises(ValueError):
            container.unpack(bytes(m))


def test_unused_lit_symbol_256_rejected_all_engines():
    """Symbol 256 sits between the literals and the length codes and is
    never emitted by any encoder; a crafted NYT escape naming it must be
    rejected by every engine (the device scan once clipped it to length
    code 0 and mis-decoded)."""
    from sqz_tpu.oracle.bitstream import BitWriter
    from sqz_tpu.oracle.squeeze import _new_trees, _write_huffman
    from sqz_tpu.formats.constants import SQUEEZE_LIT_NYT

    bw = BitWriter()
    lit, _pos = _new_trees()
    _write_huffman(bw, lit, SQUEEZE_LIT_NYT)
    bw.write_bits(256, 9)
    bw.flush()
    payload = bw.getvalue()
    import test_fuzz as _self
    size_was = _self.SIZE
    try:
        _self.SIZE = 4
        results = tuple(_decode("squeeze", e, payload)[0]
                        for e in ("oracle", "native", "device"))
        assert results == ("err", "err", "err"), results
    finally:
        _self.SIZE = size_was
