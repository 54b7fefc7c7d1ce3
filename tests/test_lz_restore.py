"""Chip-resident restore for GENERAL sqz4 streams (ops/lz_restore.py,
VERDICT r4 #4): compress_resident(mode="lz") -> decompress_resident must
round-trip with ZERO host byte assembly, and the general assembly must be
exact for arbitrary spec-valid streams (incl. host exact-parse payloads
with deep overlapped-copy chains — the reference's byte-serial decode
loop semantics, /root/reference/src/sqz.c:826-831)."""

import numpy as np
import pytest

import jax.numpy as jnp

import sqz_tpu
from sqz_tpu import native
from sqz_tpu.ops import resident
from sqz_tpu.utils import corpus


def _no_host(monkeypatch):
    def _boom(*a, **k):            # pragma: no cover - failure path
        raise AssertionError("host byte assembly was invoked")
    monkeypatch.setattr(resident, "host_decode_blocks", _boom)


def _roundtrip(data, blk_bits, mode, monkeypatch, assembly):
    blob = sqz_tpu.compress_resident(data, blk_bits=blk_bits, mode=mode)
    _no_host(monkeypatch)
    out = sqz_tpu.decompress_resident(blob,
                                      assembly=assembly)
    assert np.asarray(out).tobytes() == data


def test_lz_container_restores_on_device(monkeypatch):
    data = (corpus.texty(6 * 256, seed=1) + b"abcab" * 100 + bytes(300)
            + corpus.texty(512, seed=2))
    _roundtrip(data, 8, "lz", monkeypatch, "general")


def test_lz_container_restores_auto(monkeypatch):
    # auto: the cell pass rejects LZ-parsed lanes, the general assembly
    # picks them up — still zero host bytes
    data = corpus.texty(5 * 256, seed=3) + b"xyz" * 200
    _roundtrip(data, 8, "lz", monkeypatch, "auto")


def test_cell_containers_still_restore(monkeypatch):
    # rle/lit containers keep restoring (cell path under auto)
    data = bytes(512) + corpus.texty(700, seed=4) + b"ab" * 128
    for mode in ("lit", "rle"):
        _roundtrip(data, 8, mode, monkeypatch, "auto")


def test_deep_chain_rle_content(monkeypatch):
    # dist-1/dist-2 matches chained across every segment: pointer
    # doubling must resolve depth ~ n/seg chains exactly
    data = bytes(4096) + b"ab" * 2048 + b"Q" * 4000 + b"end!"
    _roundtrip(data, 12, "lz", monkeypatch, "general")


def test_foreign_exact_parse_streams(monkeypatch):
    # payloads from the HOST exact parse (hash chains, dists up to the
    # window, len up to 254) — not lzparse streams: the general assembly
    # must still be exact, proving the any-spec-valid-stream claim
    data = corpus.texty(8 * 1024, seed=7) + (b"0123456789" * 60)
    bs = 1 << 10
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    payloads = [native.sqz4_compress_payload(p, 1 << 15, lz=True)
                for p in parts]
    from sqz_tpu.formats import container as sqzt
    from sqz_tpu.formats.constants import SQZT_FORMAT_SQZ4
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, 10, len(data), payloads, None)
    _no_host(monkeypatch)
    out = sqz_tpu.decompress_resident(blob,
                                      assembly="general")
    assert np.asarray(out).tobytes() == data


def test_corrupt_block_flags_bad_lane():
    data = corpus.texty(3 * 256, seed=9)
    blob = sqz_tpu.compress_resident(data, blk_bits=8, mode="lz")
    bad = bytearray(blob)
    bad[-7] ^= 0x5A                       # flip a payload byte
    with pytest.raises(Exception):
        sqz_tpu.decompress_resident(bytes(bad),
                                    assembly="general")


def test_assembly_param_validation():
    data = corpus.texty(256, seed=0)
    blob = sqz_tpu.compress_resident(data, blk_bits=8, mode="lit")
    with pytest.raises(ValueError):
        sqz_tpu.decompress_resident(blob,
                                    assembly="bogus")


def test_sharded_restore_general_fallback(monkeypatch):
    # sharded mirror of assembly="auto": an LZ container restores over
    # the mesh with zero host byte assembly
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual devices")
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import decompress_resident_sharded

    mesh = make_mesh(4)
    data = corpus.texty(9 * 256, seed=11) + b"zz0" * 120
    blob = sqz_tpu.compress_resident(data, blk_bits=8, mode="lz")
    _no_host(monkeypatch)
    out = decompress_resident_sharded(blob, mesh, lanes=128)
    assert np.asarray(out).tobytes() == data


def test_corrupt_mutants_flag_or_match():
    """Adversarial guarantee: for ANY mutated payload the general
    assembly either flags the lane bad (host decoder then raises) or
    decodes it — and whenever the host decoder accepts the mutant, the
    device bytes must MATCH the host's (no silent divergence)."""
    import jax.numpy as jnp

    from sqz_tpu.ops import coder, lz_restore

    data = corpus.texty(8 * 256, seed=21) + bytes(300) + b"pqr" * 150
    bs = 256
    payloads = resident.encode_resident_blocks(data, 8, "lz", lanes=32)
    nb = len(payloads)
    sizes = [min(bs, len(data) - b * bs) for b in range(nb)]
    rng = np.random.default_rng(5)
    muts, host_out = [], []
    for t in range(24):
        b = int(rng.integers(nb))
        p = bytearray(payloads[b])
        p[int(rng.integers(len(p)))] ^= int(rng.integers(1, 256))
        muts.append((bytes(p), sizes[b]))
    lanes = len(muts)
    dargs = dict(coder.decode_dims(8), bs=bs)
    buf, plens, szs, over = resident.pack_payload_group(
        [m[0] for m in muts], [m[1] for m in muts], dargs["Pw"], lanes)
    blocks, _c, bad = lz_restore.decode_lz_group(
        jnp.asarray(buf), jnp.asarray(plens), jnp.asarray(szs), **dargs)
    bad_np = np.asarray(bad)
    checked_match = 0
    for i, (mp, sz) in enumerate(muts):
        try:
            want = native.sqz4_decompress_payload(mp, sz) \
                if native.available() else None
            if want is None:
                from sqz_tpu.oracle.sqz4 import sqz4_decode_payload
                want = sqz4_decode_payload(mp, sz)
        except Exception:
            continue                 # host rejects: bad flag optional
        if not bad_np[i]:
            assert np.asarray(blocks[i])[:sz].tobytes() == want, \
                f"mutant {i}: silent divergence"
            checked_match += 1
    assert checked_match >= 1       # some mutants always stay decodable
