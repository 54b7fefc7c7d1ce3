"""Multi-device sharding on the virtual 8-device CPU mesh: N-block parallel
compression over the mesh must equal the 1-device serial result (the
reference has no parallelism — SURVEY.md §2.6 — so equality with the oracle
IS the spec)."""

import numpy as np
import pytest

import jax

from sqz_tpu.utils import corpus


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sqz_tpu.parallel.mesh import make_mesh
    return make_mesh(8)


def test_sharded_encode_matches_oracle(mesh8):
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
    from sqz_tpu.parallel.shard import encode_blocks_sharded

    blocks = [corpus.texty(256, seed=i) for i in range(16)]
    tokens = [[("lit", b) for b in blk] for blk in blocks]
    payloads = encode_blocks_sharded(tokens, blk_bits=8, mesh=mesh8)
    for i, (blk, p) in enumerate(zip(blocks, payloads)):
        assert p == sqz4_encode_payload(blk, 1 << 8, lz=False), f"block {i}"


def test_sharded_uneven_blocks(mesh8):
    # block count not a multiple of the mesh size: padding must not leak
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
    from sqz_tpu.parallel.shard import encode_blocks_sharded

    blocks = [corpus.texty(128 + 16 * i, seed=i) for i in range(11)]
    tokens = [[("lit", b) for b in blk] for blk in blocks]
    payloads = encode_blocks_sharded(tokens, blk_bits=8, mesh=mesh8)
    assert len(payloads) == 11
    for i, (blk, p) in enumerate(zip(blocks, payloads)):
        assert p == sqz4_encode_payload(blk, 1 << 8, lz=False), f"block {i}"


def test_dryrun_multichip_entrypoints():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape[0] == 8
    g.dryrun_multichip(min(8, len(jax.devices())))


@pytest.mark.slow
def test_pallas_encoder_sharded_wide_totals():
    """A 32 KiB literal-heavy block drives model totals past 2^15; the
    sharded device encoder must stay exact there."""
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import encode_data_sharded

    rng = np.random.default_rng(5)
    # incompressible -> all literals -> pm_byte total 256 + 32768 > 2^15
    data = bytes(rng.integers(0, 256, 33000, np.uint8))
    mesh = make_mesh(2)
    payloads = encode_data_sharded(data, 15, 1 << 15, mesh)
    bs = 1 << 15
    for i in range(2):
        blk = data[i * bs:(i + 1) * bs]
        assert payloads[i] == sqz4_encode_payload(blk, 1 << 15, lz=True)


def test_pallas_encoder_sharded_over_mesh():
    """The device encoder runs per-device under shard_map (the CPU target
    on the virtual mesh); payloads match the oracle, also with per-device
    lane groups and a block count that does not fill the mesh."""
    import numpy as np
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import encode_data_sharded

    mesh = make_mesh(4)
    rng = np.random.default_rng(5)
    data = bytes(rng.integers(0, 8, 4 * 256, np.uint8))
    payloads = encode_data_sharded(data, 8, 1 << 10, mesh)
    assert payloads == encode_data_sharded(data, 8, 1 << 10, mesh, lanes=1)
    assert encode_data_sharded(data[:700], 8, 1 << 10, mesh) == \
        payloads[:2] + [sqz4_encode_payload(data[512:700], 1 << 10)]
    for i in range(4):
        blk = data[i * 256:(i + 1) * 256]
        assert payloads[i] == sqz4_encode_payload(blk, 1 << 10, lz=True)


def test_sharded_warm_seeding():
    """sqzt v2 warm start over the mesh: the scan path shards per-block
    model tables with their blocks; the device coder path broadcasts the
    seed table into every device's shard (FORMAT.md §3.1)."""
    from sqz_tpu import native
    if not native.available():
        pytest.skip("native runtime unavailable")
    from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
    from sqz_tpu.ops.sqz4_jax import seed_from_tokens
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import (encode_blocks_sharded,
                                        encode_data_sharded)
    from sqz_tpu.utils import corpus

    mesh = make_mesh(4)
    data = corpus.texty(4 * 256, seed=3)
    blocks = [data[i * 256:(i + 1) * 256] for i in range(4)]
    # scan path: literal-only tokens, seeded tables sharded with blocks
    tokens = [[("lit", b) for b in blk] for blk in blocks]
    seed = seed_from_tokens(tokens[0])
    payloads = encode_blocks_sharded(tokens, blk_bits=8, mesh=mesh,
                                     seeds=[None] + [seed] * 3)
    for i, blk in enumerate(blocks):
        want = sqz4_encode_payload(blk, 1 << 8, lz=False,
                                   seed=seed if i else None)
        assert payloads[i] == want, f"scan block {i}"
    # device-coder path: all-seeded pass with dictionary-aware planning
    pw = encode_data_sharded(data, 8, 1 << 8, mesh, warm=True)
    _, seed_p = sqz4_encode_payload(blocks[0], 1 << 8, lz=True,
                                    return_state=True)
    for i, blk in enumerate(blocks):
        want = sqz4_encode_payload(
            blk, 1 << 8, lz=True, seed=seed_p if i else None,
            dictionary=blocks[0][-(1 << 8):] if i else b"")
        assert pw[i] == want, f"device block {i}"


def test_decode_blocks_sharded():
    """The decode mirror of the sharded encode: payloads shard by block,
    per-device scan decode + match application, ordered gather."""
    from sqz_tpu import native
    if not native.available():
        pytest.skip("native runtime unavailable")
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import decode_blocks_sharded
    from sqz_tpu.utils import corpus

    mesh = make_mesh(4)
    data = corpus.texty(4 * 512, seed=8)
    payloads = native.blocks_compress(data, 1, 10, 9)
    sizes = [512] * 4
    blocks = decode_blocks_sharded(payloads, sizes, 9, mesh)
    assert b"".join(blocks) == data
    # corrupt one payload -> loud rejection
    bad = list(payloads)
    bb = bytearray(bad[3])
    bb[len(bb) // 2] ^= 0x80
    bad[3] = bytes(bb)
    with pytest.raises(ValueError):
        decode_blocks_sharded(bad, sizes, 9, mesh)


def test_sharded_lz_matches_single_device(mesh8, monkeypatch):
    """Device-LZ multi-chip surface (VERDICT r4 #3): the global-view plan
    stages + shard_map device encoder over the mesh must produce payloads
    byte-identical to the single-device resident-LZ path, and every block
    must round-trip through the oracle decoder."""
    from sqz_tpu.oracle.sqz4 import sqz4_decode_payload
    from sqz_tpu.ops.resident import encode_resident_blocks
    from sqz_tpu.parallel.shard import encode_resident_sharded

    monkeypatch.setenv("SQZ_LZ_SORT_ROWS", "2")
    data = (corpus.texty(20 * 256, seed=3) + bytes(200)
            + b"the quick brown fox " * 40)
    bs = 256
    nb = -(-len(data) // bs)
    sharded = encode_resident_sharded(data, 8, mesh8, mode="lz",
                                      lanes=3)
    single = encode_resident_blocks(data, 8, "lz", lanes=128)
    assert sharded == single
    for i in range(nb):
        sz = min(bs, len(data) - i * bs)
        assert sqz4_decode_payload(sharded[i], sz) == \
            data[i * bs:i * bs + sz], f"block {i}"


def test_lzparse_unaligned_slice_padding(monkeypatch):
    """ADVICE r4 #1: a batch that is not a multiple of SQZ_LZ_SORT_ROWS
    must pad its final slice (reusing the compiled programs) and slice the
    outputs back — payloads identical to an aligned run."""
    from jax import numpy as jnp

    from sqz_tpu.ops import lzparse

    data = corpus.texty(5 * 256, seed=9)
    blocks = np.frombuffer(data, np.uint8).reshape(5, 256)
    lengths = jnp.asarray(np.full((5,), 256, np.int32))
    out_pad = lzparse.lz_plan_device(jnp.asarray(blocks), lengths,
                                     Tt=96, rows=2)       # 3 slices, last=1
    out_one = lzparse.lz_plan_device(jnp.asarray(blocks), lengths,
                                     Tt=96, rows=5)       # single slice
    for a, b in zip(out_pad, out_one):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_lzparse_sort_rows_env_validation(monkeypatch):
    from jax import numpy as jnp

    from sqz_tpu.ops import lzparse

    blocks = jnp.zeros((2, 256), jnp.uint8)
    lengths = jnp.asarray(np.full((2,), 256, np.int32))
    for bad in ("0", "-3", "abc"):
        monkeypatch.setenv("SQZ_LZ_SORT_ROWS", bad)
        with pytest.raises(ValueError):
            lzparse.lz_plan_device(blocks, lengths, Tt=96)
