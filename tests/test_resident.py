"""Device-resident literal-only path (ops/resident.py): the token and
literal streams are generated ON DEVICE from raw bytes (no host planning,
reference HEAD literal-only semantics — src/sqz.c:591), coded by the
token-input kernel, and decoded chip-resident. Streams must be
bit-identical to the host coder's lz=False payloads."""

import numpy as np
import pytest

from sqz_tpu import native
from sqz_tpu.formats.container import split_blocks
from sqz_tpu.ops import resident
from sqz_tpu.utils import corpus

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")


def test_resident_encode_bit_exact_vs_native():
    data = corpus.texty(3 * 256 + 100, seed=7)
    payloads = resident.encode_literal_blocks(data, 8, lanes=128)
    parts = split_blocks(data, 8)
    want = [native.sqz4_compress_payload(p, 1 << 8, lz=False)
            for p in parts]
    assert payloads == want


def test_resident_encode_empty_and_tiny():
    for data in (b"", b"Z"):
        payloads = resident.encode_literal_blocks(data, 8, lanes=128)
        parts = split_blocks(data, 8)
        want = [native.sqz4_compress_payload(p, 1 << 8, lz=False)
                for p in parts]
        assert payloads == want


def test_resident_roundtrip_on_device():
    import jax.numpy as jnp
    bs, B, NB = 256, 128, 5
    data = corpus.texty(4 * bs + 60, seed=3)   # tail block of 60 bytes
    arr = np.zeros((B, bs), np.uint8)
    lengths = np.zeros((B,), np.int32)
    for b in range(NB):
        blk = data[b * bs:(b + 1) * bs]
        arr[b, :len(blk)] = np.frombuffer(blk, np.uint8)
        lengths[b] = len(blk)
    plens, out, counts = resident.roundtrip_literal_device(
        jnp.asarray(arr), jnp.asarray(lengths), 8)
    counts = np.asarray(counts)
    assert int(counts[0, 4].max()) == 0, "decoder error lane set"
    assert np.array_equal(np.asarray(counts)[0, 0, :NB], lengths[:NB])
    out = np.asarray(out)
    assert np.array_equal(out[:NB], arr[:NB])
    # payload lengths match the host coder's streams
    parts = split_blocks(data, 8)
    want = [len(native.sqz4_compress_payload(p, 1 << 8, lz=False))
            for p in parts]
    assert np.asarray(plens)[:NB].tolist() == want


def _cell_parse_tokens(blk: bytes):
    """Reference reconstruction of the resident cell parse, rule for
    rule: per full 128-byte cell, (1) a period-d repeat (smallest d in
    RLE_DISTS wins) -> ("match", 128, d); (2) an all-zero cell copies the
    nearest previous all-zero full cell within 255 cells; (3) a cell
    identical to the EARLIEST eligible (non-rule-1/2) occurrence of its
    content within 255 cells copies it (generic dedup); else literals.
    The partial tail cell is always literal."""
    toks = []
    C = resident.CELL
    n = len(blk)
    lastz = None
    earliest = {}
    i = 0
    while i < n:
        cell = blk[i:i + C]
        ci = i // C
        dist = None
        if i >= C and len(cell) == C:
            for d in resident.RLE_DISTS:
                if all(blk[j] == blk[j - d] for j in range(i, i + C)):
                    dist = d
                    break
        if len(cell) == C:
            iszero = cell == bytes(C)
            if (dist is None and iszero and lastz is not None
                    and ci - lastz <= 255 and ci > 0):
                dist = (ci - lastz) * C
            if iszero:
                lastz = ci
            eligible = dist is None        # pre-dedup state, as on device
            if dist is None:
                e = earliest.get(cell)
                if e is not None and 1 <= ci - e <= 255 and ci > 0:
                    dist = (ci - e) * C
            if eligible and cell not in earliest:
                earliest[cell] = ci
        if dist is not None:
            toks.append(("match", C, dist))
        else:
            toks += [("lit", b) for b in cell]
        i += C
    return toks


def _rle_cases():
    text = corpus.texty(1024, seed=5)
    return [
        bytes(1024),                                   # all zeros
        text,                                          # no run cells
        bytes(512) + text[:512],                       # zeros then text
        text[:256] + b"\xAA" * 512 + text[256:512],    # run mid-block
        bytes(700),                                    # partial tail
        (b"x" * 127 + b"y") * 8,                       # period breaks cells
        b"abcd" * 256,                                 # 4-byte pattern
        (text[:32] * 40)[:1024],                       # period 32
        b"ab" * 100 + b"abc" * 200 + b"\0" * 224,      # mixed periods
        # generic dedup: repeated nonzero cells at k >= 2 (k == 1 is
        # periodic d=128); A B C A D A layout exercises earliest-source
        text[:384] + text[:128] + text[384:512] + text[:128] +
        text[512:768],
        # dedup where the first occurrence is itself periodic: A A B A
        text[:128] * 2 + text[128:256] + text[:128] + text[256:768],
        # dedup mixed with far zero cells and a partial tail
        text[:128] + bytes(128) + text[128:256] + bytes(128) +
        text[128:256] + text[:100],
    ]


def test_resident_rle_bit_exact_vs_scan_engine():
    """RLE-resident payloads must equal the scan engine's bytes for the
    same cell parse (stream identity is parse-determined)."""
    from sqz_tpu.ops import sqz4_jax
    for data in _rle_cases():
        payloads = resident.encode_rle_blocks(data, 10, lanes=128)
        parts = split_blocks(data, 10)
        want = sqz4_jax.encode_blocks(
            [_cell_parse_tokens(p) for p in parts], blk_bits=10)
        assert payloads == want, f"case {data[:16]!r}"
        # and they are ordinary sqz4 payloads: native decode round-trips
        for p, blk in zip(payloads, parts):
            assert native.sqz4_decompress_payload(p, len(blk)) == blk


def test_resident_rle_ratio_beats_literal_only_on_runs():
    # 1 KiB interpret-mode blocks keep the test fast; at that size the
    # coder's fixed 8-byte flush dominates (66 vs 126 B measured), so the
    # margin here is conservative — at 64 KiB blocks the gap is ~10x
    data = bytes(4096)
    rle = resident.encode_rle_blocks(data, 10, lanes=128)
    lit = resident.encode_literal_blocks(data, 10, lanes=128)
    assert sum(len(p) for p in rle) < 0.7 * sum(len(p) for p in lit)


def test_resident_sharded_over_mesh():
    """encode_resident_sharded on the 8-virtual-device CPU mesh must
    produce exactly the single-device resident payloads, both modes."""
    import jax.numpy as jnp

    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import encode_resident_sharded
    mesh = make_mesh(8)
    data = bytes(512) + corpus.texty(2048, seed=13) + b"abcd" * 256 + \
        bytes(1024) + corpus.texty(420, seed=14)
    for mode in ("rle", "lit"):
        got = encode_resident_sharded(data, 10, mesh, mode=mode,
                                      lanes=128)
        want = resident.encode_resident_blocks(data, 10, mode,
                                               lanes=128)
        assert got == want, mode


def test_compress_resident_container_all_engines():
    """compress_resident produces a standard sqzt container: bytes and
    device-array inputs agree, every engine decodes it, and
    decompress_range works on it."""
    import jax.numpy as jnp

    import sqz_tpu
    data = bytes(512) + corpus.texty(700, seed=9) + b"ab" * 200
    for mode in ("rle", "lit"):
        blob_b = sqz_tpu.compress_resident(data, blk_bits=10, mode=mode,
                                           checksum=True)
        arr = jnp.asarray(np.frombuffer(data, np.uint8))
        blob_a = sqz_tpu.compress_resident(arr, blk_bits=10, mode=mode,
                                           checksum=True)
        assert blob_a == blob_b, mode
        assert sqz_tpu.decompress(blob_b, engine="native") == data, mode
        assert sqz_tpu.decompress(blob_b, engine="oracle") == data, mode
        assert sqz_tpu.decompress_range(blob_b, 1000, 300) == \
            data[1000:1300], mode


def test_decompress_resident_device_restore():
    """The restore path: compress_resident container -> device-resident
    decode (decode kernel + 3-pass cell assembly) == original bytes,
    across every cell-parse decision class."""
    import sqz_tpu
    for data in _rle_cases():
        blob = sqz_tpu.compress_resident(data, blk_bits=10, mode="rle")
        out = resident.decompress_resident(blob, lanes=128)
        assert np.asarray(out).tobytes() == data, f"case {data[:16]!r}"


def test_decompress_resident_uses_device_path(monkeypatch):
    """Guard against the assembly silently dying and everything passing
    via fallback: with the host decoder poisoned, a cell-parsed
    container must still restore (bad stays all-False on device)."""
    import sqz_tpu

    def _boom(*a, **k):
        raise AssertionError("host fallback used on a cell-parsed stream")

    data = bytes(1024) + corpus.texty(1024, seed=17)
    blob = sqz_tpu.compress_resident(data, blk_bits=10, mode="rle")
    monkeypatch.setattr(resident, "host_decode_blocks", _boom)
    out = resident.decompress_resident(blob, lanes=128)
    assert np.asarray(out).tobytes() == data


def test_resident_tiny_blocks_degrade_cleanly():
    """blk_bits < 7 (blocks smaller than a cell): RLE encode degrades to
    literal mode and the restore path host-decodes — both round-trip."""
    import sqz_tpu
    data = corpus.texty(500, seed=19)
    blob = sqz_tpu.compress_resident(data, blk_bits=6, mode="rle")
    out = resident.decompress_resident(blob, lanes=128)
    assert np.asarray(out).tobytes() == data


def test_decompress_resident_host_fallback():
    """A container whose streams are NOT cell-parsed (ordinary host
    encode with arbitrary matches) must still decode correctly via the
    per-lane host fallback."""
    import sqz_tpu
    data = corpus.texty(2200, seed=33)
    blob = sqz_tpu.compress(data, fmt="sqz4", engine="native",
                            blocks=True, blk_bits=10, checksum=False)
    out = resident.decompress_resident(blob, lanes=128)
    assert np.asarray(out).tobytes() == data


def test_decompress_resident_sharded_over_mesh():
    """Sharded restore: each of the 8 virtual devices assembles its own
    block shards; output equals the original bytes (incl. a non-cell
    fallback block)."""
    import sqz_tpu
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import decompress_resident_sharded
    mesh = make_mesh(8)
    data = bytes(1024) + corpus.texty(2048, seed=41) + b"abcd" * 300
    blob = sqz_tpu.compress_resident(data, blk_bits=10, mode="rle")
    out = decompress_resident_sharded(blob, mesh, lanes=128)
    assert np.asarray(out).tobytes() == data
    # host-parse container: every lane flags bad, fallback covers all
    blob2 = sqz_tpu.compress(data[:2048], fmt="sqz4", engine="native",
                             blocks=True, blk_bits=10, checksum=False)
    out2 = decompress_resident_sharded(blob2, mesh, lanes=128)
    assert np.asarray(out2).tobytes() == data[:2048]


def test_checkpoint_pytree_roundtrip(tmp_path):
    """save_pytree / load_pytree through the resident codec: mixed-dtype
    pytree (incl. a zero-heavy float leaf — the optimizer-slot case, an
    empty leaf, and bool) restores exactly."""
    import jax.numpy as jnp

    from sqz_tpu.utils import checkpoint as ckpt
    rng = np.random.default_rng(5)
    sparse = np.zeros(700, np.float32)
    sparse[::97] = rng.normal(size=sparse[::97].shape)
    tree = {
        "w": jnp.asarray(rng.normal(size=(20, 16)).astype(np.float32)),
        "m": jnp.asarray(sparse),
        "emb": {"idx": jnp.arange(50, dtype=jnp.int32),
                "mask": jnp.asarray(rng.random(64) < 0.5),
                "bf": jnp.asarray(rng.normal(size=33),
                                  dtype=jnp.bfloat16)},
        "empty": jnp.zeros((0, 4), jnp.float32),
    }
    p = tmp_path / "state.sqzckpt"
    stats = ckpt.save_pytree(tree, p, blk_bits=10)
    assert stats["raw_bytes"] > 0 and stats["compressed_bytes"] > 0
    back = ckpt.load_pytree(p)
    flat_a, td_a = __import__("jax").tree_util.tree_flatten(tree)
    flat_b, td_b = __import__("jax").tree_util.tree_flatten(back)
    assert td_a == td_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.asarray(a), np.asarray(b)), a.dtype


def test_cli_resident_compress_roundtrip(tmp_path, monkeypatch):
    from sqz_tpu.__main__ import main as cli_main
    data = bytes(400) + corpus.texty(500, seed=21)
    src = tmp_path / "in.bin"
    dst = tmp_path / "out.sqzt"
    back = tmp_path / "back.bin"
    src.write_bytes(data)
    assert cli_main(["compress", str(src), str(dst), "--resident", "rle",
                     "--blk-bits", "10"]) == 0
    assert cli_main(["decompress", str(dst), str(back)]) == 0
    assert back.read_bytes() == data


def test_resident_group_payload_fetch_bit_exact():
    """The bench's fetch path over a resident encode group: trimmed word
    download + unpack must yield the native coder's exact bytes."""
    import jax.numpy as jnp

    from sqz_tpu.ops import coder
    bs, B, NB = 256, 128, 3
    data = corpus.texty(NB * bs, seed=11)
    arr = np.frombuffer(data, np.uint8).reshape(NB, bs)
    full = np.zeros((B, bs), np.uint8)
    full[:NB] = arr
    lengths = np.zeros((B,), np.int32)
    lengths[:NB] = bs
    eargs = resident.encode_group_args(8)
    words, lens = resident.encode_literal_group(
        jnp.asarray(full), jnp.asarray(lengths), **eargs)
    lens_np = np.asarray(lens)
    payloads = coder.unpack_group_payloads(
        coder.fetch_words_trimmed(words, lens_np), lens_np, NB)
    for b in range(NB):
        assert payloads[b] == native.sqz4_compress_payload(
            arr[b].tobytes(), 1 << 8, lz=False), f"block {b}"


def test_checkpoint_delta_exact_past_int32_cumsum_wrap():
    """_undelta_device relies on int32 cumsum wrap-around staying exact
    mod 256 (256 divides 2^32, and jnp.mod of the wrapped negative value
    is non-negative). Pin that on a stream whose byte sum exceeds 2^31 —
    the regime every checkpoint over ~8 MiB of high-byte data hits."""
    from sqz_tpu.utils.checkpoint import _delta_device, _undelta_device
    rng = np.random.default_rng(3)
    # 16 Mi bytes biased high: sum ~ 16.8M * 191 ~ 3.2e9 > 2^31
    flat = rng.integers(128, 256, size=1 << 24, dtype=np.uint8)
    import jax.numpy as jnp
    d = _delta_device(jnp.asarray(flat))
    back = np.asarray(_undelta_device(d))
    assert np.array_equal(back, flat)


def test_checkpoint_pytree_sharded_over_mesh(tmp_path):
    """Mesh-aware save_pytree/load_pytree: the concatenated stream's
    blocks shard over the 8 virtual devices for both the coding and the
    restore; the tree restores exactly and the file is byte-identical
    to the single-device save."""
    import jax.numpy as jnp

    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.utils import checkpoint as ckpt
    mesh = make_mesh(8)
    rng = np.random.default_rng(9)
    sparse = np.zeros(3000, np.float32)
    sparse[::53] = rng.normal(size=sparse[::53].shape)
    tree = {
        "w": jnp.asarray(rng.normal(size=(40, 16)).astype(np.float32)),
        "m": jnp.asarray(sparse),
        "step": jnp.asarray(7, jnp.int32),
    }
    p = tmp_path / "sharded.sqzckpt"
    stats = ckpt.save_pytree(tree, p, blk_bits=10,
                             mesh=mesh)
    assert stats["compressed_bytes"] > 0
    p1 = tmp_path / "single.sqzckpt"
    ckpt.save_pytree(tree, p1, blk_bits=10)
    assert p.read_bytes() == p1.read_bytes(), \
        "sharded save must produce the identical container"
    back = ckpt.load_pytree(p, mesh=mesh)
    import jax as _jax
    flat_a, td_a = _jax.tree_util.tree_flatten(tree)
    flat_b, td_b = _jax.tree_util.tree_flatten(back)
    assert td_a == td_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.asarray(a), np.asarray(b)), a.dtype


def test_rle_far_zero_cell_copy_roundtrip():
    """Isolated all-zero cells (nonzero predecessor, so no periodic
    match exists) code as far cell-aligned copies of the nearest
    previous zero cell; streams stay spec-valid sqz4 and the resident
    restore assembles them on-device."""
    import jax.numpy as jnp

    import sqz_tpu
    rng = np.random.default_rng(2)
    bs = 1024
    cells = rng.integers(1, 256, size=(8, 128), dtype=np.uint8)
    cells[2] = 0                       # isolated zero: stays literal
    cells[5] = 0                       # far copy of cell 2 (dist 3*128)
    data = cells.reshape(-1).tobytes()
    payloads = resident.encode_rle_blocks(data, 10, lanes=128)
    assert native.sqz4_decompress_payload(payloads[0], bs) == data
    toks = resident._rle_tokens_from_blocks(
        jnp.asarray(np.frombuffer(data, np.uint8).reshape(1, bs)),
        jnp.asarray(np.asarray([bs], np.int32)), 96)
    t = np.asarray(toks)[0, :, 0]
    assert t[5] == (128 | (1 << 8) | (9 << 9) | (384 << 16)), hex(t[5])
    blob = sqz_tpu.compress_resident(data, blk_bits=10)
    out = sqz_tpu.decompress_resident(blob)
    assert np.asarray(out).tobytes() == data


def _craft_cell_stream(cells: np.ndarray, cell_kinds):
    """Hand-pack a cell-parsed sqz4 payload through the device encoder:
    cell_kinds[i] is None (literal cell) or a dist (far copy token)."""
    import jax.numpy as jnp

    from sqz_tpu.ops import coder
    nc = cells.shape[0]
    bs = nc * 128
    B = 128
    blocks = np.zeros((B, bs), np.uint8)
    blocks[0] = cells.reshape(-1)
    toks = np.zeros((1, 96, B), np.uint32)
    row = []
    for k in cell_kinds:
        if k is None:
            row.append(128)
        else:
            nb = int(k).bit_length()
            row.append(128 | (1 << 8) | (nb << 9) | (k << 16))
    row.append(0x1FF)
    toks[0, :len(row), 0] = row
    lits = resident._pack_literal_words(jnp.asarray(blocks),
                                        max(96, bs // 4))
    cap_words = resident.rle_group_args(10)["cap_words"]
    words, lens = coder.encode(jnp.asarray(toks), lits, cap_words,
                               lit_skip=True)
    lens_np = np.asarray(lens)
    return coder.unpack_group_payloads(
        coder.fetch_words_trimmed(words, lens_np), lens_np, 1)


def _decode_rle_one(payloads, bs):
    import jax.numpy as jnp

    from sqz_tpu.ops import coder
    dims = coder.decode_dims(10)
    buf, plens, szs, _over = resident.pack_payload_group(
        payloads, [bs], dims["Pw"], 128)
    return resident.decode_rle_group(
        jnp.asarray(buf), jnp.asarray(plens), jnp.asarray(szs), bs=bs,
        **dims)


def test_rle_far_copy_literal_source_assembles_on_device():
    """A (foreign) far cell-aligned copy of a nonzero LITERAL cell is
    exactly what the generic-dedup encoder emits: the device fills it
    from the source preplacement, the out[c] == out[src] verify passes,
    and no host fallback happens."""
    rng = np.random.default_rng(4)
    bs = 1024
    cells = rng.integers(1, 256, size=(8, 128), dtype=np.uint8)
    cells[3] = cells[1]                # nonzero cell copy, dist 2*128
    data = cells.reshape(-1).tobytes()
    payloads = _craft_cell_stream(
        cells, [None, None, None, 256, None, None, None, None])
    assert native.sqz4_decompress_payload(payloads[0], bs) == data
    blocks, _counts, bad = _decode_rle_one(payloads, bs)
    assert not bool(np.asarray(bad)[0])
    assert np.asarray(blocks)[0].tobytes() == data


def test_rle_far_copy_nonliteral_source_flags_bad():
    """The resident decoder fills far copies from the source cell's
    literal preplacement — zeros when the source is NOT a literal cell.
    A foreign stream far-copying a nonzero PERIODIC cell therefore fails
    the out[c] == out[src] verify, flags bad, and decodes via the host
    fallback — never silently wrong."""
    import sqz_tpu
    from sqz_tpu.formats import container as sqzt
    from sqz_tpu.formats.constants import SQZT_FORMAT_SQZ4
    rng = np.random.default_rng(5)
    bs = 1024
    cells = rng.integers(1, 256, size=(8, 128), dtype=np.uint8)
    cells[1] = cells[0]                # cell 1: periodic d=128, nonzero
    cells[3] = cells[1]                # far copy of the PERIODIC cell
    data = cells.reshape(-1).tobytes()
    payloads = _craft_cell_stream(
        cells, [None, 128, None, 256, None, None, None, None])
    assert native.sqz4_decompress_payload(payloads[0], bs) == data
    _blocks, _counts, bad = _decode_rle_one(payloads, bs)
    assert bool(np.asarray(bad)[0])
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, 10, bs, payloads, None)
    out = sqz_tpu.decompress_resident(blob)
    assert np.asarray(out).tobytes() == data   # host fallback exact


def test_rle_generic_dedup_roundtrip_and_ratio():
    """Duplicated nonzero rows (the checkpoint pad-row / repeated-
    quantized-row pattern): the encoder emits far dedup tokens, the
    resident restore assembles them on-device, and the ratio beats the
    dedup-free parse."""
    import jax.numpy as jnp

    import sqz_tpu
    rng = np.random.default_rng(6)
    bs = 1024
    cells = rng.integers(1, 256, size=(8, 128), dtype=np.uint8)
    cells[4] = cells[0]                # k=4 dup
    cells[6] = cells[0]                # earliest source stays cell 0
    cells[7] = cells[2]                # second content group
    data = cells.reshape(-1).tobytes()
    toks = resident._rle_tokens_from_blocks(
        jnp.asarray(np.frombuffer(data, np.uint8).reshape(1, bs)),
        jnp.asarray(np.asarray([bs], np.int32)), 96)
    t = np.asarray(toks)[0, :, 0]
    assert t[4] == (128 | (1 << 8) | (10 << 9) | (512 << 16)), hex(t[4])
    assert t[6] == (128 | (1 << 8) | (10 << 9) | (768 << 16)), hex(t[6])
    assert t[7] == (128 | (1 << 8) | (10 << 9) | (640 << 16)), hex(t[7])
    payloads = resident.encode_rle_blocks(data, 10, lanes=128)
    assert native.sqz4_decompress_payload(payloads[0], bs) == data
    blob = sqz_tpu.compress_resident(data, blk_bits=10)
    out = sqz_tpu.decompress_resident(blob)
    assert np.asarray(out).tobytes() == data
    lit = resident.encode_literal_blocks(data, 10, lanes=128)
    assert sum(len(p) for p in payloads) < sum(len(p) for p in lit)


def test_cli_ckpt_save_load_roundtrip(tmp_path, monkeypatch):
    from sqz_tpu.__main__ import main as cli_main
    rng = np.random.default_rng(12)
    sparse = np.zeros((60, 50), np.float32)
    sparse[::7] = 1.5
    src = tmp_path / "t.npz"
    ck = tmp_path / "t.sqzckpt"
    back = tmp_path / "t2.npz"
    np.savez(src, w=rng.normal(size=(40, 30)).astype(np.float32), m=sparse)
    assert cli_main(["ckpt-save", str(src), str(ck),
                     "--blk-bits", "10"]) == 0
    assert cli_main(["ckpt-load", str(ck), str(back)]) == 0
    a, b = np.load(src), np.load(back)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_sharded_resident_guards_match_unsharded():
    """The mesh entry point applies the same blk_bits guards as the
    unsharded path: tiny blocks degrade rle -> lit, blk_bits past the
    resident maximum rejects."""
    from sqz_tpu.parallel.mesh import make_mesh
    from sqz_tpu.parallel.shard import encode_resident_sharded
    mesh = make_mesh(8)
    data = corpus.texty(900, seed=1)
    got = encode_resident_sharded(data, 6, mesh, mode="rle", lanes=128)
    want = resident.encode_resident_blocks(data, 6, "rle", lanes=128)
    assert got == want
    bad = resident.MAX_BLK_BITS + 1
    with pytest.raises(ValueError):
        encode_resident_sharded(data, bad, mesh, mode="lit", lanes=128)
    with pytest.raises(ValueError):
        resident.encode_resident_blocks(data, bad, "lit")
