"""Benchmark: block-parallel sqz4 codec throughput on one GPU.

Prints ONE JSON line (last line of stdout):
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N, ...}

value     = combined codec throughput of the device coders (ops/coder.py):
            (bytes encoded + bytes decoded) / (device encode time + device
            decode time), steady state, inputs and results device-resident,
            round trip verified bit-exact against the native
            (reference-equivalent) streams. The stderr report adds the
            host stages (planning, transfers, assembly) and the secondary
            sections; every record names the device it ran on.
baseline  = the single-threaded native C++ codec (byte-identical streams to
            the reference C library, which publishes no throughput numbers).

Refuses to run without a GPU: a CPU run would measure XLA's CPU backend,
not the device. Cells and regression bounds are not defined here yet
(ROADMAP queue 1 item 1).

Env knobs: SQZ_BENCH_BYTES (default 32 MiB of utils/corpus.mixed),
SQZ_BENCH_BLK_BITS (default 16), SQZ_BENCH_LZ (default 1),
SQZ_BENCH_E2E_BYTES, SQZ_BENCH_WARM_BLOCKS, SQZ_BENCH_PROFILE (trace dir).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np

from sqz_tpu.utils import devcache

devcache.enable()


def _input_bytes(n: int) -> bytes:
    from sqz_tpu.utils import corpus
    return corpus.mixed(n, seed=1)


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _best_of(fn, reps: int = 3) -> float:
    """Best wall time of ``reps`` calls, each waited on with
    block_until_ready (the first, compiling call is not counted)."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    from sqz_tpu import native
    from sqz_tpu.ops import coder
    native.require()

    n_bytes = int(os.environ.get("SQZ_BENCH_BYTES", 32 * 1024 * 1024))
    blk_bits = int(os.environ.get("SQZ_BENCH_BLK_BITS", 16))
    lz = os.environ.get("SQZ_BENCH_LZ", "1") == "1"
    window = 1 << 15
    data = _input_bytes(n_bytes)
    bs = 1 << blk_bits
    parts = [data[o:o + bs] for o in range(0, len(data), bs)]
    sizes = [len(p) for p in parts]
    NB = len(parts)
    _log(f"# input {len(data)} B, {NB} blocks of 2^{blk_bits}, lz={lz}, "
         f"device {dev.device_kind} x {len(jax.devices())}")
    core_stages: dict = {}

    # ---- baseline: single-threaded native C++ on a sample of blocks
    nsamp = max(1, min(NB, NB // 8 or 8))
    t0 = time.perf_counter()
    base_payloads = [native.sqz4_compress_payload(p, window, lz=lz)
                     for p in parts[:nsamp]]
    t_base_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    base_out = [native.sqz4_decompress_payload(pl, s)
                for pl, s in zip(base_payloads, sizes)]
    t_base_dec = time.perf_counter() - t0
    samp_bytes = sum(sizes[:nsamp])
    assert b"".join(base_out) == data[:samp_bytes]
    base_gbps = 2 * samp_bytes / (t_base_enc + t_base_dec) / 1e9
    _log(f"# native 1-thread ({nsamp}/{NB} blocks): enc "
         f"{samp_bytes / t_base_enc / 1e6:.1f} MB/s, dec "
         f"{samp_bytes / t_base_dec / 1e6:.1f} MB/s")

    # ---- encode: host token plan (exact parse) untimed, device coder timed
    t0 = time.perf_counter()
    toks, lits, counts, _mx, _seed = coder.plan_tokens(
        data, blk_bits, window, lz, "exact")
    core_stages["enc_host_plan"] = round(time.perf_counter() - t0, 3)
    cap_words = coder.cap_words_for(bs + 2048)
    Tt = int(counts[:, 0].max())
    tdev = coder.stage_tokens(jnp.asarray(toks[:, :Tt]))
    ldev = coder.pack_words(jnp.asarray(lits)[None])
    prof_dir = os.environ.get("SQZ_BENCH_PROFILE")
    prof = (jax.profiler.trace(prof_dir) if prof_dir
            else contextlib.nullcontext())
    with prof:
        t_enc = _best_of(lambda: coder.encode(tdev, ldev, cap_words))
    words, lens = coder.encode(tdev, ldev, cap_words)
    t0 = time.perf_counter()
    lens_np = np.asarray(lens)
    coder.check_lens(lens_np, cap_words, NB)
    payloads = coder.unpack_group_payloads(
        coder.fetch_words_trimmed(words, lens_np), lens_np, NB)
    core_stages["enc_kernel"] = round(t_enc, 4)
    core_stages["enc_download_unpack"] = round(time.perf_counter() - t0, 3)
    assert payloads[:nsamp] == base_payloads, "device stream != native"

    # ---- decode: payload upload untimed, device decoder timed, then the
    # record download + host assembly
    dims = coder.decode_dims(blk_bits)
    buf, meta = coder.pack_decode_chunk(payloads, sizes, dims["Pw"])
    bufd = jnp.asarray(buf)
    t_dec = _best_of(lambda: coder.decode(bufd, meta, dims["lw"],
                                          dims["tw"], dims["mw"]))
    res = coder.decode(bufd, meta, dims["lw"], dims["tw"], dims["mw"])
    t0 = time.perf_counter()
    lt, tt, mt, cnt = coder.fetch_decode_host(res)
    outs = coder.postprocess_decode(lt, tt, mt, cnt, payloads, sizes, bs)
    core_stages["dec_kernel"] = round(t_dec, 4)
    core_stages["dec_download_assemble"] = round(time.perf_counter() - t0, 3)
    assert b"".join(outs) == data, "device round-trip mismatch"
    gbps = 2 * len(data) / (t_enc + t_dec) / 1e9
    _log(f"# device coders: enc {len(data) / t_enc / 1e6:.1f} MB/s, dec "
         f"{len(data) / t_dec / 1e6:.1f} MB/s; stages {core_stages}")

    comp_bytes = sum(len(p) for p in payloads)
    ratio = comp_bytes / len(data)
    ref_n = min(len(data), 4 << 20)
    ref_ratio = len(native.sqz4_compress_payload(data[:ref_n], window,
                                                 lz=lz)) / ref_n
    _log(f"# ratio: blocks {ratio * 100:.2f}% vs one whole stream over "
         f"{ref_n >> 20} MiB {ref_ratio * 100:.2f}%")

    fails: list = []
    extra: dict = {}

    def section(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:                       # noqa: BLE001
            fails.append(f"{name}: {type(e).__name__}: {e}")
            _log(f"# SECTION FAILED [{name}]: {type(e).__name__}: {e}")
        finally:
            _log(f"# [{name}] {time.perf_counter() - t0:.1f}s")

    from sqz_tpu.ops import lz_restore, lzparse, resident
    B = min(NB, coder.ENC_LANES)
    arr = np.frombuffer(data[:B * bs], np.uint8).reshape(B, bs)
    blocks_d = jnp.asarray(arr)
    lens_d = jnp.asarray(np.full((B,), bs, np.int32))
    mb = B * bs / 1e6
    spots = list(range(0, B, max(1, B // 8)))

    # ---- device LZ parse (ops/lzparse.py) + the general restore
    def sec_lz():
        gargs = lzparse.lz_group_args(blk_bits)
        t_lz = _best_of(
            lambda: lzparse.encode_lz_group(blocks_d, lens_d, **gargs), 2)
        words, lens = lzparse.encode_lz_group(blocks_d, lens_d, **gargs)
        lens_np = np.asarray(lens)
        lz_payloads = coder.unpack_group_payloads(
            coder.fetch_words_trimmed(words, lens_np), lens_np, B)
        for b in range(B):
            assert native.sqz4_decompress_payload(
                lz_payloads[b], bs) == parts[b], f"device-LZ block {b}"
        lz_ratio = sum(map(len, lz_payloads)) / (B * bs)
        fast = [native.sqz4_compress_payload(p, window, parse="fast")
                for p in parts[:B]]
        dpp = (lz_ratio - sum(map(len, fast)) / (B * bs)) * 100
        _log(f"# device LZ parse ({B} blocks): enc {mb / t_lz:.1f} MB/s, "
             f"ratio {lz_ratio * 100:.2f}% ({dpp:+.2f} pp vs host fast)")
        extra["device_lz_enc_MBps"] = round(mb / t_lz, 1)
        extra["device_lz_ratio"] = round(lz_ratio, 6)
        extra["device_lz_vs_fast_pp"] = round(dpp, 2)
        dargs = dict(coder.decode_dims(blk_bits), bs=bs)
        bufg, plg, szg, _ov = resident.pack_payload_group(
            lz_payloads, sizes[:B], dargs["Pw"], B)
        bg, pg, sg = jnp.asarray(bufg), jnp.asarray(plg), jnp.asarray(szg)
        blocks, _c, bad = lz_restore.decode_lz_group(bg, pg, sg, **dargs)
        assert not bool(np.asarray(bad).any()), "general restore bad lane"
        for b in spots:
            assert np.asarray(blocks[b]).tobytes() == parts[b]
        t_gr = _best_of(lambda: lz_restore.decode_lz_group(
            bg, pg, sg, **dargs), 2)
        _log(f"# device general restore: {mb / t_gr:.1f} MB/s")
        extra["device_lz_restore_MBps"] = round(mb / t_gr, 1)

    section("device_lz", sec_lz)

    # ---- device-resident literal-only and RLE paths (ops/resident.py)
    def sec_resident():
        eargs = resident.encode_group_args(blk_bits)
        dargs = resident.decode_group_args(blk_bits, eargs["cap_words"])
        t_enc_r = _best_of(lambda: resident.encode_literal_group(
            blocks_d, lens_d, **eargs))
        words, lens = resident.encode_literal_group(blocks_d, lens_d, **eargs)
        t_dec_r = _best_of(lambda: resident.decode_literal_group(
            words, lens, lens_d, **dargs))
        out, counts = resident.decode_literal_group(words, lens, lens_d,
                                                    **dargs)
        assert int(np.asarray(counts)[0, 4].max()) == 0
        for b in spots:
            assert np.array_equal(np.asarray(out[b]), arr[b])
        _log(f"# resident literal-only: enc {mb / t_enc_r:.1f} MB/s, dec "
             f"{mb / t_dec_r:.1f} MB/s")
        extra["resident_lit_enc_MBps"] = round(mb / t_enc_r, 1)
        extra["resident_lit_dec_MBps"] = round(mb / t_dec_r, 1)
        # RLE on checkpoint-like sparse data (~70% zero cells)
        rng = np.random.default_rng(7)
        sp_arr = arr.copy()
        sp_arr.reshape(B, bs // 128, 128)[
            rng.random((B, bs // 128)) < 0.7] = 0
        spd = jnp.asarray(sp_arr)
        gargs = resident.rle_group_args(blk_bits)
        t_rle = _best_of(lambda: resident.encode_rle_group(
            spd, lens_d, **gargs))
        words_r, lens_r = resident.encode_rle_group(spd, lens_d, **gargs)
        lr = np.asarray(lens_r)
        rle_payloads = coder.unpack_group_payloads(
            coder.fetch_words_trimmed(words_r, lr), lr, B)
        for b in spots:
            assert native.sqz4_decompress_payload(
                rle_payloads[b], bs) == sp_arr[b].tobytes()
        rdims = dict(coder.decode_dims(blk_bits), bs=bs)
        rdims["Pw"] = min(rdims["Pw"], gargs["cap_words"])
        blocks_r, _c, bad_r = resident.decode_rle_group(
            words_r, lens_r[0, 0, :], lens_d, **rdims)
        assert not bool(np.asarray(bad_r).any()), "resident restore bad"
        t_rr = _best_of(lambda: resident.decode_rle_group(
            words_r, lens_r[0, 0, :], lens_d, **rdims))
        rle_ratio = sum(map(len, rle_payloads)) / (B * bs)
        _log(f"# resident RLE (70% zero cells): enc {mb / t_rle:.1f} MB/s, "
             f"restore {mb / t_rr:.1f} MB/s, ratio {rle_ratio * 100:.2f}%")
        extra["resident_rle_enc_MBps"] = round(mb / t_rle, 1)
        extra["resident_rle_dec_MBps"] = round(mb / t_rr, 1)
        extra["resident_rle_ratio"] = round(rle_ratio, 6)

    section("device_resident", sec_resident)

    # ---- checkpoint layer (utils/checkpoint.py): save/load wall times
    def sec_checkpoint():
        from sqz_tpu.utils import checkpoint as ckpt
        rng = np.random.default_rng(11)
        nel = (4 << 20) // 4
        t_ = np.arange(nel, dtype=np.float32)
        m = np.sin(t_ * 1e-3).astype(np.float32) * 0.01
        m[rng.random(nel) < 0.7] = 0.0
        tree = {"w": jnp.asarray(np.sin(t_ * 1e-2), dtype=jnp.bfloat16),
                "m": jnp.asarray(m), "v": jnp.asarray(m * m)}
        raw = sum(int(x.nbytes) for x in jax.tree_util.tree_leaves(tree))
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "bench_ckpt.bin")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            ckpt.save_pytree(tree, path, blk_bits=blk_bits)
            t0 = time.perf_counter()
            st = ckpt.save_pytree(tree, path, blk_bits=blk_bits)
            t_save = time.perf_counter() - t0
            ckpt.load_pytree(path)
            t0 = time.perf_counter()
            got = ckpt.load_pytree(path)
            t_load = time.perf_counter() - t0
        finally:
            if os.path.exists(path):
                os.remove(path)
        for k in tree:
            assert np.array_equal(np.asarray(got[k]), np.asarray(tree[k]))
        _log(f"# checkpoint ({raw >> 20} MiB): save {raw / t_save / 1e6:.1f}"
             f" MB/s, load {raw / t_load / 1e6:.1f} MB/s, ratio "
             f"{st['ratio'] * 100:.2f}%")
        extra["ckpt_save_MBps"] = round(raw / t_save / 1e6, 1)
        extra["ckpt_load_MBps"] = round(raw / t_load / 1e6, 1)
        extra["ckpt_ratio"] = round(st["ratio"], 6)

    section("checkpoint", sec_checkpoint)

    # ---- shipping host-fed paths end to end (fast parse, pipelined)
    from sqz_tpu.ops.pipeline import encode_data_pipelined
    e2e_data = _input_bytes(int(os.environ.get(
        "SQZ_BENCH_E2E_BYTES", max(len(data), 2 * coder.ENC_LANES * bs))))
    e2e_nb = -(-len(e2e_data) // bs)
    e2e_sizes = [min(bs, len(e2e_data) - b * bs) for b in range(e2e_nb)]

    def sec_e2e():
        est, dst = {}, {}
        encode_data_pipelined(e2e_data, blk_bits, window, lz, cap=bs + 2048,
                              parse="fast")
        t0 = time.perf_counter()
        pl = encode_data_pipelined(e2e_data, blk_bits, window, lz,
                                   cap=bs + 2048, parse="fast", stats=est)
        t_e = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = coder.decode_groups(pl, e2e_sizes, blk_bits, stats=dst)
        t_d = time.perf_counter() - t0
        assert b"".join(out) == e2e_data, "pipelined round trip"
        n = len(e2e_data)
        _log(f"# end-to-end host-fed ({n >> 20} MiB, fast parse): enc "
             f"{n / t_e / 1e6:.1f} MB/s stages {est}; dec "
             f"{n / t_d / 1e6:.1f} MB/s stages {dst}")
        extra["e2e_pipelined_fast_enc_MBps"] = round(n / t_e / 1e6, 1)
        extra["e2e_pipelined_dec_MBps"] = round(n / t_d / 1e6, 1)
        extra["fast_parse_ratio"] = round(sum(map(len, pl)) / n, 6)

    section("e2e_pipelined", sec_e2e)

    # ---- warm start (sqzt v2) on a subset: the device engine's container
    # must equal the threaded native warm executor's
    import sqz_tpu

    def sec_warm():
        WB = min(NB, int(os.environ.get("SQZ_BENCH_WARM_BLOCKS", "128")))
        sub = data[:WB * bs]
        kw = dict(fmt="sqz4", blocks=True, blk_bits=blk_bits, warm=True,
                  parse="exact")
        t0 = time.perf_counter()
        blob = sqz_tpu.compress(sub, engine="tpu", **kw)
        t_w = time.perf_counter() - t0
        assert blob == sqz_tpu.compress(sub, engine="native", **kw)
        assert sqz_tpu.decompress(blob, engine="tpu") == sub
        _log(f"# warm v2 ({WB} blocks): {len(sub) / t_w / 1e6:.1f} MB/s, "
             f"ratio {len(blob) / len(sub) * 100:.2f}%")
        extra["warm_ratio"] = round(len(blob) / len(sub), 6)

    section("warm_v2", sec_warm)

    # ---- squeeze: the threaded native executor both ways
    def sec_squeeze():
        t0 = time.perf_counter()
        sq = native.blocks_compress(data, 0, 15, blk_bits, parse="fast")
        t_e = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert native.blocks_decompress(sq, len(data), 0, blk_bits) == data
        t_d = time.perf_counter() - t0
        _log(f"# squeeze native threaded ({os.cpu_count()} cores): enc "
             f"{len(data) / t_e / 1e6:.1f} MB/s, dec "
             f"{len(data) / t_d / 1e6:.1f} MB/s")
        extra["squeeze_enc_MBps"] = round(len(data) / t_e / 1e6, 1)
        extra["squeeze_dec_MBps"] = round(len(data) / t_d / 1e6, 1)

    section("squeeze", sec_squeeze)

    result = {
        "metric": "sqz4_block_parallel_encode_plus_decode_GBps_per_chip",
        "value": round(gbps, 6), "unit": "GB/s",
        "vs_baseline": round(gbps / base_gbps, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "blk_bits": blk_bits,
        "enc_MBps": round(len(data) / t_enc / 1e6, 1),
        "dec_MBps": round(len(data) / t_dec / 1e6, 1),
        "ratio": round(ratio, 6), "ref_whole_stream_ratio": round(ref_ratio, 6),
        "core_stages": core_stages,
    }
    result.update(extra)
    if fails:
        result["failed_sections"] = fails
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
