"""Time the device sqz4 coders (ops/coder.py, CUDA through jax.ffi) against
the plain XLA scan coder (ops/sqz4_jax.py) on the same blocks. Every
device result is checked byte-for-byte against the native codec.

    python tools/coder_bench.py [--blocks 4096] [--blk-bits 16]

Prints progress lines and, last, one JSON object (also written to --out).
Refuses to run without a GPU unless --allow-cpu (a rehearsal whose times
are CPU times, not device metrics).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def gpu_info() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def timed(fn, reps: int):
    """(first-call seconds incl. compile, best of ``reps`` later calls)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def lit_microops(blocks):
    """Literal-only micro-op arrays for the scan encoder: (flag 1, byte)
    per byte, then EOS and the 8 flush emissions (FORMAT.md §2.4)."""
    import numpy as np

    from sqz_tpu.ops import sqz4_jax as sj
    B, n = blocks.shape
    T = 2 * n + 10
    ms = np.empty((B, T), np.int32)
    ss = np.empty((B, T), np.int32)
    ms[:, 0:2 * n:2] = sj.PM_LITERAL
    ss[:, 0:2 * n:2] = 1
    ms[:, 1:2 * n:2] = sj.PM_BYTE
    ss[:, 1:2 * n:2] = blocks
    ms[:, 2 * n:2 * n + 2] = (sj.PM_LITERAL, sj.PM_SIZE)
    ss[:, 2 * n:2 * n + 2] = (0, 255)
    ms[:, 2 * n + 2:] = sj.OP_FLUSH
    ss[:, 2 * n + 2:] = 0
    return ms, ss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=4096)
    ap.add_argument("--blk-bits", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan-blocks", type=int, default=0,
                    help="blocks for the scan coders (0 = all)")
    ap.add_argument("--out", default="chiprun_out/coder_bench.json")
    ap.add_argument("--allow-cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.allow_cpu:
        print("coder_bench: no GPU (use --allow-cpu for a rehearsal)",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp
    import numpy as np

    from sqz_tpu import native
    from sqz_tpu.ops import coder, sqz4_jax
    from sqz_tpu.utils import corpus, devcache
    devcache.enable()
    native.require()
    coder.ensure_registered()

    bits, NB = args.blk_bits, args.blocks
    bs = 1 << bits
    data = corpus.mixed(NB * bs, args.seed)
    res = dict(device=dict(platform=dev.platform, kind=dev.device_kind,
                           count=len(jax.devices())),
               gpu=gpu_info(), blocks=NB, blk_bits=bits,
               input_bytes=len(data))
    if dev.platform == "gpu":
        res["lanes_per_sm"] = coder.cuda_lanes_per_sm()
    print("gpu:", res["gpu"], flush=True)
    cap_words = coder.cap_words_for(bs + 2048)

    # ---- device encoder on staged tokens, literal-only and LZ parses
    native_lit = native.blocks_compress(data, 1, 15, bits, lz=False)
    for mode, lz in (("lit", False), ("lz", True)):
        toks, lits, counts, _mx, _seed = coder.plan_tokens(
            data, bits, 1 << 15, lz, "fast")
        Tt = int(counts[:, 0].max())
        tdev = coder.stage_tokens(jnp.asarray(toks[:, :Tt]))
        ldev = coder.pack_words(jnp.asarray(lits)[None])
        (words, lens), first, best = timed(
            lambda: coder.encode(tdev, ldev, cap_words), args.reps)
        lens_np = np.asarray(lens)
        coder.check_lens(lens_np, cap_words, NB)
        got = coder.unpack_group_payloads(
            coder.fetch_words_trimmed(words, lens_np), lens_np, NB)
        want = native_lit if not lz else native.blocks_compress(
            data, 1, 15, bits, parse="fast")
        assert got == want, f"device encoder ({mode}) diverges from native"
        res[f"enc_{mode}_s"] = best
        res[f"enc_{mode}_first_s"] = first
        res[f"enc_{mode}_ratio"] = sum(map(len, got)) / len(data)
        print(f"device encode {mode}: {best:.4f} s "
              f"({len(data) / best / 1e6:.1f} MB/s)", flush=True)
        if lz:
            lz_payloads = got

    # ---- device decoder (LZ payloads) + the whole host-fed paths
    sizes = [bs] * NB
    dims = coder.decode_dims(bits)
    buf, meta = coder.pack_decode_chunk(lz_payloads, sizes, dims["Pw"])
    bdev = jnp.asarray(buf)
    out, first, best = timed(
        lambda: coder.decode(bdev, meta, dims["lw"], dims["tw"], dims["mw"]),
        args.reps)
    assert int(np.asarray(out[3])[:, 4].max()) == 0, "decoder error lanes"
    res["dec_lz_s"], res["dec_lz_first_s"] = best, first
    print(f"device decode lz: {best:.4f} s "
          f"({len(data) / best / 1e6:.1f} MB/s)", flush=True)
    t0 = time.perf_counter()
    e2e = coder.encode_data(data, bits, 1 << 15, True, cap=bs + 2048)
    res["e2e_encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = coder.decode_groups(e2e, sizes, bits)
    res["e2e_decode_s"] = time.perf_counter() - t0
    assert b"".join(back) == data, "device round trip failed"
    print(f"host-fed encode {res['e2e_encode_s']:.3f} s, decode "
          f"{res['e2e_decode_s']:.3f} s", flush=True)

    # ---- the plain XLA scan coders on the same (literal-only) blocks
    SB = args.scan_blocks or NB
    blocks = np.frombuffer(data, np.uint8)[:SB * bs].reshape(SB, bs)
    ms, ss = lit_microops(blocks)
    cap = 2 * bs + 4096
    enc_scan = jax.jit(sqz4_jax.encode_scan_impl, static_argnums=(2,))
    msd, ssd = jnp.asarray(ms), jnp.asarray(ss)
    del ms, ss
    (pay, plen), first, best = timed(lambda: enc_scan(msd, ssd, cap), 1)
    pay, plen = np.asarray(pay), np.asarray(plen)
    for b in (0, SB // 2, SB - 1):
        assert pay[b, :plen[b]].tobytes() == native_lit[b], \
            f"scan encoder diverges at block {b}"
    del msd, ssd, pay
    res["scan_blocks"] = SB
    res["scan_enc_lit_s"], res["scan_enc_lit_first_s"] = best, first
    print(f"scan encode lit ({SB} blocks): {best:.3f} s "
          f"(first call {first:.3f} s)", flush=True)
    P = max(len(p) for p in native_lit[:SB])
    P = 1 << (P - 1).bit_length()
    pbuf = np.zeros((SB, P), np.uint8)
    for b in range(SB):
        pbuf[b, :len(native_lit[b])] = np.frombuffer(native_lit[b], np.uint8)
    plens = np.asarray([len(p) for p in native_lit[:SB]], np.int32)
    t_max = 17 * bs // 4 + 64
    args_d = (jnp.asarray(pbuf), jnp.asarray(plens),
              jnp.asarray(np.full(SB, bs, np.int32)))
    dout, first, best = timed(
        lambda: sqz4_jax._decode_scan(*args_d, bs, t_max, bs // 2 + 1), 1)
    res["scan_dec_lit_s"], res["scan_dec_lit_first_s"] = best, first
    assert not bool(np.asarray(dout[4]).any()), "scan decoder error"
    assert np.asarray(dout[0])[0, :bs].tobytes() == data[:bs]
    # the device decoder on the same literal-only payloads
    buf_l, meta_l = coder.pack_decode_chunk(native_lit[:SB], [bs] * SB,
                                            dims["Pw"])
    bl = jnp.asarray(buf_l)
    _o, _f, best = timed(lambda: coder.decode(
        bl, meta_l, dims["lw"], dims["tw"], dims["mw"]), args.reps)
    res["dec_lit_s"] = best
    print(f"scan decode lit: {res['scan_dec_lit_s']:.3f} s; "
          f"device decode lit {best:.4f} s", flush=True)

    res["peak_bytes_in_use"] = dev.memory_stats().get("peak_bytes_in_use") \
        if dev.memory_stats() else None
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
