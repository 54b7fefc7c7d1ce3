"""Drive the codec's device path once on one GPU, through the public API,
at deployment sizes, and check every result against the plain reference
(the native host codec, byte for byte).

    python chip_smoke.py           # phases a-g on one GPU
    python chip_smoke.py --four    # only the sharded paths, on a 1-D mesh
                                   # over four GPUs, vs the one-device path

GPU only: with no GPU (or no buildable CUDA coder library) it exits
non-zero before printing a result. Every phase runs the CUDA coders as
compiled for the card. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.

Phases (data generated from --seed: a committed snapshot of the
repository's own sources (fixtures/text.txt) tiled, seeded prose,
incompressible and zero-heavy bytes; nothing downloaded):
  a  build the host and CUDA libraries, check the platform
  b  host-fed sqz4, 256 MiB in 64 KiB blocks: compress/decompress with
     engine="tpu"; container byte-identical to engine="native" (same
     parse); native decodes the device container
  c  a warm (sqzt v2) container, round-tripped the same way
  d  device-resident 256 MiB: compress_resident lit/rle/lz ->
     decompress_resident, equal on the device, and native decodes each
  e  a >= 1 GiB training-checkpoint pytree through save_pytree /
     load_pytree, restored bit-exact
  f  squeeze through engine="tpu", round-tripped
  g  100 seeded corrupt mutants: the device decoder produces or rejects
     exactly as the native decoder does
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

MIB = 1 << 20
BLK_BITS = 16


def log(msg: str):
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[{self.name}] start")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        if exc_type is None:
            log(f"[{self.name}] ok {dt:.3f} s")
        else:
            log(f"[{self.name}] FAILED after {dt:.3f} s: {exc!r}")
        return False


def mbps(nbytes: int, seconds: float) -> str:
    return f"{nbytes / seconds / 1e6:.1f} MB/s"


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def phase_a():
    """Build both libraries and refuse anything but a GPU."""
    import jax

    from sqz_tpu import native
    from sqz_tpu.ops import coder
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{dev.platform!r}); nothing is run on the CPU")
    native.require()
    coder.ensure_registered()         # builds and registers the CUDA target
    log(f"gpu: {gpu_line()}")
    sms = getattr(dev, "core_count", None)
    ctas = -(-coder.DEC_LANES // 32)          # 32-thread CTAs per dispatch
    log(f"jax devices: {len(jax.devices())} x {dev.device_kind}, {sms} SMs; "
        f"coder lanes resident per SM: {coder.cuda_lanes_per_sm()} "
        f"(occupancy limit); a {coder.DEC_LANES}-block dispatch launches "
        f"{ctas} CTAs of 32 lanes")
    return dev


def phase_b(data: bytes):
    import sqz_tpu
    kw = dict(fmt="sqz4", blocks=True, blk_bits=BLK_BITS, parse="fast")
    blob, t = timed(lambda: sqz_tpu.compress(data, engine="tpu", **kw))
    log(f"  device-engine compress {len(data) // MIB} MiB: {t:.3f} s "
        f"({mbps(len(data), t)}), ratio {len(blob) / len(data):.4f}")
    ref, t = timed(lambda: sqz_tpu.compress(data, engine="native", **kw))
    log(f"  native compress: {t:.3f} s ({mbps(len(data), t)})")
    assert blob == ref, "device container differs from the native one"
    back, t = timed(lambda: sqz_tpu.decompress(blob, engine="tpu"))
    log(f"  device-engine decompress: {t:.3f} s ({mbps(len(data), t)})")
    assert back == data, "device round trip failed"
    back, t = timed(lambda: sqz_tpu.decompress(blob, engine="native"))
    log(f"  native decompress: {t:.3f} s ({mbps(len(data), t)})")
    assert back == data, "native decode of the device container failed"
    return blob


def phase_c(data: bytes):
    import sqz_tpu
    kw = dict(fmt="sqz4", blocks=True, blk_bits=BLK_BITS, parse="fast",
              warm=True)
    blob, t = timed(lambda: sqz_tpu.compress(data, engine="tpu", **kw))
    log(f"  device-engine warm compress {len(data) // MIB} MiB: {t:.3f} s, "
        f"ratio {len(blob) / len(data):.4f}")
    assert blob == sqz_tpu.compress(data, engine="native", **kw), \
        "device warm container differs from the native one"
    back, t = timed(lambda: sqz_tpu.decompress(blob, engine="tpu"))
    log(f"  device-engine warm decompress: {t:.3f} s")
    assert back == data, "device warm round trip failed"
    assert sqz_tpu.decompress(blob, engine="native") == data


def phase_d(data: bytes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import sqz_tpu
    arr = jax.device_put(np.frombuffer(data, np.uint8))
    for mode in ("lit", "rle", "lz"):
        blob, t = timed(lambda: sqz_tpu.compress_resident(
            arr, blk_bits=BLK_BITS, mode=mode))
        log(f"  resident {mode}: compress {t:.3f} s "
            f"({mbps(len(data), t)}), ratio {len(blob) / len(data):.4f}")
        out, t = timed(lambda: jax.block_until_ready(
            sqz_tpu.decompress_resident(blob)))
        log(f"  resident {mode}: restore {t:.3f} s ({mbps(len(data), t)})")
        assert bool(jnp.array_equal(out, arr)), f"resident {mode} differs"
        assert sqz_tpu.decompress(blob, engine="native") == data, \
            f"native decode of the resident {mode} container failed"


def checkpoint_tree(seed: int):
    """A training state of 79.7M parameters, 1.12 GB in all: bf16 params,
    f32 master weights, and Adam m/v in which 90% of the rows were never
    touched (zero). Shapes: embedding (32768, 1024); 4 layers of
    attention (1024, 3072), MLP in (1024, 4096) and out (4096, 1024)."""
    import jax
    import jax.numpy as jnp
    shapes = {"embed": (32768, 1024), "attn": (4, 1024, 3072),
              "mlp_in": (4, 1024, 4096), "mlp_out": (4, 4096, 1024)}
    keys = jax.random.split(jax.random.PRNGKey(seed), 3 * len(shapes))
    tree = {}
    for i, (name, shp) in enumerate(shapes.items()):
        master = 0.02 * jax.random.normal(keys[3 * i], shp, jnp.float32)
        rows = jax.random.uniform(keys[3 * i + 1], shp[:-1] + (1,)) < 0.1
        m = jnp.where(rows, 1e-3 * jax.random.normal(keys[3 * i + 2], shp),
                      0.0).astype(jnp.float32)
        tree[name] = {"param": master.astype(jnp.bfloat16),
                      "master": master, "adam_m": m, "adam_v": m * m}
    return tree


def phase_e(seed: int):
    import jax
    import jax.numpy as jnp

    from sqz_tpu.utils import checkpoint
    tree = jax.block_until_ready(checkpoint_tree(seed))
    raw = sum(x.nbytes for x in jax.tree_util.tree_leaves(tree))
    assert raw >= 1 << 30, raw
    tmp = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "state.sqzckpt")
    try:
        stats, t = timed(lambda: checkpoint.save_pytree(tree, path))
        log(f"  save_pytree {raw / 1e9:.3f} GB: {t:.3f} s "
            f"({mbps(raw, t)}), ratio {stats['ratio']:.4f}")
        back, t = timed(lambda: jax.block_until_ready(
            checkpoint.load_pytree(path)))
        log(f"  load_pytree: {t:.3f} s ({mbps(raw, t)})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        bits = jnp.uint16 if a.dtype.itemsize == 2 else jnp.uint32
        assert bool(jnp.array_equal(jax.lax.bitcast_convert_type(a, bits),
                                    jax.lax.bitcast_convert_type(b, bits))), \
            "checkpoint leaf not restored bit-exact"


def phase_f(data: bytes):
    import sqz_tpu
    kw = dict(fmt="squeeze", blocks=True, blk_bits=BLK_BITS, parse="fast")
    blob, t = timed(lambda: sqz_tpu.compress(data, engine="tpu", **kw))
    log(f"  squeeze device-engine compress {len(data) // MIB} MiB: {t:.3f} s, ratio "
        f"{len(blob) / len(data):.4f}")
    assert blob == sqz_tpu.compress(data, engine="native", **kw)
    back, t = timed(lambda: sqz_tpu.decompress(blob, engine="tpu"))
    log(f"  squeeze device-engine decompress: {t:.3f} s")
    assert back == data, "squeeze round trip failed"


def phase_g(blob: bytes, seed: int, n: int = 100):
    import jax.numpy as jnp
    import numpy as np

    from sqz_tpu import native
    from sqz_tpu.formats import container
    from sqz_tpu.ops import coder
    _f, _w, bits, osize, payloads, _c, _fr, _a = container.unpack(blob)
    bs = 1 << bits
    rng = np.random.default_rng(seed)
    mutants, sizes = [], []
    for i in range(n):
        b = int(rng.integers(0, len(payloads)))
        m = bytearray(payloads[b])
        if i % 5 == 0:
            # the last bytes follow the flush: such mutants often still
            # decode, which checks the produce side of the agreement
            m[-1 - int(rng.integers(0, 2))] ^= int(rng.integers(1, 256))
        else:
            for _ in range(int(rng.integers(1, 4))):
                m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
            if rng.random() < 0.2:
                m = m[:int(rng.integers(1, len(m)))]
        mutants.append(bytes(m))
        sizes.append(min(bs, osize - b * bs))
    dims = coder.decode_dims(bits)
    buf, meta = coder.pack_decode_chunk(mutants, sizes, dims["Pw"])
    res = coder.decode(jnp.asarray(buf), meta, dims["lw"], dims["tw"],
                       dims["mw"])
    lt, tt, mt, cnt = coder.fetch_decode_host(res)
    rejected = 0
    for i, m in enumerate(mutants):
        try:
            want = native.sqz4_decompress_payload(m, sizes[i])
            want = want if len(want) == sizes[i] else None
        except OSError:
            want = None
        try:
            got = coder.postprocess_decode(
                lt[:, i:i + 1], tt[:, i:i + 1], mt[:, i:i + 1],
                cnt[:, :, i:i + 1], [m], [sizes[i]], bs)[0]
        except ValueError:
            got = None
        assert got == want, f"mutant {i}: device and native disagree"
        rejected += want is None
    log(f"  {n} mutants: {rejected} rejected by both, {n - rejected} "
        f"decoded identically")


def four(data: bytes, seed: int):
    """The sharded paths on a 1-D mesh over four GPUs, each compared byte
    for byte with the one-device path."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import sqz_tpu
    from sqz_tpu.utils import checkpoint
    if len(jax.devices()) < 4:
        raise SystemExit("chip_smoke --four: needs four GPUs")
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("blocks",))
    arr = jax.device_put(np.frombuffer(data, np.uint8), jax.devices()[0])
    for mode in ("rle", "lz"):
        with Phase(f"four-{mode}"):
            sharded, t = timed(lambda: sqz_tpu.compress_resident(
                arr, blk_bits=BLK_BITS, mode=mode, mesh=mesh))
            log(f"  sharded {mode} compress: {t:.3f} s "
                f"({mbps(len(data), t)})")
            single, t = timed(lambda: sqz_tpu.compress_resident(
                arr, blk_bits=BLK_BITS, mode=mode))
            log(f"  one-device {mode} compress: {t:.3f} s")
            assert sharded == single, f"sharded {mode} payloads differ"
            out, t = timed(lambda: jax.block_until_ready(
                sqz_tpu.decompress_resident(sharded, mesh=mesh)))
            log(f"  sharded {mode} restore: {t:.3f} s")
            assert np.asarray(out).tobytes() == data
    with Phase("four-checkpoint"):
        tree = jax.block_until_ready(checkpoint_tree(seed))
        tmp = os.path.join(ROOT, "build", "chip_smoke")
        os.makedirs(tmp, exist_ok=True)
        try:
            p4, p1 = (os.path.join(tmp, f"s{k}.sqzckpt") for k in (4, 1))
            _s, t = timed(lambda: checkpoint.save_pytree(tree, p4,
                                                         mesh=mesh))
            log(f"  sharded save_pytree: {t:.3f} s")
            checkpoint.save_pytree(tree, p1)
            with open(p4, "rb") as f4, open(p1, "rb") as f1:
                assert f4.read() == f1.read(), "sharded checkpoint differs"
            back = checkpoint.load_pytree(p4, mesh=mesh)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            bits = jnp.uint16 if a.dtype.itemsize == 2 else jnp.uint32
            assert bool(jnp.array_equal(
                jax.lax.bitcast_convert_type(a, bits),
                jax.lax.bitcast_convert_type(jnp.asarray(b), bits)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=256,
                    help="input size of phases b and d (MiB)")
    args = ap.parse_args(argv)

    from sqz_tpu.utils import corpus, devcache
    devcache.enable()
    with Phase("a-build"):
        dev = phase_a()
    import jax
    with Phase("data"):
        data = corpus.mixed(args.mib * MIB, args.seed)
    if args.four:
        four(data, args.seed)
    else:
        with Phase("b-host-fed"):
            blob = phase_b(data)
        with Phase("c-warm"):
            phase_c(data[:64 * MIB])
        with Phase("d-resident"):
            phase_d(data)
        with Phase("e-checkpoint"):
            phase_e(args.seed)
        with Phase("f-squeeze"):
            phase_f(data[:64 * MIB])
        with Phase("g-mutants"):
            phase_g(blob, args.seed)
    stats = dev.memory_stats() or {}
    log(f"peak device memory: {stats.get('peak_bytes_in_use')} bytes")
    log(f"gpu: {gpu_line()}")
    count = 4 if args.four else len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
