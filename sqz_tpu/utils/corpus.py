"""Test-corpus access and synthetic inputs.

``load(name)`` reads the reference corpus from SQZ_CORPUS_DIR when that
directory holds the file; otherwise it returns a seeded stand-in of the
same kind (text or binary), generated here, so tests and tools run with
no corpus at all. Synthetic generators cover the edge cases the reference
harness exercises (attic/map_experiment/test.c:198-217).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

REFERENCE_TEST_DIR = Path(os.environ.get(
    "SQZ_CORPUS_DIR", "/root/reference/test"))

CORPUS_FILES = [
    "bible.txt", "hhgttg.txt", "confucius.txt", "laozi.txt",
    "sqlite3.c", "arm64.elf", "x64.elf", "mandrill.bmp", "mandrill.png",
]


def available_corpus() -> list[Path]:
    return [REFERENCE_TEST_DIR / f for f in CORPUS_FILES
            if (REFERENCE_TEST_DIR / f).exists()]


def load(name: str) -> bytes:
    path = REFERENCE_TEST_DIR / name
    if path.exists():
        return path.read_bytes()
    return standin(name)


_TEXT_SUFFIXES = (".txt", ".c", ".h", ".md")


def standin(name: str, n: int = 1 << 17) -> bytes:
    """Seeded stand-in for a corpus file, deterministic per name. Text
    names get a slice of fixture_text() (real code and prose, 60-90 KB, so
    tiling it gives a period longer than the 32 KiB window and not aligned
    to a block, as the corpus texts do); other
    names get structured binary (runs, small integers, repeated records
    and noise) of ``n`` bytes."""
    seed = sum((i + 1) * c for i, c in enumerate(name.encode()))
    rng = np.random.default_rng(seed)
    if name.endswith(_TEXT_SUFFIXES):
        src = fixture_text()
        size = int(rng.integers(60_000, 90_000))
        off = int(rng.integers(0, len(src) - size))
        return src[off:off + size]
    parts, size = [], 0
    while size < n:
        kind = int(rng.integers(0, 4))
        k = int(rng.integers(64, 2048))
        if kind == 0:
            chunk = bytes([int(rng.integers(0, 256))]) * k
        elif kind == 1:
            chunk = rng.integers(0, 16, k, dtype=np.uint8).tobytes()
        elif kind == 2 and parts:
            chunk = parts[int(rng.integers(0, len(parts)))]
        else:
            chunk = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        parts.append(chunk)
        size += len(chunk)
    return b"".join(parts)[:n]


_VOCAB = (b"the of and to in a is that for it as was with be by on not he "
          b"this are or his from at which but have an they you were her "
          b"all she there would their we him been has when who will more "
          b"no if out so said what up its about into than them can only "
          b"other new some could time these two may then do first any my "
          b"now such like our over man me even most made after also did "
          b"many before must through back years where much your way well "
          b"down should because each just those people how too little "
          b"state good very make world still own see men work long get "
          b"here between both life being under never day same another "
          b"know while last might us great old year off come since against "
          b"go came right used take three master heaven way virtue sage "
          b"ruler people govern water mountain river spring autumn").split()


def prose(n: int, seed: int = 0) -> bytes:
    """Prose-like text: Zipf-weighted words, sentences and paragraphs."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, len(_VOCAB) + 1)
    idx = rng.choice(len(_VOCAB), size=n // 3 + 64, p=w / w.sum())
    out, size, k = [], 0, 0
    while size < n:
        slen = int(rng.integers(4, 18))
        words = [_VOCAB[i] for i in idx[k:k + slen]]
        k = (k + slen) % (len(idx) - 32)
        sent = b" ".join(words).capitalize() + b". "
        if rng.random() < 0.12:
            sent += b"\n\n"
        out.append(sent)
        size += len(sent)
    return b"".join(out)[:n]


def zeros(n: int = 4096) -> bytes:
    return b"\x00" * n


def rle4(n: int = 4096) -> bytes:
    """4-byte repeating pattern — stresses overlapped backrefs."""
    return (b"\x01\x02\x03\x04" * ((n + 3) // 4))[:n]


def hello() -> bytes:
    return b"Hello World Hello.World Hello World"


def random_bytes(n: int, seed: int = 0) -> bytes:
    """Incompressible stress input."""
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def texty(n: int, seed: int = 0) -> bytes:
    """Compressible pseudo-text with repeated words."""
    rng = np.random.default_rng(seed)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
             b"dog", b"compression", b"squeeze", b"window", b"huffman"]
    parts = []
    size = 0
    # size counts a separator per word but join emits k-1 of them, so the
    # joined text is size-1 bytes: run until it covers n exactly
    while size - 1 < n:
        w = words[int(rng.integers(0, len(words)))]
        parts.append(w)
        size += len(w) + 1
    out = b" ".join(parts)[:n]
    assert len(out) == n
    return out


_FIXTURE_TEXT = Path(__file__).resolve().parents[2] / "fixtures" / "text.txt"


def fixture_text() -> bytes:
    """Real text, 133 KB: a frozen snapshot of the repository's own sources
    (the native codec, the coder header, oracle modules, snippet notes).
    It is a committed file (``fixtures/text.txt`` in a checkout), not read
    from the live sources, so the same seed gives the same bytes in every
    revision of the repository."""
    return _FIXTURE_TEXT.read_bytes()


def mixed(n: int, seed: int = 0, chunk: int = 1 << 16) -> bytes:
    """Seeded general-content input for chip_smoke.py and the coder
    benchmark: ``chunk``-sized pieces drawn from fixture_text() (tiled),
    prose(), incompressible bytes and zero-heavy records,
    in seeded order and at seeded offsets. Built in bulk (pools sliced),
    so hundreds of MiB take seconds."""
    rng = np.random.default_rng(seed)
    src = fixture_text()
    src = src * max(1, -(-4 * chunk // max(len(src), 1)))
    text = prose(4 << 20, seed)
    nchunks = -(-n // chunk)
    kinds = rng.choice(4, size=nchunks, p=[0.4, 0.3, 0.15, 0.15])
    out = np.empty(nchunks * chunk, np.uint8)
    for i, k in enumerate(kinds):
        dst = out[i * chunk:(i + 1) * chunk]
        if k == 0:
            o = int(rng.integers(0, len(src) - chunk))
            dst[:] = np.frombuffer(src, np.uint8, chunk, o)
        elif k == 1:
            o = int(rng.integers(0, len(text) - chunk))
            dst[:] = np.frombuffer(text, np.uint8, chunk, o)
        elif k == 2:
            dst[:] = rng.integers(0, 256, chunk, dtype=np.uint8)
        else:
            rec = rng.integers(0, 256, (chunk // 64, 64), dtype=np.uint8)
            rec[rng.random(chunk // 64) < 0.7] = 0
            rec[:, 8:] &= rng.integers(0, 2, (chunk // 64, 56),
                                       dtype=np.uint8) * 255
            dst[:] = rec.reshape(-1)
    return out[:n].tobytes()
