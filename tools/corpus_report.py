"""Compression-ratio report over the reference corpus — the BASELINE
evidence table (compressed size vs the reference C codecs). Files absent
from SQZ_CORPUS_DIR are replaced by their seeded stand-ins
(utils/corpus.load), so the table always prints.

Byte-identity with the compiled reference is enforced by the golden tests;
this report records the sizes and the block-parallel container overhead.
The reference's published number (attic test.c:34-35): bible.txt
4,436,173 -> 1,451,352 B (32.7%) with the squeeze format at win_bits=15
(bible.txt is absent from the mount — scripts/fetch_corpus.py).
"""
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqz_tpu.utils import devcache  # one persistent XLA cache with bench.py

devcache.enable()

from sqz_tpu import native
from sqz_tpu.utils import corpus
import sqz_tpu

def main():
    rows = []
    for name in corpus.CORPUS_FILES:
        data = corpus.load(name)
        sq = native.squeeze_compress(data, win_bits=15)
        s4 = native.sqz4_compress(data, window=1 << 15, lz=True)
        sqt = sqz_tpu.compress(data, fmt="squeeze", engine="native",
                               blocks=True, blk_bits=16)
        rows.append((name, len(data), len(sq), len(s4), len(sqt)))

    print(f"{'file':14s} {'bytes':>9s} {'squeeze':>9s} {'%':>6s} "
          f"{'sqz4':>9s} {'%':>6s} {'sqzt64K':>9s} {'%':>6s}")
    for name, n, sq, s4, sqt in rows:
        print(f"{name:14s} {n:9d} {sq:9d} {100*sq/n:6.1f} "
              f"{s4:9d} {100*s4/n:6.1f} {sqt:9d} {100*sqt/n:6.1f}")
    t = [sum(c) for c in zip(*[(n, sq, s4, sqt) for _, n, sq, s4, sqt in rows])]
    print(f"{'TOTAL':14s} {t[0]:9d} {t[1]:9d} {100*t[1]/t[0]:6.1f} "
          f"{t[2]:9d} {100*t[2]/t[0]:6.1f} {t[3]:9d} {100*t[3]/t[0]:6.1f}")
    print("\nsqueeze/sqz4 single-block sizes are byte-identical to the compiled"
          "\nreference codecs (tests/test_reference_golden.py); sqzt adds the"
          "\n32-byte header + 8 B/block table + 8 B checksum and fresh per-block"
          "\nmodel state (the parallelism trade).")


if __name__ == "__main__":
    main()
