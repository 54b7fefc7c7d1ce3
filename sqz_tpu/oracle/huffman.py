"""Adaptive Huffman tree — scalar oracle (FORMAT.md §1.6).

State machine pinned to reference attic/map_experiment/huffman.h. The tree is
index-based: ``n`` terminals (power of two) occupy ids ``0..n-1``; internal
nodes are carved downward from ``2n-3``; the root is ``2n-2``. Code paths are
stored per node (bit k of ``path`` = branch taken at depth k, 0=left) and
recomputed on restructure, exactly like the reference — this keeps the oracle
observably identical field-by-field, which the device engine tests rely on.
"""

from __future__ import annotations


class AdaptiveHuffman:
    __slots__ = ("n", "m", "freq", "path", "bits", "pix", "lix", "rix",
                 "next", "depth", "complete",
                 "stat_updates", "stat_swaps", "stat_moves")

    def __init__(self, terminals: int) -> None:
        assert terminals >= 8 and (terminals & (terminals - 1)) == 0
        n = terminals
        m = 2 * n - 1
        self.n = n
        self.m = m
        self.freq = [0] * m
        self.path = [0] * m
        self.bits = [0] * m
        self.pix = [-1] * m
        self.lix = [-1] * m
        self.rix = [-1] * m
        self.next = m - 1        # next internal node id (allocated downward)
        self.depth = 0
        self.complete = False
        self.stat_updates = 0
        self.stat_swaps = 0
        self.stat_moves = 0

    # -- path maintenance (huffman.h:41-62) --------------------------------

    def _update_paths(self, i: int) -> None:
        self.stat_updates += 1
        if i == self.m - 1:
            self.depth = 0
        bits, path = self.bits[i], self.path[i]
        lix, rix = self.lix[i], self.rix[i]
        if lix != -1:
            self.bits[lix] = bits + 1
            self.path[lix] = path
            self._update_paths(lix)
        if rix != -1:
            self.bits[rix] = bits + 1
            self.path[rix] = path | (1 << bits)
            self._update_paths(rix)
        if bits > self.depth:
            self.depth = bits

    # -- sibling swap (huffman.h:64-86) -------------------------------------

    def _swap_siblings(self, i: int) -> int:
        if i < self.m - 1:  # not root
            pix = self.pix[i]
            lix, rix = self.lix[pix], self.rix[pix]
            if lix >= 0 and rix >= 0 and self.freq[lix] > self.freq[rix]:
                self.stat_swaps += 1
                self.lix[pix] = rix
                self.rix[pix] = lix
                self._update_paths(pix)
                return rix if i == lix else lix
        return i

    def _update_freq(self, i: int) -> None:
        lix, rix = self.lix[i], self.rix[i]
        self.freq[i] = ((self.freq[lix] if lix >= 0 else 0) +
                        (self.freq[rix] if rix >= 0 else 0))

    # -- move-up restructure (huffman.h:98-128) ------------------------------

    def _move_up(self, ix: int) -> None:
        pix = self.pix[ix]
        gix = self.pix[pix]
        parent_is_left = pix == self.lix[gix]
        psx = self.rix[gix] if parent_is_left else self.lix[gix]  # uncle
        if self.freq[ix] > self.freq[psx]:
            self.stat_moves += 1
            self.pix[ix] = gix
            if parent_is_left:
                self.rix[gix] = ix
            else:
                self.lix[gix] = ix
            self.rix[pix] = psx
            self.pix[psx] = pix
            self._update_freq(pix)
            self._update_freq(gix)
            self._swap_siblings(ix)
            self._swap_siblings(psx)
            self._swap_siblings(pix)
            self._update_paths(gix)
            self._frequency_changed(gix)

    # -- upward frequency propagation (huffman.h:130-147) --------------------

    def _frequency_changed(self, i: int) -> None:
        pix = self.pix[i]
        if pix == -1:  # root
            self._update_freq(i)
            i = self._swap_siblings(i)
        else:
            self._update_freq(pix)
            i = self._swap_siblings(i)
            self._frequency_changed(pix)
        if pix != -1 and self.pix[pix] != -1 and i == self.rix[pix]:
            self._move_up(i)

    # -- public operations ---------------------------------------------------

    def insert(self, i: int) -> bool:
        """First occurrence of terminal ``i`` (huffman.h:149-216)."""
        done = True
        root = self.m - 1
        ipx = root
        self.freq[i] = 1
        while ipx >= self.n:  # descend the left spine to the attach point
            if self.rix[ipx] == -1:
                self.rix[ipx] = i
                self.pix[i] = ipx
                break
            if self.lix[ipx] == -1:
                self.lix[ipx] = i
                self.pix[i] = ipx
                break
            ipx = self.lix[ipx]
        if ipx >= self.n:  # attached to an internal node with a free slot
            self.freq[ipx] += 1
            i = self._swap_siblings(i)
        else:  # the spine ended at a leaf: split it with a new internal node
            if self.next == self.n:
                self.complete = True
                return False
            self.next -= 1
            nix = self.next
            self.freq[nix] = self.freq[ipx]
            self.lix[nix] = ipx
            self.rix[nix] = -1
            self.pix[nix] = self.pix[ipx]
            self.bits[nix] = self.bits[ipx]
            self.path[nix] = self.path[ipx]
            opix = self.pix[ipx]
            if opix != -1:
                if self.lix[opix] == ipx:
                    self.lix[opix] = nix
                else:
                    self.rix[opix] = nix
            self.pix[ipx] = nix
            self.bits[ipx] += 1
            self.path[ipx] = self.path[nix]
            self.rix[nix] = i
            self.pix[i] = nix
            self.bits[i] = self.bits[nix] + 1
            self.path[i] = self.path[nix] | (1 << self.bits[nix])
            self._update_freq(nix)
            ipx = nix
        self._frequency_changed(i)
        self._update_paths(ipx)
        return done

    # -- state snapshot (sqzt v2 warm start, FORMAT.md §3.1) -----------------

    def snapshot(self) -> list:
        """Flat i64 state: [next, depth, complete] + freq + path + bits +
        pix + lix + rix (m entries each) — the engine-portable tree seed."""
        return ([self.next, self.depth, int(self.complete)]
                + self.freq + self.path + self.bits
                + self.pix + self.lix + self.rix)

    def load(self, flat) -> None:
        m = self.m
        assert len(flat) == 3 + 6 * m
        self.next, self.depth = int(flat[0]), int(flat[1])
        self.complete = bool(flat[2])
        f = [int(v) for v in flat[3:]]
        (self.freq, self.path, self.bits, self.pix, self.lix, self.rix) = (
            f[0:m], f[m:2 * m], f[2 * m:3 * m],
            f[3 * m:4 * m], f[4 * m:5 * m], f[5 * m:6 * m])

    def inc_frequency(self, i: int) -> None:
        """Count one more occurrence of terminal ``i`` (huffman.h:218-235)."""
        if self.pix[i] == -1:
            self.insert(i)
        elif not self.complete and self.depth < 63 and self.freq[i] < (1 << 64) - 2:
            self.freq[i] += 1
            self._frequency_changed(i)
        else:
            self.complete = True
