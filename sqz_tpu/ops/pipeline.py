"""Pipelined sqz4 encode: overlap the host token planning, host<->device
transfers and the device coder (VERDICT r2 #1 / ROADMAP r2 #3). The
decode side's overlap lives in coder.decode_groups, which overlaps chunk
c's download + assembly with chunk c+1's decode.

The serial engine runs plan -> upload -> code -> download -> unpack per
call, so the device idles during the host stages and vice versa. Here the
input is split into GROUPS of ``lanes`` blocks and a planner thread keeps
planning group k+1 while the device codes group k; JAX's async dispatch
queues uploads and coder calls without blocking, and per-group downloads
drain while later groups still compute (ctypes releases the GIL around
the native planner, which is itself block-threaded).

Streams are identical to the non-pipelined path with the same ``parse``
mode — grouping only batches coder dispatches; each block's parse and
model state are unchanged (blocks are independent, SURVEY §2.6).
"""

from __future__ import annotations

import queue
import threading
from typing import List

import numpy as np


def encode_data_pipelined(data: bytes, blk_bits: int, window: int, lz: bool,
                          cap: int, parse: str = "auto", lanes: int = None,
                          stats: dict = None) -> List[bytes]:
    """Whole-buffer cold sqz4 encode with host/device overlap. Returns
    per-block payloads (the contract of coder.encode_data).

    ``stats``: optional dict; filled with per-stage active wall seconds
    (VERDICT r3 #4): plan_s (planner thread: native parse), wait_plan_s
    (main thread starved for plans), dispatch_s (uploads + coder dispatch,
    async), fence_s (blocked on device results), fetch_s (payload
    download + unpack), wall_s. Stages overlap — their sum exceeding
    wall_s measures the pipelining."""
    import time

    from sqz_tpu.ops import coder

    st = stats if stats is not None else {}
    for k in ("plan_s", "wait_plan_s", "dispatch_s", "fence_s", "fetch_s"):
        st[k] = 0.0
    t_wall0 = time.perf_counter()
    if lanes is None:
        lanes = coder.ENC_LANES
    bs = 1 << blk_bits
    NB = max(1, -(-len(data) // bs))
    G = -(-NB // lanes)
    gbytes = bs * lanes                      # input bytes per group
    cap_words = coder.cap_words_for(cap)

    # ---- stage 1 (planner thread): plan one group at a time; a depth-2
    # queue keeps at most one planned-but-undispatched group in memory
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()                 # set on main-loop failure

    def planner():
        try:
            for g in range(G):
                if stop.is_set():
                    break
                t_g0 = time.perf_counter()
                chunk = data[g * gbytes:(g + 1) * gbytes]
                toks, lits, counts, _mx, _seed = coder.plan_tokens(
                    chunk, blk_bits, window, lz, parse)
                st["plan_s"] += time.perf_counter() - t_g0
                q.put((toks, lits, counts))
        except BaseException as e:          # surface planner errors
            q.put(e)
            return
        q.put(None)

    t = threading.Thread(target=planner, daemon=True)
    t.start()

    # ---- stage 2 (main thread): upload + dispatch per group (async), then
    # drain results in order — downloads overlap later groups' compute
    pending = []
    try:
        while True:
            t_q0 = time.perf_counter()
            item = q.get()
            st["wait_plan_s"] += time.perf_counter() - t_q0
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            t_d0 = time.perf_counter()
            toks, lits, counts = item
            words, lens = coder.dispatch_tokens(toks, lits, counts,
                                                cap_words)
            pending.append((len(counts), words, lens))
            st["dispatch_s"] += time.perf_counter() - t_d0
    except BaseException:
        # cancel + unblock the planner (bounded queue) so the thread exits
        # after at most its current group instead of planning the rest
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        raise

    payloads: List[bytes] = []
    for nb, words, lens in pending:
        t_f0 = time.perf_counter()
        lens_np = np.asarray(lens)           # fence: device results
        st["fence_s"] += time.perf_counter() - t_f0
        coder.check_lens(lens_np, cap_words, nb)
        t_f0 = time.perf_counter()
        payloads.extend(coder.unpack_group_payloads(
            coder.fetch_words_trimmed(words, lens_np), lens_np, nb))
        st["fetch_s"] += time.perf_counter() - t_f0
    t.join()
    st["wall_s"] = time.perf_counter() - t_wall0
    return payloads

