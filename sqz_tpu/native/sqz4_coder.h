// sqz4 range coder shared by the host codec (sqz_native.cpp) and the
// device coders (sqz4_ffi.cc on the CPU, sqz4_ffi.cu on the GPU).
//
// One definition of the coder step (FORMAT.md §2.2-§2.3) serves every
// engine: the host codec calls enc_op/dec_begin/dec_end around its own
// Fenwick models; the device coders run whole blocks through
// encode_lane/decode_lane, one block per thread, with the adaptive models
// in a 610-word table (the ModelSeed order, FORMAT.md §3.1) that the
// caller places (CUDA: shared memory, one column per thread; CPU: a
// stack array). Integer-only: payloads are byte-identical across engines.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define SQZ4_HD __host__ __device__ __forceinline__
#else
#define SQZ4_HD inline
#endif

namespace sqz4 {

constexpr uint64_t kMask64 = ~0ull;
constexpr int kMinLen = 2, kMaxLen = 254, kEos = 0xFF;

// device decoder error codes (counts row 4); 0 = ok
enum : int32_t { kOk = 0, kEIlseq = 1, kESize = 2, kEDist = 4, kEOverrun = 5 };

// ---------------------------------------------------------------- coder

struct Enc {
    uint64_t low = 0, range = kMask64;
};

struct Dec {
    uint64_t low = 0, range = kMask64, code = 0;
};

// Code one symbol with model statistics (start, size, total). Returns
// false when renormalisation would never end: nine equal top bytes in a
// row mean range has shifted down to 0, where the reference loops
// forever — only inconsistent statistics reach it.
template <class Emit>
SQZ4_HD bool enc_op(Enc& e, uint64_t start, uint64_t size, uint64_t total,
                    Emit&& emit) {
    e.range /= total;
    e.low += start * e.range;
    e.range *= size;
    for (int n = 0; (e.low >> 56) == ((e.low + e.range) >> 56); n++) {
        if (n == 8) return false;
        emit(static_cast<uint32_t>(e.low >> 56));
        e.low <<= 8;
        e.range <<= 8;
    }
    if (e.range < total + 1) {
        for (int k = 0; k < 2; k++) {
            emit(static_cast<uint32_t>(e.low >> 56));
            e.low <<= 8;
            e.range <<= 8;
        }
        e.range = kMask64 - e.low;
    }
    return true;
}

template <class Emit>
SQZ4_HD void enc_flush(Enc& e, Emit&& emit) {
    for (int i = 0; i < 8; i++) {
        e.range = kMask64;
        emit(static_cast<uint32_t>(e.low >> 56));
        e.low <<= 8;
    }
}

template <class Next>
SQZ4_HD void dec_consume(Dec& d, Next&& next) {
    d.code = (d.code << 8) + next();
    d.low <<= 8;
    d.range <<= 8;
}

template <class Next>
SQZ4_HD void dec_prime(Dec& d, Next&& next) {
    for (int i = 0; i < 8; i++) d.code = (d.code << 8) + next();
}

// First half of a decode step: returns range / total, 0 on a corrupt
// state. The caller looks up cum = (code - low) / r in its model.
// The reference divides first and maps range < total to EILSEQ later
// (src/sqz.c:536-541); a zero quotient is rejected up front here.
template <class Next>
SQZ4_HD uint64_t dec_begin(Dec& d, uint64_t total, Next&& next) {
    if (total < 1) return 0;
    if (d.range < total) {
        dec_consume(d, next);
        dec_consume(d, next);
        d.range = kMask64 - d.low;
    }
    return d.range / total;
}

SQZ4_HD uint64_t dec_cum(const Dec& d, uint64_t r) {
    return (d.code - d.low) / r;
}

// Second half: narrow to the decoded symbol and renormalise (false on
// the never-ending renormalisation enc_op also rejects).
template <class Next>
SQZ4_HD bool dec_end(Dec& d, uint64_t r, uint64_t start, uint64_t size,
                     Next&& next) {
    d.range = r;
    d.low += start * r;
    d.range *= size;
    for (int n = 0; (d.low >> 56) == ((d.low + d.range) >> 56); n++) {
        if (n == 8) return false;
        dec_consume(d, next);
    }
    return true;
}

// --------------------------------------------------------------- models
//
// Table words (610, the ModelSeed order): literal freqs [0, 2), size
// Fenwick tree [2, 258), byte Fenwick tree [258, 514), bits Fenwick tree
// [514, 546), dist freq0 [546, 578), dist freq1 [578, 610). Fenwick
// nodes are 0-based (node i covers (i - lowbit(i+1), i]), so a model's
// total is its last node. Counts stay below 2^32 for blocks < 2^31
// bytes, far under the reference's 2^56 update cap.

enum : int {
    kLit = 0, kSize = 2, kByte = 258, kBits = 514, kD0 = 546, kD1 = 578,
    kTabWords = 610
};

template <class T>
SQZ4_HD uint32_t fw_prefix(T& t, int base, int i) {
    uint32_t s = 0;
    for (int k = i - 1; k >= 0; k -= (k + 1) & -(k + 1)) s += t(base + k);
    return s;
}

template <class T>
SQZ4_HD void fw_inc(T& t, int base, int n, int i) {
    for (int k = i; k < n; k += (k + 1) & -(k + 1)) t(base + k) += 1;
}

template <class T>
SQZ4_HD void fw_build(T& t, int base, int n, const uint32_t* f) {
    for (int i = 0; i < n; i++) t(base + i) = f ? f[i] : 1u;
    for (int i = 1; i <= n; i++) {
        int parent = i + (i & -i);
        if (parent <= n) t(base + parent - 1) += t(base + i - 1);
    }
}

// seed: flat ModelSeed (610 u32) or nullptr for the fresh models
template <class T>
SQZ4_HD void tab_init(T& t, const uint32_t* seed) {
    t(kLit) = seed ? seed[0] : 1u;
    t(kLit + 1) = seed ? seed[1] : 1u;
    fw_build(t, kSize, 256, seed ? seed + kSize : nullptr);
    fw_build(t, kByte, 256, seed ? seed + kByte : nullptr);
    fw_build(t, kBits, 32, seed ? seed + kBits : nullptr);
    for (int b = 0; b < 32; b++) {
        t(kD0 + b) = seed ? seed[kD0 + b] : 1u;
        t(kD1 + b) = seed ? seed[kD1 + b] : 1u;
    }
}

// model ids as in FORMAT.md §2.2: 0 literal, 1 size, 2 byte, 3 bits,
// 4 + k distance bit k
SQZ4_HD int fw_base(int model) {
    return model == 1 ? kSize : model == 2 ? kByte : kBits;
}

SQZ4_HD int fw_n(int model) { return model == 3 ? 32 : 256; }

template <class T>
SQZ4_HD void binary_freqs(T& t, int model, uint32_t& f0, uint32_t& f1) {
    if (model == 0) {
        f0 = t(kLit);
        f1 = t(kLit + 1);
    } else {
        f0 = t(kD0 + model - 4);
        f1 = t(kD1 + model - 4);
    }
}

template <class T>
SQZ4_HD void binary_inc(T& t, int model, int sym) {
    if (model == 0) t(kLit + sym) += 1;
    else t((sym ? kD1 : kD0) + model - 4) += 1;
}

template <class T, class Emit>
SQZ4_HD bool enc_sym(Enc& e, T& t, int model, int sym, Emit&& emit) {
    uint64_t start, size, total;
    if (model == 0 || model >= 4) {
        uint32_t f0, f1;
        binary_freqs(t, model, f0, f1);
        start = sym ? f0 : 0;
        size = sym ? f1 : f0;
        total = uint64_t(f0) + f1;
        binary_inc(t, model, sym);
    } else {
        const int base = fw_base(model), n = fw_n(model);
        start = fw_prefix(t, base, sym);
        size = fw_prefix(t, base, sym + 1) - start;
        total = t(base + n - 1);
        fw_inc(t, base, n, sym);
    }
    return enc_op(e, start, size, total, emit);
}

// Decode one symbol of `model`; false on a corrupt stream (EILSEQ).
template <class T, class Next>
SQZ4_HD bool dec_sym(Dec& d, T& t, int model, Next&& next, int& sym) {
    uint64_t total, start, size;
    const bool binary = model == 0 || model >= 4;
    uint32_t f0 = 0, f1 = 0;
    int base = 0, n = 0;
    if (binary) {
        binary_freqs(t, model, f0, f1);
        total = uint64_t(f0) + f1;
    } else {
        base = fw_base(model);
        n = fw_n(model);
        total = t(base + n - 1);
    }
    const uint64_t r = dec_begin(d, total, next);
    if (r == 0) return false;
    const uint64_t cum = dec_cum(d, r);
    if (cum >= total) return false;
    if (binary) {
        sym = cum >= f0 ? 1 : 0;
        start = sym ? f0 : 0;
        size = sym ? f1 : f0;
        binary_inc(t, model, sym);
    } else {
        // Fenwick descent: the largest i with prefix(i) <= cum
        uint32_t value = static_cast<uint32_t>(cum);
        int i = 0;
        for (int mask = n >> 1; mask != 0; mask >>= 1) {
            const uint32_t node = t(base + i + mask - 1);
            if (value >= node) {
                i += mask;
                value -= node;
            }
        }
        start = cum - value;
        size = fw_prefix(t, base, i + 1) - start;
        sym = i;
        fw_inc(t, base, n, i);
    }
    if (size == 0) return false;
    return dec_end(d, r, start, size, next);
}

// ----------------------------------------------------------- block loops
//
// Token words (native sqz4_tok_plan):
//   bits 0..7   literal-run count (1..255) | match len (2..254) | 255 EOS
//   bit  8      1 = match / EOS, 0 = literal run
//   bits 9..13  match distance bit-length (1..15)
//   bits 16..30 match distance (< 2^15)
//   0           no further tokens (a lane without a block codes nothing)
// lit_skip: the literal stream is the raw block, so a match also moves
// the literal cursor past the bytes it covers.
template <class T, class TokAt, class LitAt, class Emit>
SQZ4_HD bool encode_tokens(T& t, TokAt&& tok_at, int64_t ntok,
                           LitAt&& lit_at, bool lit_skip, Emit&& emit) {
    Enc e;
    int64_t li = 0;
    for (int64_t i = 0; i < ntok; i++) {
        const uint32_t tok = tok_at(i);
        if (tok == 0) return true;
        const int cnt = tok & 0xFF;
        if (((tok >> 8) & 1) == 0) {
            for (int k = 0; k < cnt; k++) {
                if (!enc_sym(e, t, 0, 1, emit)) return false;
                if (!enc_sym(e, t, 2, lit_at(li++), emit)) return false;
            }
        } else if (cnt == kEos) {
            if (!enc_sym(e, t, 0, 0, emit)) return false;
            if (!enc_sym(e, t, 1, kEos, emit)) return false;
            enc_flush(e, emit);
            return true;
        } else {
            const int nbits = (tok >> 9) & 0x1F;
            const uint32_t dist = (tok >> 16) & 0x7FFF;
            if (!enc_sym(e, t, 0, 0, emit)) return false;
            if (!enc_sym(e, t, 1, cnt, emit)) return false;
            if (!enc_sym(e, t, 3, nbits, emit)) return false;
            for (int b = 0; b + 1 < nbits; b++) {
                if (!enc_sym(e, t, 4 + b, (dist >> b) & 1, emit)) return false;
            }
            if (lit_skip) li += cnt;
        }
    }
    return true;
}

// Decode one block into records: sink.lit(byte) per literal and
// sink.match(len, dist) per match. Rejects exactly what the host codec
// rejects (sqz_native.cpp sqz4_decode_payload); dlen is the length of a
// warm block's shared dictionary, which distances may reach into.
template <class T, class Next, class Sink>
SQZ4_HD int32_t decode_block(T& t, Next&& next, uint64_t size, uint64_t dlen,
                             Sink& sink) {
    Dec d;
    dec_prime(d, next);
    uint64_t optr = 0;
    for (;;) {
        int flag, v;
        if (!dec_sym(d, t, 0, next, flag)) return kEIlseq;
        if (flag) {
            if (optr >= size) return kEOverrun;
            if (!dec_sym(d, t, 2, next, v)) return kEIlseq;
            sink.lit(static_cast<uint32_t>(v));
            optr++;
            continue;
        }
        int len;
        if (!dec_sym(d, t, 1, next, len)) return kEIlseq;
        if (len == kEos) return kOk;
        if (len < kMinLen || len > kMaxLen) return kESize;
        int nbits;
        if (!dec_sym(d, t, 3, next, nbits)) return kEIlseq;
        uint32_t dist = 0;
        for (int b = 0; b + 1 < nbits; b++) {
            if (!dec_sym(d, t, 4 + b, next, v)) return kEIlseq;
            dist |= static_cast<uint32_t>(v) << b;
        }
        if (nbits > 0) dist |= 1u << (nbits - 1);
        if (dist == 0 || dist > optr + dlen) return kEDist;
        if (optr + static_cast<uint64_t>(len) > size) return kEOverrun;
        sink.match(static_cast<uint32_t>(len), dist);
        optr += len;
    }
}

// ------------------------------------------------------- device lanes
//
// Arrays are [G, rows, B] with lane (g, b) owning column b of group g —
// element (g, r, b) at (g * rows + r) * B + b. Words hold 4 bytes
// big-endian.

struct Lane {
    int64_t g, b, B;
    SQZ4_HD int64_t at(int64_t rows, int64_t r) const {
        return (g * rows + r) * B + b;
    }
};

// Encoder: toks [G, Tt, B], lits [G, Lw, B], seeded [G, 1, B] (nonzero:
// start from `seed`), words [G, CW, B], lens [G, 1, B] (bytes coded; the
// caller rejects lens > CW * 4; -1 = rejected token stream).
template <class T>
SQZ4_HD void encode_lane(T& tab, const Lane& ln, const uint32_t* toks,
                         int64_t Tt, const uint32_t* lits, int64_t Lw,
                         const uint32_t* seed, const int32_t* seeded,
                         int lit_skip, uint32_t* words, int64_t CW,
                         int32_t* lens) {
    tab_init(tab, seeded[ln.at(1, 0)] ? seed : nullptr);
    int64_t n = 0;
    uint32_t acc = 0;
    int64_t lw_cached = -1;
    uint32_t lword = 0;
    auto tok_at = [&](int64_t i) { return toks[ln.at(Tt, i)]; };
    auto lit_at = [&](int64_t j) -> int {
        const int64_t w = j >> 2;
        if (w >= Lw) return 0;
        if (w != lw_cached) {
            lword = lits[ln.at(Lw, w)];
            lw_cached = w;
        }
        return (lword >> (24 - 8 * (j & 3))) & 0xFF;
    };
    auto emit = [&](uint32_t byte) {
        acc |= byte << (24 - 8 * (n & 3));
        if ((n & 3) == 3) {
            if ((n >> 2) < CW) words[ln.at(CW, n >> 2)] = acc;
            acc = 0;
        }
        n++;
    };
    const bool ok = encode_tokens(tab, tok_at, Tt, lit_at, lit_skip != 0,
                                  emit);
    if ((n & 3) != 0 && (n >> 2) < CW) words[ln.at(CW, n >> 2)] = acc;
    lens[ln.at(1, 0)] = ok ? static_cast<int32_t>(n < 0x7FFFFFFF ? n : 0x7FFFFFFF)
                           : -1;
}

// Decoder record sink: literal bytes packed 4 per word, one token bit
// per decoded token (LSB-first, 1 = match), match records len << 24 |
// dist. A stream past its capacity stops storing and raises `ovf`.
struct RecordSink {
    const Lane* ln;
    uint32_t *lit_out, *tok_out, *mrec_out;
    int64_t LW, TW, MW;
    int64_t nlit = 0, ntok = 0, nmatch = 0, optr = 0;
    uint32_t litw = 0, tokw = 0;
    bool ovf = false;

    SQZ4_HD void put_tok(uint32_t bit) {
        tokw |= bit << (ntok & 31);
        if ((ntok & 31) == 31) {
            if ((ntok >> 5) < TW) tok_out[ln->at(TW, ntok >> 5)] = tokw;
            else ovf = true;
            tokw = 0;
        }
        ntok++;
    }
    SQZ4_HD void lit(uint32_t b) {
        litw |= b << (24 - 8 * (nlit & 3));
        if ((nlit & 3) == 3) {
            if ((nlit >> 2) < LW) lit_out[ln->at(LW, nlit >> 2)] = litw;
            else ovf = true;
            litw = 0;
        }
        nlit++;
        optr++;
        put_tok(0);
    }
    SQZ4_HD void match(uint32_t len, uint32_t dist) {
        if (nmatch < MW) mrec_out[ln->at(MW, nmatch)] = (len << 24) | dist;
        else ovf = true;
        nmatch++;
        optr += len;
        put_tok(1);
    }
    SQZ4_HD void finish() {
        if ((nlit & 3) != 0) {
            if ((nlit >> 2) < LW) lit_out[ln->at(LW, nlit >> 2)] = litw;
            else ovf = true;
        }
        if ((ntok & 31) != 0) {
            if ((ntok >> 5) < TW) tok_out[ln->at(TW, ntok >> 5)] = tokw;
            else ovf = true;
        }
    }
};

// Decoder: payload [G, Pw, B] words, meta [G, 4, B] (payload bytes,
// block size, dictionary length, seeded flag), outputs lit [G, LW, B],
// tok [G, TW, B], mrec [G, MW, B] and counts [G, 8, B]: 0 bytes
// produced, 1 literals, 2 tokens, 3 matches, 4 error code, 5 payload
// bytes consumed, 6 overflow flag, 7 zero.
template <class T>
SQZ4_HD void decode_lane(T& tab, const Lane& ln, const uint32_t* payload,
                         int64_t Pw, const int32_t* meta,
                         const uint32_t* seed, uint32_t* lit, int64_t LW,
                         uint32_t* tok, int64_t TW, uint32_t* mrec,
                         int64_t MW, int32_t* counts) {
    const int64_t plen_raw = meta[ln.at(4, 0)];
    const int64_t size = meta[ln.at(4, 1)] < 0 ? 0 : meta[ln.at(4, 1)];
    const int64_t dlen = meta[ln.at(4, 2)] < 0 ? 0 : meta[ln.at(4, 2)];
    const int64_t plen = plen_raw < 0 ? 0 : (plen_raw > 4 * Pw ? 4 * Pw : plen_raw);
    tab_init(tab, meta[ln.at(4, 3)] ? seed : nullptr);
    int64_t pos = 0;
    uint32_t cur = 0;
    auto next = [&]() -> uint64_t {
        if (pos >= plen) {
            pos++;
            return 0;
        }
        if ((pos & 3) == 0) cur = payload[ln.at(Pw, pos >> 2)];
        const uint64_t v = (cur >> (24 - 8 * (pos & 3))) & 0xFF;
        pos++;
        return v;
    };
    RecordSink sink{&ln, lit, tok, mrec, LW, TW, MW};
    const int32_t err = decode_block(tab, next, static_cast<uint64_t>(size),
                                     static_cast<uint64_t>(dlen), sink);
    sink.finish();
    counts[ln.at(8, 0)] = static_cast<int32_t>(sink.optr);
    counts[ln.at(8, 1)] = static_cast<int32_t>(sink.nlit);
    counts[ln.at(8, 2)] = static_cast<int32_t>(sink.ntok);
    counts[ln.at(8, 3)] = static_cast<int32_t>(sink.nmatch);
    counts[ln.at(8, 4)] = err;
    counts[ln.at(8, 5)] = static_cast<int32_t>(pos < 0x7FFFFFFF ? pos : 0x7FFFFFFF);
    counts[ln.at(8, 6)] = sink.ovf ? 1 : 0;
    counts[ln.at(8, 7)] = 0;
}

}  // namespace sqz4
