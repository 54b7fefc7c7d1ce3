// CPU targets of the device coders: the lane loops of sqz4_coder.h run
// here with the host compiler, so the XLA CPU backend (the test suite)
// reaches the same coder source the CUDA kernels compile
// (sqz4_ffi.cu). Registered by sqz_tpu/ops/coder.py for platform "cpu".
#include <cstdint>

#include "sqz4_coder.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct ArrayTab {
    uint32_t w[sqz4::kTabWords];
    uint32_t& operator()(int i) { return w[i]; }
};

// [G, rows, B] arrays: returns rows, or -1 when the rank or the lane
// dims disagree with (G, B)
template <class Buf>
int64_t rows_of(const Buf& buf, int64_t G, int64_t B) {
    auto d = buf.dimensions();
    if (d.size() != 3 || d[0] != G || d[2] != B) return -1;
    return d[1];
}

ffi::Error EncodeImpl(ffi::Buffer<ffi::U32> toks, ffi::Buffer<ffi::U32> lits,
                      ffi::Buffer<ffi::U32> seed,
                      ffi::Buffer<ffi::S32> seeded,
                      ffi::ResultBuffer<ffi::U32> words,
                      ffi::ResultBuffer<ffi::S32> lens, int32_t lit_skip) {
    auto td = toks.dimensions();
    if (td.size() != 3) return ffi::Error::InvalidArgument("toks: [G, Tt, B]");
    const int64_t G = td[0], Tt = td[1], B = td[2];
    const int64_t Lw = rows_of(lits, G, B), CW = rows_of(*words, G, B);
    if (Lw < 0 || CW < 0 || rows_of(seeded, G, B) != 1 ||
        rows_of(*lens, G, B) != 1 ||
        seed.element_count() != sqz4::kTabWords) {
        return ffi::Error::InvalidArgument("sqz4_encode: operand shapes");
    }
    ArrayTab tab;
    for (int64_t g = 0; g < G; g++) {
        for (int64_t b = 0; b < B; b++) {
            sqz4::encode_lane(tab, sqz4::Lane{g, b, B}, toks.typed_data(), Tt,
                              lits.typed_data(), Lw, seed.typed_data(),
                              seeded.typed_data(), lit_skip,
                              words->typed_data(), CW, lens->typed_data());
        }
    }
    return ffi::Error::Success();
}

ffi::Error DecodeImpl(ffi::Buffer<ffi::U32> payload, ffi::Buffer<ffi::S32> meta,
                      ffi::Buffer<ffi::U32> seed,
                      ffi::ResultBuffer<ffi::U32> lit,
                      ffi::ResultBuffer<ffi::U32> tok,
                      ffi::ResultBuffer<ffi::U32> mrec,
                      ffi::ResultBuffer<ffi::S32> counts) {
    auto pd = payload.dimensions();
    if (pd.size() != 3) return ffi::Error::InvalidArgument("payload: [G, Pw, B]");
    const int64_t G = pd[0], Pw = pd[1], B = pd[2];
    const int64_t LW = rows_of(*lit, G, B), TW = rows_of(*tok, G, B),
                  MW = rows_of(*mrec, G, B);
    if (LW < 0 || TW < 0 || MW < 0 || rows_of(meta, G, B) != 4 ||
        rows_of(*counts, G, B) != 8 ||
        seed.element_count() != sqz4::kTabWords) {
        return ffi::Error::InvalidArgument("sqz4_decode: operand shapes");
    }
    ArrayTab tab;
    for (int64_t g = 0; g < G; g++) {
        for (int64_t b = 0; b < B; b++) {
            sqz4::decode_lane(tab, sqz4::Lane{g, b, B}, payload.typed_data(),
                              Pw, meta.typed_data(), seed.typed_data(),
                              lit->typed_data(), LW, tok->typed_data(), TW,
                              mrec->typed_data(), MW, counts->typed_data());
        }
    }
    return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(Sqz4EncodeCpu, EncodeImpl,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("lit_skip"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(Sqz4DecodeCpu, DecodeImpl,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
