// CUDA targets of the device coders (Hopper, sm_90a): one thread owns one
// block's serial range coder. Its 610 model words live in shared memory,
// one column per thread of a 32-thread CTA (word i of thread t at
// i * 32 + t, so every access hits the thread's own bank whatever the
// data-dependent index). The coder itself is sqz4_coder.h, the source the
// host codec and the CPU targets (sqz4_ffi.cc) share; registered by
// sqz_tpu/ops/coder.py for platform "CUDA".
#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "sqz4_coder.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 32;
constexpr size_t kSmemBytes = sizeof(uint32_t) * sqz4::kTabWords * kThreads;

struct SmemTab {
    uint32_t* s;
    int t;
    __device__ __forceinline__ uint32_t& operator()(int i) {
        return s[i * kThreads + t];
    }
};

__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint32_t* toks, int64_t Tt, const uint32_t* lits,
              int64_t Lw, const uint32_t* seed, const int32_t* seeded,
              int lit_skip, uint32_t* words, int64_t CW, int32_t* lens,
              int64_t G, int64_t B) {
    extern __shared__ uint32_t smem[];
    const int64_t lane = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    if (lane >= G * B) return;
    SmemTab tab{smem, static_cast<int>(threadIdx.x)};
    sqz4::encode_lane(tab, sqz4::Lane{lane / B, lane % B, B}, toks, Tt, lits,
                      Lw, seed, seeded, lit_skip, words, CW, lens);
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* payload, int64_t Pw, const int32_t* meta,
              const uint32_t* seed, uint32_t* lit, int64_t LW, uint32_t* tok,
              int64_t TW, uint32_t* mrec, int64_t MW, int32_t* counts,
              int64_t G, int64_t B) {
    extern __shared__ uint32_t smem[];
    const int64_t lane = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    if (lane >= G * B) return;
    SmemTab tab{smem, static_cast<int>(threadIdx.x)};
    sqz4::decode_lane(tab, sqz4::Lane{lane / B, lane % B, B}, payload, Pw,
                      meta, seed, lit, LW, tok, TW, mrec, MW, counts);
}

template <class Buf>
int64_t rows_of(const Buf& buf, int64_t G, int64_t B) {
    auto d = buf.dimensions();
    if (d.size() != 3 || d[0] != G || d[2] != B) return -1;
    return d[1];
}

ffi::Error launch_status(const char* what) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) {
        return ffi::Error::Internal(std::string(what) + ": " +
                                    cudaGetErrorString(e));
    }
    return ffi::Error::Success();
}

ffi::Error EncodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> toks,
                      ffi::Buffer<ffi::U32> lits, ffi::Buffer<ffi::U32> seed,
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
    const int64_t lanes = G * B;
    if (lanes == 0) return ffi::Error::Success();
    cudaFuncSetAttribute(encode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmemBytes));
    const unsigned grid = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
    encode_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        toks.typed_data(), Tt, lits.typed_data(), Lw, seed.typed_data(),
        seeded.typed_data(), lit_skip, words->typed_data(), CW,
        lens->typed_data(), G, B);
    return launch_status("sqz4_encode launch");
}

ffi::Error DecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> payload,
                      ffi::Buffer<ffi::S32> meta, ffi::Buffer<ffi::U32> seed,
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
    const int64_t lanes = G * B;
    if (lanes == 0) return ffi::Error::Success();
    cudaFuncSetAttribute(decode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmemBytes));
    const unsigned grid = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
    decode_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        payload.typed_data(), Pw, meta.typed_data(), seed.typed_data(),
        lit->typed_data(), LW, tok->typed_data(), TW, mrec->typed_data(), MW,
        counts->typed_data(), G, B);
    return launch_status("sqz4_decode launch");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(Sqz4EncodeCuda, EncodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("lit_skip"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(Sqz4DecodeCuda, DecodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

// occupancy report for PERF.md: coder lanes resident per SM
extern "C" int sqz4_cuda_lanes_per_sm() {
    int ctas = 0;
    cudaFuncSetAttribute(encode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmemBytes));
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, encode_kernel, kThreads, kSmemBytes) != cudaSuccess) {
        return -1;
    }
    return ctas * kThreads;
}
