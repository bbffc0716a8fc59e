// Hopper (sm_90a) pieces shared by the TMA-fed wgmma weight streams of
// moe_gmm.cu (bf16 weights, moe_gmm_sm90.cuh) and moe_gmm_q.cu (int8
// weights dequantized on the way to the tensor cores): the CTA's
// geometry and the rows N it owns, the PTX of mbarriers, TMA loads and
// wgmma, the shared-memory descriptor of a 128-byte-swizzled tile, the
// zero tile of a CTA whose rows all lie past its group size, the
// epilogue, and the tensor-map encoder. Each kernel keeps only its ring
// and its main loop, the part where the weight type differs.
//
// The CTA: warpgroup 0 is the TMA producer, warpgroups 1 and 2 the
// consumers, each owning SM90_NA accumulators of 64 weight columns x N
// rows of x (A and B swapped: the weight is wgmma's MN-major 64-row A,
// x's rows are B). FUSED: a consumer's accumulators are the gate and up
// products of one 64-column slice (a CTA owns 128 columns); else two
// adjacent slices of the one weight (a CTA owns 256 columns).
//
// The tensor maps are encoded by cuTensorMapEncodeTiled, looked up at
// run time with cudaGetDriverEntryPointByVersion, so a library links
// nothing beyond cudart.
#pragma once

#include <cuda.h>
#include "moe_gmm_common.cuh"

namespace {

constexpr int SM90_THREADS = 384;     // producer + 2 consumer warpgroups
constexpr int SM90_BK = 64;           // depth of one stage
constexpr int SM90_SMEM = 232448;     // shared memory a CTA may use
constexpr int SM90_MAX_STAGES = 8;
constexpr int SM90_OUT_STRIDE = 8;    // bf16 padding of an epilogue row
constexpr int SM90_NA = 2;            // accumulator tiles a consumer
// returned by a launch when a tensor map cannot be encoded, plus the
// CUresult of cuTensorMapEncodeTiled
constexpr int SM90_ENCODE_ERROR = 100000;

// a CTA's columns
__host__ __device__ constexpr int sm90_cols(bool fused) {
  return fused ? 128 : 128 * SM90_NA;
}

// The instantiated N (rows a CTA owns), and the largest a CTA's
// registers hold: two accumulators of 64 x N f32 take N of a consumer
// thread's 232 registers.
constexpr int WG_N[] = {8, 16, 32, 64, 96, 128, 160};
constexpr int WG_N_MAX = 160;

// smallest instantiated N that covers C rows in as few row groups as
// WG_N_MAX allows
inline int wgmma_rows(int C) {
  const int groups = (C + WG_N_MAX - 1) / WG_N_MAX;
  const int per = (C + groups - 1) / groups;
  for (int n : WG_N)
    if (n >= per) return n;
  return WG_N_MAX;
}

// ------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spins until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// a box of the 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; its bytes complete on the barrier
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// orders this thread's generic-proxy writes to shared memory before
// later reads of it by the async proxy (wgmma's operand fetch)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor of a 128-byte-swizzled tile (1024-byte
// aligned): 8-row groups of 128-byte rows, 1024 bytes apart (the stride
// byte offset). The leading byte offset is unused by a K-major operand
// and, for the MN-major A, is the stride between 64-element blocks of M,
// of which a 64-row A has one; it is given 1024 there too.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

// d (64 x N f32, the wgmma accumulator layout) (+)= A B^T with A 64 x 16
// bf16, MN-major (transposed), and B N x 16 bf16, K-major, both from
// shared memory through descriptors; acc = 0 overwrites d. The
// specialisations differ only in N and the register list.
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_tn<8>(float (&d)[4], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<96>(float (&d)[48], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tn<160>(float (&d)[80], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(acc));
}

// ------------------------------------------------------------ tiles

// Rows [row0, row0 + n) x columns [col0, col0 + cols) of expert e, all
// past the group size: zeros, 16 bytes a thread.
__device__ __forceinline__ void sm90_zero_tile(bf16* __restrict__ out, int e,
                                               int C, int F, int row0,
                                               int col0, int n, int cols) {
  const int rows = min(n, C - row0);
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, col = col0 + (i % chunks) * 8;
    if (col < F)
      *reinterpret_cast<uint4*>(out + ((int64_t)e * C + row0 + r) * F +
                                col) = make_uint4(0, 0, 0, 0);
  }
}

// The epilogue of consumer warpgroup `cw` of a CTA owning rows
// [row0, row0 + N) and columns [col0, col0 + sm90_cols(FUSED)) of expert
// e: silu(gate) * up (FUSED) or the two slices as they are, rows past g
// set to 0, cast to bf16 and transposed through shared memory `smem`
// (the ring, free once both consumers are past their products) back to
// (C, F) rows, stored 16 bytes a thread.
template <bool FUSED, int N>
__device__ __forceinline__ void sm90_epilogue(float (&acc)[SM90_NA][N / 2],
                                              uint8_t* smem,
                                              bf16* __restrict__ out, int e,
                                              int C, int F, int row0,
                                              int col0, int g, int cw) {
  constexpr int NA = SM90_NA;
  constexpr int COLS = sm90_cols(FUSED);
  named_sync(1, 256);
  constexpr int OS = COLS + SM90_OUT_STRIDE;
  bf16* ot = reinterpret_cast<bf16*>(smem);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int fr = (t / 32) * 16 + lane / 4;   // accumulator row (F)
#pragma unroll
  for (int a = 0; a < (FUSED ? 1 : NA); ++a) {
    const int fbase = FUSED ? cw * 64 : (cw * NA + a) * 64;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      // wgmma's f32 layout: pairs of columns (rows c of x) per 8-wide
      // block, rows (columns f) lane / 4 and + 8
      const int c = (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
      const int f = fbase + fr + ((i / 2) % 2) * 8;
      float v = FUSED ? silu(acc[0][i]) * acc[NA - 1][i] : acc[a][i];
      if (row0 + c >= g) v = 0.f;
      ot[c * OS + f] = from_f<bf16>(v);
    }
  }
  named_sync(1, 256);
  const int rows = min(N, C - row0);
  constexpr int CHUNKS = COLS / 8;
  for (int i = threadIdx.x - 128; i < rows * CHUNKS; i += 256) {
    const int r = i / CHUNKS, ch = i % CHUNKS, col = col0 + ch * 8;
    if (col < F)
      *reinterpret_cast<uint4*>(out + ((int64_t)e * C + row0 + r) * F +
                                col) =
          *reinterpret_cast<const uint4*>(ot + r * OS + ch * 8);
  }
}

// bytes of the epilogue's tile of N rows, which reuses the ring
__host__ __device__ constexpr int sm90_out_bytes(bool fused, int n) {
  return n * (sm90_cols(fused) + SM90_OUT_STRIDE) * 2;
}

// ------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 3-D tensor map of `type` (`elem` bytes an element) over (d2, d1, d0)
// with d0 innermost, boxes of (1, b1, b0), zeros outside the tensor.
// Returns the encoder's CUresult (CUDA_ERROR_NOT_FOUND without an
// encoder).
inline int encode_3d(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type, int elem, int d0, int d1,
                     int d2, int b0, int b1, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * elem,
                                 (cuuint64_t)d0 * d1 * elem};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return (int)fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
                 step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
