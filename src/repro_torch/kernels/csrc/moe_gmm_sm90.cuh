// The tensor-core path of moe_gmm.cu for Hopper (sm_90a): a TMA-fed
// wgmma weight stream.
//
// What bounds it: the weights. At prefill an expert holds C = 160 rows
// (the 512-token bucket of mixtral-8x7b), so each weight byte feeds 160
// operations, under the card's ~295 FLOP/byte ridge: the kernel is a
// stream of E*D*F weight bytes that has to run on the tensor cores; at
// decode (C = 3, N = 8) it is the same stream with fewer operations. The
// design reads every weight byte from HBM once per call and keeps enough
// of them in flight to hold the HBM rate.
//
// Design:
//  * A and B swapped. A CTA computes out[e]^T = W[e]^T x[e]^T for a tile
//    of F: wgmma's 64-row operand A is a 64 (F) x 16 (D) slice of the
//    weight, read MN-major as stored (the transpose bit of A), and B is
//    x's rows, K-major as stored, with the instruction's N = the rows a
//    CTA owns (8 ... 160, rounded up from C). One CTA owns every row of
//    its expert, so each weight tile is loaded once; above the largest N
//    the rows split into groups along the fastest grid axis, so the CTAs
//    sharing a weight tile run together and repeat reads hit L2.
//  * TMA with 3-D tensor maps over x (E, C, D) and W (E, D, F), 128-byte
//    swizzle: the expert is a coordinate, so a box never reads into the
//    next expert; the ragged D tail, F tail and rows past C arrive as
//    zeros, and the main loop has no masks. A weight box is 64 x 64 (the
//    swizzle's 128-byte inner limit), so a consumer's 64 columns over a
//    64-deep stage are one box.
//  * Warp specialisation: warpgroup 0 is the producer (one thread issues
//    the TMA loads of a ring of `stages` stages, each completed on its
//    "full" mbarrier; the warpgroup gives its registers away with
//    setmaxnreg); warpgroups 1 and 2 are consumers, each owning two
//    accumulator tiles of 64 columns x N rows (the fused kernel: the gate
//    and up products of one 64-column slice, sharing B; gmm: two adjacent
//    slices, so a CTA owns 256 columns: one wave of CTAs at mixtral-8x7b's
//    F = 4096 and half the x re-reads of 128). A consumer keeps one
//    stage's products in flight
//    and releases the stage before on its "empty" mbarrier.
//  * Epilogue in registers (silu(g) * u, the row mask c >= g -> 0, the
//    cast to bf16), transposed through shared memory back to (C, F) rows
//    and stored 16 bytes a thread. A CTA whose rows all lie past its
//    expert's group size writes its zeros and exits before any load.
//
// Needs bf16, D % 8 == 0, F % 8 == 0 and 16-byte aligned x, weights and
// out (TMA's 16-byte strides and base). The tensor maps are encoded by
// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPointByVersion, so the library links nothing beyond
// cudart.
#pragma once

#include <cuda.h>
#include "moe_gmm_common.cuh"

namespace {

constexpr int SM90_THREADS = 384;     // producer + 2 consumer warpgroups
constexpr int SM90_BK = 64;           // depth of one stage
constexpr int SM90_BOX = 64 * SM90_BK * 2;  // one 64 x 64 bf16 weight box
constexpr int SM90_SMEM = 232448;     // shared memory a CTA may use
constexpr int SM90_MAX_STAGES = 8;
constexpr int SM90_OUT_STRIDE = 8;    // bf16 padding of an epilogue row
constexpr int SM90_NA = 2;            // accumulator tiles a consumer
// returned by the launch when a tensor map cannot be encoded, plus the
// CUresult of cuTensorMapEncodeTiled
constexpr int SM90_ENCODE_ERROR = 100000;

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

// ------------------------------------------------------------ kernel

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

// grid: (row groups, column tiles, E); block: SM90_THREADS; dynamic
// shared memory sm90_smem(N), holding `stages` = sm90_stages(N).
// FUSED: a consumer's two accumulators are the gate and up products of
// one 64-column slice (a CTA owns 128 columns). Else two slices of the
// one weight (a CTA owns 256 columns). A CTA owns rows
// [blockIdx.x * N, + N) of its expert.
template <bool FUSED, int N>
__global__ void __launch_bounds__(SM90_THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap gmap,
             const __grid_constant__ CUtensorMap umap,
             const int* __restrict__ gs, bf16* __restrict__ out, int C,
             int D, int F, int stages) {
  constexpr int NA = SM90_NA;
  constexpr int XBYTES = N * SM90_BK * 2;
  constexpr int STAGE = XBYTES + 2 * NA * SM90_BOX;
  constexpr int COLS = FUSED ? 128 : 128 * NA;   // a CTA's columns
  const int e = blockIdx.z;
  const int row0 = blockIdx.x * N;
  const int col0 = blockIdx.y * COLS;
  const int g = min(max(gs[e], 0), C);
  if (row0 >= g) {   // every row of the tile is padding
    sm90_zero_tile(out, e, C, F, row0, col0, N, COLS);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = (D + SM90_BK - 1) / SM90_BK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0, phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        if (kt >= stages) mbar_wait(&empty[s], phase ^ 1);
        uint8_t* st = smem + s * STAGE;
        const int k0 = kt * SM90_BK;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_3d(st, &xmap, &full[s], k0, row0, e);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            // box (consumer c, accumulator a): fused a = matrix
            const CUtensorMap* m = (FUSED && a == 1) ? &umap : &gmap;
            const int col = FUSED ? col0 + c * 64 : col0 + (c * NA + a) * 64;
            tma_load_3d(st + XBYTES + (c * NA + a) * SM90_BOX, m, &full[s],
                        col, k0, e);
          }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    float acc[NA][N / 2];
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_acc(acc[a]);
    int s = 0, phase = 0, prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[s], phase);
      const uint8_t* st = smem + s * STAGE;
      const uint64_t db = sw128_desc(st, 16);
      uint64_t da[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a)
        da[a] = sw128_desc(st + XBYTES + (cw * NA + a) * SM90_BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SM90_BK / 16; ++kk)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          // A: 16 rows of depth = two 1024-byte groups further; B: 16
          // elements = 32 bytes further along its 128-byte rows
          wgmma_tn<N>(acc[a], da[a] + kk * (2048 >> 4), db + kk * (32 >> 4),
                      kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_acc(acc[a]);

    // epilogue: both consumers are done with the ring, which now holds
    // the output tile as rows (N x COLS bf16, padded)
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

// a 3-D bf16 tensor map over (d2, d1, d0) with d0 innermost, boxes of
// (1, b1, b0), 128-byte swizzle, zeros outside the tensor. Returns the
// encoder's CUresult (CUDA_ERROR_NOT_FOUND without an encoder).
inline int encode_3d(CUtensorMap* map, const void* base, int d0, int d1,
                     int d2, int b0, int b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2,
                                 (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                 const_cast<void*>(base), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// bytes of one stage: the x box (N rows x 64 deep) and 2 * SM90_NA
// weight boxes
constexpr int sm90_stage_bytes(int n) {
  return n * SM90_BK * 2 + 2 * SM90_NA * SM90_BOX;
}

// stages of the ring that fit a CTA's shared memory (with the 1024-byte
// alignment slack and two barriers a stage)
constexpr int sm90_stages(int n) {
  return (SM90_SMEM - 1024) / (sm90_stage_bytes(n) + 16) < SM90_MAX_STAGES
             ? (SM90_SMEM - 1024) / (sm90_stage_bytes(n) + 16)
             : SM90_MAX_STAGES;
}

// dynamic shared memory of a CTA
constexpr int sm90_smem(int n) {
  return 1024 + sm90_stages(n) * (sm90_stage_bytes(n) + 16);
}

// x (E, C, D), weights (E, D, F), out (E, C, F), all bf16; wu unused
// unless FUSED. Returns a cudaError_t, or SM90_ENCODE_ERROR + the
// encoder's CUresult when a tensor map cannot be encoded.
template <bool FUSED, int N>
int launch_wgmma(const bf16* x, const bf16* wg, const bf16* wu,
                 const int* gs, bf16* out, int E, int C, int D, int F,
                 cudaStream_t stream) {
  constexpr int stages = sm90_stages(N);
  constexpr int cols = FUSED ? 128 : 128 * SM90_NA;   // a CTA's columns
  static_assert(stages >= 2, "a ring needs two stages");
  static_assert(N * (cols + SM90_OUT_STRIDE) * 2 <=
                    stages * sm90_stage_bytes(N),
                "the epilogue tile reuses the ring");
  constexpr int smem = sm90_smem(N);
  auto kernel = wgmma_kernel<FUSED, N>;
  // once a process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap xmap, gmap, umap;
  int rc = encode_3d(&xmap, x, D, C, E, SM90_BK, N);
  if (rc == 0) rc = encode_3d(&gmap, wg, F, D, E, 64, SM90_BK);
  if (rc == 0 && FUSED) rc = encode_3d(&umap, wu, F, D, E, 64, SM90_BK);
  if (rc != 0) return SM90_ENCODE_ERROR + rc;
  if (!FUSED) umap = gmap;   // unused
  dim3 grid((C + N - 1) / N, (F + cols - 1) / cols, E);
  kernel<<<grid, SM90_THREADS, smem, stream>>>(xmap, gmap, umap, gs, out, C,
                                                D, F, stages);
  return (int)cudaGetLastError();
}

}  // namespace
