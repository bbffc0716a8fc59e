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
// out (TMA's 16-byte strides and base). The PTX, the zero tile, the
// epilogue and the tensor-map encoder are shared with moe_gmm_q.cu's
// int8 kernel in sm90.cuh.
#pragma once

#include "sm90.cuh"

namespace {

constexpr int SM90_BOX = 64 * SM90_BK * 2;  // one 64 x 64 bf16 weight box

// ------------------------------------------------------------ kernel

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
  constexpr int COLS = sm90_cols(FUSED);
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
    // the output tile as rows
    sm90_epilogue<FUSED, N>(acc, smem, out, e, C, F, row0, col0, g, cw);
  }
}

// ------------------------------------------------------------ host

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
  constexpr int cols = sm90_cols(FUSED);
  static_assert(stages >= 2, "a ring needs two stages");
  static_assert(sm90_out_bytes(FUSED, N) <= stages * sm90_stage_bytes(N),
                "the epilogue tile reuses the ring");
  constexpr int smem = sm90_smem(N);
  auto kernel = wgmma_kernel<FUSED, N>;
  // once a process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap xmap, gmap, umap;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  int rc = encode_3d(&xmap, x, BF16, 2, D, C, E, SM90_BK, N, SW128);
  if (rc == 0) rc = encode_3d(&gmap, wg, BF16, 2, F, D, E, 64, SM90_BK, SW128);
  if (rc == 0 && FUSED)
    rc = encode_3d(&umap, wu, BF16, 2, F, D, E, 64, SM90_BK, SW128);
  if (rc != 0) return SM90_ENCODE_ERROR + rc;
  if (!FUSED) umap = gmap;   // unused
  dim3 grid((C + N - 1) / N, (F + cols - 1) / cols, E);
  kernel<<<grid, SM90_THREADS, smem, stream>>>(xmap, gmap, umap, gs, out, C,
                                                D, F, stages);
  return (int)cudaGetLastError();
}

}  // namespace