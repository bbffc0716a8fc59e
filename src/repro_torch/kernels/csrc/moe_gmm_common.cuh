// Pieces shared by the grouped expert matmuls of moe_gmm.cu (weights in
// x's dtype) and moe_gmm_q.cu (int8 weights with row scales): the type
// helpers, the simt path's tile geometry and epilogue, the split-D
// finishing kernel and its plan, and the WMMA tiles, cp.async helpers,
// per-stage products and epilogue of moe_gmm_q.cu's tensor-core path.
// Each source keeps only its own main loops, the part where the weight
// type differs; moe_gmm.cu's tensor-core path is moe_gmm_sm90.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

// ------------------------------------------------------------ simt path

constexpr int NT = 128;  // threads per block
constexpr int R = 4;     // rows per block
constexpr int BD = 64;   // reduction depth staged per shared-memory tile

// A row tile wholly past its expert's group size: its output rows are 0.
// With a split reduction the finishing kernel writes them instead.
template <typename T, int VEC>
__device__ __forceinline__ void simt_zero_tile(T* __restrict__ out, int e,
                                               int C, int F, int row0,
                                               int col0, int ksplit) {
  if (ksplit != 1) return;
  for (int r = 0; r < R && row0 + r < C; ++r)
    for (int v = 0; v < VEC && col0 + v < F; ++v)
      out[((int64_t)e * C + row0 + r) * F + col0 + v] = from_f<T>(0.f);
}

// The simt epilogue of one thread's R x VEC accumulators (two sets when
// FUSED): the activation, the row mask and the cast into `out`, or, with
// a split reduction, the f32 partial sums into
// ws[(set * ksplit + split), e, row, col].
template <typename T, bool FUSED, int VEC>
__device__ __forceinline__ void simt_store(
    const float (&acc_g)[R][VEC], const float (&acc_u)[FUSED ? R : 1][VEC],
    T* __restrict__ out, float* __restrict__ ws, int E, int C, int F, int e,
    int row0, int nrows, int col0, int ksplit, int split) {
  if (ksplit == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      if (row < C) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          if (col0 + v < F) {
            float o = 0.f;
            if (r < nrows)
              o = FUSED ? silu(acc_g[r][v]) * acc_u[FUSED ? r : 0][v]
                        : acc_g[r][v];
            out[((int64_t)e * C + row) * F + col0 + v] = from_f<T>(o);
          }
        }
      }
    }
  } else {
    const int64_t plane = (int64_t)E * C * F;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          if (col0 + v < F) {
            const int64_t o = ((int64_t)e * C + row0 + r) * F + col0 + v;
            ws[split * plane + o] = acc_g[r][v];
            if (FUSED)
              ws[(ksplit + split) * plane + o] = acc_u[FUSED ? r : 0][v];
          }
        }
      }
    }
  }
}

// adds the ksplit partial sums, applies the activation, masks rows past
// the group size and casts; one thread per output element
template <typename T, bool FUSED>
__global__ void finish_kernel(const float* __restrict__ ws,
                              const int* __restrict__ gs,
                              T* __restrict__ out, int E, int C, int F,
                              int ksplit) {
  const int64_t plane = (int64_t)E * C * F;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int e = (int)(i / ((int64_t)C * F));
  const int row = (int)((i / F) % C);
  const int g = min(max(gs[e], 0), C);
  float v = 0.f;
  if (row < g) {
    float sg = 0.f, su = 0.f;
    for (int s = 0; s < ksplit; ++s) {
      sg += ws[s * plane + i];
      if (FUSED) su += ws[(ksplit + s) * plane + i];
    }
    v = FUSED ? silu(sg) * su : sg;
  }
  out[i] = from_f<T>(v);
}

template <typename T, bool FUSED>
cudaError_t launch_finish(const float* ws, const int* gs, T* out, int E,
                          int C, int F, int ksplit, cudaStream_t stream) {
  const int64_t n = (int64_t)E * C * F;
  const int threads = 256;
  finish_kernel<T, FUSED><<<(unsigned)((n + threads - 1) / threads), threads,
                            0, stream>>>(ws, gs, out, E, C, F, ksplit);
  return cudaGetLastError();
}

// ------------------------------------------------------------ planning

struct Plan {
  bool tensor_cores;
  int vec;      // simt: columns per thread
  int ksplit;   // simt: blocks sharing one output tile's D reduction
  int kchunk;   // simt: reduction depth of each
};

constexpr int TARGET_BLOCKS_PER_SM = 8;
constexpr int MIN_KCHUNK = 256;

// The simt D split: with `tiles` (row x column x expert) blocks short of
// TARGET_BLOCKS_PER_SM a streaming multiprocessor, D is cut into chunks
// of at least MIN_KCHUNK (a multiple of BD) until the blocks are there.
__host__ inline void plan_split(Plan& p, int64_t tiles, int D, int num_sms) {
  const int64_t target = (int64_t)TARGET_BLOCKS_PER_SM * num_sms;
  const int64_t want = tiles >= target ? 1 : (target + tiles - 1) / tiles;
  int64_t kchunk = (D + want - 1) / want;
  kchunk = (kchunk + BD - 1) / BD * BD;
  if (kchunk < MIN_KCHUNK) kchunk = MIN_KCHUNK;
  if (kchunk >= D) kchunk = D;
  if (kchunk < 1) kchunk = 1;
  p.kchunk = (int)kchunk;
  p.ksplit = (int)((D + kchunk - 1) / kchunk);
  if (p.ksplit < 1) p.ksplit = 1;
}

// ---------------------------------------------------- tensor-core path

constexpr int WBM = 64, WBN = 64, WBK = 32;  // block tile
constexpr int APAD = 8, BPAD = 8, CPAD = 4;  // shared-memory row padding
constexpr int WNT = 128;                     // 4 warps, 2 x 2 of 32 x 32

// one stage: the x tile (WBM x WBK) and NB weight tiles (WBK x WBN), bf16
template <int NB>
struct Stage {
  bf16 a[WBM][WBK + APAD];
  bf16 b[NB][WBK][WBN + BPAD];
};
template <int NB>
union WmmaSmem {
  Stage<NB> st[2];
  float c[NB][WBM][WBN + CPAD];
};

template <int NB>
using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                   float>[NB][2][2];

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the tile of rows wholly past the group size: zeros
__device__ __forceinline__ void wmma_zero_tile(bf16* __restrict__ out, int e,
                                               int C, int F, int row0,
                                               int col0) {
  for (int i = threadIdx.x; i < WBM * WBN; i += WNT) {
    const int r = row0 + i / WBN, c = col0 + i % WBN;
    if (r < C && c < F) out[((int64_t)e * C + r) * F + c] = from_f<bf16>(0.f);
  }
}

template <int NB>
__device__ __forceinline__ void wmma_zero_acc(Acc<NB>& acc) {
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[m][i][j], 0.f);
}

// this warp's 32 x 32 products over one staged WBK-deep tile
template <int NB>
__device__ __forceinline__ void wmma_stage_mma(const Stage<NB>& st,
                                               Acc<NB>& acc, int wr, int wc) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < WBK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], &st.a[wr + 16 * i][kk], WBK + APAD);
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &st.b[m][kk][wc + 16 * j], WBN + BPAD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc[m][i][j], fa[i], fb, acc[m][i][j]);
      }
  }
}

// epilogue through shared memory (reusing the stage buffers): the
// activation, the row mask and the cast of the block's WBM x WBN outputs
template <bool FUSED>
__device__ __forceinline__ void wmma_epilogue(WmmaSmem<FUSED ? 2 : 1>& sm,
                                              Acc<FUSED ? 2 : 1>& acc,
                                              bf16* __restrict__ out, int e,
                                              int C, int F, int row0,
                                              int col0, int g, int wr,
                                              int wc) {
  using namespace nvcuda;
  constexpr int NB = FUSED ? 2 : 1;
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&sm.c[m][wr + 16 * i][wc + 16 * j],
                                acc[m][i][j], WBN + CPAD,
                                wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < WBM * WBN; i += WNT) {
    const int r = i / WBN, c = i % WBN;
    const int row = row0 + r, col = col0 + c;
    if (row < C && col < F) {
      float v = 0.f;
      if (row < g)
        v = FUSED ? silu(sm.c[0][r][c]) * sm.c[NB - 1][r][c] : sm.c[0][r][c];
      out[((int64_t)e * C + row) * F + col] = from_f<bf16>(v);
    }
  }
}

}  // namespace
