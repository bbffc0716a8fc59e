// Pieces shared by the grouped expert matmuls of moe_gmm.cu (weights in
// x's dtype) and moe_gmm_q.cu (int8 weights with row scales): the type
// helpers, the simt path's tile geometry and epilogue, the split-D
// finishing kernel, and the plan of a launch. Each source keeps only its
// own main loops, the part where the weight type differs; the pieces of
// their wgmma paths that both share are in sm90.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

enum Path { SIMT = 0, WGMMA = 1 };

struct GemmPlan {
  Plan simt;   // the simt path's columns a thread and D split
  int path;    // Path
  int n;       // wgmma: rows a CTA owns (0: the shape is refused)
};

}  // namespace
