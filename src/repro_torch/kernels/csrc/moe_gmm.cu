// Grouped expert matmuls of the MoE FFN over the capacity layout, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/moe_gmm.py:fused_gate_up
// (_ffn_kernel) and src/repro/kernels/moe_gmm.py:gmm (_gmm_kernel):
//
//   fused_gate_up: h[e, c, :] = silu(x[e, c] @ Wg[e]) * (x[e, c] @ Wu[e])
//   gmm:           y[e, c, :] = x[e, c] @ W[e]
//
// with x (E, C, D), weights (E, D, F), f32 accumulation, output in x's
// dtype, and rows c >= group_sizes[e] written as 0.
//
// What bounds it on this card: the weights. At decode the capacity C is
// a handful of rows (8 slots, top-2 over 8 experts: C = 3), so every
// weight element feeds at most C multiply-adds and the kernel is a
// stream of E*D*F weight bytes (1.88 GB for Wg+Wu of mixtral-8x7b at
// bf16, >= 0.56 ms at 3.35 TB/s). At prefill (C = 160) it is still
// under the card's ~295 FLOP/byte ridge, but 160 FLOP/byte is far above
// what the CUDA cores can issue (67 TFLOP/s f32), so there the products
// have to run on the tensor cores.
//
// Design, two paths chosen per call (make_plan):
//
//  * simt (small C, float32, or shapes the tensor-core path does not
//    take): one block owns one expert, a tile of R rows and NT*VEC output
//    columns; each thread owns VEC adjacent columns and reads its weight
//    rows as one 16-byte load per row (VEC = 8 bf16 or 4 f32) into R*VEC
//    f32 accumulators (two sets for the fused kernel). Latency is hidden
//    by resident warps, not by rows loaded ahead in registers: on the
//    H100, several rows ahead per thread cost more resident blocks than
//    they added loads in flight, and ran slower at decode shapes. The x tile is staged in shared memory transposed, so
//    the R rows of one depth are one broadcast float4. The D reduction is
//    a loop inside the block. With C tiny the (row x column x expert)
//    tiles alone cannot keep 132 SMs streaming, so D is also split over
//    `ksplit` blocks that write f32 partial sums to a workspace, and a
//    second kernel adds them, applies the activation, masks and casts.
//  * tensor cores (bf16, C > 8): 64x64 output tiles of one expert, four
//    warps of 32x32 built from 16x16x16 bf16 WMMA products with f32
//    accumulators; the 32-deep x and weight tiles are double-buffered in
//    shared memory by cp.async, so the next tile's loads overlap this
//    tile's products. Row tiles are the fastest grid axis, so the blocks
//    that share one weight tile run together and read it from L2.
//
// A block whose first row is past its expert's group size writes zeros
// and exits before loading anything. wgmma/TMA are later work. The parts
// shared with the int8 kernels of moe_gmm_q.cu (helpers, epilogues, the
// split-D finish and plan, the tensor-core tiles) are in
// moe_gmm_common.cuh.
#include "moe_gmm_common.cuh"

namespace {

// ------------------------------------------------------------ simt path

// VEC consecutive elements of T as floats, in one load when VEC > 1
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f(__ldg(p));
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "float32 loads are float4");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    static_assert(VEC == 8, "bfloat16 loads are 8 x 16 bits");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// grid: (column tiles, row tiles, E * ksplit); block: NT threads.
template <typename T, bool FUSED, int VEC>
__global__ void __launch_bounds__(NT)
simt_kernel(const T* __restrict__ x, const T* __restrict__ wg,
            const T* __restrict__ wu, const int* __restrict__ gs,
            T* __restrict__ out, float* __restrict__ ws, int E, int C,
            int D, int F, int ksplit, int kchunk) {
  const int e = blockIdx.z / ksplit;
  const int split = blockIdx.z % ksplit;
  const int row0 = blockIdx.y * R;
  const int col0 = (blockIdx.x * NT + threadIdx.x) * VEC;
  const int g = min(max(gs[e], 0), C);
  if (row0 >= g) {   // the whole row tile is padding
    simt_zero_tile<T, VEC>(out, e, C, F, row0, col0, ksplit);
    return;
  }
  const int nrows = min(R, g - row0);
  const int d_begin = split * kchunk;
  const int d_end = min(D, d_begin + kchunk);

  static_assert(R == 4, "the R rows of one depth are one float4");
  __shared__ __align__(16) float xs[BD * R];   // [depth][row]
  float acc_g[R][VEC];
  float acc_u[FUSED ? R : 1][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc_g[r][v] = 0.f;
      if (FUSED) acc_u[FUSED ? r : 0][v] = 0.f;
    }

  const T* xe = x + ((int64_t)e * C + row0) * D;
  const T* wge = wg + (int64_t)e * D * F + col0;
  const T* wue = FUSED ? wu + (int64_t)e * D * F + col0 : nullptr;
  const bool live = col0 < F;

  for (int d0 = d_begin; d0 < d_end; d0 += BD) {
    const int kmax = min(BD, d_end - d0);
    for (int i = threadIdx.x; i < BD * R; i += NT) {
      const int k = i / R, r = i % R;
      xs[i] = (r < nrows && k < kmax) ? to_f(xe[(int64_t)r * D + d0 + k])
                                      : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < kmax; ++k) {
        const int64_t off = (int64_t)(d0 + k) * F;
        float vg[VEC], vu[VEC];
        load_vec<T, VEC>(wge + off, vg);
        if (FUSED) load_vec<T, VEC>(wue + off, vu);
        // rows past nrows were staged as 0
        const float4 xv = reinterpret_cast<const float4*>(xs)[k];
        const float xr[R] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc_g[r][v] = fmaf(xr[r], vg[v], acc_g[r][v]);
            if (FUSED)
              acc_u[FUSED ? r : 0][v] =
                  fmaf(xr[r], vu[v], acc_u[FUSED ? r : 0][v]);
          }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  simt_store<T, FUSED, VEC>(acc_g, acc_u, out, ws, E, C, F, e, row0, nrows,
                            col0, ksplit, split);
}

// ---------------------------------------------------- tensor-core path

// grid: (row tiles, column tiles, E); block: WNT threads.
// Needs D % 8 == 0, F % 8 == 0 and 16-byte aligned x / weights.
template <bool FUSED>
__global__ void __launch_bounds__(WNT)
wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
            const bf16* __restrict__ wu, const int* __restrict__ gs,
            bf16* __restrict__ out, int C, int D, int F) {
  constexpr int NB = FUSED ? 2 : 1;
  const int e = blockIdx.z;
  const int row0 = blockIdx.x * WBM;
  const int col0 = blockIdx.y * WBN;
  const int g = min(max(gs[e], 0), C);
  const int tid = threadIdx.x;
  if (row0 >= g) {
    wmma_zero_tile(out, e, C, F, row0, col0);
    return;
  }
  __shared__ __align__(128) WmmaSmem<NB> sm;
  const bf16* xe = x + (int64_t)e * C * D;
  const bf16* w[2] = {wg + (int64_t)e * D * F,
                      FUSED ? wu + (int64_t)e * D * F : nullptr};

  auto load_stage = [&](int buf, int k0) {
    // x: WBM rows x WBK depth = 256 chunks of 8; weights: WBK x WBN each
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = tid + t * WNT;
      const int r = i / (WBK / 8), c = (i % (WBK / 8)) * 8;
      const bool ok = row0 + r < C && k0 + c < D;
      cp_async16(&sm.st[buf].a[r][c],
                 ok ? xe + (int64_t)(row0 + r) * D + k0 + c : xe, ok);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = tid + t * WNT;
        const int r = i / (WBN / 8), c = (i % (WBN / 8)) * 8;
        const bool ok = k0 + r < D && col0 + c < F;
        cp_async16(&sm.st[buf].b[m][r][c],
                   ok ? w[m] + (int64_t)(k0 + r) * F + col0 + c : w[m], ok);
      }
    cp_async_commit();
  };

  const int warp = tid / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  Acc<NB> acc;
  wmma_zero_acc<NB>(acc);

  const int nk = (D + WBK - 1) / WBK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_stage(buf ^ 1, (kt + 1) * WBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    wmma_stage_mma<NB>(sm.st[buf], acc, wr, wc);
    __syncthreads();   // the next iteration overwrites this buffer
  }
  wmma_epilogue<FUSED>(sm, acc, out, e, C, F, row0, col0, g, wr, wc);
}

// ------------------------------------------------------------ planning

Plan make_plan(int dtype, int E, int C, int D, int F, int aligned,
               int num_sms) {
  Plan p{};
  if (dtype == 1 && C > 2 * R && D % 8 == 0 && F % 8 == 0 && aligned) {
    p.tensor_cores = true;
    p.vec = 8;
    p.ksplit = 1;
    p.kchunk = D;
    return p;
  }
  const int vec = dtype == 1 ? 8 : 4;
  p.vec = (aligned && F % vec == 0) ? vec : 1;
  const int64_t tiles = (int64_t)((C + R - 1) / R) *
                        ((F + NT * p.vec - 1) / (NT * p.vec)) * E;
  plan_split(p, tiles, D, num_sms);
  return p;
}

template <typename T, bool FUSED>
cudaError_t launch(const Plan& p, const void* x, const void* wg,
                   const void* wu, const int* gs, void* out, float* ws,
                   int E, int C, int D, int F, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.tensor_cores) {
      dim3 grid((C + WBM - 1) / WBM, (F + WBN - 1) / WBN, E);
      wmma_kernel<FUSED><<<grid, WNT, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
          static_cast<const bf16*>(wu), gs, static_cast<bf16*>(out), C, D,
          F);
      return cudaGetLastError();
    }
  }
  dim3 grid((F + NT * p.vec - 1) / (NT * p.vec), (C + R - 1) / R,
            E * p.ksplit);
  const T* xt = static_cast<const T*>(x);
  const T* wgt = static_cast<const T*>(wg);
  const T* wut = static_cast<const T*>(wu);
  T* o = static_cast<T*>(out);
  if (p.vec == 1)
    simt_kernel<T, FUSED, 1><<<grid, NT, 0, stream>>>(
        xt, wgt, wut, gs, o, ws, E, C, D, F, p.ksplit, p.kchunk);
  else
    simt_kernel<T, FUSED, std::is_same<T, float>::value ? 4 : 8>
        <<<grid, NT, 0, stream>>>(xt, wgt, wut, gs, o, ws, E, C, D, F,
                                  p.ksplit, p.kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.ksplit == 1) return err;
  return launch_finish<T, FUSED>(ws, gs, o, E, C, F, p.ksplit, stream);
}

}  // namespace

// f32 workspace (in floats) that moe_gmm_launch needs for these
// arguments: the split-reduction partial sums, 0 when D is not split.
// dtype: 0 = float32, 1 = bfloat16; aligned: x, weights and out are
// 16-byte aligned.
extern "C" long long moe_gmm_workspace(int fused, int dtype, int E, int C,
                                       int D, int F, int aligned,
                                       int num_sms) {
  const Plan p = make_plan(dtype, E, C, D, F, aligned, num_sms);
  if (p.tensor_cores || p.ksplit == 1) return 0;
  return (long long)(fused ? 2 : 1) * p.ksplit * E * C * F;
}

// 1 when these arguments take the tensor-core path, else 0.
extern "C" int moe_gmm_uses_tensor_cores(int dtype, int E, int C, int D,
                                         int F, int aligned, int num_sms) {
  return make_plan(dtype, E, C, D, F, aligned, num_sms).tensor_cores;
}

// fused: 1 = silu(x@wg) * (x@wu), 0 = x@wg (wu unused).
// ws: f32 workspace of moe_gmm_workspace(...) floats for the same
// arguments. Returns the cudaError_t of the launches (0 = success).
extern "C" int moe_gmm_launch(int fused, int dtype, const void* x,
                              const void* wg, const void* wu, const int* gs,
                              void* out, float* ws, int E, int C, int D,
                              int F, int aligned, int num_sms,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(dtype, E, C, D, F, aligned, num_sms);
  if (dtype == 0)
    return fused ? launch<float, true>(p, x, wg, wu, gs, out, ws, E, C, D,
                                       F, s)
                 : launch<float, false>(p, x, wg, wu, gs, out, ws, E, C, D,
                                        F, s);
  if (dtype == 1)
    return fused ? launch<bf16, true>(p, x, wg, wu, gs, out, ws, E, C, D,
                                      F, s)
                 : launch<bf16, false>(p, x, wg, wu, gs, out, ws, E, C, D,
                                       F, s);
  return (int)cudaErrorInvalidValue;
}
