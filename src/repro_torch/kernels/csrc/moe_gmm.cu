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
//  * wgmma (bf16 with D % 8 == 0, F % 8 == 0 and 16-byte aligned
//    operands, any C): a TMA-fed wgmma weight stream in which one CTA
//    owns all rows of its expert for its weight tile, so every weight
//    byte is read from HBM once per call (moe_gmm_sm90.cuh, where its
//    design is set out). It takes decode too: at mixtral-8x7b's decode
//    shapes (C = 3, N = 8) it streamed the weights faster than the simt
//    path on an H100 at 700 W (about 0.62 against 0.78 ms fused, 0.32
//    against 0.36 ms gmm, timed in turns by chip_smoke.py).
//  * simt (float32, and the shapes TMA cannot take): one block owns one
//    expert, a tile of R rows and NT*VEC output columns; each thread owns
//    VEC adjacent columns and reads its weight rows as one 16-byte load
//    per row (VEC = 8 bf16 or 4 f32, 1 for unaligned operands) into R*VEC
//    f32 accumulators (two sets for the fused kernel). Latency is hidden
//    by resident warps, not by rows loaded ahead in registers (on the
//    H100, rows ahead cost more resident blocks than they added loads in
//    flight). The x tile is staged in shared memory transposed, so the R
//    rows of one depth are one broadcast float4. The D reduction is a
//    loop inside the block.
//    With C tiny the (row x column x expert) tiles alone cannot keep 132
//    SMs streaming, so D is also split over `ksplit` blocks that write
//    f32 partial sums to a workspace, and a second kernel adds them,
//    applies the activation, masks and casts.
//
// A block whose rows all lie past its expert's group size writes zeros
// and exits before loading anything. The parts shared with the int8
// kernels of moe_gmm_q.cu are in moe_gmm_common.cuh (helpers, the simt
// epilogue, the split-D finish and plan) and sm90.cuh (the wgmma CTA's
// PTX, epilogue and tensor maps).
#include "moe_gmm_sm90.cuh"

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

// ------------------------------------------------------------ planning

// path: -1 = the plan's choice; else the Path to take (a shape that
// Path cannot take is refused with n = 0)
GemmPlan make_plan(int fused, int dtype, int E, int C, int D, int F,
                   int aligned, int num_sms, int path) {
  GemmPlan p{};
  const bool eligible =
      dtype == 1 && D > 0 && D % 8 == 0 && F % 8 == 0 && aligned;
  p.path = path >= 0 ? path : (eligible ? WGMMA : SIMT);
  if (p.path != SIMT) {
    if (eligible && p.path == WGMMA) p.n = wgmma_rows(C);
    return p;
  }
  const int vec = dtype == 1 ? 8 : 4;
  p.simt.vec = (aligned && F % vec == 0) ? vec : 1;
  const int64_t tiles = (int64_t)((C + R - 1) / R) *
                        ((F + NT * p.simt.vec - 1) / (NT * p.simt.vec)) * E;
  plan_split(p.simt, tiles, D, num_sms);
  return p;
}

template <bool FUSED>
int launch_wgmma_rows(int n, const bf16* x, const bf16* wg, const bf16* wu,
                      const int* gs, bf16* out, int E, int C, int D, int F,
                      cudaStream_t stream) {
#define MOE_GMM_N(V) \
  case V:            \
    return launch_wgmma<FUSED, V>(x, wg, wu, gs, out, E, C, D, F, stream);
  switch (n) {
    MOE_GMM_N(8) MOE_GMM_N(16) MOE_GMM_N(32) MOE_GMM_N(64) MOE_GMM_N(96)
    MOE_GMM_N(128) MOE_GMM_N(160)
  }
#undef MOE_GMM_N
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool FUSED>
int launch(const GemmPlan& gp, const void* x, const void* wg, const void* wu,
           const int* gs, void* out, float* ws, int E, int C, int D, int F,
           cudaStream_t stream) {
  if (gp.path != SIMT) {
    if constexpr (std::is_same<T, bf16>::value) {
      if (gp.n == 0) return (int)cudaErrorInvalidValue;
      return launch_wgmma_rows<FUSED>(
          gp.n, static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
          static_cast<const bf16*>(wu), gs, static_cast<bf16*>(out), E, C, D,
          F, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const Plan& p = gp.simt;
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
  if (err != cudaSuccess || p.ksplit == 1) return (int)err;
  return (int)launch_finish<T, FUSED>(ws, gs, o, E, C, F, p.ksplit, stream);
}

}  // namespace

// f32 workspace (in floats) that moe_gmm_launch needs for these
// arguments: the split-reduction partial sums, 0 when D is not split.
// dtype: 0 = float32, 1 = bfloat16; aligned: x, weights and out are
// 16-byte aligned; path: -1 = the plan's, else the path to force (0 =
// simt, 1 = wgmma), for measuring one path against the other.
extern "C" long long moe_gmm_workspace(int fused, int dtype, int E, int C,
                                       int D, int F, int aligned,
                                       int num_sms, int path) {
  const GemmPlan p =
      make_plan(fused, dtype, E, C, D, F, aligned, num_sms, path);
  if (p.path != SIMT || p.simt.ksplit == 1) return 0;
  return (long long)(fused ? 2 : 1) * p.simt.ksplit * E * C * F;
}

// The path the plan takes for these arguments (0 = simt, 1 = wgmma).
// info, when given, receives the wgmma CTA's rows (N), ring stages and
// dynamic shared memory in bytes (zeros on the simt path).
extern "C" int moe_gmm_path(int fused, int dtype, int E, int C, int D,
                            int F, int aligned, int num_sms, int* info) {
  const GemmPlan p =
      make_plan(fused, dtype, E, C, D, F, aligned, num_sms, -1);
  if (info) {
    info[0] = p.n;
    info[1] = p.n ? sm90_stages(p.n) : 0;
    info[2] = p.n ? sm90_smem(p.n) : 0;
  }
  return p.path;
}

// fused: 1 = silu(x@wg) * (x@wu), 0 = x@wg (wu unused).
// ws: f32 workspace of moe_gmm_workspace(...) floats for the same
// arguments. Returns the cudaError_t of the launches (0 = success), or
// 100000 + the CUresult of cuTensorMapEncodeTiled when a tensor map
// cannot be encoded.
extern "C" int moe_gmm_launch(int fused, int dtype, const void* x,
                              const void* wg, const void* wu, const int* gs,
                              void* out, float* ws, int E, int C, int D,
                              int F, int aligned, int num_sms, int path,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmPlan p =
      make_plan(fused, dtype, E, C, D, F, aligned, num_sms, path);
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
