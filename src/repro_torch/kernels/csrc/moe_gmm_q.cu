// Dequantizing grouped expert matmuls over int8 slot banks, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels
// src/repro/kernels/moe_gmm.py:fused_gate_up_quant (_ffn_q_kernel) and
// src/repro/kernels/moe_gmm.py:gmm_quant (_gmm_q_kernel):
//
//   fused_gate_up_quant:
//     h[e, c, :] = silu(x[e, c] @ deq(Wg[e], sg[e])) * (x[e, c] @ deq(Wu[e], su[e]))
//   gmm_quant:
//     y[e, c, :] = x[e, c] @ deq(W[e], s[e])
//
// with x (E, C, D) float32 or bfloat16, int8 weights (E, D, F), float32
// per-row scales (E, D) on the contraction axis (deq(W, s)[d, f] =
// W[d, f] * s[d], the layout of repro_torch/kernels/quant.py), f32
// accumulation, output in x's dtype, and rows c >= group_sizes[e]
// written as 0. The weights are dequantized in registers, one element
// at a time, never as a bank in device memory.
//
// Rounding: the TPU kernel forms w * s and then x * (w * s). Here the
// scale is folded into x once per staged depth, as (x[c, d] * s[d]) *
// w[d, f]: one multiply per (row, depth) instead of one per weight
// element. The two differ by float32 rounding of the products (a few
// ulps), well inside the float32 tolerance the callers state.
//
// What bounds it on this card: the weight bytes. In the EP slot plane
// at decode (8 slots a device, up to 16 of them active, C = 3 rows) every int8
// weight feeds at most C multiply-adds, so the kernel is a stream of the
// active slots' bytes (16 x 2 x 4096 x 14336 B = 1.88 GB for Wg + Wu of
// mixtral-8x7b, >= 0.56 ms at 3.35 TB/s). A slot whose group size is 0
// reads none of its weight bytes: its blocks return before loading.
//
// Design (the simt path of moe_gmm.cu, with int8 weights): one block
// owns one expert (slot), a tile of R = 4 rows and NT * VEC output
// columns; each thread owns VEC = 16 adjacent columns and reads its
// weight rows as one 16-byte load (16 int8 values) per row, into R * 16
// f32 accumulators (two sets for the fused kernel). U = 4 rows are
// loaded before any is used: with ~128 accumulators a thread, few warps
// fit an SM, and one load in flight per thread left the stream at a
// third of the HBM rate (gmm_quant decode, H100). The x tile, already
// multiplied by the row scales, is staged in shared memory transposed,
// so the R rows of one depth are one broadcast float4 (one per weight
// matrix in the fused kernel, whose two matrices have their own scales).
// When C is small the (row x column x expert) tiles cannot keep 132 SMs
// streaming, so D is split over `ksplit` blocks writing f32 partial
// sums, and a second kernel adds them, applies the activation, masks
// and casts. The split is sized for the slots that can have rows (the
// caller's `max_active` bound: the plan cannot read the group sizes
// without a device sync), not for every slot of the bank. F not a multiple of 16, or unaligned operands, take
// one-byte loads (VEC = 1).
//
// Prefill (bf16 x, C > 8): 160 rows a slot make the products, not the
// bytes, the limit, beyond what the CUDA cores issue in f32. A
// tensor-core path takes them: the tiles of moe_gmm.cu's WMMA path (64 x
// 64 outputs of one expert, four warps of 32 x 32 from 16x16x16 bf16
// products, f32 accumulators), with each 32 x 64 int8 weight tile loaded
// as one 16-byte word a thread, dequantized in registers to bf16 as
// bf16(w * s[d]) and stored to shared memory; the x tile comes by
// cp.async. The next tile's loads are issued before this tile's
// products. Dequantized weights are rounded to bf16 there (2^-9
// relative), so this path is held at the bf16 tolerance; float32 x stays
// on the simt path. The parts shared with moe_gmm.cu (helpers,
// epilogues, the split-D finish and plan, the tensor-core tiles) are in
// moe_gmm_common.cuh.
#include "moe_gmm_common.cuh"

namespace {

// ------------------------------------------------------------ simt path

constexpr int U = 4;     // weight rows loaded ahead of their products

// VEC consecutive int8 weights as loaded: one 16-byte word (VEC = 16) or
// one byte (VEC = 1)
template <int VEC> struct Raw;
template <> struct Raw<16> { typedef int4 type; };
template <> struct Raw<1> { typedef signed char type; };

template <int VEC>
__device__ __forceinline__ typename Raw<VEC>::type load_raw(
    const int8_t* __restrict__ p) {
  return __ldg(reinterpret_cast<const typename Raw<VEC>::type*>(p));
}

// the VEC loaded weights as floats
__device__ __forceinline__ void to_float(signed char v, float* out) {
  out[0] = static_cast<float>(v);
}
__device__ __forceinline__ void to_float(int4 v, float* out) {
  // int8 -> float without the conversion unit (a quarter-rate
  // instruction that would cap the stream): flipping the sign bit makes
  // each byte b + 128; placed under the exponent byte 0x4B it reads as
  // the float 2^23 + b + 128, exactly, and one subtraction leaves b
  const unsigned w[4] = {(unsigned)v.x ^ 0x80808080u,
                         (unsigned)v.y ^ 0x80808080u,
                         (unsigned)v.z ^ 0x80808080u,
                         (unsigned)v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = __int_as_float((int)__byte_perm(w[i / 4], 0x4B000000u,
                                              0x7440u + (i % 4))) -
             8388736.0f;
}

// grid: (column tiles, row tiles, E * ksplit); block: NT threads.
template <typename T, bool FUSED, int VEC>
__global__ void __launch_bounds__(NT)
simt_q_kernel(const T* __restrict__ x, const int8_t* __restrict__ wg,
              const float* __restrict__ sg, const int8_t* __restrict__ wu,
              const float* __restrict__ su, const int* __restrict__ gs,
              T* __restrict__ out, float* __restrict__ ws, int E, int C,
              int D, int F, int ksplit, int kchunk) {
  const int e = blockIdx.z / ksplit;
  const int split = blockIdx.z % ksplit;
  const int row0 = blockIdx.y * R;
  const int col0 = (blockIdx.x * NT + threadIdx.x) * VEC;
  const int g = min(max(gs[e], 0), C);
  if (row0 >= g) {
    // the whole row tile is padding: an empty slot reads no weight byte
    simt_zero_tile<T, VEC>(out, e, C, F, row0, col0, ksplit);
    return;
  }
  const int nrows = min(R, g - row0);
  const int d_begin = split * kchunk;
  const int d_end = min(D, d_begin + kchunk);

  static_assert(R == 4, "the R rows of one depth are one float4");
  // x * scale, [depth][row]; a second copy with the up matrix's scales
  __shared__ __align__(16) float xs_g[BD * R];
  __shared__ __align__(16) float xs_u[FUSED ? BD * R : 4];
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
  const float* sge = sg + (int64_t)e * D;
  const float* sue = FUSED ? su + (int64_t)e * D : nullptr;
  const int8_t* wge = wg + (int64_t)e * D * F + col0;
  const int8_t* wue = FUSED ? wu + (int64_t)e * D * F + col0 : nullptr;
  const bool live = col0 < F;

  for (int d0 = d_begin; d0 < d_end; d0 += BD) {
    const int kmax = min(BD, d_end - d0);
    for (int i = threadIdx.x; i < BD * R; i += NT) {
      const int k = i / R, r = i % R;
      float xv = 0.f, vg = 0.f, vu = 0.f;
      if (k < kmax) {
        if (r < nrows) xv = to_f(xe[(int64_t)r * D + d0 + k]);
        vg = xv * __ldg(sge + d0 + k);
        if (FUSED) vu = xv * __ldg(sue + d0 + k);
      }
      xs_g[i] = vg;
      if (FUSED) xs_u[i] = vu;
    }
    __syncthreads();
    if (live) {
      // U rows of weights are loaded before any of them is used, so each
      // thread keeps U (x2 fused) 16-byte loads in flight
      for (int k0 = 0; k0 < kmax; k0 += U) {
        typename Raw<VEC>::type rg[U], ru[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k0 + u < kmax) {
            const int64_t off = (int64_t)(d0 + k0 + u) * F;
            rg[u] = load_raw<VEC>(wge + off);
            if (FUSED) ru[u] = load_raw<VEC>(wue + off);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k0 + u < kmax) {
            const int k = k0 + u;
            float qg[VEC], qu[VEC];
            to_float(rg[u], qg);
            if (FUSED) to_float(ru[u], qu);
            // rows past nrows were staged as 0
            const float4 xg = reinterpret_cast<const float4*>(xs_g)[k];
            const float xr[R] = {xg.x, xg.y, xg.z, xg.w};
            float xu_r[R] = {0.f, 0.f, 0.f, 0.f};
            if (FUSED) {
              const float4 xu = reinterpret_cast<const float4*>(xs_u)[k];
              xu_r[0] = xu.x; xu_r[1] = xu.y; xu_r[2] = xu.z;
              xu_r[3] = xu.w;
            }
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                acc_g[r][v] = fmaf(xr[r], qg[v], acc_g[r][v]);
                if (FUSED)
                  acc_u[FUSED ? r : 0][v] =
                      fmaf(xu_r[r], qu[v], acc_u[FUSED ? r : 0][v]);
              }
          }
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
// Needs bf16 x, D % 8 == 0, F % 16 == 0 and 16-byte aligned x / weights.
template <bool FUSED>
__global__ void __launch_bounds__(WNT)
wmma_q_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wg,
              const float* __restrict__ sg, const int8_t* __restrict__ wu,
              const float* __restrict__ su, const int* __restrict__ gs,
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
  const int8_t* w[2] = {wg + (int64_t)e * D * F,
                        FUSED ? wu + (int64_t)e * D * F : nullptr};
  const float* sc[2] = {sg + (int64_t)e * D,
                        FUSED ? su + (int64_t)e * D : nullptr};
  // this thread's 16 int8 weights of a 32 x 64 tile: row br, columns bc..
  const int br = tid / (WBN / 16), bc = (tid % (WBN / 16)) * 16;

  auto load_a = [&](int buf, int k0) {
    // x: WBM rows x WBK depth = 256 chunks of 8
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = tid + t * WNT;
      const int r = i / (WBK / 8), c = (i % (WBK / 8)) * 8;
      const bool ok = row0 + r < C && k0 + c < D;
      cp_async16(&sm.st[buf].a[r][c],
                 ok ? xe + (int64_t)(row0 + r) * D + k0 + c : xe, ok);
    }
    cp_async_commit();
  };
  auto load_b = [&](int k0, int4* raw, float* scale) {
    const bool ok = k0 + br < D && col0 + bc < F;
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      raw[m] = ok ? __ldg(reinterpret_cast<const int4*>(
                        w[m] + (int64_t)(k0 + br) * F + col0 + bc))
                  : make_int4(0, 0, 0, 0);
      scale[m] = ok ? __ldg(sc[m] + k0 + br) : 0.f;
    }
  };
  auto store_b = [&](int buf, const int4* raw, const float* scale) {
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      float q[16];
      to_float(raw[m], q);
      __align__(16) bf16 v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = __float2bfloat16(q[i] * scale[m]);
      int4* dst = reinterpret_cast<int4*>(&sm.st[buf].b[m][br][bc]);
      dst[0] = reinterpret_cast<const int4*>(v)[0];
      dst[1] = reinterpret_cast<const int4*>(v)[1];
    }
  };

  const int warp = tid / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  Acc<NB> acc;
  wmma_zero_acc<NB>(acc);

  const int nk = (D + WBK - 1) / WBK;
  int4 raw[NB];
  float scale[NB];
  load_a(0, 0);
  load_b(0, raw, scale);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    store_b(buf, raw, scale);
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < nk) {   // the next tile's loads overlap these products
      load_a(buf ^ 1, (kt + 1) * WBK);
      load_b((kt + 1) * WBK, raw, scale);
    }
    wmma_stage_mma<NB>(sm.st[buf], acc, wr, wc);
    __syncthreads();   // the next iteration overwrites the other buffer
  }
  wmma_epilogue<FUSED>(sm, acc, out, e, C, F, row0, col0, g, wr, wc);
}

// ------------------------------------------------------------ planning

// max_active: at most this many experts (slots) have rows (0: all E).
// The launch covers all E; the split is sized for the active ones, whose
// blocks are the only ones that stream weights.
// aligned: x, the weights and out are 16-byte aligned.
Plan make_plan(int dtype, int E, int C, int D, int F, int aligned,
               int num_sms, int max_active) {
  Plan p{};
  p.vec = (aligned && F % 16 == 0) ? 16 : 1;
  if (dtype == 1 && C > 2 * R && D % 8 == 0 && p.vec == 16) {
    p.tensor_cores = true;
    p.ksplit = 1;
    p.kchunk = D;
    return p;
  }
  const int e_live = max_active > 0 && max_active < E ? max_active : E;
  const int64_t tiles = (int64_t)((C + R - 1) / R) *
                        ((F + NT * p.vec - 1) / (NT * p.vec)) * e_live;
  plan_split(p, tiles, D, num_sms);
  return p;
}

template <typename T, bool FUSED>
cudaError_t launch(const Plan& p, const void* x, const int8_t* wg,
                   const float* sg, const int8_t* wu, const float* su,
                   const int* gs, void* out, float* ws, int E, int C, int D,
                   int F, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.tensor_cores) {
      dim3 grid((C + WBM - 1) / WBM, (F + WBN - 1) / WBN, E);
      wmma_q_kernel<FUSED><<<grid, WNT, 0, stream>>>(
          static_cast<const bf16*>(x), wg, sg, wu, su, gs,
          static_cast<bf16*>(out), C, D, F);
      return cudaGetLastError();
    }
  }
  dim3 grid((F + NT * p.vec - 1) / (NT * p.vec), (C + R - 1) / R,
            E * p.ksplit);
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (p.vec == 16)
    simt_q_kernel<T, FUSED, 16><<<grid, NT, 0, stream>>>(
        xt, wg, sg, wu, su, gs, o, ws, E, C, D, F, p.ksplit, p.kchunk);
  else
    simt_q_kernel<T, FUSED, 1><<<grid, NT, 0, stream>>>(
        xt, wg, sg, wu, su, gs, o, ws, E, C, D, F, p.ksplit, p.kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.ksplit == 1) return err;
  return launch_finish<T, FUSED>(ws, gs, o, E, C, F, p.ksplit, stream);
}

}  // namespace

// f32 workspace (in floats) that moe_gmm_q_launch needs for these
// arguments: the split-reduction partial sums, 0 when D is not split.
// dtype of x: 0 = float32, 1 = bfloat16; aligned: x, the int8 weights
// and out are 16-byte aligned.
extern "C" long long moe_gmm_q_workspace(int fused, int dtype, int E, int C,
                                         int D, int F, int aligned,
                                         int num_sms, int max_active) {
  const Plan p = make_plan(dtype, E, C, D, F, aligned, num_sms, max_active);
  if (p.tensor_cores || p.ksplit == 1) return 0;
  return (long long)(fused ? 2 : 1) * p.ksplit * E * C * F;
}

// The path these arguments launch: 0 for the tensor cores, else the simt
// path's columns per thread (16: one 16-byte load per weight row; 1:
// byte loads), with its number of D splits in *ksplit.
extern "C" int moe_gmm_q_plan(int dtype, int E, int C, int D, int F,
                              int aligned, int num_sms, int max_active,
                              int* ksplit) {
  const Plan p = make_plan(dtype, E, C, D, F, aligned, num_sms, max_active);
  if (ksplit) *ksplit = p.ksplit;
  return p.tensor_cores ? 0 : p.vec;
}

// fused: 1 = silu(x @ deq(wg, sg)) * (x @ deq(wu, su)), 0 = x @ deq(wg,
// sg) (wu, su unused). dtype of x and out: 0 = float32, 1 = bfloat16.
// max_active: an upper bound on the experts with rows (0: unknown), which
// sizes the D split. ws: f32 workspace of moe_gmm_q_workspace(...)
// floats for the same arguments. Returns the cudaError_t of the launches (0 = success).
extern "C" int moe_gmm_q_launch(int fused, int dtype, const void* x,
                                const void* wg, const void* sg,
                                const void* wu, const void* su,
                                const int* gs, void* out, float* ws, int E,
                                int C, int D, int F, int aligned,
                                int num_sms, int max_active,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(dtype, E, C, D, F, aligned, num_sms, max_active);
  const int8_t* wgq = static_cast<const int8_t*>(wg);
  const int8_t* wuq = static_cast<const int8_t*>(wu);
  const float* sgf = static_cast<const float*>(sg);
  const float* suf = static_cast<const float*>(su);
  if (dtype == 0)
    return fused ? launch<float, true>(p, x, wgq, sgf, wuq, suf, gs, out,
                                       ws, E, C, D, F, s)
                 : launch<float, false>(p, x, wgq, sgf, wuq, suf, gs, out,
                                        ws, E, C, D, F, s);
  if (dtype == 1)
    return fused ? launch<bf16, true>(p, x, wgq, sgf, wuq, suf, gs, out, ws,
                                      E, C, D, F, s)
                 : launch<bf16, false>(p, x, wgq, sgf, wuq, suf, gs, out,
                                       ws, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}
