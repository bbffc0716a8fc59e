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
// written as 0. The weights are dequantized on chip, never as a bank in
// device memory.
//
// What bounds it on this card: the weight bytes. In the EP slot plane
// at decode (8 slots a device, up to 16 of them active, C = 3 rows) every
// int8 weight feeds at most C multiply-adds, so the kernel is a stream of
// the active slots' bytes (16 x 2 x 4096 x 14336 B = 1.88 GB for Wg + Wu
// of mixtral-8x7b, >= 0.56 ms at 3.35 TB/s). At prefill (C = 160) each
// byte feeds 160 multiply-adds: still under the ridge, but far beyond
// what the CUDA cores issue in f32, so the products run on the tensor
// cores. A slot whose group size is 0 reads none of its weight bytes:
// its blocks return before loading.
//
// Two paths, chosen per call (make_plan):
//
//  * wgmma (bf16 x with D % 8 == 0, F % 16 == 0 and 16-byte aligned x,
//    weights, scales and out; any C, decode included): the CTA of
//    moe_gmm.cu's bf16 stream (sm90.cuh: A and B swapped, one CTA owns
//    every row of its expert for its weight tile, so each weight byte is
//    read once a call; a TMA producer warpgroup and two consumer
//    warpgroups; 3-D tensor maps zero-fill the ragged edges). What
//    differs is the weight: the producer's ring carries int8 boxes of 128
//    columns x 64 deep (128-byte swizzle, half the bytes of a bf16 stage)
//    and the stage's row scales (a box of 64 floats each, on the same
//    "full" barrier). Each consumer dequantizes its columns of the stage,
//    bf16(w * s[d]) (one 16-byte chunk is 16 columns at one depth, so one
//    scale), into its own bf16 A tiles in the 128-byte-swizzled MN-major
//    layout a bf16 TMA box would have had, then fences the writes to the
//    async proxy, meets its warpgroup at a named barrier and issues the
//    wgmma products on them. Above N = 32 a CTA has an SM to itself and
//    triple-buffers its A tiles: the conversion of one stage overlaps the
//    products of the one before, which may queue behind those of the one
//    before that, and the barrier both publishes this stage's tiles and
//    shows that every warp has seen done the products that read the
//    buffer the next stage writes. At decode's N <= 32 the products are
//    short and the dequantization's latency is what a CTA cannot hide
//    alone: two CTAs share an SM, each with one A buffer (a second
//    barrier waits for the products before it is rewritten) and half the
//    shared memory and registers. A stage is released once its products
//    are done (its x box is B). Rounding to bf16 (2^-9 relative) holds
//    this path to the bf16 tolerance. Measured against this design on an
//    H100 (chip_smoke.py phase 3, in turns): wgmma with A from registers
//    (each thread loading its fragment's int8 bytes from the box, no bf16
//    tile in shared memory) was slower for the fused kernel at decode and
//    prefill and faster only for gmm_quant at decode, so shared-memory
//    traffic is not what bounds this kernel; products at the smallest N
//    covering each CTA's rows, picked by a branch in the main loop, were
//    slower at prefill than products at the N of C; one A buffer above
//    N = 32 (more ring stages) tied or lost at prefill.
//  * simt (float32 x, and bf16 shapes TMA cannot take): one block owns
//    one expert (slot), a tile of R = 4 rows and NT * VEC output columns;
//    each thread owns VEC = 16 adjacent columns and reads its weight rows
//    as one 16-byte load (16 int8 values) per row, into R * 16 f32
//    accumulators (two sets for the fused kernel). U = 4 rows are loaded
//    before any is used. The x tile, already multiplied by the row
//    scales, is staged in shared memory transposed, so the R rows of one
//    depth are one broadcast float4. When C is small the (row x column x
//    expert) tiles cannot keep 132 SMs streaming, so D is split over
//    `ksplit` blocks writing f32 partial sums, and a second kernel adds
//    them, applies the activation, masks and casts. The split is sized
//    for the slots that can have rows (the caller's `max_active` bound:
//    the plan cannot read the group sizes without a device sync). F not a
//    multiple of 16, or unaligned operands, take one-byte loads (VEC = 1).
//
// simt rounding: the TPU kernel forms w * s and then x * (w * s). Here
// the scale is folded into x once per staged depth, as (x[c, d] * s[d]) *
// w[d, f]: one multiply per (row, depth) instead of one per weight
// element. The two differ by float32 rounding of the products (a few
// ulps), well inside the float32 tolerance the callers state.
//
// Each int8 byte becomes a float without the conversion unit (to_float).
// The parts shared with moe_gmm.cu are in moe_gmm_common.cuh (helpers,
// the simt epilogue, the split-D finish and plan) and sm90.cuh (the
// wgmma CTA's PTX, epilogue and tensor maps).
#include "sm90.cuh"

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

// ------------------------------------------------------------ wgmma path

constexpr int Q_BOXF = 128;                // columns of an int8 weight box
constexpr int Q_BOX = Q_BOXF * SM90_BK;    // bytes of one (128 x 64 int8)
// a stage's row scales (64 floats for each of at most two matrices),
// padded so the next stage starts 1024-byte aligned
constexpr int Q_SCALES = 1024;
constexpr int Q_TILE = 64 * SM90_BK * 2;   // a bf16 A tile, 64 x 64

// CTAs an SM holds at N: two at the small N of decode, where the
// products are short and a second CTA's warps hide the latency of the
// dequantization; one above
__host__ __device__ constexpr int q_ctas(int n) { return n <= 32 ? 2 : 1; }

// A-tile buffers a consumer: one when two CTAs share an SM (the products
// that read it finish before it is written again); else three, one being
// written while the products of the two stages before may still read
// theirs
__host__ __device__ constexpr int q_bufs(int n) {
  return q_ctas(n) == 2 ? 1 : 3;
}

// the consumers' A tiles: 2 consumers x q_bufs(n) buffers x SM90_NA
__host__ __device__ constexpr int q_atiles(int n) {
  return 2 * q_bufs(n) * SM90_NA * Q_TILE;
}

// bytes of one stage: the x box (N rows x 64 deep, bf16), two int8
// weight boxes and the scales
__host__ __device__ constexpr int q_stage_bytes(int n) {
  return n * SM90_BK * 2 + 2 * Q_BOX + Q_SCALES;
}

// shared memory a CTA may use: all of a CTA's 227 KB, or half of the
// SM's 228 KB less the 1 KB the system keeps for each CTA
constexpr int q_smem_cap(int n) {
  return q_ctas(n) == 2 ? 233472 / 2 - 1024 : SM90_SMEM;
}

// stages of the ring that fit beside the A tiles (with the 1024-byte
// alignment slack and two barriers a stage)
constexpr int q_stages(int n) {
  return (q_smem_cap(n) - 1024 - q_atiles(n)) / (q_stage_bytes(n) + 16) <
                 SM90_MAX_STAGES
             ? (q_smem_cap(n) - 1024 - q_atiles(n)) / (q_stage_bytes(n) + 16)
             : SM90_MAX_STAGES;
}

// dynamic shared memory of a CTA
constexpr int q_smem(int n) {
  return 1024 + q_atiles(n) + q_stages(n) * (q_stage_bytes(n) + 16);
}

// 16 int8 weights of one depth (a 16-byte word) times that depth's
// scale, each rounded once to bf16 as bf16(w * s): columns 0-7 in lo,
// 8-15 in hi
__device__ __forceinline__ void dequant16(uint4 raw, float s, uint4& lo,
                                          uint4& hi) {
  float q[16];
  to_float(make_int4((int)raw.x, (int)raw.y, (int)raw.z, (int)raw.w), q);
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(q[2 * i] * s,
                                                   q[2 * i + 1] * s);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  lo = make_uint4(p[0], p[1], p[2], p[3]);
  hi = make_uint4(p[4], p[5], p[6], p[7]);
}

// grid: (row groups, column tiles, E); block: SM90_THREADS; dynamic
// shared memory q_smem(N): the consumers' bf16 A tiles, then a ring of
// `stages` = q_stages(N) stages, each the x box, two int8 weight boxes
// and the row scales. FUSED: the boxes are Wg's and Wu's columns
// [col0, col0 + 128), and consumer cw converts columns 64 cw .. of each
// (its gate and up accumulators); else W's columns [col0, + 128) and
// [col0 + 128, + 128), and consumer cw converts box cw (its two
// 64-column slices). A CTA owns rows [blockIdx.x * N, + N) of its
// expert.
template <bool FUSED, int N>
__global__ void __launch_bounds__(SM90_THREADS, q_ctas(N))
wgmma_q_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap gmap,
               const __grid_constant__ CUtensorMap umap,
               const __grid_constant__ CUtensorMap sgmap,
               const __grid_constant__ CUtensorMap sumap,
               const int* __restrict__ gs, bf16* __restrict__ out, int C,
               int D, int F, int stages) {
  constexpr int NA = SM90_NA;
  constexpr int XBYTES = N * SM90_BK * 2;
  constexpr int STAGE = q_stage_bytes(N);
  constexpr int NS = FUSED ? 2 : 1;   // scale vectors a stage
  constexpr int COLS = sm90_cols(FUSED);
  constexpr int BUFS = q_bufs(N);
  // registers a thread: the producer gives its away to the consumers,
  // within the share of the SM's 64K that each of q_ctas(N) CTAs holds
  constexpr int PRODUCER_REGS = q_ctas(N) == 2 ? 24 : 40;
  constexpr int CONSUMER_REGS = q_ctas(N) == 2 ? 104 : 232;
  const int e = blockIdx.z;
  const int row0 = blockIdx.x * N;
  const int col0 = blockIdx.y * COLS;
  const int g = min(max(gs[e], 0), C);
  if (row0 >= g) {   // every row of the tile is padding: no weight byte
    sm90_zero_tile(out, e, C, F, row0, col0, N, COLS);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem + q_atiles(N);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int s = 0, phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        if (kt >= stages) mbar_wait(&empty[s], phase ^ 1);
        uint8_t* st = ring + s * STAGE;
        const int k0 = kt * SM90_BK;
        mbar_expect_tx(&full[s], XBYTES + 2 * Q_BOX + NS * SM90_BK * 4);
        tma_load_3d(st, &xmap, &full[s], k0, row0, e);
#pragma unroll
        for (int b = 0; b < 2; ++b)
          tma_load_3d(st + XBYTES + b * Q_BOX,
                      (FUSED && b == 1) ? &umap : &gmap, &full[s],
                      FUSED ? col0 : col0 + b * Q_BOXF, k0, e);
#pragma unroll
        for (int v = 0; v < NS; ++v)
          tma_load_3d(st + XBYTES + 2 * Q_BOX + v * SM90_BK * 4,
                      v ? &sumap : &sgmap, &full[s], k0, e, 0);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1, t = threadIdx.x % 128;
    // this thread's depth of a stage, and the first of its two 16-column
    // chunks (q0, q0 + 2) of each 64-column slice: eight neighbouring
    // threads take eight depths, so their 16-byte reads and writes fall
    // on eight different bank groups of the swizzled rows
    const int dr = t % 64, q0 = t / 64;
    uint8_t* atiles = smem + cw * BUFS * NA * Q_TILE;
    float acc[NA][N / 2];
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_acc(acc[a]);
    int s = 0, phase = 0, prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[s], phase);
      const uint8_t* st = ring + s * STAGE;
      uint8_t* buf = atiles + (kt % BUFS) * NA * Q_TILE;
      const float* sc =
          reinterpret_cast<const float*>(st + XBYTES + 2 * Q_BOX);
      if constexpr (BUFS == 1) {
        // the products of the stage before read the buffer: every warp
        // has to be past them before any writes it
        wgmma_wait<0>();
        named_sync(2 + cw, 128);
        if (kt > 0 && t == 0) mbar_arrive(&empty[prev]);
      }
      // the int8 slices of this consumer -> its bf16 A tiles, each
      // 16-byte chunk at its swizzled place (chunk j of row d at j ^ d % 8)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const uint8_t* box = st + XBYTES + (FUSED ? a : cw) * Q_BOX;
        const int qb = FUSED ? cw * 4 : a * 4;   // the slice's first chunk
        const float sd = sc[(FUSED ? a : 0) * SM90_BK + dr];
        uint8_t* tile = buf + a * Q_TILE + dr * 128;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = q0 + 2 * j;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              box + dr * 128 + (((qb + q) ^ (dr & 7)) << 4));
          uint4 lo, hi;
          dequant16(raw, sd, lo, hi);
          *reinterpret_cast<uint4*>(tile + (((2 * q) ^ (dr & 7)) << 4)) = lo;
          *reinterpret_cast<uint4*>(tile + (((2 * q + 1) ^ (dr & 7)) << 4)) =
              hi;
        }
      }
      fence_proxy_async();
      // every warp of the consumer has written its part of this stage's
      // tiles and (three buffers), at its wait one stage ago, seen the
      // products of stage kt - 2 done: the next stage overwrites their
      // buffer
      named_sync(2 + cw, 128);
      const uint64_t db = sw128_desc(st, 16);
      uint64_t da[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) da[a] = sw128_desc(buf + a * Q_TILE, 1024);
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
      if constexpr (BUFS != 1) {
        wgmma_wait<1>();   // the products of the stage before are done
        if (kt > 0 && t == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_acc(acc[a]);
    // both consumers are done with the tiles and the ring, which now
    // hold the output tile as rows
    sm90_epilogue<FUSED, N>(acc, smem, out, e, C, F, row0, col0, g, cw);
  }
}

// x (E, C, D) bf16, int8 weights (E, D, F) with f32 scales (E, D), out
// (E, C, F) bf16; wu, su unused unless FUSED. Returns a cudaError_t, or
// SM90_ENCODE_ERROR + the encoder's CUresult when a tensor map cannot be
// encoded.
template <bool FUSED, int N>
int launch_wgmma_q(const bf16* x, const int8_t* wg, const float* sg,
                   const int8_t* wu, const float* su, const int* gs,
                   bf16* out, int E, int C, int D, int F,
                   cudaStream_t stream) {
  constexpr int stages = q_stages(N);
  constexpr int cols = sm90_cols(FUSED);
  static_assert(stages >= 2, "a ring needs two stages");
  static_assert(sm90_out_bytes(FUSED, N) <=
                    q_atiles(N) + stages * q_stage_bytes(N),
                "the epilogue tile reuses the A tiles and the ring");
  constexpr int smem = q_smem(N);
  auto kernel = wgmma_q_kernel<FUSED, N>;
  // once a process (the port drives one card): the dynamic shared memory,
  // and the largest carve-out, so that q_ctas(N) CTAs fit an SM
  static const cudaError_t attr = [&] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (attr != cudaSuccess) return (int)attr;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr CUtensorMapSwizzle FLAT = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap xmap, gmap, umap, sgmap, sumap;
  int rc = encode_3d(&xmap, x, BF16, 2, D, C, E, SM90_BK, N, SW128);
  // int8 bytes move as uint8: TMA copies them without reading them
  if (rc == 0)
    rc = encode_3d(&gmap, wg, U8, 1, F, D, E, Q_BOXF, SM90_BK, SW128);
  // the scales as (1, E, D): a stage's box is 64 depths of one expert
  if (rc == 0) rc = encode_3d(&sgmap, sg, F32, 4, D, E, 1, SM90_BK, 1, FLAT);
  if (rc == 0 && FUSED)
    rc = encode_3d(&umap, wu, U8, 1, F, D, E, Q_BOXF, SM90_BK, SW128);
  if (rc == 0 && FUSED)
    rc = encode_3d(&sumap, su, F32, 4, D, E, 1, SM90_BK, 1, FLAT);
  if (rc != 0) return SM90_ENCODE_ERROR + rc;
  if (!FUSED) {   // unused
    umap = gmap;
    sumap = sgmap;
  }
  dim3 grid((C + N - 1) / N, (F + cols - 1) / cols, E);
  kernel<<<grid, SM90_THREADS, smem, stream>>>(xmap, gmap, umap, sgmap,
                                                sumap, gs, out, C, D, F,
                                                stages);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ planning

// max_active: at most this many experts (slots) have rows (0: all E).
// The simt launch covers all E; its split is sized for the active ones,
// whose blocks are the only ones that stream weights.
// aligned: x, the int8 weights, their scales and out are 16-byte
// aligned. path: -1 = the plan's choice; else the Path to take (a shape
// that Path cannot take is refused with n = 0).
GemmPlan make_plan(int dtype, int E, int C, int D, int F, int aligned,
                   int num_sms, int max_active, int path) {
  GemmPlan p{};
  const bool eligible =
      dtype == 1 && D > 0 && D % 8 == 0 && F % 16 == 0 && aligned;
  p.path = path >= 0 ? path : (eligible ? WGMMA : SIMT);
  if (p.path != SIMT) {
    if (eligible && p.path == WGMMA) p.n = wgmma_rows(C);
    return p;
  }
  p.simt.vec = (aligned && F % 16 == 0) ? 16 : 1;
  const int e_live = max_active > 0 && max_active < E ? max_active : E;
  const int64_t tiles =
      (int64_t)((C + R - 1) / R) *
      ((F + NT * p.simt.vec - 1) / (NT * p.simt.vec)) * e_live;
  plan_split(p.simt, tiles, D, num_sms);
  return p;
}

template <bool FUSED>
int launch_wgmma_q_rows(int n, const bf16* x, const int8_t* wg,
                        const float* sg, const int8_t* wu, const float* su,
                        const int* gs, bf16* out, int E, int C, int D, int F,
                        cudaStream_t stream) {
#define MOE_GMM_Q_N(V)                                                    \
  case V:                                                                 \
    return launch_wgmma_q<FUSED, V>(x, wg, sg, wu, su, gs, out, E, C, D, \
                                    F, stream);
  switch (n) {
    MOE_GMM_Q_N(8) MOE_GMM_Q_N(16) MOE_GMM_Q_N(32) MOE_GMM_Q_N(64)
    MOE_GMM_Q_N(96) MOE_GMM_Q_N(128) MOE_GMM_Q_N(160)
  }
#undef MOE_GMM_Q_N
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool FUSED>
int launch(const GemmPlan& gp, const void* x, const int8_t* wg,
           const float* sg, const int8_t* wu, const float* su,
           const int* gs, void* out, float* ws, int E, int C, int D, int F,
           cudaStream_t stream) {
  if (gp.path != SIMT) {
    if constexpr (std::is_same<T, bf16>::value) {
      if (gp.n == 0) return (int)cudaErrorInvalidValue;
      return launch_wgmma_q_rows<FUSED>(gp.n, static_cast<const bf16*>(x),
                                        wg, sg, wu, su, gs,
                                        static_cast<bf16*>(out), E, C, D, F,
                                        stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  const Plan& p = gp.simt;
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
  if (err != cudaSuccess || p.ksplit == 1) return (int)err;
  return (int)launch_finish<T, FUSED>(ws, gs, o, E, C, F, p.ksplit, stream);
}

}  // namespace

// The path a launch with these arguments takes (0 = simt, 1 = wgmma).
// dtype of x: 0 = float32, 1 = bfloat16; aligned: x, the int8 weights,
// their scales and out are 16-byte aligned; max_active: an upper bound
// on the experts with rows (0: unknown), which sizes the simt D split;
// path: -1 = the plan's, else the path to force (for measuring one path
// against the other). info receives: [0] the D splits (1 on wgmma), [1]
// the wgmma CTA's rows N (0 on simt, or when a forced wgmma cannot take
// the shape), [2] its ring stages, [3] its dynamic shared memory in
// bytes, [4] the f32 workspace in floats that moe_gmm_q_launch needs (the
// split-D partial sums; 0 unless simt splits D).
extern "C" int moe_gmm_q_plan(int fused, int dtype, int E, int C, int D,
                              int F, int aligned, int num_sms,
                              int max_active, int path, long long* info) {
  const GemmPlan p =
      make_plan(dtype, E, C, D, F, aligned, num_sms, max_active, path);
  const bool split = p.path == SIMT && p.simt.ksplit > 1;
  info[0] = p.path == SIMT ? p.simt.ksplit : 1;
  info[1] = p.n;
  info[2] = p.n ? q_stages(p.n) : 0;
  info[3] = p.n ? q_smem(p.n) : 0;
  info[4] = split ? (long long)(fused ? 2 : 1) * p.simt.ksplit * E * C * F
                  : 0;
  return p.path;
}

// fused: 1 = silu(x @ deq(wg, sg)) * (x @ deq(wu, su)), 0 = x @ deq(wg,
// sg) (wu, su unused). dtype of x and out: 0 = float32, 1 = bfloat16.
// aligned, max_active and path as for moe_gmm_q_plan; ws: f32 workspace
// of the floats moe_gmm_q_plan names for the same arguments. Returns the
// cudaError_t of the launches (0 = success), or 100000 + the CUresult of
// cuTensorMapEncodeTiled when a tensor map cannot be encoded.
extern "C" int moe_gmm_q_launch(int fused, int dtype, const void* x,
                                const void* wg, const void* sg,
                                const void* wu, const void* su,
                                const int* gs, void* out, float* ws, int E,
                                int C, int D, int F, int aligned,
                                int num_sms, int max_active, int path,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmPlan p =
      make_plan(dtype, E, C, D, F, aligned, num_sms, max_active, path);
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
