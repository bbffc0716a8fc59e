// One-query decode attention against a contiguous (ring) KV cache or a
// paged block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/decode_attn.py:
// decode_attention (_kernel): flash decoding of one new query per row
// b, with q (B, H, hd), k/v (B, S, KV, hd), kv_pos (B, S) and per-row
// kv_len / q_pos (B,); and decode_attention_paged (_paged_kernel): the
// same recurrence over a global pool k/v (NB, blk, KV, hd), kv_pos
// (NB, blk), where logical slot s of row b lives at pool block
// tables[b, s / blk], offset s % blk, and S = nbs * blk. As the TPU
// kernel's _paged_kernel calls _kernel, both launches run one kernel
// body, templated on where a slot lives (ContiguousSlots, PagedSlots).
// Slot addresses are computed per slot, never per tile, so a 32-slot
// tile may span several pool blocks or part of one (any blk >= 1).
// Lanes past kv_len are still read (unassigned table entries point at
// pool block 0) and score NEG_INF like every hidden lane, so a fully
// hidden row averages v over all S lanes, as the plain version does. Query head h reads KV head h / (H / KV). Slot s
// is visible when s < kv_len[b] and kv_pos[b, s] <= q_pos[b] (and
// kv_pos[b, s] > q_pos[b] - window when window > 0); hidden slots score
// the finite NEG_INF = -0.7 * FLT_MAX, as in the reference, so a fully
// hidden row averages v instead of producing NaN. q is scaled by
// 1/sqrt(hd) in its own dtype before the dot, as the Pallas wrapper
// does; the running (m, l, acc) recurrence is kept in f32 and l is
// clamped at 1e-30.
//
// What bounds it on this card: the bytes of K and V. At the main path's
// decode (8 rows x 561 slots x 8 KV heads x 128 x 2 tensors x 2 bytes,
// about 18 MB a layer; 576 slots paged) that is ~5.5 us at 3.35 TB/s,
// so launch latency and the length of each block's serial loop
// dominate.
//
// Design: one block per (row b, KV head, split of S) serves all H/KV
// query heads of that group, so each K/V tile is read from device memory
// once per group, not once per query head. The rows x KV heads alone
// give too few blocks for 132 SMs, so S is split over `nsplit` blocks
// (flash decoding): each folds its slots into a partial (m, l, acc) and
// a second kernel merges the splits. Inside a block the loop over S runs
// over BS = 32-slot tiles staged in shared memory as f32 (16-byte loads;
// K rows padded by one float so the per-slot dot products of a warp hit
// distinct banks): each thread scores (head, slot) pairs, each warp runs
// the online softmax of one head with warp shuffles (BS = warp size),
// and every thread rescales and accumulates its (head, dim) outputs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BS = 32;        // cache slots per shared-memory tile
constexpr int NT = 128;       // threads per block
constexpr int NWARP = NT / 32;
constexpr int ACC_MAX = 16;   // (head, dim) outputs per thread: G*hd <= 2048
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 (bf16) or 4 (f32) consecutive elements per 16-byte load
template <typename T>
constexpr int kVec = std::is_same<T, float>::value ? 4 : 8;

template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, float* o) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// Where the slots of a row live. at(b) binds row b once: `first` is
// the row's first cache row in the (rows, KV, hd) view of k/v, row(s)
// the cache row of logical slot s counted from there (times KV * hd
// gives the element offset), and pos(s) the slot's position.
struct ContiguousSlots {     // k/v (B, S, KV, hd), kv_pos (B, S)
  const int* kv_pos;
  int S;
  struct Row {
    int64_t first;
    const int* pos_row;
    __device__ __forceinline__ int64_t row(int s) const { return s; }
    __device__ __forceinline__ int pos(int s) const {
      return __ldg(pos_row + s);
    }
  };
  __device__ __forceinline__ Row at(int b) const {
    return {(int64_t)b * S, kv_pos + (int64_t)b * S};
  }
};

struct PagedSlots {          // k/v (NB, blk, KV, hd), kv_pos (NB, blk)
  const int* kv_pos;
  const int* tables;         // (B, nbs) pool block ids
  int blk, nbs;
  struct Row {
    int64_t first;           // 0: slots address the whole pool
    const int* table;
    const int* kv_pos;
    int blk;
    __device__ __forceinline__ int64_t row(int s) const {
      return (int64_t)__ldg(table + s / blk) * blk + s % blk;
    }
    __device__ __forceinline__ int pos(int s) const {
      return __ldg(kv_pos + row(s));
    }
  };
  __device__ __forceinline__ Row at(int b) const {
    return {0, tables + (int64_t)b * nbs, kv_pos, blk};
  }
};

size_t smem_bytes(int G, int hd) {
  return sizeof(float) *
         ((size_t)G * hd + (size_t)BS * (hd + 1) + (size_t)BS * hd +
          (size_t)G * BS + 3 * (size_t)G);
}

// grid: (B, KV, nsplit); block: NT threads; dynamic shared memory
// smem_bytes(G, hd). With nsplit == 1 the block writes `out`; otherwise
// it writes its partial (m, l) to ml[(b, h, split), 2] and its
// unnormalised acc to pacc[(b, h, split), hd] for combine_kernel.
// S is the logical slot count of every row (nbs * blk when paged).
template <typename T, typename Slots>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const Slots slots,
                   const int* __restrict__ kv_len,
                   const int* __restrict__ q_pos, T* __restrict__ out,
                   float* __restrict__ ml, float* __restrict__ pacc, int H,
                   int KV, int S, int hd, int window, float scale,
                   int chunk, int vec) {
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int G = H / KV;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // (G, hd)
  float* ks = qs + G * hd;             // (BS, hd + 1)
  float* vs = ks + BS * (hd + 1);      // (BS, hd)
  float* sc = vs + BS * hd;            // (G, BS) scores, then weights
  float* m_s = sc + G * BS;            // (G,) running max
  float* l_s = m_s + G;                // (G,) running denominator
  float* c_s = l_s + G;                // (G,) this tile's rescale factor

  const int len = kv_len[b];
  const int qp = q_pos[b];
  for (int i = threadIdx.x; i < G * hd; i += NT) {
    const int g = i / hd, d = i % hd;
    const float qv = to_f(q[((int64_t)b * H + kvh * G + g) * hd + d]);
    qs[i] = to_f(from_f<T>(qv * scale));   // pre-scaled in q's dtype
  }
  for (int g = threadIdx.x; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[ACC_MAX];
#pragma unroll
  for (int a = 0; a < ACC_MAX; ++a) acc[a] = 0.f;

  const int64_t row_stride = (int64_t)KV * hd;   // between cache rows
  const auto rs = slots.at(b);
  const T* kb = k + rs.first * row_stride + (int64_t)kvh * hd;
  const T* vb = v + rs.first * row_stride + (int64_t)kvh * hd;
  const int s_begin = split * chunk;
  const int s_end = min(S, s_begin + chunk);

  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    const int n = min(BS, s_end - s0);
    if (vec > 1) {
      const int per_row = hd / vec;
      for (int i = threadIdx.x; i < BS * per_row; i += NT) {
        const int j = i / per_row, d = (i % per_row) * vec;
        float fk[8], fv[8];
        if (j < n) {
          load16<T>(kb + rs.row(s0 + j) * row_stride + d, fk);
          load16<T>(vb + rs.row(s0 + j) * row_stride + d, fv);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) fk[t] = fv[t] = 0.f;
        }
        for (int t = 0; t < vec; ++t) {
          ks[j * (hd + 1) + d + t] = fk[t];
          vs[j * hd + d + t] = fv[t];
        }
      }
    } else {
      for (int i = threadIdx.x; i < BS * hd; i += NT) {
        const int j = i / hd, d = i % hd;
        float kk = 0.f, vv = 0.f;
        if (j < n) {
          kk = to_f(kb[rs.row(s0 + j) * row_stride + d]);
          vv = to_f(vb[rs.row(s0 + j) * row_stride + d]);
        }
        ks[j * (hd + 1) + d] = kk;
        vs[j * hd + d] = vv;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * BS; i += NT) {
      const int g = i / BS, j = i % BS;
      const int s = s0 + j;
      float score = NEG_INF;
      if (j < n) {
        const int kp = rs.pos(s);
        bool vis = (s < len) && (kp <= qp);
        if (window > 0) vis = vis && (kp > qp - window);
        if (vis) {
          float dot = 0.f;
          const float* qg = qs + g * hd;
          const float* kr = ks + j * (hd + 1);
          for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kr[d], dot);
          score = dot;
        }
      }
      sc[i] = score;
    }
    __syncthreads();
    // online softmax: one warp per head, lane j holds slot j of the tile
    for (int g = warp; g < G; g += NWARP) {
      const float sj = sc[g * BS + lane];
      const float m_prev = m_s[g];
      float mx = lane < n ? sj : m_prev;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      // slots past the split do not exist: weight 0 (hidden slots inside
      // it keep exp(NEG_INF - m) like the reference)
      const float p = lane < n ? expf(sj - m_new) : 0.f;
      sc[g * BS + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC_MAX; ++a) {
      const int i = threadIdx.x + a * NT;
      if (i < G * hd) {
        const int g = i / hd, d = i % hd;
        float t = acc[a] * c_s[g];
        const float* p = sc + g * BS;
        for (int j = 0; j < n; ++j) t = fmaf(p[j], vs[j * hd + d], t);
        acc[a] = t;
      }
    }
    __syncthreads();
  }
  const int64_t hbase = (int64_t)b * H + kvh * G;   // first head's row
#pragma unroll
  for (int a = 0; a < ACC_MAX; ++a) {
    const int i = threadIdx.x + a * NT;
    if (i < G * hd) {
      const int g = i / hd, d = i % hd;
      if (nsplit == 1) {
        out[(hbase + g) * hd + d] = from_f<T>(acc[a] / fmaxf(l_s[g], 1e-30f));
      } else {
        pacc[((hbase + g) * nsplit + split) * hd + d] = acc[a];
      }
    }
  }
  if (nsplit > 1) {
    for (int g = threadIdx.x; g < G; g += NT) {
      ml[((hbase + g) * nsplit + split) * 2] = m_s[g];
      ml[((hbase + g) * nsplit + split) * 2 + 1] = l_s[g];
    }
  }
}

// merges the nsplit partial (m, l, acc) of each (row, head):
// out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
// grid: B * H blocks; block: hd threads (<= 1024)
template <typename T>
__global__ void combine_kernel(const float* __restrict__ ml,
                               const float* __restrict__ pacc,
                               T* __restrict__ out, int nsplit, int hd) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = ml + bh * nsplit * 2;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(m[2 * s] - mx);
    l = fmaf(w, m[2 * s + 1], l);
    a = fmaf(w, pacc[(bh * nsplit + s) * hd + d], a);
  }
  out[bh * hd + d] = from_f<T>(a / fmaxf(l, 1e-30f));
}

constexpr int TARGET_BLOCKS_PER_SM = 2;

// how many blocks share one (row, KV head)'s slots, and how many
// slots (a multiple of BS) each takes
void split_plan(int B, int KV, int S, int num_sms, int* nsplit, int* chunk) {
  const int64_t groups = (int64_t)B * KV;
  const int64_t target = (int64_t)TARGET_BLOCKS_PER_SM * num_sms;
  int64_t want = groups >= target ? 1 : (target + groups - 1) / groups;
  const int64_t tiles = (S + BS - 1) / BS;
  if (want > tiles) want = tiles;
  const int64_t per = (tiles + want - 1) / want;
  *chunk = (int)(per * BS);
  *nsplit = (int)((S + *chunk - 1) / *chunk);
}

template <typename T, typename Slots>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Slots slots, const int* kv_len, const int* q_pos,
                   void* out, float* ws, int B, int H, int KV, int S, int hd,
                   int window, float scale, int aligned, int num_sms,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, hd);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T, Slots>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int nsplit, chunk;
  split_plan(B, KV, S, num_sms, &nsplit, &chunk);
  const int vec = (aligned && hd % kVec<T> == 0) ? kVec<T> : 1;
  float* ml = ws;
  float* pacc = ws + (int64_t)B * H * nsplit * 2;
  dim3 grid(B, KV, nsplit);
  decode_attn_kernel<T, Slots><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), slots, kv_len, q_pos, static_cast<T*>(out),
      ml, pacc, H, KV, S, hd, window, scale, chunk, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_kernel<T><<<B * H, hd, 0, stream>>>(ml, pacc,
                                              static_cast<T*>(out), nsplit,
                                              hd);
  return cudaGetLastError();
}

}  // namespace

// The largest G * hd (query heads per KV head times head dim) a block
// can serve.
extern "C" int decode_attn_max_group_width() { return ACC_MAX * NT; }

// f32 workspace (in floats) decode_attn_launch needs for these
// arguments: the partial (m, l, acc) of every split, 0 without a split.
extern "C" long long decode_attn_workspace(int B, int H, int KV, int S,
                                           int hd, int num_sms) {
  int nsplit, chunk;
  split_plan(B, KV, S, num_sms, &nsplit, &chunk);
  if (nsplit == 1) return 0;
  return (long long)B * H * nsplit * (2 + hd);
}

// dtype: 0 = float32, 1 = bfloat16. All int arrays are int32. aligned:
// k and v are 16-byte aligned. ws: decode_attn_workspace(...) floats.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int decode_attn_launch(int dtype, const void* q, const void* k,
                                  const void* v, const int* kv_pos,
                                  const int* kv_len, const int* q_pos,
                                  void* out, float* ws, int B, int H, int KV,
                                  int S, int hd, int window, float scale,
                                  int aligned, int num_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ContiguousSlots slots{kv_pos, S};
  if (dtype == 0)
    return launch<float>(q, k, v, slots, kv_len, q_pos, out, ws, B, H, KV,
                         S, hd, window, scale, aligned, num_sms, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, slots, kv_len, q_pos, out, ws, B,
                                 H, KV, S, hd, window, scale, aligned,
                                 num_sms, s);
  return (int)cudaErrorInvalidValue;
}

// The paged launch: k/v (NB, blk, KV, hd), kv_pos (NB, blk), tables
// (B, nbs) int32 pool block ids in [0, NB); every row has S = nbs * blk
// logical slots. ws: decode_attn_workspace(B, H, KV, nbs * blk, hd,
// num_sms) floats. Returns the cudaError_t of the launches.
extern "C" int decode_attn_paged_launch(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const int* kv_pos,
                                        const int* tables, const int* kv_len,
                                        const int* q_pos, void* out,
                                        float* ws, int B, int H, int KV,
                                        int blk, int nbs, int hd, int window,
                                        float scale, int aligned,
                                        int num_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedSlots slots{kv_pos, tables, blk, nbs};
  const int S = nbs * blk;
  if (dtype == 0)
    return launch<float>(q, k, v, slots, kv_len, q_pos, out, ws, B, H, KV,
                         S, hd, window, scale, aligned, num_sms, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, slots, kv_len, q_pos, out, ws, B,
                                 H, KV, S, hd, window, scale, aligned,
                                 num_sms, s);
  return (int)cudaErrorInvalidValue;
}
