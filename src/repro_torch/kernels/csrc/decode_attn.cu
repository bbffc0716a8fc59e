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
// Slot addresses are computed per slot, never per tile, so a tile may
// span several pool blocks or part of one (any blk >= 1).
//
// The function: query head h reads KV head h / (H / KV). Slot s is
// visible when s < kv_len[b] and kv_pos[b, s] <= q_pos[b] (and
// kv_pos[b, s] > q_pos[b] - window when window > 0); hidden slots score
// the finite NEG_INF = -0.7 * FLT_MAX, as in the reference. q is scaled
// by 1/sqrt(hd) in its own dtype before the dot, as the Pallas wrapper
// does; the running (m, l, acc) recurrence is kept in f32 and l is
// clamped at 1e-30.
//
// What bounds it on this card: the bytes of the visible K and V lanes
// (plus, for a fully hidden row, its V over all S lanes). At the main
// path's decode (8 rows, kv_len 301..560 of S = 561, 8 KV heads x 128,
// bf16) that is ~14 MB, ~4.3 us at 3.35 TB/s: the call is short enough
// that the latency of each step (the launch, the first loads, the
// merge of the split) costs as much as the bytes. So the design keeps
// that chain short: one launch, every CTA of it resident at once (a
// 2-stage mma CTA takes ~74 KB of shared memory at the main shape, so 3
// fit an SM), all of a CTA's first loads in flight together, and one
// cluster barrier to merge.
//
// Design.
// * One launch. A cluster of `nsplit` <= 8 CTAs serves one (row, KV
//   head) group with all its G = H / KV query heads, so each K/V lane is
//   read once per group. The cluster is the largest (a power of two) at
//   which the card holds every group's cluster at once, by its own
//   occupancy count: a second wave would double the call's latency. Each
//   CTA folds its share of the row's slots into a partial (m, l, acc)
//   and pushes it, by stores to distributed shared memory, to the CTAs
//   that own its slices of the group's G * hd outputs; after one cluster
//   barrier each CTA merges its slice locally and writes it. Every CTA
//   arrives at a first barrier when it starts and waits on it before
//   its first remote store, so no store reaches a CTA that is not yet
//   running; CTAs with no slots still reach every barrier, and no CTA
//   touches a peer's memory after the last one.
// * Stop at kv_len. The row's lanes [0, min(kv_len, S)) are divided
//   among the cluster; nothing at or past kv_len is read. Such a lane
//   would weigh exp(NEG_INF - m) = 0 whenever the row has a visible
//   lane. A row with no visible lane at all (kv_len = 0, or every lane
//   hidden by position or window) averages v over all S lanes in the
//   reference's uniform softmax: after the merge, a cluster whose m is
//   still NEG_INF sums v over all S lanes (pool block 0 included, where
//   unassigned table entries point) and writes the mean.
// * "mma" path (bf16, k/v 16-byte aligned, hd a multiple of 16 up to
//   128, G <= 8: every model of the repo): each warp streams its own
//   16-slot steps of K and V as bf16 into a 2-stage ring by 16-byte
//   cp.async (zero-filled past the range), positions beside them, so
//   the next step's loads overlap this step's products. q.K^T and P.V
//   run on tensor cores as mma.sync.m16n8k16 (bf16 in, f32 out) with
//   the slots on M and the group's heads on N, padded with zero rows of
//   q to 8. The online softmax stays in
//   f32 registers; P is rounded to bf16 for the P.V product (l sums the
//   f32 weights) and moved from the score layout into the B operand by
//   movmatrix. Each warp keeps its own (m, l, acc); the 4 warps merge in
//   shared memory, then the cluster merges.
// * "simt" path (float32, which the parity runs use, in full f32; and
//   bf16 shapes the mma path cannot take): 32-slot CTA tiles in their
//   own dtype, a 2-stage ring where shared memory allows. Each warp
//   scores its heads with the lanes on the head dimension (32 partial
//   dot products a lane, summed across lanes in 31 shuffles), runs the
//   online softmax of that head with lane j on slot j, and every thread
//   accumulates its (head, dim) outputs.
// * Softmax statistics (the contiguous launch only, on request): a
//   caller that splits a row's slots over ranks (a sequence-sharded
//   cache) merges the ranks' partial results by their (m, l), which the
//   cluster merge already holds per head. With m_out / l_out set, the
//   CTA that owns a head's first output writes the merged m (the max of
//   the scaled scores; NEG_INF for a row with no visible lane) and l
//   (the sum of exp(score - m); S for such a row), and `out` is float32
//   whatever the input type, so the cross-rank merge rounds once. Null
//   pointers launch exactly the kernel without them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <mutex>
#include <type_traits>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 128;      // threads per CTA
constexpr int NWARP = NTHREADS / 32;
constexpr int MAX_SPLIT = 8;       // CTAs of a cluster (the portable size)
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
// mma path
constexpr int WS = 16;             // slots per warp step (the mma M)
constexpr int MMA_STAGES = 2;
constexpr int MMA_NK = 8;          // k-steps of 16: hd <= 128
constexpr int MMA_UNIT = WS * NWARP;
// simt path
constexpr int TS = 32;             // slots per CTA tile
constexpr int ACC_MAX = 16;        // (head, dim) outputs a thread: G*hd <= 2048

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

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the warp's 8x8 b16 matrix (lane l: row l/4, cols 2(l%4), +1) transposed
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// the cluster barrier in two halves: arrive early, wait where needed
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_max_g(float x) {   // over lane / 4
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float warp_sum_g(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// 32 values in each lane -> lane j holds the sum over all lanes of
// value j (16 + 8 + 4 + 2 + 1 shuffles). Each step halves the values a
// lane keeps: the half its lane bit OFF selects, plus its partner's.
template <int OFF>
__device__ __forceinline__ float transpose_reduce(float (&v)[32],
                                                  int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) {
    return transpose_reduce<OFF / 2>(v, lane);
  } else {
    return v[0];
  }
}

// ------------------------------------------------------------ layouts

// Where the slots of a row live. at(b) binds row b once; row(s) is the
// absolute cache row of logical slot s in the (rows, KV, hd) view of
// k/v (times KV * hd gives the element offset), and kv_pos[row(s)] its
// position.
struct ContiguousSlots {     // k/v (B, S, KV, hd), kv_pos (B, S)
  const int* kv_pos;
  int S;
  struct Row {
    int64_t first;
    __device__ __forceinline__ int64_t row(int s) const { return first + s; }
  };
  __device__ __forceinline__ Row at(int b) const { return {(int64_t)b * S}; }
};

struct PagedSlots {          // k/v (NB, blk, KV, hd), kv_pos (NB, blk)
  const int* kv_pos;
  const int* tables;         // (B, nbs) pool block ids
  int blk, nbs;
  struct Row {
    const int* table;
    int blk;
    __device__ __forceinline__ int64_t row(int s) const {
      return (int64_t)__ldg(table + s / blk) * blk + s % blk;
    }
  };
  __device__ __forceinline__ Row at(int b) const {
    return {tables + (int64_t)b * nbs, blk};
  }
};

// Everything a launch needs besides where the slots live; o_* are byte
// offsets into the CTA's dynamic shared memory.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  const int* q_pos;
  void* out;        // T, or float32 when m_out is set
  float* m_out;     // (B, H) softmax statistics, or null
  float* l_out;
  int H, KV, S, hd, G, window, nsplit, stages, vec;
  float scale;
  int o_ring, o_pos, o_q, o_sc, o_cc, o_cm, o_cl, o_rx, o_hs, o_rxv;
};

struct Carve {
  int at = 0;
  int take(long long bytes) {
    const int o = at;
    at += (int)((bytes + 15) & ~15LL);
    return o;
  }
};

// The receive area every path has: each CTA's (m, l) of every head
// (MAX_SPLIT, G) twice, and each CTA's acc for this CTA's slice of the
// G * hd outputs (n, ceil(G * hd / n)), pushed there by the peers.
long long rx_bytes(const Params& p) {
  return 4LL * (2 * MAX_SPLIT * p.G + p.G * p.hd + MAX_SPLIT);
}

// The hidden-row scratch (nlg, hd) and the peers' v sums of a row with
// no visible lane (MAX_SPLIT, hd) live in the ring, free by then.
long long hs_bytes(const Params& p) {
  return 4LL * (NTHREADS * p.vec > p.hd ? NTHREADS * p.vec : p.hd);
}

int mma_smem(Params& p) {
  Carve c;
  p.o_ring = c.take(2LL * NWARP * MMA_STAGES * 2 * WS * (p.hd + 8));
  p.o_pos = c.take(4LL * NWARP * MMA_STAGES * WS);
  p.o_q = c.take(2LL * 8 * p.hd);
  p.o_rx = c.take(rx_bytes(p));
  p.o_sc = p.o_cc = p.o_cm = p.o_cl = 0;
  p.o_hs = p.o_ring;
  p.o_rxv = p.o_ring + (int)((hs_bytes(p) + 15) & ~15LL);
  return c.at;
}

int simt_smem(Params& p, int elsize) {
  Carve c;
  p.o_ring = c.take((long long)p.stages * 2 * TS * p.hd * elsize);
  p.o_pos = c.take(4LL * p.stages * TS);
  p.o_q = c.take(4LL * p.G * p.hd);
  p.o_sc = c.take(4LL * p.G * TS);
  p.o_cc = c.take(4LL * p.G);
  p.o_cm = c.take(4LL * p.G);
  p.o_cl = c.take(4LL * p.G);
  p.o_rx = c.take(rx_bytes(p));
  p.o_hs = c.take(hs_bytes(p));
  p.o_rxv = p.o_ring;
  return c.at;
}

// this CTA's share [*b, *e) of the row's lanes [0, len), in `unit`s
__device__ __forceinline__ void cta_range(int len, int unit, int n,
                                          int rank, int* b, int* e) {
  const int units = (len + unit - 1) / unit;
  const int per = (units + n - 1) / n;
  *b = min(rank * per * unit, len);
  *e = min(*b + per * unit, len);
}

// ---------------------------------------------------- cluster merge

// Push this CTA's partial into the receive areas of the cluster: the
// (m, l) of head g to every CTA, the acc of output i to the CTA whose
// slice holds it. Remote stores; the barrier in merge_and_store makes
// them visible.
__device__ __forceinline__ void push_ml(const Params& p, unsigned char* smem,
                                        int g, float m, float l) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* rx = reinterpret_cast<float*>(smem + p.o_rx);
  for (int r = 0; r < p.nsplit; ++r) {
    float* dst = cluster.map_shared_rank(rx, r);
    dst[rank * p.G + g] = m;
    dst[(MAX_SPLIT + rank) * p.G + g] = l;
  }
}

__device__ __forceinline__ void push_acc(const Params& p,
                                         unsigned char* smem, int i,
                                         float a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (p.G * p.hd + p.nsplit - 1) / p.nsplit;
  const int owner = i / per;
  float* rx = reinterpret_cast<float*>(smem + p.o_rx) + 2 * MAX_SPLIT * p.G;
  cluster.map_shared_rank(rx, owner)[(int)cluster.block_rank() * per +
                                     (i - owner * per)] = a;
}

// Write output i of the group (float32 with statistics, else T) and,
// from the owner of a head's first output, that head's (m, l).
template <typename T>
__device__ __forceinline__ void store_out(const Params& p, int64_t head0,
                                          int i, float o, float m,
                                          float l) {
  if (p.m_out == nullptr) {
    static_cast<T*>(p.out)[head0 * p.hd + i] = from_f<T>(o);
    return;
  }
  static_cast<float*>(p.out)[head0 * p.hd + i] = o;
  if (i % p.hd == 0) {
    p.m_out[head0 + i / p.hd] = m;
    p.l_out[head0 + i / p.hd] = l;
  }
}

// Every CTA has pushed its partial. Merge this CTA's slice of the
// group's G * hd outputs from its receive area and write it; a row with
// no visible lane gets the mean of v over all S lanes. Every CTA of the
// cluster calls this, with or without slots.
template <typename T, typename Row>
__device__ __forceinline__ void merge_and_store(const Params& p,
                                                const Row& rs, int b,
                                                int kvh,
                                                unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = p.nsplit, rank = (int)cluster.block_rank();
  const int G = p.G, hd = p.hd, tid = threadIdx.x;
  const float* rm = reinterpret_cast<const float*>(smem + p.o_rx);
  const float* rl = rm + MAX_SPLIT * G;
  const float* racc = rm + 2 * MAX_SPLIT * G;
  const int per = (G * hd + n - 1) / n;
  const int lo = rank * per, hi = min(lo + per, G * hd);
  const int64_t head0 = (int64_t)b * p.H + (int64_t)kvh * G;

  cluster.sync();   // every push into this CTA has landed
  // head 0's m over the cluster: NEG_INF when the row has no visible
  // lane (the same answer in every CTA)
  float M0 = NEG_INF;
  for (int r = 0; r < n; ++r) M0 = fmaxf(M0, rm[r * G]);
  if (M0 != NEG_INF) {
    for (int i = lo + tid; i < hi; i += NTHREADS) {
      const int g = i / hd;
      float M = NEG_INF;
      for (int r = 0; r < n; ++r) M = fmaxf(M, rm[r * G + g]);
      float L = 0.f, a = 0.f;
      for (int r = 0; r < n; ++r) {
        const float w = expf(rm[r * G + g] - M);
        L = fmaf(w, rl[r * G + g], L);
        a = fmaf(w, racc[r * per + (i - lo)], a);
      }
      store_out<T>(p, head0, i, a / fmaxf(L, 1e-30f), M, L);
    }
    return;   // nothing reads this CTA's memory any more
  }
  // No visible lane in the row: the uniform softmax over all S lanes.
  // This CTA sums v over its share of them in `nlg` lane groups (16-byte
  // loads where aligned) and pushes the sum to every CTA.
  const int S = p.S;
  const int sper = (S + n - 1) / n;
  const int s_lo = min(rank * sper, S), s_hi = min(s_lo + sper, S);
  const int vec = p.vec;
  const int cpr = hd / vec;                        // chunks a row
  const int nlg = cpr >= NTHREADS ? 1 : NTHREADS / cpr;
  const int64_t rstride = (int64_t)p.KV * hd;
  const T* vb = static_cast<const T*>(p.v) + (int64_t)kvh * hd;
  float* part = reinterpret_cast<float*>(smem + p.o_hs);   // (nlg, hd)
  float* rxv = reinterpret_cast<float*>(smem + p.o_rxv);   // (n, hd)
  for (int t = tid; t < nlg * cpr; t += NTHREADS) {
    const int lg = t / cpr, c = t % cpr;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = s_lo + lg; j < s_hi; j += nlg) {
      const T* src = vb + rs.row(j) * rstride + c * vec;
      if (vec > 1) {
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        load16<T>(src, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] += f[e];
      } else {
        a[0] += to_f(*src);
      }
    }
    for (int e = 0; e < vec; ++e) part[lg * hd + c * vec + e] = a[e];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += NTHREADS) {
    float sum = 0.f;
    for (int lg = 0; lg < nlg; ++lg) sum += part[lg * hd + d];
    for (int r = 0; r < n; ++r)
      cluster.map_shared_rank(rxv, r)[rank * hd + d] = sum;
  }
  cluster.sync();
  const float inv_s = S > 0 ? 1.f / (float)S : 0.f;
  for (int i = lo + tid; i < hi; i += NTHREADS) {
    const int d = i % hd;
    float a = 0.f;
    for (int r = 0; r < n; ++r) a += rxv[r * hd + d];
    store_out<T>(p, head0, i, a * inv_s, NEG_INF, (float)S);
  }
}

// ------------------------------------------------------ the mma path

// grid: B * KV * nsplit CTAs in clusters of nsplit; block: NTHREADS.
// The group's G <= 8 heads are the mma N (8), hd <= 16 * MMA_NK.
template <typename Slots>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_mma(const Params p, const Slots slots) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x / p.nsplit, rank = blockIdx.x % p.nsplit;
  const int b = grp / p.KV, kvh = grp % p.KV;
  const int G = p.G, hd = p.hd, nk = hd / 16, hdp = hd + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  // peers' shared memory may be written only once every CTA of the
  // cluster runs: arrive now, wait before the first push
  cluster_arrive_relaxed();
  const auto rs = slots.at(b);
  // q into registers before anything waits on kv_len: every load of the
  // CTA's prologue is in flight together
  constexpr int QPT = 8 * 16 * MMA_NK / NTHREADS;   // q values a thread
  const T* qg = static_cast<const T*>(p.q) +
                ((int64_t)b * p.H + (int64_t)kvh * G) * hd;
  float qv[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * NTHREADS;
    qv[u] = i < G * hd ? __bfloat162float(qg[i]) : 0.f;
  }
  const int len = min(max(__ldg(p.kv_len + b), 0), p.S);
  const int qp = __ldg(p.q_pos + b);
  int begin, end;
  cta_range(len, WS, p.nsplit, rank, &begin, &end);
  const int64_t rstride = (int64_t)p.KV * hd;
  const T* kg = static_cast<const T*>(p.k) + (int64_t)kvh * hd;
  const T* vg = static_cast<const T*>(p.v) + (int64_t)kvh * hd;

  // this warp's ring: MMA_STAGES x {K (WS, hdp), V (WS, hdp)} and the
  // slots' positions; warp w takes steps w, w + NWARP, ... of WS slots
  const int stage_elems = 2 * WS * hdp;
  T* ring = reinterpret_cast<T*>(smem + p.o_ring) +
            warp * MMA_STAGES * stage_elems;
  int* pring = reinterpret_cast<int*>(smem + p.o_pos) +
               warp * MMA_STAGES * WS;
  const int sw = begin + WS * warp;
  const int nsteps = end > sw ? (end - sw + MMA_UNIT - 1) / MMA_UNIT : 0;
  const int j = lane & (WS - 1);   // the slot row this lane copies

  auto row_of = [&](int i) -> int64_t {
    const int s = sw + MMA_UNIT * i + j;
    return (i < nsteps && s < end) ? rs.row(s) : 0;
  };
  auto load_step = [&](int i, int64_t row) {
    const bool ok = sw + MMA_UNIT * i + j < end;
    T* ks = ring + (i % MMA_STAGES) * stage_elems;
    T* vs = ks + WS * hdp;
    const T* ksrc = kg + row * rstride;
    const T* vsrc = vg + row * rstride;
    for (int c = lane >> 4; c < hd / 8; c += 2) {
      cp_async16(ks + j * hdp + c * 8, ksrc + c * 8, ok);
      cp_async16(vs + j * hdp + c * 8, vsrc + c * 8, ok);
    }
    if (lane < WS)
      cp_async4(pring + (i % MMA_STAGES) * WS + j, slots.kv_pos + row, ok);
  };

  int64_t rows[MMA_STAGES];   // the first steps' rows, loads together
#pragma unroll
  for (int i = 0; i < MMA_STAGES; ++i) rows[i] = row_of(i);
#pragma unroll
  for (int i = 0; i < MMA_STAGES - 1; ++i) {
    if (i < nsteps) load_step(i, rows[i]);
    cp_async_commit();
  }
  int64_t row_next = rows[MMA_STAGES - 1];   // a step ahead of its use

  // q pre-scaled in bf16, (8, hd) with the rows past G zero
  T* qs = reinterpret_cast<T*>(smem + p.o_q);
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * NTHREADS;
    if (i < 8 * hd) qs[i] = __float2bfloat16(qv[u] * p.scale);
  }
  __syncthreads();
  uint32_t qf[MMA_NK][2];   // B fragments of q^T: (k = dim, n = head)
#pragma unroll
  for (int kk = 0; kk < MMA_NK; ++kk) {
    if (kk < nk) {
      const T* r = qs + g4 * hd + kk * 16 + 2 * t4;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(r);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(r + 8);
    } else {
      qf[kk][0] = qf[kk][1] = 0u;
    }
  }

  // this lane's state: heads 2 t4 + c; acc[mt] is the mma tile O^T
  // (dims 16 mt + g4 (+8), heads 2 t4 (+1))
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[MMA_NK][4];
#pragma unroll
  for (int mt = 0; mt < MMA_NK; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    const int nx = i + MMA_STAGES - 1;
    if (nx < nsteps) load_step(nx, row_next);
    cp_async_commit();
    row_next = row_of(nx + 1);
    cp_async_wait<MMA_STAGES - 1>();
    __syncwarp();
    const T* ks = ring + (i % MMA_STAGES) * stage_elems;
    const T* vs = ks + WS * hdp;
    const int* ps = pring + (i % MMA_STAGES) * WS;

    // scores S (slots 16 x heads 8) = K q^T
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < MMA_NK; ++kk) {
      if (kk < nk) {
        uint32_t a[4];
        ldsm_x4(a, ks + (lane & 15) * hdp + kk * 16 + (lane >> 4) * 8);
        mma_bf16(sc, a, qf[kk][0], qf[kk][1]);
      }
    }
    // this lane's slots: rows g4 and g4 + 8 of the step
    const int s0 = sw + MMA_UNIT * i;
    bool vis[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g4 + 8 * h;
      const int kp = ps[r];
      bool v = (s0 + r < end) && kp <= qp;
      if (p.window > 0) v = v && kp > qp - p.window;
      vis[h] = v;
    }
    // online softmax per head column; P as the B operand of P.V
    float pr[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float x0 = vis[0] ? sc[c] : NEG_INF;
      const float x1 = vis[1] ? sc[2 + c] : NEG_INF;
      const float mnew = fmaxf(m[c], warp_max_g(fmaxf(x0, x1)));
      const float p0 = vis[0] ? __expf(x0 - mnew) : 0.f;
      const float p1 = vis[1] ? __expf(x1 - mnew) : 0.f;
      const float corr = __expf(m[c] - mnew);
      l[c] = fmaf(l[c], corr, warp_sum_g(p0 + p1));
      m[c] = mnew;
#pragma unroll
      for (int mt = 0; mt < MMA_NK; ++mt) {
        acc[mt][c] *= corr;
        acc[mt][2 + c] *= corr;
      }
      pr[c] = p0;
      pr[2 + c] = p1;
    }
    const uint32_t pb0 = movmatrix_t(pack_bf16(pr[0], pr[1]));
    const uint32_t pb1 = movmatrix_t(pack_bf16(pr[2], pr[3]));
    // O^T (dims 16 x heads 8) += V^T P
#pragma unroll
    for (int mt = 0; mt < MMA_NK; ++mt) {
      if (mt < nk) {
        uint32_t a[4];
        const int mi = lane >> 3;
        ldsm_x4_trans(a, vs + ((lane & 7) + (mi >> 1) * 8) * hdp + mt * 16 +
                             (mi & 1) * 8);
        mma_bf16(acc[mt], a, pb0, pb1);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncwarp();

  // this warp's partial, f32, into its own ring: m, l (8) and acc (8, hd)
  float* wp = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int h = 2 * t4 + c;
    if (g4 == 0) {
      wp[h] = m[c];
      wp[8 + h] = l[c];
    }
    float* wa = wp + 16 + h * hd;
#pragma unroll
    for (int mt = 0; mt < MMA_NK; ++mt) {
      if (mt < nk) {
        wa[mt * 16 + g4] = acc[mt][c];
        wa[mt * 16 + g4 + 8] = acc[mt][2 + c];
      }
    }
  }
  __syncthreads();
  // the CTA's partial from its warps', in one pass: each output reads
  // its head's (m, l) and its acc from every warp, and is pushed to the
  // CTA whose slice holds it
  const float* wbase = reinterpret_cast<const float*>(smem + p.o_ring);
  const int wstride = MMA_STAGES * stage_elems / 2;   // floats a warp
  cluster_wait();
  for (int i = tid; i < G * hd; i += NTHREADS) {
    const int g = i / hd;
    float mw[NWARP], M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      mw[w] = wbase[w * wstride + g];
      M = fmaxf(M, mw[w]);
    }
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float* wp_ = wbase + w * wstride;
      const float e = expf(mw[w] - M);
      L = fmaf(e, wp_[8 + g], L);
      a = fmaf(e, wp_[16 + i], a);
    }
    push_acc(p, smem, i, a);
    if (i % hd == 0) push_ml(p, smem, g, M, L);
  }
  merge_and_store<T>(p, rs, b, kvh, smem);
}

// ----------------------------------------------------- the simt path

// grid and clusters as the mma path; 32-slot CTA tiles in T, a ring of
// p.stages (1 or 2) tiles.
template <typename T, typename Slots>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_simt(const Params p, const Slots slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x / p.nsplit, rank = blockIdx.x % p.nsplit;
  const int b = grp / p.KV, kvh = grp % p.KV;
  const int G = p.G, hd = p.hd, vec = p.vec, stages = p.stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cluster_arrive_relaxed();   // as the mma path: wait before pushing
  const auto rs = slots.at(b);
  const T* qg = static_cast<const T*>(p.q) +
                ((int64_t)b * p.H + (int64_t)kvh * G) * hd;
  float qv[ACC_MAX];   // q into registers first, as the mma path
#pragma unroll
  for (int u = 0; u < ACC_MAX; ++u) {
    const int i = tid + u * NTHREADS;
    qv[u] = i < G * hd ? to_f(qg[i]) : 0.f;
  }
  const int len = min(max(__ldg(p.kv_len + b), 0), p.S);
  const int qp = __ldg(p.q_pos + b);
  int begin, end;
  cta_range(len, TS, p.nsplit, rank, &begin, &end);
  const int64_t rstride = (int64_t)p.KV * hd;
  const T* kg = static_cast<const T*>(p.k) + (int64_t)kvh * hd;
  const T* vg = static_cast<const T*>(p.v) + (int64_t)kvh * hd;
  T* ring = reinterpret_cast<T*>(smem + p.o_ring);   // stages x {K, V}
  int* pring = reinterpret_cast<int*>(smem + p.o_pos);
  float* qs = reinterpret_cast<float*>(smem + p.o_q);   // (G, hd)
  float* sc = reinterpret_cast<float*>(smem + p.o_sc);  // (G, TS) weights
  float* cc = reinterpret_cast<float*>(smem + p.o_cc);  // (G,) rescale
  float* cm = reinterpret_cast<float*>(smem + p.o_cm);  // (G,) running m
  float* cl = reinterpret_cast<float*>(smem + p.o_cl);  // (G,) running l
  const int ntiles = end > begin ? (end - begin + TS - 1) / TS : 0;
  const int cpr = hd / vec;

  auto load_step = [&](int t) {
    const int s0 = begin + t * TS;
    T* ks = ring + (t % stages) * 2 * TS * hd;
    T* vs = ks + TS * hd;
    for (int i = tid; i < TS * cpr; i += NTHREADS) {
      const int jj = i / cpr, c = (i % cpr) * vec;
      const bool ok = s0 + jj < end;
      const int64_t row = ok ? rs.row(s0 + jj) : 0;
      if (vec > 1) {
        cp_async16(ks + jj * hd + c, kg + row * rstride + c, ok);
        cp_async16(vs + jj * hd + c, vg + row * rstride + c, ok);
      } else {
        ks[jj * hd + c] = ok ? kg[row * rstride + c] : from_f<T>(0.f);
        vs[jj * hd + c] = ok ? vg[row * rstride + c] : from_f<T>(0.f);
      }
    }
    if (tid < TS) {
      const bool ok = s0 + tid < end;
      cp_async4(pring + (t % stages) * TS + tid,
                slots.kv_pos + (ok ? rs.row(s0 + tid) : 0), ok);
    }
  };

  if (stages == 2) {
    if (ntiles > 0) load_step(0);
    cp_async_commit();
  }
#pragma unroll
  for (int u = 0; u < ACC_MAX; ++u) {
    const int i = tid + u * NTHREADS;
    if (i < G * hd) qs[i] = to_f(from_f<T>(qv[u] * p.scale));   // q's dtype
  }
  for (int g = tid; g < G; g += NTHREADS) {
    cm[g] = NEG_INF;
    cl[g] = 0.f;
  }
  float acc[ACC_MAX];
#pragma unroll
  for (int a = 0; a < ACC_MAX; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    if (stages == 2) {
      if (t + 1 < ntiles) load_step(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_step(t);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s0 = begin + t * TS;
    const int n = min(TS, end - s0);
    const T* ks = ring + (t % stages) * 2 * TS * hd;
    const T* vs = ks + TS * hd;
    const int* ps = pring + (t % stages) * TS;
    // warp w scores heads w, w + NWARP, ...: lanes on the dimension,
    // then lane j holds slot j's score and runs the online softmax
    for (int g = warp; g < G; g += NWARP) {
      float part[TS];
#pragma unroll
      for (int jj = 0; jj < TS; ++jj) part[jj] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float qv = qs[g * hd + d];
#pragma unroll
        for (int jj = 0; jj < TS; ++jj)
          part[jj] = fmaf(qv, to_f(ks[jj * hd + d]), part[jj]);
      }
      const float dot = transpose_reduce<TS / 2>(part, lane);
      const int kp = ps[lane];
      bool vis = lane < n && kp <= qp;
      if (p.window > 0) vis = vis && kp > qp - p.window;
      const float sj = vis ? dot : NEG_INF;
      float mx = sj;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = cm[g];
      const float m_new = fmaxf(m_prev, mx);
      const float pj = vis ? expf(sj - m_new) : 0.f;
      sc[g * TS + lane] = pj;
      float sum = pj;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cl[g] = cl[g] * corr + sum;
        cm[g] = m_new;
        cc[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC_MAX; ++a) {
      const int i = tid + a * NTHREADS;
      if (i < G * hd) {
        const int g = i / hd, d = i % hd;
        float x = acc[a] * cc[g];
        const float* pw = sc + g * TS;
        for (int jj = 0; jj < n; ++jj)
          x = fmaf(pw[jj], to_f(vs[jj * hd + d]), x);
        acc[a] = x;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  cluster_wait();
#pragma unroll
  for (int a = 0; a < ACC_MAX; ++a) {
    const int i = tid + a * NTHREADS;
    if (i < G * hd) push_acc(p, smem, i, acc[a]);
  }
  for (int g = tid; g < G; g += NTHREADS) push_ml(p, smem, g, cm[g], cl[g]);
  merge_and_store<T>(p, rs, b, kvh, smem);
}

// ----------------------------------------------------------- launch

enum Path { SIMT = 0, MMA = 1 };

// the mma path takes bf16 with k/v 16-byte aligned, hd a multiple of
// 16 up to 16 * MMA_NK and the group's G <= 8 heads (the mma N)
Path choose_path(int dtype, int G, int hd, int aligned) {
  return dtype == 1 && aligned && hd % 16 == 0 && hd <= 16 * MMA_NK &&
                 G <= 8
             ? MMA
             : SIMT;
}

int smem_optin(int dev) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// The launch plan before the cluster size: path, the Params' shape
// fields and smem offsets, the dynamic shared memory a CTA takes (0: no
// plan fits) and the largest cluster a row's lanes can use.
struct Plan {
  Path path;
  int smem, max_split;
  Params p;
};

Plan make_plan(int dtype, int H, int KV, int S, int hd, int window,
               float scale, int aligned, int optin) {
  Plan pl{};
  Params& p = pl.p;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.hd = hd;
  p.G = H / KV;
  p.window = window;
  p.scale = scale;
  pl.path = choose_path(dtype, p.G, hd, aligned);
  int unit;
  if (pl.path == MMA) {
    p.vec = 8;
    p.stages = MMA_STAGES;
    pl.smem = mma_smem(p);
    unit = WS;
  } else {
    const int es = dtype == 1 ? 2 : 4;
    const int kv = dtype == 1 ? 8 : 4;
    p.vec = (aligned && hd % kv == 0) ? kv : 1;
    p.stages = 2;
    pl.smem = simt_smem(p, es);
    if (pl.smem > optin) {
      p.stages = 1;
      pl.smem = simt_smem(p, es);
    }
    unit = TS;
  }
  if (pl.smem > optin) pl.smem = 0;
  const int units = (S + unit - 1) / unit;
  pl.max_split = 1;
  while (pl.max_split * 2 <= MAX_SPLIT && pl.max_split * 2 <= units)
    pl.max_split *= 2;
  return pl;
}

template <typename Slots>
using Kernel = void (*)(Params, Slots);

template <typename Slots>
Kernel<Slots> pick_kernel(const Plan& pl, int dtype) {
  if (pl.path == MMA) return decode_attn_mma<Slots>;
  if (dtype == 0) return decode_attn_simt<float, Slots>;
  return decode_attn_simt<__nv_bfloat16, Slots>;
}

// Per kernel instance and device, once: the opt-in shared memory limit
// (never set per call, so a call's launch sequence is one capturable
// kernel launch) and, per (shared memory, cluster size), how many
// clusters the card holds at once.
struct Known {
  const void* fn;
  int dev, smem, n, clusters;   // smem = n = -1: the attribute is set
};
std::mutex known_mu;
std::vector<Known> known;

cudaError_t prepare(const void* fn, int dev) {
  std::lock_guard<std::mutex> lock(known_mu);
  for (const Known& k : known)
    if (k.fn == fn && k.dev == dev && k.n < 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin(dev));
  if (err == cudaSuccess) known.push_back({fn, dev, -1, -1, 0});
  return err;
}

cudaError_t max_clusters(const void* fn, int dev, int smem, int n,
                         int* clusters) {
  std::lock_guard<std::mutex> lock(known_mu);
  for (const Known& k : known)
    if (k.fn == fn && k.dev == dev && k.smem == smem && k.n == n) {
      *clusters = k.clusters;
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (err == cudaSuccess) known.push_back({fn, dev, smem, n, *clusters});
  return err;
}

// The cluster size: the largest power of two up to pl.max_split at which
// all B * KV groups are on the card at once (one wave: a second wave
// would double the call's latency); 1 when not even that fits.
cudaError_t choose_split(const void* fn, int dev, const Plan& pl,
                         long long groups, int* nsplit) {
  int n = pl.max_split;
  for (; n > 1; n /= 2) {
    int clusters = 0;
    const cudaError_t err = max_clusters(fn, dev, pl.smem, n, &clusters);
    if (err != cudaSuccess) return err;
    if (groups <= clusters) break;
  }
  *nsplit = n;
  return cudaSuccess;
}

// Plan, size and launch one call: clusters of p.nsplit CTAs, one kernel
// launch on `stream`.
template <typename Slots>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const Slots& slots, const int* kv_len, const int* q_pos,
                   void* out, float* m_out, float* l_out, int B, int H,
                   int KV, int S, int hd,
                   int window, float scale, int aligned,
                   cudaStream_t stream) {
  if ((dtype != 0 && dtype != 1) || KV <= 0 || H % KV || hd <= 0)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Plan pl = make_plan(dtype, H, KV, S, hd, window, scale, aligned,
                      smem_optin(dev));
  if (pl.smem == 0 || pl.p.G * hd > ACC_MAX * NTHREADS)
    return cudaErrorInvalidValue;
  const Kernel<Slots> fn = pick_kernel<Slots>(pl, dtype);
  const void* key = reinterpret_cast<const void*>(fn);
  const long long groups = (long long)B * KV;
  if ((err = prepare(key, dev)) != cudaSuccess ||
      (err = choose_split(key, dev, pl, groups, &pl.p.nsplit)) !=
          cudaSuccess)
    return err;
  Params& p = pl.p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = kv_len;
  p.q_pos = q_pos;
  p.out = out;
  p.m_out = m_out;
  p.l_out = l_out;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * p.nsplit));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, p, slots);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename Slots>
int plan_info(int dtype, int B, int H, int KV, int S, int hd, int aligned,
              int* info) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  Plan pl = make_plan(dtype, H, KV, S, hd, 0, 1.f, aligned,
                      smem_optin(dev));
  int nsplit = 1;
  if (pl.smem > 0) {
    const void* key =
        reinterpret_cast<const void*>(pick_kernel<Slots>(pl, dtype));
    if (prepare(key, dev) != cudaSuccess ||
        choose_split(key, dev, pl, (long long)B * KV, &nsplit) !=
            cudaSuccess)
      return -1;
  }
  info[0] = nsplit;
  info[1] = pl.p.stages;
  info[2] = pl.smem;
  return (int)pl.path;
}

}  // namespace

// The largest G * hd (query heads per KV head times head dim) a CTA can
// serve.
extern "C" int decode_attn_max_group_width() { return ACC_MAX * NTHREADS; }

// The launch plan for these arguments on the current device (paged: the
// pool layout, S = nbs * blk): returns the path (0 simt, 1 mma; -1 no
// plan) and fills info[0..2] with the cluster size (CTAs a group), the
// ring stages and the dynamic shared memory of a CTA in bytes (0: too
// large).
extern "C" int decode_attn_plan(int dtype, int paged, int B, int H, int KV,
                                int S, int hd, int aligned, int* info) {
  if ((dtype != 0 && dtype != 1) || KV <= 0 || H % KV || hd <= 0)
    return -1;
  return paged ? plan_info<PagedSlots>(dtype, B, H, KV, S, hd, aligned, info)
               : plan_info<ContiguousSlots>(dtype, B, H, KV, S, hd, aligned,
                                            info);
}

// dtype: 0 = float32, 1 = bfloat16. All int arrays are int32. aligned:
// k and v are 16-byte aligned. m_out / l_out: null, or (B, H) float32
// softmax statistics, and then out is float32. One kernel launch on
// `stream`; returns its cudaError_t (0 = success).
extern "C" int decode_attn_launch(int dtype, const void* q, const void* k,
                                  const void* v, const int* kv_pos,
                                  const int* kv_len, const int* q_pos,
                                  void* out, float* m_out, float* l_out,
                                  int B, int H, int KV, int S, int hd,
                                  int window, float scale, int aligned,
                                  void* stream) {
  const ContiguousSlots slots{kv_pos, S};
  return (int)launch(dtype, q, k, v, slots, kv_len, q_pos, out, m_out,
                     l_out, B, H, KV, S, hd, window, scale, aligned,
                     static_cast<cudaStream_t>(stream));
}

// The paged launch: k/v (NB, blk, KV, hd), kv_pos (NB, blk), tables
// (B, nbs) int32 pool block ids in [0, NB); every row has S = nbs * blk
// logical slots. One kernel launch; returns its cudaError_t.
extern "C" int decode_attn_paged_launch(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const int* kv_pos,
                                        const int* tables, const int* kv_len,
                                        const int* q_pos, void* out, int B,
                                        int H, int KV, int blk, int nbs,
                                        int hd, int window, float scale,
                                        int aligned, void* stream) {
  const PagedSlots slots{kv_pos, tables, blk, nbs};
  return (int)launch(dtype, q, k, v, slots, kv_len, q_pos, out, nullptr,
                     nullptr, B, H, KV, nbs * blk, hd, window, scale,
                     aligned,
                     static_cast<cudaStream_t>(stream));
}
