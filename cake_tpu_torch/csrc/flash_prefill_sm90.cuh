// The Hopper prefill attention shared by csrc/flash_prefill.cu (bf16 cache)
// and csrc/flash_prefill_q8.cu (int8 cache): tiles, shared-memory plan,
// the consumer warpgroups' body and the host side's TMA descriptors (the
// PTX wrappers and the descriptor encoder are csrc/sm90.cuh's). The two
// kernels differ only in their producer warpgroup and in the two scale
// hooks of the consumer body.
//
// A CTA of 3 warpgroups takes BQ = 128 q rows of one (b, h):
// - warpgroup 0, the producer, keeps a ring of K tiles and one of V tiles
//   (BK = 128 keys at D = 64 and 128, 64 at D = 256; bf16, 128-byte
//   swizzle) filled, with one "full" and one "empty" mbarrier per slot;
// - warpgroups 1 and 2, the consumers, own 64 q rows each. Q is loaded once
//   by TMA. S = Q K^T is wgmma m64n128k16 with Q and K from shared memory
//   (both K-major; m64n64k16 at BK = 64); P stays in registers, is rounded
//   to bf16 there and is the register A operand of O += P V (wgmma
//   m64n{D}k16), with V read in its natural [key][d] layout through the
//   descriptor's transpose flag.
// At D = 256 a consumer thread's O is 128 f32 registers: with BK = 128 its
// S (64) and P (32) would not fit beside O in the consumer's register
// budget, and two stages of 128-key K and V tiles (256 KB) beside Q (64 KB)
// would not fit in shared memory. BK = 64 halves both: 176 registers of O,
// S and P, and 64 + 2 x (32 + 32) = 192 KB.
// Only the tiles that hold the causal diagonal, the window's lower edge or
// the buffer's end are masked element by element. Blocks are mapped so
// that the q tiles with the most live KV tiles start first.
//
// The output is the normalized bf16 attention (`NormOut`) or, in the
// statistics form (`StatsOut`, csrc/flash_prefill_stats.cu), the
// online-softmax state itself: the unnormalized f32 accumulator, the row
// max in natural-log units and the row sum, which partials over other key
// blocks merge with exactly (a ring-attention visit). Its queries may lie
// anywhere relative to the keys: a row with no live key, or a q tile with
// none, gives m = -1e30, l = 0 and o = 0, so a masked key never counts
// (its P is 0 even while the row's max is still the mask value).

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace fp90 {

using namespace sm90;

constexpr int BQ = 128;       // q rows per CTA: two consumer warpgroups of 64
// keys per KV tile, the unit of kv_block_bounds on the host (per D)
__host__ __device__ constexpr int block_k(int D) { return D == 256 ? 64 : 128; }
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
// A CTA of THREADS threads is launched with 168 registers a thread (65,536
// / 384, rounded down to 8). setmaxnreg moves them between warpgroups
// inside that allocation: the producer's cut is what the two consumer
// warpgroups may add (a consumer that asks for more waits forever).
constexpr int consumer_regs(int producer_regs) {
  return (THREADS / 128 * 168 - producer_regs) / 2 / 8 * 8;
}
constexpr float NEG_INF = -1e30f;

// Byte offsets in the dynamic shared memory (1024-aligned, as the 128-byte
// swizzle wants): Q, then a ring of STAGES K slots and one of STAGES V
// slots. A 64-column block of a bf16 tile is `rows` rows of 128 bytes,
// swizzled by TMA (128B mode); a D = 128 tile is two such blocks, one after
// the other. Over the int8 cache (STAGING > 0 bytes), each K slot also has
// its tile's BK key and BK value scales (f32), and TMA stages the int8
// codes ahead of their conversion.
template <int D, int STAGES_, int STAGING_BYTES = 0>
struct Plan {
  static constexpr int BK = block_k(D);
  static constexpr int STAGES = STAGES_;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one bf16 K or V tile
  static constexpr int K_RING = Q_BYTES;
  static constexpr int V_RING = K_RING + STAGES * KV_BYTES;
  static constexpr int SCALES = V_RING + STAGES * KV_BYTES;
  static constexpr int STAGING =
      SCALES + (STAGING_BYTES ? STAGES * 2 * BK * 4 : 0);
  static constexpr int SMEM = STAGING + STAGING_BYTES;
  static_assert(SMEM + 1024 <= 227 * 1024, "over a CTA's shared memory");
  __host__ __device__ static constexpr int k_slot(int s) {
    return K_RING + s * KV_BYTES;
  }
  __host__ __device__ static constexpr int v_slot(int s) {
    return V_RING + s * KV_BYTES;
  }
};

// The two consumer warpgroups take turns to issue their products (named
// barriers 2 and 3), so one's softmax runs under the other's wgmma.
__device__ __forceinline__ void turn_begin(int wg) {
  named_barrier_sync(2 + wg, CONSUMER_THREADS);
}
__device__ __forceinline__ void turn_end(int wg) {
  named_barrier_arrive(3 - wg, CONSUMER_THREADS);
}

// --------------------------------------------------------------------------
// Block mapping and the consumer body
// --------------------------------------------------------------------------

struct Tile {
  int qt, h, b;
};

// grid (H, q tiles, B), walked in order: every head's last q tile (the
// most live KV tiles under the causal mask) is dispatched first.
__device__ __forceinline__ Tile tile_of_block() {
  return {static_cast<int>(gridDim.y - 1 - blockIdx.y),
          static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.z)};
}

// The bf16 cache: no scales.
struct NoScales {
  static constexpr bool kScaled = false;
};

// The int8 cache: each K slot's key and value scales in shared memory, the
// key's scale multiplying its score column and the value's scale P before
// P is rounded to bf16 (the running sum takes P without it).
struct SlotScales {
  static constexpr bool kScaled = true;
  const float* base;  // K slot s: BK key scales at s * 2 * BK, then BK value
};

// Where a consumer warpgroup's rows go. NormOut: the bf16 output rows of
// one (b, h), row stride o_st, divided by the row sum. StatsOut: the f32
// accumulator rows of one (b, h) (D floats each, contiguous) and its row
// max (natural-log units) and row sum, undivided.
struct NormOut {
  static constexpr bool kStats = false;
  __nv_bfloat16* o;
  long long o_st;
};

struct StatsOut {
  static constexpr bool kStats = true;
  float* o;
  float* m;
  float* l;
};

constexpr float LN2 = 0.6931471805599453f;

// The two rings' mbarriers: a K slot is released once its scores (and, over
// the int8 cache, its scales) are read, a V slot once its PV product is
// done, so the next K tile loads while this one's softmax runs.
struct Ring {
  uint64_t* full_k;
  uint64_t* empty_k;
  uint64_t* full_v;
  uint64_t* empty_v;
};

// Online-softmax state of one consumer thread: rows qa and qb (positions),
// their running max in the log2 domain, partial sums and the rescale of O
// still owed from the last tile.
struct RowState {
  int qa, qb;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float a0 = 1.f, a1 = 1.f;
};

// S = Q K^T of one KV tile into `s`, issued and committed (not waited).
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_s,
                                         uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(
        s, smem_desc(q_s + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
        smem_desc(k_s + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
        kk > 0);
  wg_commit();
}

// O += P V of one KV tile, issued and committed (not waited).
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&p)[BK / 16][4],
                                         uint32_t v_s) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wgmma_rs(acc, p[j], smem_desc(v_s + j * 16 * 128, BK * 128, 1024));
  wg_commit();
}

// The scores of tile `kb` (this thread's rows qa and qb, its columns
// n * 8 + tq * 2 + {0, 1}) become P in place: scaled to the log2 domain,
// masked where the tile holds the diagonal, the window's lower edge or the
// buffer's end (key S), exponentiated against the new running max (a row
// whose max is still the mask value takes P = 0), summed into l, and (int8
// cache) times the value scale. Leaves the rescale of O in r.a0/r.a1.
template <int N, class Scales>
__device__ __forceinline__ void softmax_tile(float (&s)[N], RowState& r,
                                             const Scales& scales, int slot,
                                             int kb, int first, int last,
                                             int S, int window, int tq,
                                             float scale_log2) {
  constexpr int BK = 2 * N;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    if constexpr (Scales::kScaled) {
      const float2 ks = *reinterpret_cast<const float2*>(
          scales.base + slot * 2 * BK + n * 8 + tq * 2);
      s[n * 4 + 0] *= ks.x;
      s[n * 4 + 1] *= ks.y;
      s[n * 4 + 2] *= ks.x;
      s[n * 4 + 3] *= ks.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n * 4 + e] *= scale_log2;
  }
  if (kb * BK + BK - 1 > first || kb * BK + BK > S ||
      (window >= 0 && kb * BK <= last - window)) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * BK + n * 8 + tq * 2 + (e & 1);
        const int qp = (e & 2) ? r.qb : r.qa;
        if (!(key <= qp && key < S && (window < 0 || key > qp - window)))
          s[n * 4 + e] = NEG_INF;
      }
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n * 4 + 0], s[n * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[n * 4 + 2], s[n * 4 + 3]));
  }
  // full-row max over the 4 threads that share a row
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  r.a0 = exp2f(r.m0 - mx0);
  r.a1 = exp2f(r.m1 - mx1);
  r.m0 = mx0;
  r.m1 = mx1;
  // every key of the row masked so far: exp2(-1e30 - -1e30) would be 1
  const float b0 = mx0 <= NEG_INF ? INFINITY : mx0;
  const float b1 = mx1 <= NEG_INF ? INFINITY : mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    s[n * 4 + 0] = exp2f(s[n * 4 + 0] - b0);
    s[n * 4 + 1] = exp2f(s[n * 4 + 1] - b0);
    s[n * 4 + 2] = exp2f(s[n * 4 + 2] - b1);
    s[n * 4 + 3] = exp2f(s[n * 4 + 3] - b1);
    rs0 += s[n * 4 + 0] + s[n * 4 + 1];
    rs1 += s[n * 4 + 2] + s[n * 4 + 3];
    if constexpr (Scales::kScaled) {
      const float2 vs = *reinterpret_cast<const float2*>(
          scales.base + slot * 2 * BK + BK + n * 8 + tq * 2);
      s[n * 4 + 0] *= vs.x;
      s[n * 4 + 1] *= vs.y;
      s[n * 4 + 2] *= vs.x;
      s[n * 4 + 3] *= vs.y;
    }
  }
  r.l0 = r.l0 * r.a0 + rs0;
  r.l1 = r.l1 * r.a1 + rs1;
}

// P rounded to bf16 in the layout of wgmma's register A operand: n8 blocks
// 2j and 2j+1 of the scores are k-step j.
template <int N>
__device__ __forceinline__ void round_p(const float (&s)[N],
                                        uint32_t (&p)[N / 8][4]) {
  constexpr int BK = 2 * N;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    p[n / 2][(n & 1) * 2 + 0] = pack_bf16(s[n * 4 + 0], s[n * 4 + 1]);
    p[n / 2][(n & 1) * 2 + 1] = pack_bf16(s[n * 4 + 2], s[n * 4 + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const RowState& r) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    acc[n * 4 + 0] *= r.a0;
    acc[n * 4 + 1] *= r.a0;
    acc[n * 4 + 2] *= r.a1;
    acc[n * 4 + 3] *= r.a1;
  }
}

// One consumer warpgroup (`wg` 0 or 1, 64 q rows) over the live KV tiles
// [lo, hi] of its CTA's q tile (keys below S): online softmax with f32
// running max and sum, rows `< T` written to `out` (`NormOut`,
// `StatsOut`). The
// products of consecutive tiles overlap the softmax: S of tile i and
// P_{i-1} V_{i-1} are in flight together, and the softmax of tile i runs
// while the second one finishes.
template <int D, class P, class Scales, class Out>
__device__ __forceinline__ void consume(uint32_t smem, Scales scales,
                                        Ring ring, uint64_t* qbar, int wg,
                                        int qt, int lo, int hi, int T, int S,
                                        int pos, int window, float scale_log2,
                                        Out out) {
  constexpr int ST = P::STAGES;
  constexpr int BK = P::BK;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = qt * BQ + wg * 64;  // this warpgroup's first q row
  const int first = pos + r0, last = first + 63;  // its first/last position
  const uint32_t q_s = smem + wg * 64 * D * 2;
  RowState r;
  r.qa = first + warp * 16 + g;
  r.qb = r.qa + 8;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t p[BK / 16][4];
  const int n = hi - lo + 1;  // >= 1: the kernels return early otherwise

  if (wg == 1) named_barrier_arrive(2, CONSUMER_THREADS);  // 0 goes first
  mbar_wait(qbar, 0);
  mbar_wait(&ring.full_k[0], 0);
  turn_begin(wg);
  wg_fence();
  issue_qk<D, BK>(s, q_s, smem + P::k_slot(0));
  turn_end(wg);
  wg_wait<0>();
  fence_regs(s);
  softmax_tile(s, r, scales, 0, lo, first, last, S, window, tq,
               scale_log2);
  mbar_arrive(&ring.empty_k[0]);
  round_p(s, p);
  for (int i = 1; i < n; ++i) {
    const int st = i % ST, pst = (i - 1) % ST;
    rescale(acc, r);  // the rescale tile i-1 owes O, before P_{i-1} V_{i-1}
    fence_regs(acc);
    fence_regs(p);
    mbar_wait(&ring.full_k[st], (i / ST) & 1);
    mbar_wait(&ring.full_v[pst], ((i - 1) / ST) & 1);
    turn_begin(wg);
    wg_fence();
    issue_qk<D, BK>(s, q_s, smem + P::k_slot(st));
    issue_pv<D, BK>(acc, p, smem + P::v_slot(pst));
    turn_end(wg);
    wg_wait<1>();  // S of tile i
    fence_regs(s);
    softmax_tile(s, r, scales, st, lo + i, first, last, S, window, tq,
                 scale_log2);
    mbar_arrive(&ring.empty_k[st]);
    wg_wait<0>();  // P_{i-1} V_{i-1}
    fence_regs(acc);
    mbar_arrive(&ring.empty_v[pst]);
    round_p(s, p);
  }
  const int pst = (n - 1) % ST;
  rescale(acc, r);
  fence_regs(acc);
  fence_regs(p);
  mbar_wait(&ring.full_v[pst], ((n - 1) / ST) & 1);
  turn_begin(wg);
  wg_fence();
  issue_pv<D, BK>(acc, p, smem + P::v_slot(pst));
  if (wg == 0) turn_end(wg);  // the last turn: warpgroup 0 goes no more
  wg_wait<0>();
  fence_regs(acc);
  mbar_arrive(&ring.empty_v[pst]);

  float l0 = r.l0, l1 = r.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int ra = r0 + warp * 16 + g;
  if constexpr (Out::kStats) {
    // the state itself: O undivided, m in natural-log units (a row that
    // saw no live key keeps m = -1e30, l = 0 and O = 0)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + tq * 2;
      if (ra < T)
        *reinterpret_cast<float2*>(out.o + (long long)ra * D + d) =
            make_float2(acc[j * 4 + 0], acc[j * 4 + 1]);
      if (ra + 8 < T)
        *reinterpret_cast<float2*>(out.o + (long long)(ra + 8) * D + d) =
            make_float2(acc[j * 4 + 2], acc[j * 4 + 3]);
    }
    if (tq == 0) {
      if (ra < T) {
        out.m[ra] = r.m0 <= NEG_INF ? NEG_INF : r.m0 * LN2;
        out.l[ra] = l0;
      }
      if (ra + 8 < T) {
        out.m[ra + 8] = r.m1 <= NEG_INF ? NEG_INF : r.m1 * LN2;
        out.l[ra + 8] = l1;
      }
    }
  } else {
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + tq * 2;
      if (ra < T)
        *reinterpret_cast<__nv_bfloat162*>(out.o + ra * out.o_st + d) =
            __floats2bfloat162_rn(acc[j * 4 + 0] * inv0,
                                  acc[j * 4 + 1] * inv0);
      if (ra + 8 < T)
        *reinterpret_cast<__nv_bfloat162*>(out.o + (ra + 8) * out.o_st + d) =
            __floats2bfloat162_rn(acc[j * 4 + 2] * inv1,
                                  acc[j * 4 + 3] * inv1);
    }
  }
}

// The statistics form's rows of a q tile that sees no live KV tile at all:
// m = -1e30, l = 0, O = 0 (every thread of the CTA takes a share).
template <int D>
__device__ __forceinline__ void store_empty(StatsOut out, int qt, int T) {
  const int r0 = qt * BQ, rows = min(BQ, T - r0);
  for (int i = threadIdx.x; i < rows * D; i += THREADS)
    out.o[(long long)r0 * D + i] = 0.f;
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    out.m[r0 + i] = NEG_INF;
    out.l[r0 + i] = 0.f;
  }
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

// Q [B, H, T, D] bf16 with element strides (q_sb, q_sh, q_st), in boxes of
// 64 rows x 64 columns, 128-byte swizzle.
inline int q_tensor_map(CUtensorMap* map, const void* q, int B, int H, int T,
                        int D, long long q_sb, long long q_sh,
                        long long q_st) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)q_st * 2, (cuuint64_t)q_sh * 2,
                                 (cuuint64_t)q_sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A contiguous cache buffer [B, KVH, S, D] in boxes of `rows` rows: bf16 in
// 64-column blocks with 128-byte swizzle, int8 as whole unswizzled rows.
inline int kv_tensor_map(CUtensorMap* map, const void* kv, int B, int KVH,
                         int S, int D, bool int8, int rows) {
  const cuuint64_t elem = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)KVH,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * elem, (cuuint64_t)S * D * elem,
                                 (cuuint64_t)KVH * S * D * elem};
  const cuuint32_t box[4] = {int8 ? (cuuint32_t)D : 64u, (cuuint32_t)rows,
                             1, 1};
  return tensor_map_4d(
      map,
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      kv, dims, strides, box,
      int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}


// --------------------------------------------------------------------------
// The bf16-cache kernel (csrc/flash_prefill.cu, csrc/flash_prefill_stats.cu)
// --------------------------------------------------------------------------

constexpr int BF16_PRODUCER_REGS = 40;
constexpr int BF16_CONSUMER_REGS = consumer_regs(BF16_PRODUCER_REGS);
template <int D>
using BfPlan = Plan<D, 2>;

// The kernel's output: the normalized bf16 [B, H, T, D] at element strides
// (o_sb, o_sh, o_st), or the statistics form's contiguous f32 o
// [B, H, T, D], m and l [B, H, T].
struct NormDst {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_st;
};

struct StatsDst {
  float* o;
  float* m;
  float* l;
};

template <int D>
__device__ __forceinline__ NormOut rows_of(const NormDst& d, int b, int h,
                                           int H, int T) {
  return {d.o + b * d.o_sb + h * d.o_sh, d.o_st};
}

template <int D>
__device__ __forceinline__ StatsOut rows_of(const StatsDst& d, int b, int h,
                                            int H, int T) {
  const long long bh = (long long)b * H + h;
  return {d.o + bh * T * D, d.m + bh * T, d.l + bh * T};
}

template <int D, class Dst>
__global__ void __launch_bounds__(THREADS, 1)
bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const Dst dst,
            const int* __restrict__ kb_lo, const int* __restrict__ kb_hi,
            int H, int KVH, int T, int S, int pos, int window,
            float scale_log2) {
  using P = BfPlan<D>;
  constexpr int ST = P::STAGES, BK = P::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 * ST + 1];
  const Ring ring{bars, bars + ST, bars + 2 * ST, bars + 3 * ST};
  uint64_t* qbar = bars + 4 * ST;
  const uint32_t smem = aligned_smem(smem_raw);

  const Tile tile = tile_of_block();
  const int hk = tile.h / (H / KVH);
  const int lo = kb_lo ? kb_lo[tile.qt] : 0;
  const int hi = min(kb_hi[tile.qt], (S - 1) / BK);
  auto out = rows_of<D>(dst, tile.b, tile.h, H, T);
  if (lo > hi) {  // no live tile: only the statistics form is called so
    if constexpr (decltype(out)::kStats) store_empty<D>(out, tile.qt, T);
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&ring.full_k[s], 1);
      mbar_init(&ring.empty_k[s], CONSUMER_THREADS);
      mbar_init(&ring.full_v[s], 1);
      mbar_init(&ring.empty_v[s], CONSUMER_THREADS);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every TMA load
    setmaxnreg_dec<BF16_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_expect_tx(qbar, P::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(smem + w * 64 * D * 2 + cb * 64 * 128, &tm_q, qbar,
                      cb * 64, tile.qt * BQ + w * 64, tile.h, tile.b);
      for (int kb = lo, i = 0; kb <= hi; ++kb, ++i) {
        const int st = i % ST, parity = (i / ST - 1) & 1;
        if (i >= ST) mbar_wait(&ring.empty_k[st], parity);
        mbar_expect_tx(&ring.full_k[st], P::KV_BYTES);
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(smem + P::k_slot(st) + cb * BK * 128, &tm_k,
                      &ring.full_k[st], cb * 64, kb * BK, hk, tile.b);
        if (i >= ST) mbar_wait(&ring.empty_v[st], parity);
        mbar_expect_tx(&ring.full_v[st], P::KV_BYTES);
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(smem + P::v_slot(st) + cb * BK * 128, &tm_v,
                      &ring.full_v[st], cb * 64, kb * BK, hk, tile.b);
      }
    }
  } else {
    setmaxnreg_inc<BF16_CONSUMER_REGS>();
    consume<D, P>(smem, NoScales{}, ring, qbar, threadIdx.x / 128 - 1,
                  tile.qt, lo, hi, T, S, pos, window, scale_log2, out);
  }
}

template <int D, class Dst>
int launch_bf16_d(const void* q, const void* k, const void* v, Dst dst,
                  const int* kb_lo, const int* kb_hi, int B, int H, int KVH,
                  int T, int S, long long q_sb, long long q_sh,
                  long long q_st, int pos, int window, float scale_log2,
                  cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = q_tensor_map(&tm_q, q, B, H, T, D, q_sb, q_sh, q_st);
  constexpr int BK = BfPlan<D>::BK;
  if (!err) err = kv_tensor_map(&tm_k, k, B, KVH, S, D, false, BK);
  if (!err) err = kv_tensor_map(&tm_v, v, B, KVH, S, D, false, BK);
  if (err) return err;
  constexpr int smem = BfPlan<D>::SMEM;
  // above 48 KB a kernel must opt in to dynamic shared memory
  cudaError_t cerr = cudaFuncSetAttribute(
      bf16_kernel<D, Dst>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid(H, (T + BQ - 1) / BQ, B);
  bf16_kernel<D, Dst><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, dst, kb_lo, kb_hi, H, KVH, T, S, pos, window,
      scale_log2);
  return (int)cudaGetLastError();
}

// One call of the bf16 kernel at head width D (64, 128 or 256). Returns 0,
// a cudaError_t or ERR_TENSOR_MAP. `kb_lo` may be null (no window: 0).
template <class Dst>
int launch_bf16(const void* q, const void* k, const void* v, Dst dst,
                const int* kb_lo, const int* kb_hi, int B, int H, int KVH,
                int T, int S, int D, long long q_sb, long long q_sh,
                long long q_st, int pos, int window, float scale_log2,
                cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_bf16_d<64>(q, k, v, dst, kb_lo, kb_hi, B, H, KVH, T, S,
                               q_sb, q_sh, q_st, pos, window, scale_log2,
                               stream);
    case 128:
      return launch_bf16_d<128>(q, k, v, dst, kb_lo, kb_hi, B, H, KVH, T, S,
                                q_sb, q_sh, q_st, pos, window, scale_log2,
                                stream);
    case 256:
      return launch_bf16_d<256>(q, k, v, dst, kb_lo, kb_hi, B, H, KVH, T, S,
                                q_sb, q_sh, q_st, pos, window, scale_log2,
                                stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fp90
