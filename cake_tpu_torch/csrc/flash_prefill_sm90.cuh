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
// Only the tiles that hold the causal diagonal or the window's lower edge
// are masked element by element. Blocks are mapped so that the q tiles
// with the most live KV tiles start first.

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
// masked where the tile holds the diagonal or the window's lower edge,
// exponentiated against the new running max, summed into l, and (int8
// cache) times the value scale. Leaves the rescale of O in r.a0/r.a1.
template <int N, class Scales>
__device__ __forceinline__ void softmax_tile(float (&s)[N], RowState& r,
                                             const Scales& scales, int slot,
                                             int kb, int first, int last,
                                             int window, int tq,
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
  if (kb * BK + BK - 1 > first || (window >= 0 && kb * BK <= last - window)) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * BK + n * 8 + tq * 2 + (e & 1);
        const int qp = (e & 2) ? r.qb : r.qa;
        if (!(key <= qp && (window < 0 || key > qp - window)))
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
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    s[n * 4 + 0] = exp2f(s[n * 4 + 0] - mx0);
    s[n * 4 + 1] = exp2f(s[n * 4 + 1] - mx0);
    s[n * 4 + 2] = exp2f(s[n * 4 + 2] - mx1);
    s[n * 4 + 3] = exp2f(s[n * 4 + 3] - mx1);
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
// [lo, hi] of its CTA's q tile: online softmax with f32 running max and
// sum, output in bf16 to rows `< T` of `o` (row stride `o_st`). The
// products of consecutive tiles overlap the softmax: S of tile i and
// P_{i-1} V_{i-1} are in flight together, and the softmax of tile i runs
// while the second one finishes.
template <int D, class P, class Scales>
__device__ __forceinline__ void consume(uint32_t smem, Scales scales,
                                        Ring ring, uint64_t* qbar, int wg,
                                        int qt, int lo, int hi, int T,
                                        int pos, int window, float scale_log2,
                                        __nv_bfloat16* o, long long o_st) {
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
  softmax_tile(s, r, scales, 0, lo, first, last, window, tq, scale_log2);
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
    softmax_tile(s, r, scales, st, lo + i, first, last, window, tq,
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
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int ra = r0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + tq * 2;
    if (ra < T)
      *reinterpret_cast<__nv_bfloat162*>(o + ra * o_st + d) =
          __floats2bfloat162_rn(acc[j * 4 + 0] * inv0,
                                acc[j * 4 + 1] * inv0);
    if (ra + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + (ra + 8) * o_st + d) =
          __floats2bfloat162_rn(acc[j * 4 + 2] * inv1,
                                acc[j * 4 + 3] * inv1);
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

}  // namespace fp90
