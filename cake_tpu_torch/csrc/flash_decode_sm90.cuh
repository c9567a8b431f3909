// The Hopper decode attention shared by csrc/flash_decode.cu (bf16 cache)
// and csrc/flash_decode_q8.cu (int8 cache with f32 per-token scales): one
// query row per stream, the GQA group of G = H / KVH query heads (any G
// from 1 to 16) folded into the rows of one kv head. The two kernels
// differ only in the KV format (`Bf16KV`, `Int8KV`): how a K row becomes
// mma.sync B fragments, how V does, and the two scale hooks.
//
// What bounds it on this card: 2 multiply-adds per K/V element per query
// row, ~2G operations a byte of bf16 (4G of int8), far below the H100's
// ~295: bound by the bytes of K and V it reads; at one stream, 8 MB at
// 2,048 keys, as much by latencies (pos, then the first tile, then the
// split-K fold's round trips through L2).
//
// One launch does everything a call needs:
// - Bounds in the kernel. Each CTA reads `pos[b]` and `window` and works
//   out its row's live tile range [lo, hi] itself:
//     hi = min(pos / BK, (S - 1) / BK)
//     lo = window >= 0 ? max(pos - window + 1, 0) / BK : 0
//   This device copy of the formula MUST match `kv_block_bounds` of
//   cake_tpu_torch/ops/flash.py (qb = 0, block_q = 1, block_k = BK);
//   chip_smoke.py's window cases (edges inside a tile and on its boundary)
//   hold the kernels against the plain versions, which use that function.
// - Split K. The grid is (nsplit, B * KVH); the host picks nsplit from the
//   shapes alone (about one CTA an SM), and a split takes at least
//   MIN_TILES tiles, so a short live range goes to fewer CTAs. A CTA takes
//   a contiguous share of its row's live tiles, so the splits follow the
//   live range and not the buffer: the `used` splits that get tiles work,
//   the others leave at once. One used split writes the output itself.
//   Otherwise each writes its f32 partial (max, sum, unnormalized output),
//   and the last of a (b, kv head) to finish, picked by a per-(b, kv head)
//   counter that it resets, sums the partials in split order and writes
//   the bf16 output. No sum depends on timing: two calls give the same
//   bits.
// - K/V by asynchronous bulk copies. Warp 4 (the producer) keeps a ring
//   of STAGES slots of 64-key tiles in flight with 1-d `cp.async.bulk`
//   copies completing on an mbarrier, one per 8 key rows (2 KB of bf16 at
//   D = 128; a copy per 256-byte row measured slower), into groups
//   padded so that the consumers' fragment loads are free of bank
//   conflicts (`Layout`). Key rows past the buffer's end are
//   zero-filled with ordinary stores, and a tile's scales go by one bulk
//   copy where they are 16-byte aligned, else by ordinary loads: every S,
//   B, window and pos is taken.
// - Scores and P.V on the tensor cores (mma.sync m16n8k16, f32
//   accumulation), with no shuffle per key: the G query rows, padded to
//   16, are the A operand (loaded once); each of warps 0-3 takes 16 keys of
//   every tile (keys 8n + 2w + j, n = 0..7, j = 0, 1, for warp w: one row
//   of each 8-row group), K from shared memory as B. The score
//   accumulators are, in registers, the A operand of P.V. A warp keeps
//   its own running max (two shuffles a row a tile) and per-lane sums;
//   the four warps merge once at the end in shared memory, in warp order.
// Numerics of csrc/flash_prefill_sm90.cuh: f32 scores times 1/sqrt(D)
// (in the log2 domain), masked keys at -1e30, online softmax in f32, P
// rounded to bf16 before P.V, output bf16. Over the int8 cache the key
// scale multiplies the score column and the value scale P before its
// rounding; the sum takes P without it.

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace fd90 {

using namespace sm90;

constexpr int BK = 64;          // keys per KV tile (unit of kv_block_bounds)
constexpr int CONSUMERS = 4;    // warps; each takes 16 keys of every tile
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and the producer warp
constexpr int MAX_G = 16;       // query rows of a kv head: one m16 A tile
constexpr int STAGES = 4;
// the least number of KV tiles a split takes (1 and 4 measured no faster)
constexpr int MIN_TILES = 2;
constexpr float NEG_INF = -1e30f;

struct Bf16KV {
  static constexpr bool Q8 = false;
  static constexpr int ESIZE = 2;
};

struct Int8KV {
  static constexpr bool Q8 = true;
  static constexpr int ESIZE = 1;
};

// A ring slot: the 64 K rows of a tile in 8 groups of 8 rows (one bulk
// copy each), the same for V, and over the int8 cache the tile's 64 key
// and 64 value scales. Key k is row k % 8 of group k / 8. A warp's loads
// take one row of each group (8 rows a tile for warp w: 8n + 2w + j), so
// the groups' pads, not the rows', keep each load free of bank conflicts:
// - bf16 K, 16-byte loads, 8 lanes a wavefront (2 groups): group stride
//   = 64 mod 128 bytes;
// - int8 K, 8-byte loads, 16 lanes (4 groups): stride = 32 mod 128;
// - bf16 V, ldmatrix (8 groups, 16 bytes each): stride = 16 mod 128;
// - int8 V, 4-byte loads of 4 groups 2 apart (8 words each): stride = 16
//   mod 64.
template <int D, class F>
struct Layout {
  static constexpr int ROW = D * F::ESIZE;  // bytes of a K or V row
  static constexpr int K_GROUP = 8 * ROW + (F::Q8 ? 32 : 64);
  static constexpr int V_GROUP = 8 * ROW + 16;
  static constexpr int V_OFF = 8 * K_GROUP;
  static constexpr int S_OFF = V_OFF + 8 * V_GROUP;  // key, value scales
  static constexpr int SLOT = S_OFF + (F::Q8 ? 2 * BK * 4 : 0);
  // the four warps' outputs, maxima and sums, merged at the end, in rows
  // of MSTRIDE floats: a warp's store of one fragment element writes rows
  // g (8 of them) at columns out_d(nb, 2tq + c), 2tq apart for bf16 and
  // 8tq apart for int8 (`out_d`); rows 8 (bf16) or 1 (int8) banks apart
  // spread the 32 lanes over 16 or 32 banks
  static constexpr int MSTRIDE = D + (F::Q8 ? 1 : 8);
  static constexpr int MERGE = CONSUMERS * MAX_G * (MSTRIDE + 2) * 4;
  static constexpr int SMEM =
      STAGES * SLOT > MERGE ? STAGES * SLOT : MERGE;
  static_assert(SLOT % 128 == 0, "slots keep the banks' alignment");

  __device__ static int k_row(int key) {
    return (key >> 3) * K_GROUP + (key & 7) * ROW;
  }
  __device__ static int v_row(int key) {
    return V_OFF + (key >> 3) * V_GROUP + (key & 7) * ROW;
  }
};

struct Args {
  const __nv_bfloat16* q;
  const unsigned char* k;  // [B, KVH, S, D] bf16 or int8
  const unsigned char* v;
  const float* ks;  // [B, KVH, S] (int8 cache only)
  const float* vs;
  const int* pos;  // [B]
  __nv_bfloat16* o;
  float* part_o;   // [B * KVH, nsplit, G, D] (nsplit > 1)
  float* part_ml;  // [B * KVH, nsplit, G, 2]
  int* counters;   // [B * KVH], 0 between calls
  int KVH, G, S, nsplit;
  long long q_sb, q_sh, o_sb, o_sh;
  int window;
  float scale_log2;
};

__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  const float c[4] = {acc[0], acc[1], acc[2], acc[3]};
  mma_16816(acc, a, b0, b1, c);
}

// Two int8 codes, byte i of `lo` and byte i of `hi`, as a bf16 pair.
__device__ __forceinline__ uint32_t i8_pair(uint32_t lo, uint32_t hi, int i) {
  return i8x2_to_bf16x2(__byte_perm(lo, hi, i | ((4 + i) << 4)), 0x4140);
}

// The A fragments of the query rows (rows >= G are zero). The k slots of a
// 32-column chunk c are permuted so that a lane's loads are wide: lane tq
// holds d = 32c + 8tq .. +7, slots (2tq, 2tq+1, 2tq+8, 2tq+9) of k16 step
// 2c being d + 0..3 and of step 2c + 1 d + 4..7. K's B fragments take the
// same d in the same slots (`scores`).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const Args& a, int b, int hk, int g,
                                       int tq) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* q0 = a.q + b * a.q_sb + (hk * a.G + g) * a.q_sh;
  const __nv_bfloat16* q8 = q0 + 8 * a.q_sh;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    const int d = 32 * c + 8 * tq;
    const uint4 r0 = g < a.G ? *reinterpret_cast<const uint4*>(q0 + d) : zero;
    const uint4 r8 =
        g + 8 < a.G ? *reinterpret_cast<const uint4*>(q8 + d) : zero;
    qa[2 * c][0] = r0.x;
    qa[2 * c][1] = r8.x;
    qa[2 * c][2] = r0.y;
    qa[2 * c][3] = r8.y;
    qa[2 * c + 1][0] = r0.z;
    qa[2 * c + 1][1] = r8.z;
    qa[2 * c + 1][2] = r0.w;
    qa[2 * c + 1][3] = r8.w;
  }
}

// Key of score column n of block j of warp w.
__device__ __forceinline__ int key_of(int w, int j, int n) {
  return 8 * n + 2 * w + j;
}

// Raw scores of this warp's 16 keys: s[j] holds rows (g, g + 8) x columns
// (2tq, 2tq + 1), column n being key 8n + 2w + j (`key_of`).
template <int D, class F>
__device__ __forceinline__ void scores(float (&s)[2][4],
                                       const uint32_t (&qa)[D / 16][4],
                                       const unsigned char* kt, int w, int g,
                                       int tq) {
  using L = Layout<D, F>;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const unsigned char* row = kt + L::k_row(key_of(w, j, g));
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      uint32_t b[4];
      if constexpr (F::Q8) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + 32 * c + 8 * tq);
        b[0] = i8x2_to_bf16x2(v.x, 0x4140);
        b[1] = i8x2_to_bf16x2(v.x, 0x4342);
        b[2] = i8x2_to_bf16x2(v.y, 0x4140);
        b[3] = i8x2_to_bf16x2(v.y, 0x4342);
      } else {
        const uint4 v =
            *reinterpret_cast<const uint4*>(row + 64 * c + 16 * tq);
        b[0] = v.x;
        b[1] = v.y;
        b[2] = v.z;
        b[3] = v.w;
      }
      mma(s[j], qa[2 * c], b[0], b[1]);
      mma(s[j], qa[2 * c + 1], b[2], b[3]);
    }
  }
}

// O += P V over this warp's 16 keys. P's k slots are the score columns:
// slot n (n < 8) is key_of(w, 0, n) and slot 8 + n key_of(w, 1, n). bf16: n8
// block nb is d = 8 nb + n, B fragments by ldmatrix.trans. int8: a lane's
// 4-byte loads of the keys of slots 2tq, 2tq + 1, 2tq + 8, 2tq + 9 hold
// d = 32c + 4g .. +3, so n8 block nb = 4c + i is d = 32c + 4n + i (`out_d`
// maps back).
template <int D, class F>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const uint32_t (&pa)[4],
                                   const unsigned char* slot, int w,
                                   int lane) {
  using L = Layout<D, F>;
  if constexpr (F::Q8) {
    const int g = lane >> 2, tq = lane & 3;
    const unsigned char* r0 = slot + L::v_row(key_of(w, 0, 2 * tq)) + 4 * g;
    const unsigned char* r1 =
        slot + L::v_row(key_of(w, 0, 2 * tq + 1)) + 4 * g;
    const unsigned char* r8 = slot + L::v_row(key_of(w, 1, 2 * tq)) + 4 * g;
    const unsigned char* r9 =
        slot + L::v_row(key_of(w, 1, 2 * tq + 1)) + 4 * g;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r0 + 32 * c);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r1 + 32 * c);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(r8 + 32 * c);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(r9 + 32 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma(o[4 * c + i], pa, i8_pair(w0, w1, i), i8_pair(w8, w9, i));
    }
  } else {
    // matrices 0 and 2 are slots 0-7, 1 and 3 slots 8-15; 2 and 3 the next
    // 8 columns of d
    const int mi = lane >> 3;
    const uint32_t row = smem_u32(
        slot + L::v_row(key_of(w, mi & 1, lane & 7)) + 16 * (mi >> 1));
#pragma unroll
    for (int nb2 = 0; nb2 < D / 16; ++nb2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + 32 * nb2);
      mma(o[2 * nb2], pa, b[0], b[1]);
      mma(o[2 * nb2 + 1], pa, b[2], b[3]);
    }
  }
}

// The d of column n of output n8 block nb.
template <class F>
__device__ __forceinline__ int out_d(int nb, int n) {
  return F::Q8 ? 32 * (nb / 4) + 4 * n + nb % 4 : 8 * nb + n;
}

// Warp 4: every live tile of this CTA into the ring, a slot as soon as the
// four consumer warps have freed it.
template <int D, class F>
__device__ __forceinline__ void produce(const Args& a, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        long long head, int first, int n,
                                        int lane) {
  using L = Layout<D, F>;
  const unsigned char* kg = a.k + head * a.S * L::ROW;
  const unsigned char* vg = a.v + head * a.S * L::ROW;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, key0 = (first + i) * BK;
    if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
    unsigned char* slot = smem + s * L::SLOT;
    const int valid = min(BK, a.S - key0);
    // the buffer's last tile: rows past its end are zeros (P is 0 there,
    // and 0 * a stale NaN would not be)
    constexpr int CHUNKS = L::ROW / 16;
    for (int u = lane; u < (BK - valid) * CHUNKS; u += 32) {
      const int r = valid + u / CHUNKS, c = u % CHUNKS;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(slot + L::k_row(r) + c * 16) = zero;
      *reinterpret_cast<uint4*>(slot + L::v_row(r) + c * 16) = zero;
    }
    uint32_t bytes = 2u * valid * L::ROW;
    bool bulk_scales = false;
    if constexpr (F::Q8) {
      const float* ks = a.ks + head * a.S + key0;
      const float* vs = a.vs + head * a.S + key0;
      float* sk = reinterpret_cast<float*>(slot + L::S_OFF);
      bulk_scales = valid % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(ks) |
                      reinterpret_cast<uintptr_t>(vs)) & 15) == 0;
      if (bulk_scales) {
        bytes += 2u * valid * 4;
        for (int r = valid + lane; r < BK; r += 32) sk[r] = sk[BK + r] = 0.f;
      } else {  // scales off the 16-byte rule: ordinary loads
        for (int r = lane; r < BK; r += 32) {
          sk[r] = r < valid ? ks[r] : 0.f;
          sk[BK + r] = r < valid ? vs[r] : 0.f;
        }
      }
    }
    // the ordinary stores above, before this slot's bulk copies and before
    // the consumers' wait ends
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_expect_tx(&full[s], bytes);
    __syncwarp();
    const uint32_t dst = smem_u32(slot);
    if (lane < 16) {  // lanes 0-7 copy K's groups, 8-15 V's
      const int grp = lane & 7, rows = min(8, valid - 8 * grp);
      const bool is_v = lane >= 8;
      if (rows > 0)
        bulk_load(dst + (is_v ? L::v_row(8 * grp) : L::k_row(8 * grp)),
                  (is_v ? vg : kg) + (long long)(key0 + 8 * grp) * L::ROW,
                  rows * L::ROW, &full[s]);
    }
    if constexpr (F::Q8) {
      if (bulk_scales && lane == 0) {
        bulk_load(dst + L::S_OFF, a.ks + head * a.S + key0, valid * 4,
                  &full[s]);
        bulk_load(dst + L::S_OFF + BK * 4, a.vs + head * a.S + key0,
                  valid * 4, &full[s]);
      }
    }
  }
}

// Grid (nsplit, B * KVH): split blockIdx.x of the live tiles of
// (b, kv head) = blockIdx.y.
template <int D, class F>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const Args a) {
  using L = Layout<D, F>;
  constexpr int NB = D / 8;  // output n8 blocks
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  __shared__ int last;
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.KVH, hk = bh % a.KVH;
  __nv_bfloat16* out = a.o + b * a.o_sb + hk * a.G * a.o_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this row's live tiles (kv_block_bounds), and this split's share
  const int p = a.pos[b];
  const int hi = min(p / BK, (a.S - 1) / BK);
  const int lo = a.window >= 0 ? max(p - a.window + 1, 0) / BK : 0;
  const int live = max(hi - lo + 1, 0);
  const int per = max((live + a.nsplit - 1) / a.nsplit, MIN_TILES);
  const int used = (live + per - 1) / per;
  if (split > 0 && split >= used) return;  // no tile for this split
  const int first = lo + split * per;
  const int n = max(0, min(per, hi + 1 - first));

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    produce<D, F>(a, smem, full, empty, bh, first, n, lane);
    return;
  }

  const int g = lane >> 2, tq = lane & 3;
  uint32_t qa[D / 16][4];
  load_q<D>(qa, a, b, hk, g, tq);
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const unsigned char* slot = smem + s * L::SLOT;
    const float* sk = reinterpret_cast<const float*>(slot + L::S_OFF);
    mbar_wait(&full[s], (i / STAGES) & 1);
    float sc[2][4];
    scores<D, F>(sc, qa, slot, warp, g, tq);
    const int key0 = (first + i) * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = key_of(warp, j, 2 * tq + (e & 1)), key = key0 + kl;
        const bool ok = key < a.S && key <= p &&
                        (a.window < 0 || key > p - a.window);
        float x = sc[j][e] * a.scale_log2;
        if constexpr (F::Q8) x *= sk[kl];
        sc[j][e] = ok ? x : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
    float pr[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = exp2f(sc[j][e] - m[e >> 1]);
        l[e >> 1] += x;
        pr[j][e] = x;
        if constexpr (F::Q8)
          pr[j][e] *= sk[BK + key_of(warp, j, 2 * tq + (e & 1))];
      }
    const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]),
                            pack_bf16(pr[0][2], pr[0][3]),
                            pack_bf16(pr[1][0], pr[1][1]),
                            pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
    }
    pv<D, F>(o, pa, slot, warp, lane);
    // this warp's reads of the slot come before the next copies into it
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // The four warps' states, merged in warp order in the ring's memory:
  // rows of MSTRIDE floats, padded so that a warp's stores of one element
  // of its fragments fall in distinct banks but for at most 2-way
  // conflicts (`Layout::MSTRIDE`).
  constexpr int MS = L::MSTRIDE;
  float* red_o = reinterpret_cast<float*>(smem);  // [4][16][MS]
  float* red_m = red_o + CONSUMERS * MAX_G * MS;  // [4][16]
  float* red_l = red_m + CONSUMERS * MAX_G;       // [4][16]
  named_barrier_sync(1, 32 * CONSUMERS);  // every warp is done with the ring
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (tq == 0) {
      red_m[warp * MAX_G + g + 8 * r] = m[r];
      red_l[warp * MAX_G + g + 8 * r] = l[r];
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red_o[(warp * MAX_G + g + 8 * (e >> 1)) * MS +
            out_d<F>(nb, 2 * tq + (e & 1))] = o[nb][e];
  named_barrier_sync(1, 32 * CONSUMERS);

  const int tid = threadIdx.x;
  const bool direct = used <= 1;  // this CTA writes the output
  const long long slot0 = ((long long)bh * a.nsplit + split) * a.G;
  for (int idx = tid; idx < a.G * D; idx += 32 * CONSUMERS) {
    const int r = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) M = fmaxf(M, red_m[w * MAX_G + r]);
    float Lsum = 0.f, O = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
        const float wt = exp2f(red_m[w * MAX_G + r] - M);
        Lsum += red_l[w * MAX_G + r] * wt;
        O += red_o[(w * MAX_G + r) * MS + d] * wt;
      }
    }
    if (direct) {
      out[r * a.o_sh + d] = __float2bfloat16_rn(O / Lsum);
    } else {
      a.part_o[(slot0 + r) * D + d] = O;
      if (d == 0) {
        a.part_ml[(slot0 + r) * 2] = M;
        a.part_ml[(slot0 + r) * 2 + 1] = Lsum;
      }
    }
  }
  if (direct) return;

  // the last used split of this (b, kv head) to finish sums every used
  // split's partial, in split order
  // (one thread's fence after the barrier orders the CTA's writes before
  // its count: fences are cumulative)
  named_barrier_sync(1, 32 * CONSUMERS);
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&a.counters[bh], 1) == used - 1;
    if (last) a.counters[bh] = 0;  // ready for the next call
    __threadfence();
  }
  named_barrier_sync(1, 32 * CONSUMERS);
  if (!last) return;
  // The fold: every split's max and sum into shared memory (all loads in
  // flight at once); then a warp a row: lanes take splits, the row's max
  // and sum by shuffles, and each split's weight, the 1 / sum folded in;
  // then four output columns a thread, summed over the splits in split
  // order.
  const long long base = (long long)bh * a.nsplit * a.G;
  const int np = used * a.G;  // (split, row) pairs, split-major
  float* fm = reinterpret_cast<float*>(smem);
  float* fl = fm + np;
  for (int i = tid; i < np; i += 32 * CONSUMERS) {
    fm[i] = __ldcg(a.part_ml + (base + i) * 2);
    fl[i] = __ldcg(a.part_ml + (base + i) * 2 + 1);
  }
  named_barrier_sync(1, 32 * CONSUMERS);
  for (int r = warp; r < a.G; r += CONSUMERS) {
    float M = -INFINITY;
    for (int sp = lane; sp < used; sp += 32) M = fmaxf(M, fm[sp * a.G + r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float Lsum = 0.f;
    for (int sp = lane; sp < used; sp += 32)
      Lsum += fl[sp * a.G + r] * exp2f(fm[sp * a.G + r] - M);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      Lsum += __shfl_xor_sync(0xffffffffu, Lsum, off);
    __syncwarp();
    for (int sp = lane; sp < used; sp += 32)
      fm[sp * a.G + r] = exp2f(fm[sp * a.G + r] - M) / Lsum;
  }
  named_barrier_sync(1, 32 * CONSUMERS);
  for (int idx = tid; idx < a.G * D / 4; idx += 32 * CONSUMERS) {
    const int r = idx / (D / 4), d = 4 * (idx % (D / 4));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < used; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          a.part_o + (base + sp * a.G + r) * D + d));
      const float wt = fm[sp * a.G + r];
      acc.x += v.x * wt;
      acc.y += v.y * wt;
      acc.z += v.z * wt;
      acc.w += v.w * wt;
    }
    __nv_bfloat16* dst = out + r * a.o_sh + d;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(acc.x, acc.y);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
        __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

template <int D, class F>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Layout<D, F>::SMEM;
  // above 48 KB a kernel must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<D, F><<<dim3(a.nsplit, B * a.KVH), THREADS, smem, stream>>>(
      a);
  return (int)cudaGetLastError();
}

// One call as the host's wrapper gives it: H / KVH = G in 1..16, D 64 or
// 128, nsplit >= 1 (and above 1 partials and counters). Returns 0 or a
// cudaError_t.
template <class F>
int run(const Args& a, int B, int H, int D, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (B <= 0 || a.KVH <= 0 || H % a.KVH || a.G != H / a.KVH || a.G < 1 ||
      a.G > MAX_G || a.S <= 0 || a.nsplit < 1 ||
      (a.nsplit > 1 &&
       (a.part_o == nullptr || a.part_ml == nullptr || a.counters == nullptr)))
    return bad;
  if (D == 64) return launch<64, F>(a, B, stream);
  if (D == 128) return launch<128, F>(a, B, stream);
  return bad;
}

template <class F>
int smem_bytes(int D) {
  return D == 64 ? Layout<64, F>::SMEM : D == 128 ? Layout<128, F>::SMEM : 0;
}

}  // namespace fd90
