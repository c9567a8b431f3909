// The Hopper body shared by csrc/quant_matmul.cu (int8 weights) and
// csrc/quant4_matmul.cu (packed int4 weights, per-channel or grouped
// scales): y = x @ W with W's codes converted to bf16 exactly on chip, f32
// accumulation, the scale applied to f32 sums, bf16 output rounded once.
// The two kernels differ only in the weight format (`Int8W`, `Int4W`): how
// a byte row unpacks into K rows, and where the scale goes.
//
// Two regimes, chosen by the host's plan (cake_tpu_torch/ops/qmatmul.py):
//
// Prefill (M > 16), bound by tensor-core operations. The product is
// y^T = W^T x^T, with the weight as wgmma's register A operand (the route
// of CUTLASS's mixed-input GEMMs): a CTA of 3 warpgroups computes a
// BM x 128 output tile over all of K in 64-row k steps, through a ring of
// 5 slots:
// - warpgroup 0, the producer, gives its registers away (setmaxnreg); its
//   thread 0 loads each step's x tile (bf16, K-major) and raw weight tile
//   (int8 or packed int4, and grouped, the step's row of scales) by TMA,
//   both with the 128-byte swizzle, waiting only for a slot to be free.
// - warpgroups 1 and 2, the consumers, own 64 weight columns each. A
//   thread converts its two columns' codes of the next k step from the
//   raw tile straight into A fragments (two 16-bit loads a K row pair, no
//   bf16 tile in shared memory) while the tensor cores run this step's
//   wgmma m64nBMk16, B = the x tile read in place. So the conversion,
//   paid once per weight code for BM rows of x, is spread over 256
//   threads and hidden under the products; one step's products stay in
//   flight, and a slot is freed when they are done.
// - BM = 256 (128 f32 accumulators a thread) where the output tiles fill
//   the card, else 128. Grouped int4 keeps the group's own partial beside
//   the sum: wgmma writes it fresh (scale-d = 0) on the group's first k
//   step, and before the next group's first the consumer folds
//   acc += partial * s[g, n] in f32. Two accumulators fit at BM = 192
//   (2 x 96 f32 and 32 registers of A fragments, of the 240 a consumer
//   gets once the producer keeps 24), which grouped takes for 256.
// The grid is rastered with the M tiles fastest, so the CTAs of a wave
// share the weight's N tiles in L2.
//
// Decode (M <= 16), bound by the weight's bytes (2-4 operations a byte).
// A CTA of 5 warps streams a 128-column strip of W over a range of K:
// - warp 4's lane 0 keeps a ring of 6 (int4: 5) slots of 8 KB weight tiles
//   (raw codes, 128-byte swizzle) and the x columns they meet in flight by
//   TMA, so no register holds a load and 40-48 KB a CTA (about one CTA an
//   SM, as the host plans it) are on their way;
// - warps 0-3 each take a quarter of every slot's K rows and convert their
//   codes in registers straight into mma.sync m16n8k16 A fragments (the
//   product is y^T = W^T x^T: 16 output columns a fragment, x padded to 8
//   or 16 rows as the B operand); the codes a thread needs for 8 fragments
//   are 4 (int8) or 2 (int4) 16-byte loads;
// - the four warps' sums are added in shared memory in warp order. Where
//   the plan splits K over CTAs (too few 128-column strips for the card),
//   each split writes its f32 partial, and the last CTA of a strip to
//   finish (a per-strip counter it resets itself) sums the partials in
//   split order, scales and stores bf16: one launch, no atomics in any sum,
//   the same bits on every run.

#pragma once

#include "sm90.cuh"

namespace qmm {

using namespace sm90;

constexpr int BK = 64;   // K rows of a prefill k step
constexpr int BN = 128;  // output columns of a CTA
constexpr int PREFILL_THREADS = 384;
constexpr int PRODUCER_REGS = 24;
// 168 registers a thread at launch (65,536 / 384, rounded down to 8): what
// the producer gives away the two consumer warpgroups share
constexpr int CONSUMER_REGS = (3 * 168 - PRODUCER_REGS) / 2 / 8 * 8;
constexpr int DECODE_THREADS = 160;
constexpr int DECODE_W_BYTES = 64 * BN;  // weight bytes of a decode slot

constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }

// --------------------------------------------------------------------------
// Conversions (exact: every code is a small integer)
// --------------------------------------------------------------------------

// bf16 pair {128 + lo byte, 128 + byte 2} - 136 of a word whose bytes 0 and 2
// hold a nibble biased by 8 (n ^ 8): the signed nibbles, as a bf16 pair.
__device__ __forceinline__ uint32_t biased_nibbles_to_bf16x2(uint32_t t) {
  const uint32_t a = (t & 0x000F000Fu) | 0x43004300u;
  const uint32_t c = 0xC308C308u;  // -136, -136
  const __nv_bfloat162 sum =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&sum);
}

// Low and high nibbles of the four bytes of `w`, each biased by 8.
__device__ __forceinline__ uint32_t low_nibbles(uint32_t w) {
  return (w & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t high_nibbles(uint32_t w) {
  return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// The int8 codes at byte i of `lo` and byte i of `hi` as a bf16 pair.
__device__ __forceinline__ uint32_t i8_pair(uint32_t lo, uint32_t hi, int i) {
  const uint32_t t = __byte_perm(lo, hi, ((4 + i) << 8) | i);
  const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (t & 0x00800080u) | 0xC300C300u;
  const __nv_bfloat162 sum =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&sum);
}

// The (low, high) nibble of byte i of a packed word as a bf16 pair, from
// the word's biased low and high nibbles.
__device__ __forceinline__ uint32_t i4_pair(uint32_t lo, uint32_t hi, int i) {
  return biased_nibbles_to_bf16x2(__byte_perm(lo, hi, ((4 + i) << 8) | i));
}

// --------------------------------------------------------------------------
// Weight formats
// --------------------------------------------------------------------------

// Where a consumer thread's two weight columns lie in a raw tile of 128
// columns whose 128-byte rows TMA swizzled (16-byte chunk c of row r at
// chunk c ^ (r % 8)): byte `col` (even) of row r.
__device__ __forceinline__ uint32_t raw_pair(const unsigned char* raw, int r,
                                             int col) {
  return *reinterpret_cast<const uint16_t*>(
      raw + r * 128 + (((col >> 4) ^ (r & 7)) << 4) + (col & 15));
}

// int8 [K, N]: one K row a byte row; the per-channel scale in the epilogue.
struct Int8W {
  static constexpr int PACK = 1;
  static constexpr bool GROUPED = false;

  // Prefill: the wgmma A fragment (W^T, 16 weight columns x 16 K rows) of
  // k16 step kk of a raw [64][128] tile, for the thread's columns col and
  // col + 1 (fragment rows g and g + 8) and K rows kk * 16 + {2tq, 2tq + 1,
  // 2tq + 8, 2tq + 9}.
  __device__ __forceinline__ static void a_frag(uint32_t (&a)[4],
                                                const unsigned char* raw,
                                                int kk, int col, int tq) {
    const int r = kk * 16 + 2 * tq;
    const uint32_t r0 = raw_pair(raw, r, col), r1 = raw_pair(raw, r + 1, col);
    const uint32_t r8 = raw_pair(raw, r + 8, col);
    const uint32_t r9 = raw_pair(raw, r + 9, col);
    a[0] = i8_pair(r0, r1, 0);
    a[1] = i8_pair(r0, r1, 1);
    a[2] = i8_pair(r8, r9, 0);
    a[3] = i8_pair(r8, r9, 1);
  }
};

// packed int4 [K/2, N]: byte row p holds K rows 2p (low nibble) and 2p + 1
// (high nibble). Per-channel scales in the epilogue, or grouped [K/g, N]
// scales folded into each group's f32 partial.
template <bool G>
struct Int4W {
  static constexpr int PACK = 2;
  static constexpr bool GROUPED = G;

  // Prefill: as Int8W::a_frag over a raw [32][128] packed tile: K rows
  // 2tq and 2tq + 1 of step kk are the two nibbles of packed row kk * 8 +
  // tq, rows 2tq + 8 and 2tq + 9 those of packed row kk * 8 + tq + 4.
  __device__ __forceinline__ static void a_frag(uint32_t (&a)[4],
                                                const unsigned char* raw,
                                                int kk, int col, int tq) {
    const int p = kk * 8 + tq;
    const uint32_t w = raw_pair(raw, p, col) | (raw_pair(raw, p + 4, col)
                                                << 16);
    const uint32_t lo = low_nibbles(w), hi = high_nibbles(w);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = i4_pair(lo, hi, i);
  }
};

// --------------------------------------------------------------------------
// Prefill regime
// --------------------------------------------------------------------------

// Byte offsets of a ring slot in the dynamic shared memory (1024-aligned):
// the x tile (BM rows of 64 bf16), the raw weight tile (64 int8 or 32
// packed int4 rows of 128 columns), both with TMA's 128-byte swizzle, and
// (grouped) the k step's 128 scales.
template <class W, int BM>
struct PrefillPlan {
  static constexpr int RAW = BM * BK * 2;
  static constexpr int S = RAW + BK / W::PACK * BN;
  static constexpr int TX = S + (W::GROUPED ? BN * 4 : 0);  // TMA bytes
  static constexpr int SLOT = round_up(TX, 1024);
  static constexpr int STAGES = 5;
  static constexpr int SMEM = STAGES * SLOT;
};

// A consumer warpgroup's state over its 64 weight columns and the CTA's BM
// rows of x: the f32 sum and, grouped, the current group's partial (wgmma
// D is W^T x^T: D row 16 w + g is weight column col, row 16 w + g + 8 is
// col + 1; D column j is x row j).
template <class W, int BM>
struct Consumer {
  using P = PrefillPlan<W, BM>;
  static constexpr int NACC = BM / 2;  // f32 a thread: 64 x BM over 128
  float acc[NACC];
  float part[W::GROUPED ? NACC : 1];
  uint32_t a[2][BK / 16][4];  // the A fragments of two k steps
  int pending = -1;  // the slot whose products may still be in flight
  int col, tq;

  // The A fragments of k step `kt` (its slot has landed) into set S.
  template <int S>
  __device__ __forceinline__ void convert(const unsigned char* slot) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      W::a_frag(a[S][kk], slot + P::RAW, kk, col, tq);
  }

  // acc += part * s[g, col], once the group's products are done; the
  // group's scales are in slot `s` (its last k step).
  __device__ __forceinline__ void fold(const unsigned char* slot) {
    fence_regs(part);
    fence_regs(acc);
    const float* sc = reinterpret_cast<const float*>(slot + P::S);
    const float s0 = sc[col], s1 = sc[col + 1];
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j) {
      acc[j * 4 + 0] += part[j * 4 + 0] * s0;
      acc[j * 4 + 1] += part[j * 4 + 1] * s0;
      acc[j * 4 + 2] += part[j * 4 + 2] * s1;
      acc[j * 4 + 3] += part[j * 4 + 3] * s1;
    }
  }
};

// One k step of a consumer warpgroup, its A fragments in set S: issue its
// products, then (while they run) release the previous step's slot and
// convert the next step's codes into the other set.
template <class W, int BM, int S>
__device__ __forceinline__ void prefill_step(Consumer<W, BM>& c, int kt,
                                             int nk, int group,
                                             uint32_t smem,
                                             unsigned char* smem_raw,
                                             uint64_t* full, uint64_t* empty,
                                             int tid) {
  using P = PrefillPlan<W, BM>;
  constexpr int ST = P::STAGES;
  const int s = kt % ST;
  const bool first = W::GROUPED && (kt * BK) % group == 0;
  if (W::GROUPED && first && kt > 0) {
    // the previous group's products are done: fold them in, then free
    // the slot that holds its scales
    wg_wait<0>();
    c.fold(smem_raw + c.pending * P::SLOT);
    fence_proxy_async();  // the scales are read before TMA refills
    if (tid == 0) mbar_arrive(&empty[c.pending]);
    c.pending = -1;
  }
  wg_fence();
  const uint32_t x = smem + s * P::SLOT;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = smem_desc(x + kk * 32, 16, 1024);
    if constexpr (W::GROUPED)
      wgmma_rs_kmajor(c.part, c.a[S][kk], db, !(first && kk == 0));
    else
      wgmma_rs_kmajor(c.acc, c.a[S][kk], db, 1);
  }
  wg_commit();
  wg_wait<1>();  // the previous step's products are done
  // wgmma read set S ^ 1 until now: its registers were not reused before
  fence_regs(c.a[S ^ 1]);
  if (tid == 0 && c.pending >= 0) mbar_arrive(&empty[c.pending]);
  c.pending = s;
  if (kt + 1 < nk) {
    const int s1 = (kt + 1) % ST;
    mbar_wait(&full[s1], ((kt + 1) / ST) & 1);
    c.template convert<S ^ 1>(smem_raw + s1 * P::SLOT);
  }
}

template <class W, int BM>
__global__ void __launch_bounds__(PREFILL_THREADS, 1)
prefill_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_s,
               const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ y, int M, int N, int K,
               int group) {
  using P = PrefillPlan<W, BM>;
  constexpr int ST = P::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * ST];
  uint64_t* full = bars;        // a slot's TMA bytes have landed
  uint64_t* empty = bars + ST;  // both consumers are done with it
  const uint32_t smem = aligned_smem(smem_raw);

  const int m_tiles = (M + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int nk = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one thread of each consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      // the TMA loads of every k step, a ring ahead of the products
      prefetch_tensor_map(&tm_x);
      prefetch_tensor_map(&tm_w);
      if constexpr (W::GROUPED) prefetch_tensor_map(&tm_s);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(&empty[s], (kt / ST - 1) & 1);
        uint64_t* bar = &full[s];
        const uint32_t slot = smem + s * P::SLOT;
        mbar_expect_tx(bar, P::TX);
        tma_load_2d(slot, &tm_x, bar, kt * BK, m0);
        tma_load_2d(slot + P::RAW, &tm_w, bar, n0, kt * (BK / W::PACK));
        if constexpr (W::GROUPED)
          tma_load_2d(slot + P::S, &tm_s, bar, n0, kt * BK / group);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2;
    Consumer<W, BM> c;
    c.col = wg * 64 + warp * 16 + 2 * g;  // within the CTA's 128 columns
    c.tq = lane & 3;
#pragma unroll
    for (int i = 0; i < c.NACC; ++i) c.acc[i] = 0.f;
    mbar_wait(&full[0], 0);
    c.template convert<0>(smem_raw);
    for (int kt = 0; kt < nk; kt += 2) {
      prefill_step<W, BM, 0>(c, kt, nk, group, smem, smem_raw, full, empty,
                             tid);
      if (kt + 1 < nk)
        prefill_step<W, BM, 1>(c, kt + 1, nk, group, smem, smem_raw, full,
                               empty, tid);
    }
    wg_wait<0>();
    fence_regs(c.a[0]);
    fence_regs(c.a[1]);
    if constexpr (W::GROUPED) c.fold(smem_raw + c.pending * P::SLOT);
    fence_regs(c.acc);

    // D row (col, col + 1), column j * 8 + 2 tq (+ 1) -> y rows m, m + 1
    const int n = n0 + c.col;
    if (n < N) {
      float s0 = 1.f, s1 = 1.f;
      if constexpr (!W::GROUPED) {
        s0 = scale[n];
        s1 = scale[n + 1];
      }
#pragma unroll
      for (int j = 0; j < c.NACC / 4; ++j) {
        const int m = m0 + j * 8 + 2 * c.tq;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)m * N + n) =
              __floats2bfloat162_rn(c.acc[j * 4 + 0] * s0,
                                    c.acc[j * 4 + 2] * s1);
        if (m + 1 < M)
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)(m + 1) * N +
                                             n) =
              __floats2bfloat162_rn(c.acc[j * 4 + 1] * s0,
                                    c.acc[j * 4 + 3] * s1);
      }
    }
  }
}

// --------------------------------------------------------------------------
// Decode regime
// --------------------------------------------------------------------------

// acc = a * b (`fresh`) or acc += a * b.
__device__ __forceinline__ void mma_step(float (&acc)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], bool fresh) {
  float c[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = fresh ? 0.f : acc[e];
  mma_16816(acc, a, b[0], b[1], c);
}

// A ring slot: the weight tile (64 byte rows of 128 columns, 128-byte
// swizzle), the x columns of its K rows (one 16-row x 64-column block,
// 128-byte swizzle, per 64 K rows) and (grouped) two rows of 128 scales.
// A slot covers SK = 64 K rows of int8 or 128 of int4: 8 KB of weight.
template <class W>
struct DecodePlan {
  static constexpr int SK = 64 * W::PACK;
  static constexpr int X = DECODE_W_BYTES;
  static constexpr int S = X + SK / 64 * 16 * 128;
  static constexpr int TX = S + (W::GROUPED ? 2 * BN * 4 : 0);
  static constexpr int SLOT = round_up(TX, 1024);
  // ring slots: three CTAs of either format share an SM's shared memory
  static constexpr int STAGES = W::PACK == 1 ? 6 : 5;
  static constexpr int SMEM = STAGES * SLOT;
};

// A k16 step of one warp: the A fragments of the strip's 8 16-column
// groups, from the codes of the slot's weight tile `w`, and the B
// fragments of x (rows g and, with NM = 2, g + 8) from the slot's x block.
// Fragment f covers output columns 16 g + 2 f (its row g) and 16 g + 2 f + 1
// (its row g + 8) for the thread's g, so a thread's codes of one K row are
// the 16 bytes of chunk g.
//   int8: the k16 step's K rows are the tile's rows k0 .. k0 + 15 in order.
//   int4: fragment slots 2tq, 2tq + 1 are the nibbles of packed row
//   k0/2 + 2tq and slots 2tq + 8, 2tq + 9 those of packed row k0/2 + 2tq
//   + 1 (K rows k0 + 4tq .. k0 + 4tq + 3); x's B fragment takes the same K
//   rows.
template <class W, int NM>
__device__ __forceinline__ void decode_k16(float (&acc)[8][NM][4],
                                           const unsigned char* w,
                                           const unsigned char* x, int k0,
                                           int g, int tq, bool fresh) {
  uint32_t b[NM][2];
  const int xb = k0 / 64, kc = k0 % 64;  // x block, column within it
  if constexpr (W::PACK == 1) {
    const int r = k0 + 2 * tq;
    auto row = [&](int k) {
      return *reinterpret_cast<const uint4*>(w + k * 128 +
                                             ((g ^ (k & 7)) << 4));
    };
    const uint4 r0 = row(r), r1 = row(r + 1), r8 = row(r + 8),
                r9 = row(r + 9);
#pragma unroll
    for (int nm = 0; nm < NM; ++nm) {
      const int xr = g + 8 * nm;
      const unsigned char* xrow = x + xb * 2048 + xr * 128;
      b[nm][0] = *reinterpret_cast<const uint32_t*>(
          xrow + (((kc / 8) ^ g) << 4) + 4 * tq);
      b[nm][1] = *reinterpret_cast<const uint32_t*>(
          xrow + (((kc / 8 + 1) ^ g) << 4) + 4 * tq);
    }
    const uint32_t a0[4] = {r0.x, r0.y, r0.z, r0.w};
    const uint32_t a1[4] = {r1.x, r1.y, r1.z, r1.w};
    const uint32_t a8[4] = {r8.x, r8.y, r8.z, r8.w};
    const uint32_t a9[4] = {r9.x, r9.y, r9.z, r9.w};
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int wi = f / 2, bi = (f % 2) * 2;
      const uint32_t a[4] = {
          i8_pair(a0[wi], a1[wi], bi), i8_pair(a0[wi], a1[wi], bi + 1),
          i8_pair(a8[wi], a9[wi], bi), i8_pair(a8[wi], a9[wi], bi + 1)};
#pragma unroll
      for (int nm = 0; nm < NM; ++nm) mma_step(acc[f][nm], a, b[nm], fresh);
    }
  } else {
    auto row = [&](int p) {
      return *reinterpret_cast<const uint4*>(w + p * 128 +
                                             ((g ^ (p & 7)) << 4));
    };
    const int p = k0 / 2 + 2 * tq;
    const uint4 lo = row(p), hi = row(p + 1);
#pragma unroll
    for (int nm = 0; nm < NM; ++nm) {
      const int xr = g + 8 * nm;
      const int c = kc + 4 * tq;  // x column of slot 2tq
      const uint2 v = *reinterpret_cast<const uint2*>(
          x + xb * 2048 + xr * 128 + (((c / 8) ^ g) << 4) + (c % 8) * 2);
      b[nm][0] = v.x;
      b[nm][1] = v.y;
    }
    const uint32_t p0[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t p1[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      const uint32_t l0 = low_nibbles(p0[wi]), h0 = high_nibbles(p0[wi]);
      const uint32_t l1 = low_nibbles(p1[wi]), h1 = high_nibbles(p1[wi]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = wi * 2 + half, bi = half * 2;
        const uint32_t a[4] = {i4_pair(l0, h0, bi), i4_pair(l0, h0, bi + 1),
                               i4_pair(l1, h1, bi), i4_pair(l1, h1, bi + 1)};
#pragma unroll
        for (int nm = 0; nm < NM; ++nm) mma_step(acc[f][nm], a, b[nm], fresh);
      }
    }
  }
}

// Output strip blockIdx.x (128 columns) over the K slots of split
// blockIdx.y: [split * per_split, +per_split) of ceil(K / SK), never empty.
template <class W, int NM>
__global__ void __launch_bounds__(DECODE_THREADS)
decode_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_s,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
              float* __restrict__ part, int* __restrict__ counters, int M,
              int N, int K, int group, int per_split, int splits) {
  using P = DecodePlan<W>;
  constexpr int ST = P::STAGES;
  constexpr int STEPS = P::SK / 64;  // k16 steps of a warp in a slot
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * ST];
  __shared__ int last;
  uint64_t* full = bars;
  uint64_t* empty = bars + ST;  // the four consumer warps are done
  const uint32_t smem = aligned_smem(smem_raw);

  const int strip = blockIdx.x, split = blockIdx.y, n0 = strip * BN;
  const int first = split * per_split;
  const int n = min(per_split, (K + P::SK - 1) / P::SK - first);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {  // the producer: one lane keeps the ring full
    if (lane == 0) {
      prefetch_tensor_map(&tm_w);
      prefetch_tensor_map(&tm_x);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, k = (first + i) * P::SK;
        if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
        uint64_t* bar = &full[s];
        const uint32_t slot = smem + s * P::SLOT;
        mbar_expect_tx(bar, P::TX);
        tma_load_2d(slot, &tm_w, bar, n0, k / W::PACK);
        for (int xb = 0; xb < P::SK / 64; ++xb)
          tma_load_2d(slot + P::X + xb * 2048, &tm_x, bar, k + xb * 64, 0);
        if constexpr (W::GROUPED)
          tma_load_2d(slot + P::S, &tm_s, bar, n0, k / group);
      }
    }
    return;
  }

  const int g = lane >> 2, tq = lane & 3;
  float acc[8][NM][4];
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int nm = 0; nm < NM; ++nm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][nm][e] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    const unsigned char* slot = smem_raw + s * P::SLOT;
    mbar_wait(&full[s], (i / ST) & 1);
    if constexpr (W::GROUPED) {
      // this warp's 32 K rows lie in one group: their partial, times the
      // group's scales
      float gp[8][NM][4];
#pragma unroll
      for (int st = 0; st < STEPS; ++st)
        decode_k16<W, NM>(gp, slot, slot + P::X, (warp * STEPS + st) * 16,
                          g, tq, st == 0);
      const int k = (first + i) * P::SK;
      const int row = (k + warp * STEPS * 16) / group - k / group;
      const float* sc = reinterpret_cast<const float*>(slot + P::S) +
                        row * BN + 16 * g;
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const float2 v = *reinterpret_cast<const float2*>(sc + 2 * f);
#pragma unroll
        for (int nm = 0; nm < NM; ++nm) {
          acc[f][nm][0] += gp[f][nm][0] * v.x;
          acc[f][nm][1] += gp[f][nm][1] * v.x;
          acc[f][nm][2] += gp[f][nm][2] * v.y;
          acc[f][nm][3] += gp[f][nm][3] * v.y;
        }
      }
    } else {
#pragma unroll
      for (int st = 0; st < STEPS; ++st)
        decode_k16<W, NM>(acc, slot, slot + P::X, (warp * STEPS + st) * 16,
                          g, tq, false);
    }
    // this warp's reads of the slot come before TMA writes it again
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the four warps' sums, added in warp order in the ring's memory:
  // fragment element e of f is y[m][n], m = 8 nm + 2 tq + (e & 1),
  // n = 16 g + 2 f + (e >> 1)
  const int tid = threadIdx.x;
  float* red = reinterpret_cast<float*>(smem_raw);  // [4][16][BN]
  named_barrier_sync(1, 128);  // every warp is done with the ring
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int nm = 0; nm < NM; ++nm)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * 16 + 8 * nm + 2 * tq + (e & 1)) * BN + 16 * g + 2 * f +
            (e >> 1)] = acc[f][nm][e];
  named_barrier_sync(1, 128);
  for (int e = tid; e < M * BN; e += 128) {
    const int m = e / BN, c = e % BN, col = n0 + c;
    if (col >= N) continue;
    const float v = red[m * BN + c] + red[(16 + m) * BN + c] +
                    red[(32 + m) * BN + c] + red[(48 + m) * BN + c];
    if (splits > 1)
      part[((long long)split * M + m) * N + col] = v;
    else
      y[(long long)m * N + col] =
          __float2bfloat16_rn(W::GROUPED ? v : v * scale[col]);
  }
  if (splits == 1) return;

  // the last split of this strip to finish sums every split's partial
  __threadfence();
  named_barrier_sync(1, 128);
  if (tid == 0) {
    last = atomicAdd(&counters[strip], 1) == splits - 1;
    if (last) counters[strip] = 0;  // ready for the next call
    __threadfence();
  }
  named_barrier_sync(1, 128);
  if (!last) return;
  for (int e = tid; e < M * BN; e += 128) {
    const int m = e / BN, c = e % BN, col = n0 + c;
    if (col >= N) continue;
    float v = 0.f;
    for (int j = 0; j < splits; ++j)
      v += __ldcg(part + ((long long)j * M + m) * N + col);
    y[(long long)m * N + col] =
        __float2bfloat16_rn(W::GROUPED ? v : v * scale[col]);
  }
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

template <class W, int BM>
int launch_prefill(const void* x, const void* w, const void* scale, void* y,
                   int M, int N, int K, int group, cudaStream_t stream) {
  using P = PrefillPlan<W, BM>;
  CUtensorMap tm_x, tm_w, tm_s;
  int err = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                          (cuuint64_t)K * 2, 64, BM,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                        K / W::PACK, N, BN, BK / W::PACK,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  tm_s = tm_w;  // never read unless grouped
  if (!err && W::GROUPED)
    err = tensor_map_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N,
                        (K + group - 1) / group, (cuuint64_t)N * 4, BN, 1,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  // above 48 KB a kernel must opt in to dynamic shared memory
  cudaError_t cerr = cudaFuncSetAttribute(
      prefill_kernel<W, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  const unsigned grid = (unsigned)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  prefill_kernel<W, BM><<<grid, PREFILL_THREADS, P::SMEM, stream>>>(
      tm_x, tm_w, tm_s, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), M, N, K, group);
  return (int)cudaGetLastError();
}

template <class W, int NM>
int launch_decode(const void* x, const void* w, const void* scale, void* y,
                  void* part, int* counters, int M, int N, int K, int group,
                  int per_split, int splits, cudaStream_t stream) {
  using P = DecodePlan<W>;
  CUtensorMap tm_x, tm_w, tm_s;
  int err = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                          (cuuint64_t)K * 2, 64, 16,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                        K / W::PACK, N, BN, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  tm_s = tm_w;  // never read unless grouped
  if (!err && W::GROUPED)
    err = tensor_map_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N,
                        (K + group - 1) / group, (cuuint64_t)N * 4, BN, 2,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      decode_kernel<W, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((N + BN - 1) / BN, splits);
  decode_kernel<W, NM><<<grid, DECODE_THREADS, P::SMEM, stream>>>(
      tm_x, tm_w, tm_s, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), counters, M,
      N, K, group, per_split, splits);
  return (int)cudaGetLastError();
}

template <class W>
int smem_bytes(int block_m) {
  if (block_m == 16) return DecodePlan<W>::SMEM;
  if (block_m == 128) return PrefillPlan<W, 128>::SMEM;
  if (block_m == 192 && W::GROUPED) return PrefillPlan<W, 192>::SMEM;
  if (block_m == 256 && !W::GROUPED) return PrefillPlan<W, 256>::SMEM;
  return 0;
}

// One call of format W as the host's plan gives it: `block_m` 16 is the
// decode regime (`splits` x `per_split` K slots of SK rows; `part` holds
// splits x M x N floats and `counters` one int a 128-column strip, all 0,
// when splits > 1), 128 or 256 the prefill regime (splits 1). Returns 0, a
// cudaError_t or ERR_TENSOR_MAP.
template <class W>
int run(const void* x, const void* w, const void* scale, void* y, void* part,
        int* counters, int M, int N, int K, int group, int block_m,
        int splits, int per_split, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (M <= 0 || K <= 0 || K % BK || N <= 0 || N % 16) return bad;
  if (W::GROUPED && (group <= 0 || group % BK)) return bad;
  if (block_m == 16) {
    const int slots = (K + DecodePlan<W>::SK - 1) / DecodePlan<W>::SK;
    if (M > 16 || splits < 1 || per_split < 1 ||
        (long long)(splits - 1) * per_split >= slots ||
        (long long)splits * per_split < slots ||
        (splits > 1 && (part == nullptr || counters == nullptr)))
      return bad;
    return M <= 8 ? launch_decode<W, 1>(x, w, scale, y, part, counters, M, N,
                                        K, group, per_split, splits, stream)
                  : launch_decode<W, 2>(x, w, scale, y, part, counters, M, N,
                                        K, group, per_split, splits, stream);
  }
  if (splits != 1) return bad;
  if (block_m == 128)
    return launch_prefill<W, 128>(x, w, scale, y, M, N, K, group, stream);
  if constexpr (W::GROUPED) {
    if (block_m == 192)
      return launch_prefill<W, 192>(x, w, scale, y, M, N, K, group, stream);
  } else {
    if (block_m == 256)
      return launch_prefill<W, 256>(x, w, scale, y, M, N, K, group, stream);
  }
  return bad;
}

}  // namespace qmm
