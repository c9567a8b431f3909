// Causal GQA flash attention for prefill over the int8 KV cache, bf16
// queries, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_prefill_q8_kernel` of
// cake_tpu/ops/pallas/flash.py (called through `flash_attention_q8`, :323).
// Same function: q [B, H, T, D] bf16 at absolute offset `pos` against the
// int8 cache k_q/v_q [B, KVH, S, D] with one f32 scale per token and head,
// k_scale/v_scale [B, KVH, S] (the layout of cake_tpu_torch.ops.kvcache
// QuantizedKV). The per-token scales are constant along D, so they factor
// out of both products and the dequantized cache never exists:
// - scores are (q . k_q) times the key's scale, times 1/sqrt(D);
// - the running max and sum are those of csrc/flash_prefill.cu: online
//   softmax in f32, the sum `l` taking P WITHOUT the value scale;
// - the value scale multiplies P before P is rounded to bf16 for the PV
//   product (P * v_scale) @ v_q.
// Mask kpos <= pos + qpos (and kpos > pos + qpos - window when windowed);
// output bf16. Query head h reads kv head h / (H / KVH).
//
// What bounds it on this card: at the main path's shapes (T = 2048,
// D = 128) the two products do ~T/2 multiply-adds per KV byte, far above
// the H100's ~295 operations per byte: bound by tensor-core operations, as
// the bf16 kernel is. The int8 cache halves the KV bytes it reads.
//
// What the design does about that: the consumer warpgroups are those of
// csrc/flash_prefill.cu (csrc/flash_prefill_sm90.cuh: wgmma products, P in
// registers, masks only on edge tiles, longest q tiles first), with the
// two scale hooks on. The producer warpgroup differs: TMA brings each int8
// K and V tile (half the bf16 bytes) into a staging buffer, and its 128
// threads convert the codes to bf16 (exact: |q| <= 127) into the same
// swizzled 2-stage ring the consumers read, beside the tile's 128 key and
// 128 value scales, then arrive on the stage's "full" barrier. The next
// int8 tile is in flight while the consumers work on the current one.

#include "flash_prefill_sm90.cuh"

using namespace fp90;

namespace {

// the producer's threads convert tiles, so they keep more registers
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = consumer_regs(PRODUCER_REGS);
static_assert(BK == 128, "one key (and its two scales) per producer thread");

// Four int8 codes to four bf16 values, two packed pairs.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  lo = i8x2_to_bf16x2(w, 0x4140);
  hi = i8x2_to_bf16x2(w, 0x4342);
}

// TMA stages the codes in quarter tiles (K rows 0-63, K rows 64-127, V rows
// 0-63, V rows 64-127 of a tile) in a ring of NBUF buffers, two tiles ahead
// of the conversion. Each producer warp converts its own SLICE rows of every
// quarter and marks the buffer read (a "freed" mbarrier counting the four
// warps); thread 0 refills a buffer a step later, so the warps never wait
// for each other.
constexpr int HALF = BK / 2;
constexpr int SLICE = HALF / 4;
constexpr int NBUF = 8;

template <int D>
using Q8Plan = Plan<D, 2, NBUF * HALF * D>;

// Where the producer is in its sequence of quarters: K of tile j (parts 0
// and 1), then V of tile j - 1 (parts 2 and 3), for j = 0..n. A consumer
// needs K_j with V_{j-1}, and K_j's slot is free half an iteration before
// V_{j-1}'s.
struct Quarters {
  int j = 0, part = 0;
  __device__ __forceinline__ bool valid(int n) const { return j <= n; }
  __device__ __forceinline__ int tile() const { return part < 2 ? j : j - 1; }
  __device__ __forceinline__ void next(int n) {
    do {
      if (++part == 4) {
        part = 0;
        ++j;
      }
    } while (j <= n && (part < 2 ? j == n : j == 0));
  }
};

// One warp's SLICE rows of a staged quarter into a bf16 tile of the ring,
// in two steps so that the staging buffer is free before the conversion:
// the codes into registers, then to bf16 in the layout TMA's 128-byte
// swizzle gives the bf16 kernel (64-column blocks of BK rows of 128 bytes,
// 16-byte chunk c of row r at chunk c ^ (r % 8)). Lane l takes the 8-code
// units l, l + 32, ...: eight neighbouring lanes read 64 neighbouring bytes
// and write the eight chunks of one 128-byte row, so neither side has bank
// conflicts.
template <int D>
struct Codes {
  static constexpr int PER_ROW = D / 8;  // 8-code units a row
  static constexpr int N = SLICE * PER_ROW / 32;
  uint2 w[N];

  __device__ __forceinline__ void load(const unsigned char* src, int lane) {
#pragma unroll
    for (int m = 0; m < N; ++m)
      w[m] = *reinterpret_cast<const uint2*>(src + (lane + m * 32) * 8);
  }

  __device__ __forceinline__ void store_bf16(unsigned char* dst, int row0,
                                             int lane) const {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int u = lane + m * 32;
      const int r = row0 + u / PER_ROW, c8 = u % PER_ROW;
      uint4 b;
      i8x4_to_bf16x4(w[m].x, b.x, b.y);
      i8x4_to_bf16x4(w[m].y, b.z, b.w);
      *reinterpret_cast<uint4*>(dst + (c8 / 8) * BK * 128 + r * 128 +
                                (((c8 % 8) ^ (r & 7)) << 4)) = b;
    }
  }
};

// One thread: TMA of the quarter at `at` into staging buffer `buf`.
template <int D>
__device__ __forceinline__ void stage_quarter(uint32_t staging,
                                              const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v,
                                              uint64_t* bar, int buf,
                                              Quarters at, int lo, int hk,
                                              int b) {
  mbar_expect_tx(bar, HALF * D);
  tma_load_4d(staging + buf * HALF * D, at.part < 2 ? tm_k : tm_v, bar, 0,
              (lo + at.tile()) * BK + (at.part & 1) * HALF, hk, b);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_q8_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        __nv_bfloat16* __restrict__ o,
                        const int* __restrict__ kb_lo,
                        const int* __restrict__ kb_hi, int H, int KVH, int T,
                        int S, long long o_sb, long long o_sh, long long o_st,
                        int pos, int window, float scale_log2) {
  using P = Q8Plan<D>;
  constexpr int ST = P::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 * ST + 1 + 2 * NBUF];
  const Ring ring{bars, bars + ST, bars + 2 * ST, bars + 3 * ST};
  uint64_t* qbar = bars + 4 * ST;
  uint64_t* staged = bars + 4 * ST + 1;  // a staging buffer is loaded
  uint64_t* freed = staged + NBUF;       // ... and read by the four warps
  const uint32_t smem = aligned_smem(smem_raw);
  unsigned char* base = smem_raw;
  float* scales = reinterpret_cast<float*>(base + P::SCALES);

  const Tile tile = tile_of_block();
  const int hk = tile.h / (H / KVH);
  const int lo = kb_lo ? kb_lo[tile.qt] : 0;
  const int hi = min(kb_hi[tile.qt], (S - 1) / BK);
  if (lo > hi) return;  // no live tile: never so for a valid call

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      // every producer thread converts a share of a tile
      mbar_init(&ring.full_k[s], 128);
      mbar_init(&ring.empty_k[s], CONSUMER_THREADS);
      mbar_init(&ring.full_v[s], 128);
      mbar_init(&ring.empty_v[s], CONSUMER_THREADS);
    }
    mbar_init(qbar, 1);
    for (int q = 0; q < NBUF; ++q) {
      mbar_init(&staged[q], 1);
      mbar_init(&freed[q], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int n = hi - lo + 1;
    Quarters ahead, at;  // thread 0's next quarter to stage; this one
    if (t == 0) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      mbar_expect_tx(qbar, P::Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(smem + w * 64 * D * 2 + cb * 64 * 128, &tm_q, qbar,
                      cb * 64, tile.qt * BQ + w * 64, tile.h, tile.b);
      for (int buf = 0; buf < NBUF && ahead.valid(n); ++buf, ahead.next(n))
        stage_quarter<D>(smem + P::STAGING, &tm_k, &tm_v, &staged[buf], buf,
                         ahead, lo, hk, tile.b);
    }
    const long long head = (long long)tile.b * KVH + hk;
    const float* ks_src = k_scale + head * S;
    const float* vs_src = v_scale + head * S;
    float ks = 0.f, vs = 0.f;
    for (int seq = 0; at.valid(n); ++seq, at.next(n)) {
      const int buf = seq % NBUF, i = at.tile(), st = i % ST;
      const bool is_v = at.part >= 2;
      if (at.part == 0) {  // this K tile's scales, read early
        const int key = (lo + i) * BK + t;
        ks = key < S ? ks_src[key] : 0.f;
        vs = key < S ? vs_src[key] : 0.f;
      }
      Codes<D> codes;
      mbar_wait(&staged[buf], (seq / NBUF) & 1);
      codes.load(base + P::STAGING + buf * HALF * D + warp * SLICE * D,
                 lane);
      // this warp's rows are read, and ordered before the next TMA writes
      // into the buffer
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&freed[buf]);
      if (t == 0 && seq > 0 && ahead.valid(n)) {
        // refill the previous step's buffer once every warp has read it
        const int prev = (seq - 1) % NBUF;
        mbar_wait(&freed[prev], ((seq - 1) / NBUF) & 1);
        stage_quarter<D>(smem + P::STAGING, &tm_k, &tm_v, &staged[prev],
                         prev, ahead, lo, hk, tile.b);
        ahead.next(n);
      }
      if ((at.part & 1) == 0 && i >= ST)
        mbar_wait(is_v ? &ring.empty_v[st] : &ring.empty_k[st],
                  (i / ST - 1) & 1);
      codes.store_bf16(base + (is_v ? P::v_slot(st) : P::k_slot(st)),
                       (at.part & 1) * HALF + warp * SLICE, lane);
      if (at.part == 1) {  // both scales beside the K tile
        scales[st * 2 * BK + t] = ks;
        scales[st * 2 * BK + BK + t] = vs;
      }
      if (at.part & 1) {  // this warp's rows of the tile are in place
        fence_proxy_async();  // wgmma reads shared memory by async proxy
        mbar_arrive(is_v ? &ring.full_v[st] : &ring.full_k[st]);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<D, P>(smem, SlotScales{scales}, ring, qbar,
                  threadIdx.x / 128 - 1, tile.qt, lo, hi, T, pos, window,
                  scale_log2, o + tile.b * o_sb + tile.h * o_sh, o_st);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* o, const int* kb_lo, const int* kb_hi,
           int B, int H, int KVH, int T, int S, long long q_sb,
           long long q_sh, long long q_st, long long o_sb, long long o_sh,
           long long o_st, int pos, int window, float scale_log2,
           cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = q_tensor_map(&tm_q, q, B, H, T, D, q_sb, q_sh, q_st);
  if (!err) err = kv_tensor_map(&tm_k, k, B, KVH, S, D, true, HALF);
  if (!err) err = kv_tensor_map(&tm_v, v, B, KVH, S, D, true, HALF);
  if (err) return err;
  constexpr int smem = Q8Plan<D>::SMEM;
  // above 48 KB a kernel must opt in to dynamic shared memory
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_prefill_q8_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid(H, (T + BQ - 1) / BQ, B);
  flash_prefill_q8_kernel<D><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(o), kb_lo,
      kb_hi, H, KVH, T, S, o_sb, o_sh, o_st, pos, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Block sizes the host side needs for `kv_block_bounds`.
int flash_prefill_q8_block_q() { return BQ; }
int flash_prefill_q8_block_k() { return BK; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_prefill_q8_smem_bytes(int D) {
  return D == 64 ? Q8Plan<64>::SMEM : D == 128 ? Q8Plan<128>::SMEM : 0;
}

// Returns 0, a cudaError_t or ERR_TENSOR_MAP. `kb_lo` may be null (no
// window: 0).
int flash_prefill_q8_bf16(const void* q, const void* k, const void* ks,
                          const void* v, const void* vs, void* o,
                          const int* kb_lo, const int* kb_hi, int B, int H,
                          int KVH, int T, int S, int D, long long q_sb,
                          long long q_sh, long long q_st, long long o_sb,
                          long long o_sh, long long o_st, int pos,
                          int window, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, ks, v, vs, o, kb_lo, kb_hi, B, H, KVH, T, S,
                        q_sb, q_sh, q_st, o_sb, o_sh, o_st, pos, window,
                        scale_log2, st);
    case 128:
      return launch<128>(q, k, ks, v, vs, o, kb_lo, kb_hi, B, H, KVH, T, S,
                         q_sb, q_sh, q_st, o_sb, o_sh, o_st, pos, window,
                         scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_prefill_q8_error_string(int err) {
  return error_string(err);
}

}  // extern "C"
