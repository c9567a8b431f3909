// Causal GQA flash attention for prefill, bf16, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_prefill_kernel` of
// cake_tpu/ops/pallas/flash.py (called through `flash_attention`, :147).
// Same function: q [B, H, T, D] at absolute offset `pos` against the full
// cache buffers k/v [B, KVH, S, D]; f32 scores times 1/sqrt(D) in the log2
// domain; online softmax with f32 running max, sum and accumulator; mask
// kpos <= pos + qpos (and kpos > pos + qpos - window when windowed); P
// rounded to bf16 before the PV product; output in bf16. Query head h reads
// kv head h / (H / KVH).
//
// What bounds it on this card: at the main path's shapes (T = 2048,
// D = 128) the two products do ~T/2 multiply-adds per KV byte, far above
// the H100's ~295 operations per byte, so it is bound by tensor-core
// operations, and only wgmma reaches their full rate.
//
// What the design does about that (csrc/flash_prefill_sm90.cuh): a CTA of
// 3 warpgroups per 128 q rows of one (b, h). The producer warpgroup gives
// its registers away (setmaxnreg) and one of its threads keeps a 2-stage
// ring of 128-key K and V tiles filled by TMA (128-byte swizzle, full and
// empty mbarriers), so loads overlap the products. Two consumer warpgroups
// of 64 q rows each run S = Q K^T and O += P V on wgmma, P staying in
// registers and V read in place through the descriptor's transpose flag;
// only diagonal and window-edge tiles are masked; the longest q tiles start
// first. The loop runs only over the live KV tiles [kb_lo, kb_hi] that the
// host computes with `kv_block_bounds` (cake_tpu_torch/ops/flash.py).

#include "flash_prefill_sm90.cuh"

using namespace fp90;

namespace {

constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = consumer_regs(PRODUCER_REGS);
template <int D>
using BfPlan = Plan<D, 2>;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o,
                     const int* __restrict__ kb_lo,
                     const int* __restrict__ kb_hi, int H, int KVH, int T,
                     int S, long long o_sb, long long o_sh, long long o_st,
                     int pos, int window, float scale_log2) {
  using P = BfPlan<D>;
  constexpr int ST = P::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 * ST + 1];
  const Ring ring{bars, bars + ST, bars + 2 * ST, bars + 3 * ST};
  uint64_t* qbar = bars + 4 * ST;
  const uint32_t smem = aligned_smem(smem_raw);

  const Tile tile = tile_of_block();
  const int hk = tile.h / (H / KVH);
  const int lo = kb_lo ? kb_lo[tile.qt] : 0;
  const int hi = min(kb_hi[tile.qt], (S - 1) / BK);
  if (lo > hi) return;  // no live tile: never so for a valid call

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
    setmaxnreg_dec<PRODUCER_REGS>();
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
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<D, P>(smem, NoScales{}, ring, qbar, threadIdx.x / 128 - 1,
                  tile.qt, lo, hi, T, pos, window, scale_log2,
                  o + tile.b * o_sb + tile.h * o_sh, o_st);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kb_lo, const int* kb_hi, int B, int H, int KVH, int T,
           int S, long long q_sb, long long q_sh, long long q_st,
           long long o_sb, long long o_sh, long long o_st, int pos,
           int window, float scale_log2, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = q_tensor_map(&tm_q, q, B, H, T, D, q_sb, q_sh, q_st);
  if (!err) err = kv_tensor_map(&tm_k, k, B, KVH, S, D, false);
  if (!err) err = kv_tensor_map(&tm_v, v, B, KVH, S, D, false);
  if (err) return err;
  constexpr int smem = BfPlan<D>::SMEM;
  // above 48 KB a kernel must opt in to dynamic shared memory
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid(H, (T + BQ - 1) / BQ, B);
  flash_prefill_kernel<D><<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), kb_lo, kb_hi, H, KVH,
      T, S, o_sb, o_sh, o_st, pos, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Block sizes the host side needs for `kv_block_bounds`.
int flash_prefill_block_q() { return BQ; }
int flash_prefill_block_k() { return BK; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_prefill_smem_bytes(int D) {
  return D == 64 ? BfPlan<64>::SMEM : D == 128 ? BfPlan<128>::SMEM : 0;
}

// Returns 0, a cudaError_t or ERR_TENSOR_MAP. `kb_lo` may be null (no
// window: 0).
int flash_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                       const int* kb_lo, const int* kb_hi, int B, int H,
                       int KVH, int T, int S, int D, long long q_sb,
                       long long q_sh, long long q_st, long long o_sb,
                       long long o_sh, long long o_st, int pos, int window,
                       float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, kb_lo, kb_hi, B, H, KVH, T, S, q_sb,
                        q_sh, q_st, o_sb, o_sh, o_st, pos, window,
                        scale_log2, st);
    case 128:
      return launch<128>(q, k, v, o, kb_lo, kb_hi, B, H, KVH, T, S, q_sb,
                         q_sh, q_st, o_sb, o_sh, o_st, pos, window,
                         scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_prefill_error_string(int err) { return error_string(err); }

}  // extern "C"
