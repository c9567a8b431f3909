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
// D = 128 or 256) the two products do ~T/2 multiply-adds per KV byte, far
// above the H100's ~295 operations per byte, so it is bound by tensor-core
// operations, and only wgmma reaches their full rate.
//
// What the design does about that (csrc/flash_prefill_sm90.cuh): a CTA of
// 3 warpgroups per 128 q rows of one (b, h). The producer warpgroup gives
// its registers away (setmaxnreg) and one of its threads keeps a 2-stage
// ring of 128-key K and V tiles (64-key at D = 256) filled by TMA (128-byte
// swizzle, full and empty mbarriers), so loads overlap the products. Two
// consumer warpgroups of 64 q rows each run S = Q K^T and O += P V on
// wgmma, P staying in
// registers and V read in place through the descriptor's transpose flag;
// only diagonal and window-edge tiles are masked; the longest q tiles start
// first. The loop runs only over the live KV tiles [kb_lo, kb_hi] that the
// host computes with `kv_block_bounds` (cake_tpu_torch/ops/flash.py).
// The kernel (`bf16_kernel`) is csrc/flash_prefill_sm90.cuh's, shared with
// its statistics form (csrc/flash_prefill_stats.cu).

#include "flash_prefill_sm90.cuh"

using namespace fp90;

extern "C" {

// Block sizes the host side needs for `kv_block_bounds` (keys a tile, per
// head width).
int flash_prefill_block_q() { return BQ; }
int flash_prefill_block_k_d64() { return BfPlan<64>::BK; }
int flash_prefill_block_k_d128() { return BfPlan<128>::BK; }
int flash_prefill_block_k_d256() { return BfPlan<256>::BK; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_prefill_smem_bytes(int D) {
  return D == 64    ? BfPlan<64>::SMEM
         : D == 128 ? BfPlan<128>::SMEM
         : D == 256 ? BfPlan<256>::SMEM
                    : 0;
}

// Returns 0, a cudaError_t or ERR_TENSOR_MAP. `kb_lo` may be null (no
// window: 0).
int flash_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                       const int* kb_lo, const int* kb_hi, int B, int H,
                       int KVH, int T, int S, int D, long long q_sb,
                       long long q_sh, long long q_st, long long o_sb,
                       long long o_sh, long long o_st, int pos, int window,
                       float scale_log2, void* stream) {
  return launch_bf16(q, k, v, NormDst{static_cast<__nv_bfloat16*>(o),
                                      o_sb, o_sh, o_st},
                     kb_lo, kb_hi, B, H, KVH, T, S, D, q_sb, q_sh, q_st, pos,
                     window, scale_log2, static_cast<cudaStream_t>(stream));
}

const char* flash_prefill_error_string(int err) { return error_string(err); }

}  // extern "C"
