// The statistics form of csrc/flash_prefill.cu: causal GQA flash attention
// for prefill over a bf16 key block, bf16, on Hopper (sm_90a), returning
// the online-softmax state instead of the normalized output.
//
// Replaces, on the card, the per-block attention of the JAX package's ring
// attention (`attend_stats`, cake_tpu/ops/ring.py:38, an XLA einsum over
// f32 scores; the JAX sp path reaches no Pallas kernel); its function is
// that of the Pallas kernel `_prefill_kernel` of
// cake_tpu/ops/pallas/flash.py (`flash_attention`, :147) with the division
// by the row sum left out. q [B, H, T, D] at offset `pos` relative to the
// block's first key, against k/v [B, KVH, S, D]: key j attends query row t
// iff j <= pos + t (and j > pos + t - window when windowed), with `pos` any
// integer (a ring visit of an earlier block has every key live: pos >= T).
// Outputs, contiguous: o [B, H, T, D] f32 unnormalized, relative to m;
// m [B, H, T] f32, the row max of the scaled scores in natural-log units;
// l [B, H, T] f32, the row sum of exp(score - m). P is rounded to bf16
// before the PV product, as in the normalized form. A row with no live key
// gives m = -1e30, l = 0, o = 0 exactly, so partials merge as
// cake_tpu_torch/ops/ring.py merge_stats does.
//
// The kernel and its design are csrc/flash_prefill_sm90.cuh's
// (`bf16_kernel` with `StatsDst`): the same tiles, rings and wgmma
// products; only the epilogue differs, and a q tile with no live KV tile
// writes its empty rows and leaves.

#include "flash_prefill_sm90.cuh"

using namespace fp90;

extern "C" {

int flash_prefill_stats_block_q() { return BQ; }
int flash_prefill_stats_block_k_d64() { return BfPlan<64>::BK; }
int flash_prefill_stats_block_k_d128() { return BfPlan<128>::BK; }
int flash_prefill_stats_block_k_d256() { return BfPlan<256>::BK; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_prefill_stats_smem_bytes(int D) {
  return D == 64    ? BfPlan<64>::SMEM
         : D == 128 ? BfPlan<128>::SMEM
         : D == 256 ? BfPlan<256>::SMEM
                    : 0;
}

// Returns 0, a cudaError_t or ERR_TENSOR_MAP. `kb_lo` may be null (no
// window: 0); `kb_hi` may run past the buffer's last tile (it is clamped).
int flash_prefill_stats_bf16(const void* q, const void* k, const void* v,
                             void* o, void* m, void* l, const int* kb_lo,
                             const int* kb_hi, int B, int H, int KVH, int T,
                             int S, int D, long long q_sb, long long q_sh,
                             long long q_st, int pos, int window,
                             float scale_log2, void* stream) {
  return launch_bf16(q, k, v,
                     StatsDst{static_cast<float*>(o), static_cast<float*>(m),
                              static_cast<float*>(l)},
                     kb_lo, kb_hi, B, H, KVH, T, S, D, q_sb, q_sh, q_st, pos,
                     window, scale_log2, static_cast<cudaStream_t>(stream));
}

const char* flash_prefill_stats_error_string(int err) {
  return error_string(err);
}

}  // extern "C"
