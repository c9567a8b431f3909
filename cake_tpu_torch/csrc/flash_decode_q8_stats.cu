// The statistics form of csrc/flash_decode_q8.cu: decode GQA flash
// attention straight from one shard of a sequence-sharded int8 KV cache,
// bf16 queries, on Hopper (sm_90a), in one launch, returning the
// online-softmax state instead of the normalized output.
//
// The JAX package's sequence-parallel decode over the int8 cache
// dequantizes each shard at trace level and attends with the XLA
// `attend_stats` (cake_tpu/ops/attention.py:373-388,
// cake_tpu/ops/ring.py:38); it reaches no Pallas kernel. This is the
// port's counterpart, as csrc/flash_decode_q8.cu is at one shard: the int8
// codes k_q/v_q [B, KVH, S, D] and their f32 per-token scales
// k_scale/v_scale [B, KVH, S] are read where they lie, the key scale
// multiplying the score column and the value scale P before its rounding.
// Frontiers, outputs and empty rows as csrc/flash_decode_stats.cu: o
// [B, H, T, D] f32 unnormalized, m and l [B, H, T] f32, m in natural-log
// units; a row with no live key gives m = -1e30, l = 0, o = 0.

#include "flash_decode_sm90.cuh"

using namespace fd90;

extern "C" {

int flash_decode_q8_stats_block_k() { return BK; }

int flash_decode_q8_stats_tile_rows() { return MAX_G; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_decode_q8_stats_smem_bytes(int D) { return smem_bytes<Int8KV>(D); }

// Returns 0 or a cudaError_t. Partials and counters as for
// flash_decode_bf16.
int flash_decode_q8_stats_bf16(const void* q, const void* k, const void* ks,
                               const void* v, const void* vs, const int* pos,
                               void* o, void* m, void* l, float* part_o,
                               float* part_ml, int* counters, int B, int H,
                               int KVH, int S, int D, int T, int nsplit,
                               long long q_sb, long long q_sh,
                               long long q_st, int window, float scale_log2,
                               void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const unsigned char*>(k),
         static_cast<const unsigned char*>(v),
         static_cast<const float*>(ks),
         static_cast<const float*>(vs),
         pos,
         nullptr,
         part_o,
         part_ml,
         counters,
         KVH,
         KVH > 0 ? H / KVH : 0,
         S,
         T,
         nsplit,
         0,
         q_sb,
         q_sh,
         q_st,
         0,
         0,
         0,
         window,
         scale_log2};
  a.so = static_cast<float*>(o);
  a.sm = static_cast<float*>(m);
  a.sl = static_cast<float*>(l);
  return run<Int8KV>(a, B, H, D, static_cast<cudaStream_t>(stream));
}

const char* flash_decode_q8_stats_error_string(int err) {
  return error_string(err);
}

}  // extern "C"
