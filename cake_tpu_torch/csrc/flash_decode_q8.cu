// Decode GQA flash attention straight from the int8 KV cache, bf16
// queries, on Hopper (sm_90a), in one launch: one query position a stream
// or T of them (a speculative verify).
//
// The JAX package has no Pallas kernel here: its decode over the int8
// cache dequantizes at trace level on the XLA path, where the convert and
// multiply fuse into the attention dot's operand read
// (cake_tpu/ops/attention.py:397-421, cake_tpu/ops/kvcache.py:47-52). This
// kernel is the port's counterpart of that fusion: q [B, H, T, D] bf16
// against the int8 codes k_q/v_q [B, KVH, S, D] and the f32 per-token
// scales k_scale/v_scale [B, KVH, S] (cake_tpu_torch.ops.kvcache
// QuantizedKV), read where they lie; the dequantized cache never exists.
// The per-token scales are constant along D, so they factor out of both
// products: the key scale multiplies the score column, the value scale P
// before its rounding to bf16 (the running sum takes P without it), as in
// csrc/flash_prefill_q8.cu. Everything else is csrc/flash_decode.cu's
// function: causal frontier per row from `pos [B]` (query t at
// pos[b] + t), optional window, f32 online softmax, output bf16.
//
// What bounds it: the int8 bytes of K and V and their scales, D + 4 bytes
// a key and operand (half of the bf16 cache's 2 D). The design is
// csrc/flash_decode_sm90.cuh's, with the codes converted to bf16 exactly
// in registers on their way into the mma.sync fragments.

#include "flash_decode_sm90.cuh"

using namespace fd90;

extern "C" {

int flash_decode_q8_block_k() { return BK; }

// Query rows of a CTA: the G * T rows of a kv head go 16 to a CTA.
int flash_decode_q8_tile_rows() { return MAX_G; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_decode_q8_smem_bytes(int D) { return smem_bytes<Int8KV>(D); }

// Returns 0 or a cudaError_t. Partials and counters as for
// flash_decode_bf16.
int flash_decode_q8_bf16(const void* q, const void* k, const void* ks,
                         const void* v, const void* vs, const int* pos,
                         void* o, float* part_o, float* part_ml,
                         int* counters, int B, int H, int KVH, int S, int D,
                         int T, int nsplit, long long q_sb, long long q_sh,
                         long long q_st, long long o_sb, long long o_sh,
                         long long o_st, int window, float scale_log2,
                         void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const unsigned char*>(k),
               static_cast<const unsigned char*>(v),
               static_cast<const float*>(ks),
               static_cast<const float*>(vs),
               pos,
               static_cast<__nv_bfloat16*>(o),
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
               o_sb,
               o_sh,
               o_st,
               window,
               scale_log2};
  return run<Int8KV>(a, B, H, D, static_cast<cudaStream_t>(stream));
}

const char* flash_decode_q8_error_string(int err) {
  return error_string(err);
}

}  // extern "C"
