// Decode GQA flash attention over the bf16 KV cache, on Hopper (sm_90a),
// in one launch: one query position a stream (a decode step) or T of them
// (a speculative verify).
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// cake_tpu/ops/pallas/flash.py (called through `flash_decode`, :483), and
// at T > 1 with per-row positions the XLA attention the JAX package sends
// that shape to (cake_tpu/ops/attention.py:142-143, 156-157). Same
// function: q [B, H, T, D] bf16 against the cache buffers k/v
// [B, KVH, S, D] bf16, the GQA group of G = H / KVH query heads and the T
// positions folded into the rows of one kv head, a causal frontier per row
// read from `pos [B]` on the device (query t of row b sits at pos[b] + t;
// no host sync per step), an optional sliding window, f32 scores times
// 1/sqrt(D), online softmax in f32, P rounded to bf16 before the PV
// product, output in bf16.
//
// What bounds it, and the design (bounds computed in the kernel, split K
// folded by the last CTA, bulk-copy ring, mma.sync for both products): see
// csrc/flash_decode_sm90.cuh, whose body csrc/flash_decode_q8.cu shares.

#include "flash_decode_sm90.cuh"

using namespace fd90;

extern "C" {

int flash_decode_block_k() { return BK; }

// Query rows of a CTA: the G * T rows of a kv head go 16 to a CTA.
int flash_decode_tile_rows() { return MAX_G; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_decode_smem_bytes(int D) { return smem_bytes<Bf16KV>(D); }

// Returns 0 or a cudaError_t. nsplit CTAs share a row's live tiles; with
// nsplit > 1, part_o holds B*KVH*nsplit*G*T*D floats, part_ml
// B*KVH*nsplit*G*T*2 and counters B*KVH*ceil(G*T/16) ints, all 0 (the
// kernel leaves them 0).
int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const int* pos, void* o, float* part_o, float* part_ml,
                      int* counters, int B, int H, int KVH, int S, int D,
                      int T, int nsplit, long long q_sb, long long q_sh,
                      long long q_st, long long o_sb, long long o_sh,
                      long long o_st, int window, float scale_log2,
                      void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const unsigned char*>(k),
               static_cast<const unsigned char*>(v),
               nullptr,
               nullptr,
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
  return run<Bf16KV>(a, B, H, D, static_cast<cudaStream_t>(stream));
}

const char* flash_decode_error_string(int err) { return error_string(err); }

}  // extern "C"
