// The statistics form of csrc/flash_decode.cu: decode GQA flash attention
// over one shard of a sequence-sharded bf16 KV cache, on Hopper (sm_90a),
// in one launch, returning the online-softmax state instead of the
// normalized output.
//
// Replaces, on the card, the per-shard attention of the JAX package's
// sequence-parallel decode (`sp_decode_attend`, cake_tpu/ops/ring.py:214,
// whose `attend_stats` is an XLA einsum over f32 scores; the JAX sp path
// reaches no Pallas kernel); its function is that of the Pallas kernel
// `_decode_kernel` of cake_tpu/ops/pallas/flash.py (`flash_decode`, :483)
// with the division by the row sum left out. q [B, H, T, D] bf16 against
// the shard's k/v [B, KVH, S, D] bf16 from a frontier per row relative to
// the shard's first key (`pos [B]`, any integer: query t of row b sees key
// j iff j <= pos[b] + t, and j > pos[b] + t - window when windowed).
// Outputs, contiguous: o [B, H, T, D] f32 unnormalized, relative to m;
// m [B, H, T] f32, the row max of the scaled scores in natural-log units;
// l [B, H, T] f32, the row sum of exp(score - m). A row with no live key
// gives m = -1e30, l = 0, o = 0 exactly.
//
// The kernel is csrc/flash_decode_sm90.cuh's (bounds in the kernel, split
// K folded by the last CTA, bulk-copy ring, mma.sync), with `Args::so` set.

#include "flash_decode_sm90.cuh"

using namespace fd90;

extern "C" {

int flash_decode_stats_block_k() { return BK; }

int flash_decode_stats_tile_rows() { return MAX_G; }

// Dynamic shared memory of one CTA at head width D (0 if D is not built).
int flash_decode_stats_smem_bytes(int D) { return smem_bytes<Bf16KV>(D); }

// Returns 0 or a cudaError_t. Partials and counters as for
// flash_decode_bf16.
int flash_decode_stats_bf16(const void* q, const void* k, const void* v,
                            const int* pos, void* o, void* m, void* l,
                            float* part_o, float* part_ml, int* counters,
                            int B, int H, int KVH, int S, int D, int T,
                            int nsplit, long long q_sb, long long q_sh,
                            long long q_st, int window, float scale_log2,
                            void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const unsigned char*>(k),
         static_cast<const unsigned char*>(v),
         nullptr,
         nullptr,
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
  return run<Bf16KV>(a, B, H, D, static_cast<cudaStream_t>(stream));
}

const char* flash_decode_stats_error_string(int err) {
  return error_string(err);
}

}  // extern "C"
