// Packed-int4-weight matmul, bf16 activations, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel4` of cake_tpu/ops/pallas/quant.py
// (called through `quant4_matmul_pallas`, :158). Same function: x [M, K]
// bf16 times the packed weight qp [K/2, N] int8, where byte i holds K row
// 2i in its low nibble and K row 2i+1 in its high nibble, each a signed
// value in [-7, 7]; f32 accumulation; output bf16. Scales are f32, either
// per output channel (scale [N], applied in the epilogue) or grouped along
// K (scale [K/g, N], g a multiple of 16: each group's f32 partial is
// multiplied by its group's scale before it is added, never the bf16
// weight).
//
// What bounds it on this card: at decode (M = 1) it does 4 operations per
// weight byte, far below the H100's ~295 per byte, so it is bound by the
// bytes of qp (half the int8 bytes). At prefill (M = 2048) it is bound by
// tensor-core operations.
//
// What the design does about that: the body of csrc/quant_matmul.cu
// (csrc/qmatmul_sm90.cuh), with the nibbles unpacked into two K rows:
// a fragment's two K rows are one byte's two nibbles, in both regimes.
// Grouped prefill folds each group's wgmma partial into the sum (BM = 192:
// both 96-float accumulators fit a consumer thread's registers); grouped
// decode folds each warp's 32-row partial of a slot. Groups that are a
// multiple of 16 rows but not of 64 (g16, g32, g96) are their own instance
// (`qmm::FINE`): the fold comes at the k16 step that starts a group, inside
// a k step (prefill) or a warp's rows (decode); multiples of 64 keep theirs.

#include "qmatmul_sm90.cuh"

extern "C" {

// Tile sizes the host side computes with.
int quant4_matmul_block_k() { return qmm::BK; }
int quant4_matmul_block_n() { return qmm::BN; }
int quant4_matmul_decode_block_k() {
  return qmm::DecodePlan<qmm::Int4W<qmm::PER_CHANNEL>>::SK;
}

// The instance a group size runs: PER_CHANNEL (0), GROUPS (a multiple of
// 64), FINE (another multiple of 16); -1 for any other.
int quant4_matmul_scales(int group) {
  if (group == 0) return qmm::PER_CHANNEL;
  if (group < 0 || group % 16) return -1;
  return group % qmm::BK ? qmm::FINE : qmm::GROUPS;
}

// Dynamic shared memory of a CTA of the plan's block_m for the instance
// `scales` (quant4_matmul_scales; 0 if not built).
int quant4_matmul_smem_bytes(int block_m, int scales) {
  switch (scales) {
    case qmm::PER_CHANNEL:
      return qmm::smem_bytes<qmm::Int4W<qmm::PER_CHANNEL>>(block_m);
    case qmm::GROUPS:
      return qmm::smem_bytes<qmm::Int4W<qmm::GROUPS>>(block_m);
    case qmm::FINE:
      return qmm::smem_bytes<qmm::Int4W<qmm::FINE>>(block_m);
  }
  return 0;
}

// Returns 0, a cudaError_t or ERR_TENSOR_MAP. `group` is the group size
// along K (0: per-channel scales); the rest as quant_matmul_bf16.
int quant4_matmul_bf16(const void* x, const void* qp, const void* scale,
                       void* y, void* part, void* counters, int M, int N,
                       int K, int group, int block_m, int splits,
                       int per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counters);
  switch (quant4_matmul_scales(group)) {
    case qmm::PER_CHANNEL:
      return qmm::run<qmm::Int4W<qmm::PER_CHANNEL>>(
          x, qp, scale, y, part, cnt, M, N, K, 0, block_m, splits, per_split,
          st);
    case qmm::GROUPS:
      return qmm::run<qmm::Int4W<qmm::GROUPS>>(x, qp, scale, y, part, cnt, M,
                                               N, K, group, block_m, splits,
                                               per_split, st);
    case qmm::FINE:
      return qmm::run<qmm::Int4W<qmm::FINE>>(x, qp, scale, y, part, cnt, M,
                                             N, K, group, block_m, splits,
                                             per_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* quant4_matmul_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
