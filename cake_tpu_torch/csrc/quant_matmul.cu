// Int8-weight matmul y = (x @ q) * scale, bf16 activations, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of cake_tpu/ops/pallas/quant.py
// (called through `quant_matmul_pallas`, :51). Same function: x [M, K] bf16
// times q [K, N] int8 (the [in, out] layout, a K row contiguous along N),
// int8 converted to bf16 on chip (exact: |q| <= 127), f32 accumulation, the
// per-output-channel f32 scale[N] applied in the epilogue, output bf16.
//
// What bounds it on this card: at decode (M = 1) it does 2 operations per
// weight byte, far below the H100's ~295 per byte, so it is bound by the
// bytes of q it streams. At prefill (M = 2048) it does 2M = 4096
// operations per weight byte: bound by tensor-core operations.
//
// What the design does about that (csrc/qmatmul_sm90.cuh): prefill is a
// warp-specialised wgmma kernel (a TMA ring of x tiles and raw int8
// tiles; two consumer warpgroups convert the codes into wgmma's register
// A operand while the previous k step's products run); decode streams q
// through a deep TMA ring into mma.sync fragments converted in registers,
// and folds a split K's partials in the last CTA of each strip, in one
// launch.

#include "qmatmul_sm90.cuh"

extern "C" {

// Tile sizes the host side computes with.
int quant_matmul_block_k() { return qmm::BK; }
int quant_matmul_block_n() { return qmm::BN; }
int quant_matmul_decode_block_k() { return qmm::DecodePlan<qmm::Int8W>::SK; }

// Dynamic shared memory of a CTA of the plan's block_m (0 if not built);
// `grouped` is ignored (int8 has no groups).
int quant_matmul_smem_bytes(int block_m, int grouped) {
  (void)grouped;
  return qmm::smem_bytes<qmm::Int8W>(block_m);
}

// Returns 0, a cudaError_t or ERR_TENSOR_MAP. K % 64 == 0, N % 16 == 0;
// the plan's block_m (16: decode; 128, 256: prefill), splits and K slots
// a split (see qmm::run).
int quant_matmul_bf16(const void* x, const void* q, const void* scale,
                      void* y, void* part, void* counters, int M, int N,
                      int K, int block_m, int splits, int per_split,
                      void* stream) {
  return qmm::run<qmm::Int8W>(x, q, scale, y, part,
                              static_cast<int*>(counters), M, N, K, 0,
                              block_m, splits, per_split,
                              static_cast<cudaStream_t>(stream));
}

const char* quant_matmul_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
