// Packed-int4-weight matmul, bf16 activations, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel4` of cake_tpu/ops/pallas/quant.py
// (called through `quant4_matmul_pallas`, :158). Same function: x [M, K]
// bf16 times the packed weight qp [K/2, N] int8, where byte i holds K row
// 2i in its low nibble and K row 2i+1 in its high nibble, each a signed
// value in [-7, 7]; f32 accumulation; output bf16. Scales are f32, either
// per output channel (scale [N], applied in the epilogue) or grouped along
// K (scale [K/g, N]: each K tile lies inside one group, and its f32
// partial is multiplied by its group's scale before it is added).
//
// What bounds it on this card: at decode (M = 1) it does 4 operations per
// weight byte, far below the H100's ~295 per byte, so it is bound by the
// bytes of qp (half the int8 bytes). At prefill (M = 2048) it is bound by
// tensor-core operations.
//
// What the design does about that:
// - The loop of csrc/quant_matmul.cu: one CTA of 4 warps computes a
//   BM x 128 output tile (BM = 16 for M <= 16, 64 above) over a range of
//   64-row K tiles, with mma.sync m16n8k16 into f32 accumulators.
// - A 64-row K tile is 32 packed rows. Each 16-byte load of packed bytes is
//   unpacked with shifts straight into two rows of the bf16 shared tile, in
//   natural K order, so x is read as it is (the TPU kernel's even/odd split
//   of x only kept Mosaic's weight side unstrided).
// - Grouped scales keep a second accumulator for the current K tile and
//   fold it into the running one with the tile's group scale; group sizes
//   must be a multiple of the 64-row K tile (64 and 128 run).
// - At small M the host splits K over CTAs (grid.z); the splits' f32
//   partials are summed in a fixed order by a second kernel. No atomics.
// - As in quant_matmul.cu, the next K tile's global loads are issued into
//   registers before the current tile is multiplied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 64;        // K rows per tile (32 packed rows)
constexpr int THREADS = 128;  // 4 warps x 32 columns
constexpr int STRA = BK + 8;  // padded smem rows (bf16 elements)
constexpr int STRB = BN + 8;
constexpr int COMBINE_THREADS = 256;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two n8 tiles from the [k][n] tile (see quant_matmul.cu).
__device__ __forceinline__ void load_b_x4(uint32_t (&b)[4],
                                          const __nv_bfloat16* sB, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p =
      sB + (k0 + (mat & 1) * 8 + r) * STRB + n0 + (mat >> 1) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Sign-extended low and high nibble of byte i of w.
__device__ __forceinline__ float nibble_lo(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (28 - 8 * i)) >> 28);
}
__device__ __forceinline__ float nibble_hi(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 28);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 packed bytes (one 16-byte load along N) as two rows of 16 bf16:
// the low nibbles to row_lo, the high nibbles to row_hi.
__device__ __forceinline__ void store_i4x16(__nv_bfloat16* row_lo,
                                            __nv_bfloat16* row_hi,
                                            uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t word = w[j / 2];
    const int b = (j % 2) * 2;
    lo[j] = pack_bf16(nibble_lo(word, b), nibble_lo(word, b + 1));
    hi[j] = pack_bf16(nibble_hi(word, b), nibble_hi(word, b + 1));
  }
  reinterpret_cast<uint4*>(row_lo)[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  reinterpret_cast<uint4*>(row_lo)[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  reinterpret_cast<uint4*>(row_hi)[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  reinterpret_cast<uint4*>(row_hi)[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
}

// 16-byte loads a thread makes per K tile: of x, and of packed qp rows
template <int BM>
struct Loads {
  static constexpr int A = BM * (BK / 8) / THREADS;
  static constexpr int B = (BK / 2) * (BN / 16) / THREADS;
  static_assert(A * THREADS == BM * (BK / 8), "x tile split");
  static_assert(B * THREADS == (BK / 2) * (BN / 16), "qp tile split");
};

// Issues this thread's global loads of K tile k0 into registers (rows of x
// past M and columns of qp past N read as zero).
template <int BM>
__device__ __forceinline__ void fetch(uint4 (&ra)[Loads<BM>::A],
                                      uint4 (&rb)[Loads<BM>::B],
                                      const __nv_bfloat16* x,
                                      const int8_t* qp, int m0, int n0,
                                      int k0, int M, int N, int K) {
#pragma unroll
  for (int j = 0; j < Loads<BM>::A; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    ra[j] = m0 + r < M ? *reinterpret_cast<const uint4*>(
                             x + (long long)(m0 + r) * K + k0 + c)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < Loads<BM>::B; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
    rb[j] = n0 + c < N ? *reinterpret_cast<const uint4*>(
                             qp + (long long)(k0 / 2 + r) * N + n0 + c)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Writes the fetched registers into the shared tiles, each packed row
// unpacked into two bf16 K rows.
template <int BM>
__device__ __forceinline__ void stage(const uint4 (&ra)[Loads<BM>::A],
                                      const uint4 (&rb)[Loads<BM>::B],
                                      __nv_bfloat16* sA, __nv_bfloat16* sB) {
#pragma unroll
  for (int j = 0; j < Loads<BM>::A; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(sA + r * STRA + c) = ra[j];
  }
#pragma unroll
  for (int j = 0; j < Loads<BM>::B; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
    store_i4x16(sB + (2 * r) * STRB + c, sB + (2 * r + 1) * STRB + c, rb[j]);
  }
}

template <int BM, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
quant4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ qp,
                     const float* __restrict__ scale,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                     int M, int N, int K, int group, int k_per_split) {
  constexpr int MT = BM / 16;  // m16 tiles a warp holds
  __shared__ __align__(16) __nv_bfloat16 sA[BM * STRA];
  __shared__ __align__(16) __nv_bfloat16 sB[BK * STRB];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int kt0 = blockIdx.z * k_per_split;
  const int kt1 = min(kt0 + k_per_split, K / BK);

  // acc: the running sum; tacc: this K tile's partial (grouped only)
  float acc[MT][4][4], tacc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = tacc[mt][nt][i] = 0.f;

  // the next tile's loads are in flight while this one is multiplied
  uint4 ra[Loads<BM>::A], rb[Loads<BM>::B];
  if (kt0 < kt1) fetch<BM>(ra, rb, x, qp, m0, n0, kt0 * BK, M, N, K);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tiles
    stage<BM>(ra, rb, sA, sB);
    __syncthreads();
    if (kt + 1 < kt1)
      fetch<BM>(ra, rb, x, qp, m0, n0, k0 + BK, M, N, K);

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* r0 = sA + (mt * 16 + g) * STRA + kk * 16 + tq * 2;
        const __nv_bfloat16* r1 = r0 + 8 * STRA;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(r1);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        load_b_x4(b, sB, kk * 16, warp * 32 + np * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (GROUPED) {
            mma_bf16_16816(tacc[mt][2 * np], af[mt], b[0], b[1]);
            mma_bf16_16816(tacc[mt][2 * np + 1], af[mt], b[2], b[3]);
          } else {
            mma_bf16_16816(acc[mt][2 * np], af[mt], b[0], b[1]);
            mma_bf16_16816(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }

    if (GROUPED) {  // fold this tile's partial in with its group's scale
      const float* srow = scale + (long long)(k0 / group) * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + warp * 32 + nt * 8 + tq * 2;
        const float s0 = n < N ? srow[n] : 0.f;
        const float s1 = n < N ? srow[n + 1] : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] += tacc[mt][nt][0] * s0;
          acc[mt][nt][1] += tacc[mt][nt][1] * s1;
          acc[mt][nt][2] += tacc[mt][nt][2] * s0;
          acc[mt][nt][3] += tacc[mt][nt][3] * s1;
          tacc[mt][nt][0] = tacc[mt][nt][1] = tacc[mt][nt][2] =
              tacc[mt][nt][3] = 0.f;
        }
      }
    }
  }

  // epilogue: bf16 output (per-channel scale, or none when grouped), or
  // this split's f32 partial
  float* p = part ? part + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + warp * 32 + nt * 8 + tq * 2;
    if (n >= N) continue;
    const bool scaled = !p && !GROUPED;
    const float s0 = scaled ? scale[n] : 1.f;
    const float s1 = scaled ? scale[n + 1] : 1.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mt * 16 + g + h * 8;
        if (r >= M) continue;
        const float c0 = acc[mt][nt][2 * h], c1 = acc[mt][nt][2 * h + 1];
        if (p)
          *reinterpret_cast<float2*>(p + (long long)r * N + n) =
              make_float2(c0, c1);
        else
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)r * N + n) =
              __floats2bfloat162_rn(c0 * s0, c1 * s1);
      }
    }
  }
}

// Sums the K splits' partials in split order, applies the per-channel
// scale (null when grouped: the groups' scales are already in), rounds.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ y, int splits, long long MN,
               int N) {
  const long long i = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += part[j * MN + i];
  y[i] = __float2bfloat16_rn(scale ? s * scale[i % N] : s);
}

template <int BM, bool GROUPED>
int launch(const void* x, const void* qp, const void* scale, void* y,
           void* part, int M, int N, int K, int group, int splits,
           int k_per_split, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  quant4_matmul_kernel<BM, GROUPED><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(qp),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(part) : nullptr, M, N, K, group,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long MN = (long long)M * N;
  combine_kernel<<<(unsigned)((MN + COMBINE_THREADS - 1) / COMBINE_THREADS),
                   COMBINE_THREADS, 0, stream>>>(
      static_cast<const float*>(part),
      GROUPED ? nullptr : static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), splits, MN, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes the host side computes with.
int quant4_matmul_block_k() { return BK; }
int quant4_matmul_block_n() { return BN; }

// Returns 0 or a cudaError_t. `group` is the group size along K (0: per
// channel scales). `part` holds splits x M x N floats when splits > 1.
int quant4_matmul_bf16(const void* x, const void* qp, const void* scale,
                       void* y, void* part, int M, int N, int K, int group,
                       int block_m, int splits, int k_per_split,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % BK || N % 16 || group < 0 || (group && group % BK) ||
      splits < 1 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const bool grouped = group > 0;
  if (block_m == 16 && !grouped)
    return launch<16, false>(x, qp, scale, y, part, M, N, K, group, splits,
                             k_per_split, st);
  if (block_m == 16 && grouped)
    return launch<16, true>(x, qp, scale, y, part, M, N, K, group, splits,
                            k_per_split, st);
  if (block_m == 64 && !grouped)
    return launch<64, false>(x, qp, scale, y, part, M, N, K, group, splits,
                             k_per_split, st);
  if (block_m == 64 && grouped)
    return launch<64, true>(x, qp, scale, y, part, M, N, K, group, splits,
                            k_per_split, st);
  return (int)cudaErrorInvalidValue;
}

const char* quant4_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
