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
// What the design does about that:
// - One CTA of 4 warps computes a BM x 128 output tile (BM = 16 for M <= 16,
//   64 above) over a range of 64-row K tiles. The bf16 x tile and the int8
//   q tile are read with 16-byte loads (q along N, coalesced); q is
//   converted to bf16 on its way into shared memory, so device memory only
//   ever carries the int8 bytes.
// - The products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate). Each warp owns 32 output columns: A fragments come from
//   padded shared rows, B fragments from ldmatrix.trans on the [k][n] tile.
// - M = 1 pads the A tile to 16 rows: wasted tensor-core work, harmless
//   where the bytes bound. The output tiles alone would leave SMs idle at
//   decode (wk/wv: 8 CTAs of 128 columns for 132 SMs), so the host splits
//   K over CTAs (grid.z); each split writes an f32 partial and a second
//   kernel sums them in a fixed order and applies the scale. No atomics:
//   the result does not change from run to run.
// - The next K tile's global loads are issued into registers before the
//   current tile is multiplied, so their latency hides behind the mma work;
//   the shared tiles are single-buffered. cp.async/TMA pipelining and wgmma
//   are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 64;        // K rows per tile
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

// B fragments of two n8 tiles: the k16 x n16 block of the [k][n] tile at
// (k0, n0). Matrices 0/1 are k rows 0-7/8-15 of columns n0..n0+7, 2/3 the
// same of n0+8..n0+15; .trans hands each thread the (k, k+1) pairs of one
// column, which is the col-major B operand of m16n8k16.
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

__device__ __forceinline__ float byte_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<signed char>(w >> (8 * i)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 int8 values (one 16-byte load) as 16 bf16 at dst (32 bytes).
__device__ __forceinline__ void store_i8x16(__nv_bfloat16* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    o[j] = pack_bf16(byte_at(w[j / 2], (j % 2) * 2),
                     byte_at(w[j / 2], (j % 2) * 2 + 1));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// 16-byte loads a thread makes per K tile: of x, and of q
template <int BM>
struct Loads {
  static constexpr int A = BM * (BK / 8) / THREADS;
  static constexpr int B = BK * (BN / 16) / THREADS;
  static_assert(A * THREADS == BM * (BK / 8), "x tile split");
  static_assert(B * THREADS == BK * (BN / 16), "q tile split");
};

// Issues this thread's global loads of K tile k0 into registers (rows of x
// past M and columns of q past N read as zero).
template <int BM>
__device__ __forceinline__ void fetch(uint4 (&ra)[Loads<BM>::A],
                                      uint4 (&rb)[Loads<BM>::B],
                                      const __nv_bfloat16* x,
                                      const int8_t* q, int m0, int n0,
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
                             q + (long long)(k0 + r) * N + n0 + c)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Writes the fetched registers into the shared tiles, q converted to bf16.
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
    store_i8x16(sB + r * STRB + c, rb[j]);
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                    int M, int N, int K, int k_per_split) {
  constexpr int MT = BM / 16;  // m16 tiles a warp holds
  __shared__ __align__(16) __nv_bfloat16 sA[BM * STRA];
  __shared__ __align__(16) __nv_bfloat16 sB[BK * STRB];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int kt0 = blockIdx.z * k_per_split;
  const int kt1 = min(kt0 + k_per_split, K / BK);

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // the next tile's loads are in flight while this one is multiplied
  uint4 ra[Loads<BM>::A], rb[Loads<BM>::B];
  if (kt0 < kt1) fetch<BM>(ra, rb, x, q, m0, n0, kt0 * BK, M, N, K);
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // every warp is done with the previous tiles
    stage<BM>(ra, rb, sA, sB);
    __syncthreads();
    if (kt + 1 < kt1)
      fetch<BM>(ra, rb, x, q, m0, n0, (kt + 1) * BK, M, N, K);

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
          mma_bf16_16816(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }

  // epilogue: scaled bf16 output, or this split's f32 partial
  float* p = part ? part + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + warp * 32 + nt * 8 + tq * 2;
    if (n >= N) continue;
    const float s0 = p ? 1.f : scale[n], s1 = p ? 1.f : scale[n + 1];
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

// Sums the K splits' partials in split order, scales, rounds to bf16.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ y, int splits, long long MN,
               int N) {
  const long long i = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += part[j * MN + i];
  y[i] = __float2bfloat16_rn(s * scale[i % N]);
}

template <int BM>
int launch(const void* x, const void* q, const void* scale, void* y,
           void* part, int M, int N, int K, int splits, int k_per_split,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  quant_matmul_kernel<BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(part) : nullptr, M, N, K,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long MN = (long long)M * N;
  combine_kernel<<<(unsigned)((MN + COMBINE_THREADS - 1) / COMBINE_THREADS),
                   COMBINE_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), splits, MN, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes the host side computes with.
int quant_matmul_block_k() { return BK; }
int quant_matmul_block_n() { return BN; }

// Returns 0 or a cudaError_t. `part` holds splits x M x N floats when
// splits > 1 (else it may be null). K % 64 == 0 and N % 16 == 0.
int quant_matmul_bf16(const void* x, const void* q, const void* scale,
                      void* y, void* part, int M, int N, int K, int block_m,
                      int splits, int k_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % BK || N % 16 || splits < 1 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  switch (block_m) {
    case 16:
      return launch<16>(x, q, scale, y, part, M, N, K, splits, k_per_split,
                        st);
    case 64:
      return launch<64>(x, q, scale, y, part, M, N, K, splits, k_per_split,
                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
