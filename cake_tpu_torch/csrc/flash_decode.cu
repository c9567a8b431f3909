// Single-query (decode) GQA flash attention, bf16, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// cake_tpu/ops/pallas/flash.py (called through `flash_decode`, :483).
// Same function: q [B, H, 1, D] against the cache buffers k/v
// [B, KVH, S, D], the GQA group of G = H / KVH query heads folded into the
// rows of one kv head, a causal frontier per row read from `pos [B]` on the
// device (no host sync per step), an optional sliding window, f32 scores
// times 1/sqrt(D), online softmax in f32, P rounded to bf16 before the PV
// product, output in bf16.
//
// What bounds it on this card: it does 2 multiply-adds per K/V element
// per query row, ~2G operations per byte, far below the H100's ~295
// operations per byte, so it is bound by the bytes of K and V it reads.
//
// What the design does about that:
// - K and V are read once per kv-head group, not once per query head: a
//   CTA handles all G rows of one (b, kv head).
// - Only the live KV tiles [kb_lo, kb_hi] (from `kv_block_bounds` on the
//   host side, cake_tpu_torch/ops/flash.py) are read.
// - At small batch there are too few (b, kv head) pairs to fill 132 SMs,
//   so the live range is split over `nsplit` CTAs (flash-decoding): each
//   writes a partial (max, sum, unnormalized output) in f32, and a second
//   small kernel combines the partials. The host picks nsplit from the SM
//   count.
// - Inside a CTA each warp streams 8 keys at a time straight from global
//   memory, a lane holding D/32 consecutive elements of each row, so every
//   row load is one coalesced 256-byte transaction for D = 128; the eight
//   K and eight V rows of a step are issued before they are used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // keys per KV tile (unit of kv_block_bounds)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KPW = 8;        // keys a warp takes per step
constexpr int COMBINE_THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int VEC>
__device__ __forceinline__ void load_row(float (&dst)[VEC],
                                         const __nv_bfloat16* src) {
  static_assert(VEC % 2 == 0, "row slices are bf16 pairs");
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f =
        __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(src)[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ pos,
                          const int* __restrict__ kb_lo,
                          const int* __restrict__ kb_hi,
                          float* __restrict__ part_o,
                          float* __restrict__ part_ml, int KVH, int S,
                          int nsplit, long long q_sb, long long q_sh,
                          int window, float scale_log2) {
  constexpr int VEC = D / 32;  // elements of a row each lane holds
  __shared__ float s_m[WARPS][G], s_l[WARPS][G];
  __shared__ float s_o[WARPS][G][D];

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / KVH, hk = bh % KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int p = pos[b];
  const int lo = kb_lo ? kb_lo[b] : 0;
  const int hi = min(kb_hi[b], (S - 1) / BK);
  const int per = (hi - lo + nsplit) / nsplit;  // ceil((hi-lo+1)/nsplit)
  const int kb0 = lo + split * per;
  const int key0 = kb0 * BK;
  const int key1 = min(min(kb0 + per, hi + 1) * BK, S);  // exclusive

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_row<VEC>(qr[g], q + b * q_sb + (hk * G + g) * q_sh + lane * VEC);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const __nv_bfloat16* kbase = k + (long long)bh * S * D + lane * VEC;
  const __nv_bfloat16* vbase = v + (long long)bh * S * D + lane * VEC;

  for (int base = key0 + warp * KPW; base < key1; base += WARPS * KPW) {
    float kf[KPW][VEC], vf[KPW][VEC];
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      if (base + j < key1) {
        load_row<VEC>(kf[j], kbase + (long long)(base + j) * D);
        load_row<VEC>(vf[j], vbase + (long long)(base + j) * D);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[j][i] = vf[j][i] = 0.f;
      }
    }
    float s[G][KPW];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot += qr[g][i] * kf[j][i];
        s[g][j] = dot;
      }
    // every lane ends with the full dot products
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < KPW; ++j)
          s[g][j] += __shfl_xor_sync(0xffffffffu, s[g][j], off);

#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const int key = base + j;
        const bool ok = key <= p && (window < 0 || key > p - window);
        // keys past this split's range are absent, masked keys are -1e30
        s[g][j] = key >= key1 ? -INFINITY
                              : (ok ? s[g][j] * scale_log2 : NEG_INF);
        mx = fmaxf(mx, s[g][j]);
      }
      const float alpha = exp2f(m[g] - mx);
      float psum = 0.f, pv[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) pv[i] = 0.f;
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const float pj = exp2f(s[g][j] - mx);
        psum += pj;
        const float pb = __bfloat162float(__float2bfloat16(pj));
#pragma unroll
        for (int i = 0; i < VEC; ++i) pv[i] += pb * vf[j][i];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * alpha + pv[i];
    }
  }

  // merge the four warps' partial softmax states
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_o[warp][g][lane * VEC + i] = acc[g][i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wgt = exp2f(s_m[w][g] - M);
        L += s_l[w][g] * wgt;
        O += s_o[w][g][d] * wgt;
      }
    }
    const long long slot = ((long long)bh * nsplit + split) * G + g;
    part_o[slot * D + d] = O;
    if (d == 0) {
      part_ml[slot * 2] = M;
      part_ml[slot * 2 + 1] = L;
    }
  }
}

template <int D, int G>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine_kernel(const float* __restrict__ part_o,
                            const float* __restrict__ part_ml,
                            __nv_bfloat16* __restrict__ o, int KVH,
                            int nsplit, long long o_sb, long long o_sh) {
  const int bh = blockIdx.x;
  const int b = bh / KVH, hk = bh % KVH;
  for (int idx = threadIdx.x; idx < G * D; idx += COMBINE_THREADS) {
    const int g = idx / D, d = idx % D;
    const long long slot0 = (long long)bh * nsplit * G + g;
    float M = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp)
      M = fmaxf(M, part_ml[(slot0 + (long long)sp * G) * 2]);
    float L = 0.f, O = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const long long slot = slot0 + (long long)sp * G;
      const float ms = part_ml[slot * 2];
      if (ms == -INFINITY) continue;  // a split with no live keys
      const float wgt = exp2f(ms - M);
      L += part_ml[slot * 2 + 1] * wgt;
      O += part_o[slot * D + d] * wgt;
    }
    o[b * o_sb + (hk * G + g) * o_sh + d] = __float2bfloat16(O / L);
  }
}

template <int D, int G>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const int* kb_lo, const int* kb_hi, void* o, float* part_o,
           float* part_ml, int B, int KVH, int S, int nsplit, long long q_sb,
           long long q_sh, long long o_sb, long long o_sh, int window,
           float scale_log2, cudaStream_t stream) {
  flash_decode_split_kernel<D, G><<<dim3(nsplit, B * KVH), THREADS, 0,
                                    stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, kb_lo, kb_hi, part_o,
      part_ml, KVH, S, nsplit, q_sb, q_sh, window, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<D, G><<<B * KVH, COMBINE_THREADS, 0, stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(o), KVH, nsplit, o_sb,
      o_sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_g(int G, const void* q, const void* k, const void* v,
             const int* pos, const int* kb_lo, const int* kb_hi, void* o,
             float* part_o, float* part_ml, int B, int KVH, int S,
             int nsplit, long long q_sb, long long q_sh, long long o_sb,
             long long o_sh, int window, float scale_log2,
             cudaStream_t stream) {
  switch (G) {
#define CAKE_DECODE_CASE(NG)                                                \
  case NG:                                                                  \
    return launch<D, NG>(q, k, v, pos, kb_lo, kb_hi, o, part_o, part_ml, B, \
                         KVH, S, nsplit, q_sb, q_sh, o_sb, o_sh, window,    \
                         scale_log2, stream);
    CAKE_DECODE_CASE(1)
    CAKE_DECODE_CASE(2)
    CAKE_DECODE_CASE(4)
    CAKE_DECODE_CASE(8)
#undef CAKE_DECODE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_decode_block_k() { return BK; }

// Returns 0 or a cudaError_t. `kb_lo` may be null (no window: 0).
// part_o holds B*KVH*nsplit*G*D floats, part_ml B*KVH*nsplit*G*2.
int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const int* pos, const int* kb_lo, const int* kb_hi,
                      void* o, float* part_o, float* part_ml, int B, int H,
                      int KVH, int S, int D, int nsplit, long long q_sb,
                      long long q_sh, long long o_sb, long long o_sh,
                      int window, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  switch (D) {
    case 64:
      return launch_g<64>(G, q, k, v, pos, kb_lo, kb_hi, o, part_o, part_ml,
                          B, KVH, S, nsplit, q_sb, q_sh, o_sb, o_sh, window,
                          scale_log2, st);
    case 128:
      return launch_g<128>(G, q, k, v, pos, kb_lo, kb_hi, o, part_o,
                           part_ml, B, KVH, S, nsplit, q_sb, q_sh, o_sb,
                           o_sh, window, scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
