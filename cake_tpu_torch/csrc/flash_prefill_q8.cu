// Causal GQA flash attention for prefill over the int8 KV cache, bf16
// queries, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_prefill_q8_kernel` of
// cake_tpu/ops/pallas/flash.py (called through `flash_attention_q8`, :323).
// Same function: q [B, H, T, D] bf16 at absolute offset `pos` against the
// int8 cache k_q/v_q [B, KVH, S, D] with one f32 scale per token and head,
// k_scale/v_scale [B, KVH, S] (the layout of cake_tpu_torch.ops.kvcache
// QuantizedKV). The per-token scales are constant along D, so they factor
// out of both products and the dequantized cache never exists:
// - scores are (q . k_q) times the key's scale, times 1/sqrt(D);
// - the running max and sum are those of csrc/flash_prefill.cu: online
//   softmax in f32, the sum `l` taking P WITHOUT the value scale;
// - the value scale multiplies P before P is rounded to bf16 for the PV
//   product (P * v_scale) @ v_q.
// Mask kpos <= pos + qpos (and kpos > pos + qpos - window when windowed);
// output bf16. Query head h reads kv head h / (H / KVH).
//
// What bounds it on this card: at the main path's shapes (T = 2048,
// D = 128) the two products do ~T/2 multiply-adds per KV byte, far above
// the H100's ~295 operations per byte: bound by tensor-core operations, as
// the bf16 kernel is. The int8 cache halves the KV bytes it reads.
//
// What the design does about that: the tiles, warps and mma.sync fragments
// of csrc/flash_prefill.cu (one CTA of 4 warps per 64-row q tile of one
// (b, h), 64-key tiles, Q fragments, scores and output accumulator in
// registers). K and V tiles are read as int8 with 16-byte loads and
// converted to bf16 on their way into shared memory (exact: |q| <= 127);
// the tile's 64 key and 64 value scales sit beside them in shared memory.
// The loop runs only over the live KV tiles [kb_lo, kb_hi] from
// `kv_block_bounds` (cake_tpu_torch/ops/flash.py). Loads are synchronous and
// single-buffered; pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;      // q rows per CTA
constexpr int BK = 64;       // keys per KV tile
constexpr int THREADS = 128; // 4 warps x 16 q rows
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies `rows` rows of D bf16 (row stride `stride` elements in global
// memory) into a padded shared tile; rows at or past `limit` are zeroed.
template <int D, int STR>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int limit, int rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * STR + c) = val;
  }
}

__device__ __forceinline__ float byte_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<signed char>(w >> (8 * i)));
}

// Copies `rows` rows of D int8 (contiguous rows) into a padded bf16 shared
// tile; rows at or past `limit` are zeroed.
template <int D, int STR>
__device__ __forceinline__ void load_tile_i8(__nv_bfloat16* dst,
                                             const int8_t* src, int row0,
                                             int limit, int rows) {
  constexpr int CH = D / 16;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 16;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * D +
                                            c);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = pack_bf16(byte_at(w[j / 2], (j % 2) * 2),
                       byte_at(w[j / 2], (j % 2) * 2 + 1));
    uint4* out = reinterpret_cast<uint4*>(dst + r * STR + c);
    out[0] = make_uint4(o[0], o[1], o[2], o[3]);
    out[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_prefill_q8_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ k,
                        const float* __restrict__ k_scale,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ v_scale,
                        __nv_bfloat16* __restrict__ o,
                        const int* __restrict__ kb_lo,
                        const int* __restrict__ kb_hi, int H, int KVH, int T,
                        int S, long long q_sb, long long q_sh, long long q_st,
                        long long o_sb, long long o_sh, long long o_st,
                        int pos, int window, float scale_log2) {
  constexpr int STR = D + 8;  // padded smem row (halves): spreads banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * STR;
  __nv_bfloat16* sV = sK + BK * STR;
  __shared__ float sKs[BK], sVs[BK];  // the tile's key and value scales

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;

  const __nv_bfloat16* qbase = q + b * q_sb + h * q_sh;
  const long long head = (long long)b * KVH + hk;
  const int8_t* kbase = k + head * S * D;
  const int8_t* vbase = v + head * S * D;
  const float* ksbase = k_scale + head * S;
  const float* vsbase = v_scale + head * S;

  load_tile<D, STR>(sQ, qbase, q_st, qt * BQ, T, BQ);
  __syncthreads();

  // Q fragments (A operand) of this warp's 16 rows, all of D.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = sQ + (warp * 16 + g) * STR + kk * 16 + tq * 2;
    const __nv_bfloat16* r1 = r0 + 8 * STR;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (log2 domain) of rows g and g+8; per-thread partial sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int qpos0 = pos + qt * BQ + warp * 16 + g;  // row g; row g+8 is +8
  const int lo = kb_lo ? kb_lo[qt] : 0;
  const int hi = min(kb_hi[qt], (S - 1) / BK);

  for (int kb = lo; kb <= hi; ++kb) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_i8<D, STR>(sK, kbase, kb * BK, S, BK);
    load_tile_i8<D, STR>(sV, vbase, kb * BK, S, BK);
    if (threadIdx.x < BK) {
      const int key = kb * BK + threadIdx.x;
      sKs[threadIdx.x] = key < S ? ksbase[key] : 0.f;
      sVs[threadIdx.x] = key < S ? vsbase[key] : 0.f;
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // B = K^T: column n*8+g of B is key n*8+g, rows are d
        const __nv_bfloat16* kr = sK + (n * 8 + g) * STR + kk * 16 + tq * 2;
        mma_bf16_16816(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb * BK + n * 8 + tq * 2 + (i & 1);
        const int qp = qpos0 + ((i & 2) ? 8 : 0);
        const bool ok = key <= qp && (window < 0 || key > qp - window);
        // the key's scale folds into its score column
        s[n][i] = ok ? s[n][i] * sKs[key - kb * BK] * scale_log2 : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // full-row max over the 4 threads that share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P = exp(s - m): summed in f32 as it is; times the value's scale
    // before it is rounded to bf16 for the PV product
    uint32_t pf[BK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - mx0), p1 = exp2f(s[n][1] - mx0);
      const float p2 = exp2f(s[n][2] - mx1), p3 = exp2f(s[n][3] - mx1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      const float vs0 = sVs[n * 8 + tq * 2], vs1 = sVs[n * 8 + tq * 2 + 1];
      pf[n / 2][(n & 1) * 2 + 0] = pack_bf16(p0 * vs0, p1 * vs1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2 * vs0, p3 * vs1);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        // B = V: rows are keys j*16 + tq*2 (+1, +8, +9), column d = n*8+g
        const __nv_bfloat16* vr = sV + (j * 16 + tq * 2) * STR + n * 8 + g;
        mma_bf16_16816(acc[n], pf[j], pack_raw(vr[0], vr[STR]),
                       pack_raw(vr[8 * STR], vr[9 * STR]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = qt * BQ + warp * 16 + g;
  __nv_bfloat16* obase = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + tq * 2;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(obase + r0 * o_st + d) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r0 + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(obase + (r0 + 8) * o_st + d) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* o, const int* kb_lo, const int* kb_hi,
           int B, int H, int KVH, int T, int S, long long q_sb,
           long long q_sh, long long q_st, long long o_sb, long long o_sh,
           long long o_st, int pos, int window, float scale_log2,
           cudaStream_t stream) {
  constexpr int smem = (BQ + 2 * BK) * (D + 8) * 2;
  // above 48 KB a kernel must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_q8_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_prefill_q8_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(o),
      kb_lo, kb_hi, H, KVH, T, S, q_sb, q_sh, q_st, o_sb, o_sh, o_st, pos,
      window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Block sizes the host side needs for `kv_block_bounds`.
int flash_prefill_q8_block_q() { return BQ; }
int flash_prefill_q8_block_k() { return BK; }

// Returns 0 or a cudaError_t. `kb_lo` may be null (no window: 0).
int flash_prefill_q8_bf16(const void* q, const void* k, const void* ks,
                          const void* v, const void* vs, void* o,
                          const int* kb_lo, const int* kb_hi, int B, int H,
                          int KVH, int T, int S, int D, long long q_sb,
                          long long q_sh, long long q_st, long long o_sb,
                          long long o_sh, long long o_st, int pos,
                          int window, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, ks, v, vs, o, kb_lo, kb_hi, B, H, KVH, T, S,
                        q_sb, q_sh, q_st, o_sb, o_sh, o_st, pos, window,
                        scale_log2, st);
    case 128:
      return launch<128>(q, k, ks, v, vs, o, kb_lo, kb_hi, B, H, KVH, T, S,
                         q_sb, q_sh, q_st, o_sb, o_sh, o_st, pos, window,
                         scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_prefill_q8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
