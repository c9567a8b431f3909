// Hopper (sm_90a) building blocks shared by the port's kernels: PTX
// wrappers for shared-memory addresses, mbarriers, TMA tile loads, wgmma
// and its fences, named barriers and setmaxnreg; and the host side's TMA
// descriptor encoder
// (cuTensorMapEncodeTiled, found through the runtime); 1-d bulk copies,
// mma.sync, ldmatrix and the exact int8-to-bf16 conversion. Included by
// csrc/flash_prefill_sm90.cuh, csrc/qmatmul_sm90.cuh and
// csrc/flash_decode_sm90.cuh.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: `encoder()`)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// a C entry's own error codes, above every cudaError_t
constexpr int ERR_TENSOR_MAP = 1000;

// --------------------------------------------------------------------------
// PTX wrappers
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma reads its shared operands through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(m))
               : "memory");
}

// One TMA tile load of a 4-d tensor map into shared memory, completing on
// `bar` (coordinates innermost first).
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA tile load of a 2-d tensor map into shared memory, completing on
// `bar` (coordinates innermost first).
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One 1-d bulk copy of `bytes` bytes from global to shared memory,
// completing on `bar`: no tensor map. `dst`, `src` and `bytes` must be
// multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d = a * b + c, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1,
                                          const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the 16-byte rows of matrix i, and lane t receives elements
// (2 (t % 4), t / 4) and (2 (t % 4) + 1, t / 4) of each, as mma.sync's B
// fragment of a [k][n] matrix stored n-contiguous.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two int8 codes (bytes `sel & 0xF` and `(sel >> 8) & 0xF` of `w`,
// selector 0x414n) as a packed bf16 pair, exactly, in four instructions:
// each code byte goes under the byte 0x43, which makes the bf16 128 + low7
// once bit 7 is cleared; bit 7 (the sign's weight, -128) picks the addend
// -128 (0xC300) or -256 (0xC380), and the bf16 sum is the code itself
// (every integer in [-128, 127] is a bf16).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0x43434343u, sel);
  const uint32_t a = t & 0xFF7FFF7Fu, c = (t & 0x00800080u) | 0xC300C300u;
  const __nv_bfloat162 sum =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&sum);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes across a wgmma
// fence or wait (the asm statements themselves keep their order).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands (Q
// and K, rows of 64 bf16 along the reduced dimension): the 16-element step
// along it is +32 bytes of start address inside the swizzle atom; `sbo` is
// the stride of 8-row groups (1024 bytes). The MN-major operand (V, rows of
// 64 d values per key): `lbo` is the stride between 64-column blocks of d,
// `sbo` that of 8-key groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define SM90_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define SM90_R32                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31"

#define SM90_R64                                                       \
  SM90_R32                                                             \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"

#define SM90_R96                                                       \
  SM90_R64                                                             \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "  \
  "%90, %91, %92, %93, %94, %95"

#define SM90_R128                                                      \
  SM90_R64                                                             \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "  \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, " \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "  \
  "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "  \
  "%125, %126, %127"

// S (64 x N, f32) = or += A (64 x 16, shared) * B (16 x N, shared,
// K-major), N = 128 or 64; `accumulate` 0 ignores S's old value.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" SM90_R64 "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" SM90_R32 "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x N, f32) += A (64 x 16, bf16 in registers) * B (16 x N, shared,
// MN-major: the transpose flag of B is set), N = 256, 128 or 64.
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" SM90_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56), SM90_D8(64), SM90_D8(72),
        SM90_D8(80), SM90_D8(88), SM90_D8(96), SM90_D8(104), SM90_D8(112),
        SM90_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" SM90_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" SM90_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N, f32) = or += A (64 x 16, bf16 in registers) * B (16 x N,
// shared, K-major), N = 128, 192 or 256; `accumulate` 0 ignores D's old value.
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" SM90_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[96],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{" SM90_R96 "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56), SM90_D8(64), SM90_D8(72),
        SM90_D8(80), SM90_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" SM90_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56), SM90_D8(64), SM90_D8(72),
        SM90_D8(80), SM90_D8(88), SM90_D8(96), SM90_D8(104), SM90_D8(112),
        SM90_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef SM90_D8
#undef SM90_R32
#undef SM90_R64
#undef SM90_R96
#undef SM90_R128

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The dynamic shared memory's shared-window address; its declaration asks
// for 1024-byte alignment, and a CTA traps rather than run misaligned.
__device__ __forceinline__ uint32_t aligned_smem(const void* smem_raw) {
  const uint32_t smem = smem_u32(smem_raw);
  if (smem & 1023) __trap();
  return smem;
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library links no libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d tiled tensor map: `dims` innermost first, `strides` in bytes of
// dims 1..3, `box` the tile. Zero fill outside the tensor. Returns 0 or
// ERR_TENSOR_MAP.
inline int tensor_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                         const void* ptr, const cuuint64_t (&dims)[4],
                         const cuuint64_t (&strides)[3],
                         const cuuint32_t (&box)[4],
                         CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                    ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// A 2-d tiled tensor map of a row-major [rows, cols] tensor: `cols` the
// inner dimension, `row_bytes` the stride of a row, `box` the tile {cols,
// rows}. Zero fill outside the tensor. Returns 0 or ERR_TENSOR_MAP.
inline int tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                         const void* ptr, cuuint64_t cols, cuuint64_t rows,
                         cuuint64_t row_bytes, cuuint32_t box_cols,
                         cuuint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t ones[2] = {1, 1};
  CUresult res = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                    ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

inline const char* error_string(int err) {
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a TMA descriptor (or the driver "
           "has none)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace sm90
