// Tensor-core machinery shared by the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) for Hopper (sm_90a).
//
// Replaces nothing by itself: it is the common part of the redesigned K3
// (`_fwd_kernel` behind `flash_attention_fwd_res`) and K4 (`_bwd_dq_kernel`
// / `_bwd_dkv_kernel` behind `flash_attention_bwd`) of
// src/repro/kernels/flash_attention.py.
//
// What bounds those kernels on this card: with head_dim 64 or 128 each
// (query, key) pair costs 4 hd (forward) or 10 hd (backward) operations, so
// at the main paths' shapes the CUDA cores' 67 TFLOP/s in float32 were the
// limit, far above the bytes.  bf16 products belong on the tensor cores
// (989 TFLOP/s), which Hopper reaches only through `wgmma`, reading its
// operands from shared memory laid out in the 128-byte swizzle.
//
// What is here:
// * a 64-row x 64-column bf16 box (8 KB, 128 bytes a row) is the unit of
//   every tile: TMA writes it in the 128-byte swizzle, so a tile of head_dim
//   128 is two boxes, each exactly one swizzle atom wide;
// * wgmma shared-memory descriptors for the two ways a box is read: K-major
//   (the contraction runs along the 128-byte rows: Q, K, dO, V as the
//   operands of Q K^T, dO V^T, K Q^T, V dO^T) and MN-major (the contraction
//   runs down the rows: V, K, dO, Q as the B operand of P V, dS K, P^T dO,
//   dS^T Q, which wgmma transposes on the fly for bf16);
// * `wgmma.fence` / `commit_group` / `wait_group`, and m64nNk16 bf16 -> f32
//   instructions in SS form (A and B in shared memory) and RS form (A in
//   registers);
// * the map from an accumulator fragment to (row, col) and the packing of
//   an accumulator into the A operand of the next product, so a softmax
//   numerator or a gradient never leaves registers;
// * an mbarrier ring of TMA-filled stages, and 4-D TMA loads from tensor
//   maps that `make_tmap` encodes on the host through the driver entry
//   point (the libraries are linked by nvcc alone, with no -lcuda).
//
// Only bf16 goes through this path.  float32 inputs stay on the CUDA-core
// kernels: on the tensor cores a float32 product is TF32 (10-bit mantissa),
// which cannot meet the 1e-4 float32 tolerance, and no main path runs
// attention in float32.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace tc {

constexpr int BOX_ROWS = 64;                  // rows of one TMA box
constexpr int BOX_BYTES = BOX_ROWS * 128;     // 64 rows x 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 (batch, rows, heads, hd) tensor,
// innermost first (hd, heads, rows, batch), read in boxes of (64, 1, 64, 1):
// 64 columns of one head at 64 positions of one batch.  Rows past `rows`
// read as zeros and never spill into the next batch.  -> a cudaError_t.
inline int make_tmap(CUtensorMap* map, const void* ptr, int hd, int heads, int rows,
                     int batch) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t row_bytes = (cuuint64_t)heads * hd * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, row_bytes, row_bytes * rows};
  const cuuint32_t box[4] = {64, 1, BOX_ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` and asks for
// the largest shared-memory carveout of the SM's 256 KB (so that two
// blocks of ~100 KB fit one SM), once per device (`done` is the caller's
// bit set of devices already raised).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, uint64_t& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (done >> dev & 1) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

// Blocks of `kernel` that one SM holds at once with `bytes` of dynamic
// shared memory (0 on error).
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, int threads, int bytes) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes) ==
                 cudaSuccess
             ? n
             : 0;
}

// ---------------------------------------------------- shared memory, TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Brings a tensor map into the TMA unit's cache ahead of its first load.
__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box from a 4-D tensor map into shared memory; completion is counted
// on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A ring of STAGES buffers, each with a "full" barrier (one arrival plus
// the TMA bytes) and an "empty" barrier (one arrival per consumer thread).
// Use i of the ring lives in stage i % STAGES; the producer may refill a
// stage once every consumer has released its previous use.
template <int STAGES>
struct Ring {
  uint32_t bars;  // 2 * STAGES mbarriers, 8 bytes each: full, then empty

  __device__ __forceinline__ uint32_t full(int i) const { return bars + 8 * (i % STAGES); }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return bars + 8 * (STAGES + i % STAGES);
  }
  __device__ __forceinline__ static uint32_t parity(int i) { return (i / STAGES) & 1; }
  __device__ __forceinline__ void init(int consumers) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumers);
    }
  }
  // producer, before filling use i
  __device__ __forceinline__ void acquire(int i) const {
    if (i >= STAGES) mbar_wait(empty(i), parity(i - STAGES));
  }
  __device__ __forceinline__ void wait_full(int i) const { mbar_wait(full(i), parity(i)); }
  __device__ __forceinline__ void release(int i) const { mbar_arrive(empty(i)); }
};

// ------------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (64 rows of a tile at `tile`), contraction slice j of 16
// columns: boxes of 64 columns one after another, 32 bytes per slice inside
// a box's 128-byte rows, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int j) {
  return make_desc(tile + (j / 4) * BOX_BYTES + (j % 4) * 32, 16, 1024);
}
// MN-major B operand: the contraction runs down the tile's rows, slice j =
// rows 16 j .. 16 j + 15 (two 8-row atoms); N runs along the columns, the
// next 64 columns one box (LBO) further on.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int j) {
  return make_desc(tile + j * 2048, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// m64nNk16, A from registers, B MN-major (transposed), N = 64 or 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

// --------------------------------------------------------------- fragments
// Element i of an m64nN float accumulator held by thread t (0..127) of its
// warpgroup sits at row frag_row(t, i), column frag_col(t, i): warp t / 32
// owns rows 16 (t / 32) .. + 15; the lanes of a quad (t / 4) share a row.
__device__ __forceinline__ int frag_row(int t, int i) {
  return (t / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int frag_col(int t, int i) { return 8 * (i / 4) + 2 * (t % 4) + (i % 2); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns 16 j .. 16 j + 15 of an m64n64 accumulator, rounded to bf16, as
// the A operand of an RS product whose contraction slice j they are.
__device__ __forceinline__ void pack_a(const float (&d)[32], int j, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * j + 0], d[8 * j + 1]);
  a[1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
  a[2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
  a[3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Round up a shared-memory address to the 1024 bytes a swizzle atom needs.
__device__ __forceinline__ uint32_t align_1024(uint32_t addr) { return (addr + 1023) & ~1023u; }

}  // namespace tc
}  // namespace repro
