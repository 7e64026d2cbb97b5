// Fused gated-SGD update + hierarchical averaging for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/hier_mix.py:
//   K1  `_kernel`, behind `hier_mix_chunks` (one leaf, f32 or bf16) and the
//       dense `_packed_call` (the packed (W, sum C) float32 buffer):
//         out[j, c] = sum_i T[i, j] * (x[i, c] - eta * theta_i * g[i, c])
//   K2  `_grouped_kernel` / `_hub_grouped_kernel`, behind the grouped
//       `_packed_call`: the same update u, then
//         z = S u  (S: (D, W) v-weighted scatter),  z <- H^T z  (hub only),
//         out = B z  (B: (W, D) membership broadcast);
//   K5  `hier_mix_packed_chunked` is one launch of K1/K2 per column chunk
//       (a column range of the packed buffer, passed as base pointers and
//       row strides).
//
// Numerics contract, shared with the plain versions in kernels/ref.py so
// that kernel, plain version, packed and per-leaf launches and any chunking
// give the same bits: x and g are read in their type and widened to
// float32; a_i = eta * theta_i is rounded once; u = x - a_i * g is rounded
// twice (product, then difference: __fmul_rn / __fsub_rn, never an FMA);
// every sum starts at 0.0f and adds its rounded products in index order
// (i = 0..W-1, d = 0..D-1) with __fadd_rn; the result is rounded once to
// the output type.
//
// What bounds it on the card: bytes.  Each column reads W values of x and
// of g and writes W values of out; the operations are 2 W^2 (K1) or
// 4 W D + 2 D^2 (K2) per column, which at the W <= ~100 of the paper stays
// below the H100's 67 TFLOP/s float32 rate / 3.35 TB/s ratio for W small
// and is comparable at W = 100 (the W = 100 buffers are tiny).
//
// What this simple design does about it: x, g and out are touched once,
// coalesced, with 16-byte vector loads and stores where the buffer is
// aligned.  A block stages a_i and the operator (T, or S, B and H) in
// shared memory once and walks column tiles (grid-stride): its threads
// load a (W, tile) slab of x and g, write u as float32 into shared memory,
// and then each thread computes its outputs for VEC adjacent columns by
// looping over the workers (and hubs) itself.  No tensor cores: the
// contraction depth is W and the kernel is bound by bytes.  Ragged edges
// (C not a multiple of the tile or of VEC, unaligned leaves, (W,) leaves of
// one column) go element by element behind masks; nothing is padded.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int NT = 256;   // threads per block

struct Layout {           // shared-memory layout, in floats
  int a, op, bcast, hub, u, z, z2, total;
};

__host__ __device__ inline Layout layout(int w, int d, bool grouped, bool hub,
                                         int tile) {
  Layout L;
  L.a = 0;
  L.op = w;                                       // T (W, W) or S (D, W)
  L.bcast = L.op + (grouped ? d * w : w * w);     // B (W, D)
  L.hub = L.bcast + (grouped ? w * d : 0);        // H (D, D)
  L.u = L.hub + (hub ? d * d : 0);                // u tile (W, tile)
  L.z = L.u + w * tile;                           // z tile (D, tile)
  L.z2 = L.z + (grouped ? d * tile : 0);          // H^T z tile (D, tile)
  L.total = L.z2 + (hub ? d * tile : 0);
  return L;
}

// VEC values of T at p (16 bytes) widened to float
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f32<T>(t[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  uint4 raw;
  T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) t[k] = from_f32<T>(v[k]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// acc[k] = sum_r coef[r * cstride] * rows[r * tile + k], r = 0..n-1, in
// order, each product and sum rounded on its own
template <int VEC>
__device__ __forceinline__ void contract(float (&acc)[VEC], const float* coef,
                                         int cstride, const float* rows,
                                         int tile, int n) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  for (int r = 0; r < n; ++r) {
    const float cr = coef[r * cstride];
    const float* row = rows + r * tile;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(cr, row[k]));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
hier_mix_kernel(const T* __restrict__ x, const T* __restrict__ g,
                T* __restrict__ out, const float* __restrict__ op,
                const float* __restrict__ bcast, const float* __restrict__ hub,
                const float* __restrict__ theta, float eta, int w, int d,
                int64_t cols, int64_t ld_in, int64_t ld_out, int tile,
                int aligned) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const bool grouped = bcast != nullptr, has_hub = hub != nullptr;
  const Layout L = layout(w, d, grouped, has_hub, tile);
  float* a_s = smem + L.a;
  float* op_s = smem + L.op;
  float* b_s = smem + L.bcast;
  float* h_s = smem + L.hub;
  float* u_s = smem + L.u;
  float* z_s = smem + L.z;
  float* z2_s = smem + L.z2;

  const int tid = threadIdx.x;
  for (int i = tid; i < w; i += NT) a_s[i] = __fmul_rn(eta, theta[i]);
  const int n_op = grouped ? d * w : w * w;
  for (int k = tid; k < n_op; k += NT) op_s[k] = op[k];
  if (grouped)
    for (int k = tid; k < w * d; k += NT) b_s[k] = bcast[k];
  if (has_hub)
    for (int k = tid; k < d * d; k += NT) h_s[k] = hub[k];

  const int tpr = tile / VEC;        // threads along one row of the tile
  const int rpp = NT / tpr;          // rows covered per pass
  const int r0 = tid / tpr;
  const int cc = (tid % tpr) * VEC;  // this thread's first column in the tile
  const int64_t n_tiles = (cols + tile - 1) / tile;

  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t c0 = t * tile + cc;
    const bool vec_ok = aligned && c0 + VEC <= cols;
    __syncthreads();   // operators staged / previous tile's u and z consumed

    // u = x - a * g for the (W, tile) slab, float32, into shared memory
    for (int i = r0; i < w; i += rpp) {
      float xv[VEC], gv[VEC];
      const int64_t off = i * ld_in + c0;
      if (vec_ok) {
        load_vec<T, VEC>(x + off, xv);
        load_vec<T, VEC>(g + off, gv);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const bool live = c0 + k < cols;
          xv[k] = live ? to_f32<T>(x[off + k]) : 0.0f;
          gv[k] = live ? to_f32<T>(g[off + k]) : 0.0f;
        }
      }
      const float ai = a_s[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        u_s[i * tile + cc + k] = __fsub_rn(xv[k], __fmul_rn(ai, gv[k]));
    }
    __syncthreads();

    const float* src = u_s;      // rows the output contracts
    const float* coef = op_s;    // dense: T[i, j] at op_s[i * w + j]
    int cstride = w, depth = w;
    if (grouped) {
      // z[e] = sum_i S[e, i] u[i]
      for (int e = r0; e < d; e += rpp) {
        float acc[VEC];
        contract<VEC>(acc, op_s + e * w, 1, u_s + cc, tile, w);
#pragma unroll
        for (int k = 0; k < VEC; ++k) z_s[e * tile + cc + k] = acc[k];
      }
      __syncthreads();
      src = z_s;
      if (has_hub) {
        // z2[e] = sum_d H[d, e] z[d]
        for (int e = r0; e < d; e += rpp) {
          float acc[VEC];
          contract<VEC>(acc, h_s + e, d, z_s + cc, tile, d);
#pragma unroll
          for (int k = 0; k < VEC; ++k) z2_s[e * tile + cc + k] = acc[k];
        }
        __syncthreads();
        src = z2_s;
      }
      coef = b_s;                // out[j] = sum_d B[j, d] z[d]
      cstride = 1;
      depth = d;
    }

    for (int j = r0; j < w; j += rpp) {
      float acc[VEC];
      const float* cj = grouped ? coef + j * d : coef + j;
      contract<VEC>(acc, cj, cstride, src + cc, tile, depth);
      const int64_t off = j * ld_out + c0;
      if (vec_ok) {
        store_vec<T, VEC>(out + off, acc);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (c0 + k < cols) out[off + k] = from_f32<T>(acc[k]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* g, void* out, const float* op,
           const float* bcast, const float* hub, const float* theta, float eta,
           int w, int d, int64_t cols, int64_t ld_in, int64_t ld_out, int tile,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool grouped = bcast != nullptr, has_hub = hub != nullptr;
  const size_t smem = sizeof(float) * layout(w, d, grouped, has_hub, tile).total;
  auto kernel = hier_mix_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                           smem)))
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (cols + tile - 1) / tile;
  const int grid = (int)(n_tiles < (int64_t)sms * per_sm ? n_tiles
                                                         : (int64_t)sms * per_sm);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(out);
  const int aligned = bits % 16 == 0 && ld_in % VEC == 0 && ld_out % VEC == 0;
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out),
      op, bcast, hub, theta, eta, w, d, cols, ld_in, ld_out, tile, aligned);
  return cudaGetLastError();
}

}  // namespace

// x, g: (W, cols) with row stride ld_in; out: (W, cols) with row stride
// ld_out; all of one dtype (0 float32, 1 bfloat16).  Dense: op = T (W, W),
// bcast = hub = null.  Grouped: op = S (D, W), bcast = B (W, D), hub = H
// (D, D) or null.  theta (W,), operators float32, row-major.  tile is the
// columns a block stages at a time (a power of two from 32 to 256; the
// caller picks one whose shared memory fits).  Returns the cudaError_t of
// the launch.
extern "C" int hier_mix(const void* x, const void* g, void* out,
                        const float* op, const float* bcast, const float* hub,
                        const float* theta, float eta, int w, int d,
                        int64_t cols, int64_t ld_in, int64_t ld_out, int tile,
                        int dtype, void* stream) {
  if (cols <= 0 || w <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch<float>(x, g, out, op, bcast, hub, theta, eta, w, d, cols,
                         ld_in, ld_out, tile, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, g, out, op, bcast, hub, theta, eta, w, d,
                                 cols, ld_in, ld_out, tile, s);
  return cudaErrorInvalidValue;
}

