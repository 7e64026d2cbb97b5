// Flash-attention backward for Hopper (sm_90a): dq, dk and dv by
// recomputation from the forward's float32 logsumexp.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` behind
// `flash_attention_bwd` in src/repro/kernels/flash_attention.py.  Same
// contract: q pre-scaled by 1/sqrt(head_dim); per tile s = q k^T (softcapped
// as in the forward), p = exp(s - lse) on live entries and 0 elsewhere,
// dp = do v^T, ds = p (dp - delta) times the softcap chain rule
// 1 - (s / softcap)^2; dq = scale * sum_kv ds k, dk = sum_q ds^T q_scaled,
// dv = sum_q p^T do, dk/dv summed over the GQA group of q heads that read
// the kv head.  delta = rowsum(do * o) (B, H, T) float32 comes from the
// wrapper, as the TPU wrapper computes it outside Pallas.  Causal, sliding
// window and kv_len masks as in the forward; fully masked tiles are skipped
// by the loop bounds (TPU `_tile_live`).
//
// What bounds it on the card: at the training path's shapes (T = S = 128,
// hd 128) the bytes of q, k, v, o, do, lse in and dq, dk, dv out; at long
// sequences the 10 * hd operations per live (query, key) pair.
//
// What this simple design does about that: two kernels, each thread block
// owning one output tile so that no two blocks write the same element.
// The dq kernel runs one block per (q tile of 64 rows, head, batch) and
// loops over the live kv tiles; the dk/dv kernel runs one block per (kv tile
// of 64 rows, kv head, batch) and loops over the live q tiles and, inside,
// the group's q heads.  Each keeps its tiles in shared memory, so a k/v (or
// q/do) byte is read once per tile of the other side, and accumulates in
// float32 registers.  No float atomics: the sums run in a fixed order, so
// dq, dk and dv are the same bits on every run (the trainer's kill-and-
// resume contract needs that).  Products run on the CUDA cores in float32;
// wgmma, TMA and a single fused pass are left for a later change.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: a 16 x 16 grid of register tiles

template <int HD>
constexpr size_t dq_smem_floats() {
  return 2 * BQ * (HD + 1)   // q tile (pre-scaled), do tile
         + 2 * BK * (HD + 1) // k tile, v tile
         + BQ * (BK + 1)     // ds
         + 2 * BQ;           // lse, delta
}

template <int HD>
constexpr size_t dkv_smem_floats() {
  return 2 * BK * (HD + 1)   // k tile, v tile
         + 2 * BQ * (HD + 1) // q tile (pre-scaled), do tile
         + 2 * BQ * (BK + 1) // p, ds
         + 2 * BQ;           // lse, delta
}

// Loads `rows` rows of head `head` (row stride `row_stride` elements)
// starting at position `start` into a (rows x (HD + 1)) float tile, times
// `mul`; rows past `len` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int start,
                                          int len, int64_t row_stride, float mul) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, pos = start + r;
    dst[r * (HD + 1) + d] = pos < len ? to_f32(base[pos * row_stride + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ bool is_live(int qpos, int kpos, int t_len, int s_len,
                                        int causal, int window) {
  bool live = qpos < t_len && kpos < s_len;
  if (causal) live = live && kpos <= qpos;
  if (window > 0) live = live && qpos - kpos < window;
  return live;
}

// s = q k^T and dp = do v^T for rows ty + 16 i, keys tx + 16 j of the
// tiles in shared memory; then p and ds per live entry (0 elsewhere).
template <int HD>
__device__ __forceinline__ void tile_p_ds(const float* q_s, const float* do_s,
                                          const float* k_s, const float* v_s,
                                          const float* lse_s, const float* dl_s,
                                          int q_start, int k_start, int t_len,
                                          int s_len, int causal, int window,
                                          float softcap, float p[4][4],
                                          float ds[4][4]) {
  constexpr int S = HD + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = q_s[(ty + 16 * i) * S + d];
      dov[i] = do_s[(ty + 16 * i) * S + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = k_s[(tx + 16 * j) * S + d];
      vv[j] = v_s[(tx + 16 * j) * S + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q_start + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k_start + tx + 16 * j;
      p[i][j] = ds[i][j] = 0.f;
      if (is_live(qpos, kpos, t_len, s_len, causal, window)) {
        const float s = apply_softcap(sc[i][j], softcap);
        const float pe = expf(s - lse_s[r]);
        float g = pe * (dp[i][j] - dl_s[r]);
        if (softcap > 0.f) {
          const float u = s / softcap;
          g *= 1.f - u * u;
        }
        p[i][j] = pe;
        ds[i][j] = g;
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int t_len, int s_len, int n_heads,
                    int n_kv_heads, int causal, int window, float softcap,
                    float scale) {
  constexpr int S = HD + 1, PS = BK + 1, TC = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * S;
  float* k_s = do_s + BQ * S;
  float* v_s = k_s + BK * S;
  float* ds_s = v_s + BK * S;
  float* lse_s = ds_s + BQ * PS;
  float* dl_s = lse_s + BQ;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q_start = qb * BQ;
  const int64_t q_row = (int64_t)n_heads * HD, k_row = (int64_t)n_kv_heads * HD;
  const int64_t q_off = ((int64_t)b * t_len * n_heads + h) * HD;
  const int64_t k_off = ((int64_t)b * s_len * n_kv_heads + kvh) * HD;
  const int64_t r_off = ((int64_t)b * n_heads + h) * t_len;

  load_tile<T, HD>(q_s, q + q_off, q_start, t_len, q_row, scale);
  load_tile<T, HD>(do_s, dout + q_off, q_start, t_len, q_row, 1.f);
  if (tid < BQ) {
    const int t = q_start + tid;
    lse_s[tid] = t < t_len ? lse[r_off + t] : 0.f;
    dl_s[tid] = t < t_len ? delta[r_off + t] : 0.f;
  }

  float acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;

  // kv tiles reachable from this q tile (TPU `_tile_live`)
  int kb_end = (s_len + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, (q_start + BQ - 1) / BK + 1);
  int kb_begin = 0;
  if (window > 0 && q_start - window + 1 > 0) kb_begin = (q_start - window + 1) / BK;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // the previous tile is done with k_s, v_s, ds_s
    load_tile<T, HD>(k_s, k + k_off, k_start, s_len, k_row, 1.f);
    load_tile<T, HD>(v_s, v + k_off, k_start, s_len, k_row, 1.f);
    __syncthreads();
    float p[4][4], ds[4][4];
    tile_p_ds<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, q_start, k_start, t_len,
                  s_len, causal, window, softcap, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds_s[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // acc += ds @ k
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float kk = k_s[j * S + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q_start + ty + 16 * i;
    if (t < t_len) {
      T* row = dq + q_off + t * q_row;
#pragma unroll
      for (int c = 0; c < TC; ++c) row[tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len,
                     int n_heads, int n_kv_heads, int causal, int window,
                     float softcap, float scale) {
  constexpr int S = HD + 1, PS = BK + 1, TC = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * S;
  float* q_s = v_s + BK * S;
  float* do_s = q_s + BQ * S;
  float* p_s = do_s + BQ * S;
  float* ds_s = p_s + BQ * PS;
  float* lse_s = ds_s + BQ * PS;
  float* dl_s = lse_s + BQ;

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k_start = kb * BK;
  const int64_t q_row = (int64_t)n_heads * HD, k_row = (int64_t)n_kv_heads * HD;
  const int64_t k_off = ((int64_t)b * s_len * n_kv_heads + kvh) * HD;

  load_tile<T, HD>(k_s, k + k_off, k_start, s_len, k_row, 1.f);
  load_tile<T, HD>(v_s, v + k_off, k_start, s_len, k_row, 1.f);

  float dk_acc[4][TC], dv_acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // q tiles that reach this kv tile (TPU `_tile_live`, solved for the q tile)
  const int nq = (t_len + BQ - 1) / BQ;
  const int qb_begin = causal ? k_start / BQ : 0;
  int qb_end = nq;
  if (window > 0) qb_end = min(nq, (k_start + BK + window - 2) / BQ + 1);

  for (int qb = qb_begin; qb < qb_end; ++qb) {
    const int q_start = qb * BQ;
    for (int g = 0; g < group; ++g) {  // the GQA group, reduced in-block
      const int h = kvh * group + g;
      const int64_t q_off = ((int64_t)b * t_len * n_heads + h) * HD;
      const int64_t r_off = ((int64_t)b * n_heads + h) * t_len;
      __syncthreads();  // the previous (q tile, head) is done with the tiles
      load_tile<T, HD>(q_s, q + q_off, q_start, t_len, q_row, scale);
      load_tile<T, HD>(do_s, dout + q_off, q_start, t_len, q_row, 1.f);
      if (tid < BQ) {
        const int t = q_start + tid;
        lse_s[tid] = t < t_len ? lse[r_off + t] : 0.f;
        dl_s[tid] = t < t_len ? delta[r_off + t] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      tile_p_ds<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, q_start, k_start, t_len,
                    s_len, causal, window, softcap, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_s[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
          ds_s[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dv[key] += sum_r p[r][key] do[r];  dk[key] += sum_r ds[r][key] q[r]
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[r * PS + ty + 16 * i];
          dsv[i] = ds_s[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const float dov = do_s[r * S + tx + 16 * c];
          const float qv = q_s[r * S + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k_start + ty + 16 * i;
    if (s < s_len) {
      T* dk_row = dk + k_off + s * k_row;
      T* dv_row = dv + k_off + s * k_row;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        dk_row[tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
        dv_row[tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int batch, int t_len, int s_len, int n_heads, int n_kv_heads,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  if (t_len > 0) {
    const size_t smem = dq_smem_floats<HD>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
    flash_bwd_dq_kernel<T, HD><<<grid, NT, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), t_len, s_len, n_heads,
        n_kv_heads, causal, window, softcap, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (s_len > 0) {
    const size_t smem = dkv_smem_floats<HD>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s_len + BK - 1) / BK, n_kv_heads, batch);
    flash_bwd_dkv_kernel<T, HD><<<grid, NT, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), t_len,
        s_len, n_heads, n_kv_heads, causal, window, softcap, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: (B, T, H, hd); k, v, dk, dv: (B, S, Hkv, hd); lse, delta:
// (B, H, T) float32; all contiguous.  dtype: 0 float32, 1 bfloat16;
// head_dim 64 or 128.  Returns a cudaError_t (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta,
                         void* dq, void* dk, void* dv, int batch, int t_len,
                         int s_len, int n_heads, int n_kv_heads, int head_dim,
                         int dtype, int causal, int window, float softcap,
                         float scale, void* stream) {
  if (batch == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(T, HD)                                                               \
  return launch<T, HD>(q, k, v, dout, lse, delta, dq, dk, dv, batch, t_len, s_len,     \
                       n_heads, n_kv_heads, causal, window, softcap, scale, st)
  if (dtype == repro::DTYPE_F32 && head_dim == 64) REPRO_BWD(float, 64);
  if (dtype == repro::DTYPE_F32 && head_dim == 128) REPRO_BWD(float, 128);
  if (dtype == repro::DTYPE_BF16 && head_dim == 64) REPRO_BWD(__nv_bfloat16, 64);
  if (dtype == repro::DTYPE_BF16 && head_dim == 128) REPRO_BWD(__nv_bfloat16, 128);
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
