// Flash-attention forward for Hopper (sm_90a): blocked online-softmax
// attention returning o and the float32 logsumexp lse.
//
// Replaces the TPU kernel `_fwd_kernel` behind `flash_attention_fwd_res` in
// src/repro/kernels/flash_attention.py.  Same contract: causal, sliding
// window and logit softcap masking, GQA (query head h reads kv head
// h / group), q multiplied by 1/sqrt(head_dim) before the dot, float32
// online softmax and accumulation, o in the input dtype, lse (B, H, T)
// float32; a row with no live key gives o = 0 and lse = -1e30.
//
// What bounds it on the card: at long prefill, tensor-core FLOPs (4 * hd
// operations per live (query, key) pair against 989 TFLOP/s in bf16); the
// bytes (q, k, v read once, o written once) are far smaller.
//
// What this simple design does about that: one thread block per (q-tile of
// 64 rows, head, batch) keeps its q tile in shared memory and streams 64-row
// k/v tiles through shared memory, so each k/v byte is read once per q tile
// rather than once per query; the loop over kv tiles (the TPU's sequential
// grid axis) starts and stops at the causal / window reachability bounds, so
// fully masked tiles cost nothing.  The products run on the CUDA cores in
// float32 (4x4 and 4x(hd/16) register tiles per thread), not on the tensor
// cores: wgmma, TMA and warp specialisation are left for a later change.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per kv tile
constexpr int NT = 256;  // threads per block: a 16 x 16 grid of register tiles

template <int HD>
constexpr size_t smem_floats() {
  return BQ * (HD + 1)      // q tile, pre-scaled (row padded against bank conflicts)
         + BK * (HD + 1)    // k tile
         + BK * HD          // v tile
         + BQ * (BK + 1)    // logits, then probabilities
         + 3 * BQ;          // running max m, normaliser l, rescale alpha
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, int s_len, int n_heads,
                 int n_kv_heads, int causal, int window, float softcap,
                 float scale) {
  constexpr int QS = HD + 1, KS = HD + 1, PS = BK + 1;
  constexpr int TC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * KS;
  float* p_s = v_s + BK * HD;
  float* m_s = p_s + BQ * PS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q_start = qb * BQ;

  const int64_t q_row = (int64_t)n_heads * HD;   // stride between positions
  const int64_t k_row = (int64_t)n_kv_heads * HD;
  const T* q_base = q + ((int64_t)b * t_len * n_heads + h) * HD;
  const T* k_base = k + ((int64_t)b * s_len * n_kv_heads + kvh) * HD;
  const T* v_base = v + ((int64_t)b * s_len * n_kv_heads + kvh) * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, t = q_start + r;
    q_s[r * QS + d] = t < t_len ? to_f32(q_base[t * q_row + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
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
    __syncthreads();  // the previous tile is done with k_s, v_s, p_s
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD, s = k_start + r;
      float kv = 0.f, vv = 0.f;
      if (s < s_len) {
        kv = to_f32(k_base[s * k_row + d]);
        vv = to_f32(v_base[s * k_row + d]);
      }
      k_s[r * KS + d] = kv;
      v_s[r * HD + d] = vv;
    }
    __syncthreads();

    // logits for rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q_start + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k_start + c;
        bool live = kpos < s_len;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && qpos - kpos < window;
        p_s[r * PS + c] = live ? apply_softcap(sc[i][j], softcap) : MASKED;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 rows, each lane 2 keys of a row
    for (int r = warp * (BQ / 8); r < (warp + 1) * (BQ / 8); ++r) {
      const float s0 = p_s[r * PS + lane], s1 = p_s[r * PS + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      p_s[r * PS + lane] = p0;
      p_s[r * PS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + row_sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float vv = v_s[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q_start + r;
    if (t < t_len) {
      const float l = l_s[r];
      const float denom = l == 0.f ? 1.f : l;
      T* o_row = o + (((int64_t)b * t_len + t) * n_heads + h) * HD;
#pragma unroll
      for (int c = 0; c < TC; ++c) o_row[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
    }
  }
  if (tid < BQ && q_start + tid < t_len) {
    const float l = l_s[tid];
    const float denom = l == 0.f ? 1.f : l;
    lse[((int64_t)b * n_heads + h) * t_len + q_start + tid] = m_s[tid] + logf(denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int t_len, int s_len, int n_heads, int n_kv_heads,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, t_len, s_len, n_heads, n_kv_heads, causal, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, T, H, hd), k/v: (B, S, Hkv, hd), o: (B, T, H, hd), lse: (B, H, T),
// all contiguous.  dtype: 0 float32, 1 bfloat16; head_dim 64 or 128.
// Returns a cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int batch, int t_len, int s_len,
                         int n_heads, int n_kv_heads, int head_dim, int dtype,
                         int causal, int window, float softcap, float scale,
                         void* stream) {
  if (batch == 0 || t_len == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(T, HD)                                                               \
  return launch<T, HD>(q, k, v, o, lse, batch, t_len, s_len, n_heads, n_kv_heads,      \
                       causal, window, softcap, scale, st)
  if (dtype == repro::DTYPE_F32 && head_dim == 64) REPRO_FWD(float, 64);
  if (dtype == repro::DTYPE_F32 && head_dim == 128) REPRO_FWD(float, 128);
  if (dtype == repro::DTYPE_BF16 && head_dim == 64) REPRO_FWD(__nv_bfloat16, 64);
  if (dtype == repro::DTYPE_BF16 && head_dim == 128) REPRO_FWD(__nv_bfloat16, 128);
#undef REPRO_FWD
  return (int)cudaErrorInvalidValue;
}
