// Paged flash-decode for Hopper (sm_90a): one query token per sequence
// against a paged KV cache, split-KV partials plus an exact logsumexp
// combine.
//
// Replaces the TPU kernel `_decode_kernel` behind `flash_decode_paged` in
// src/repro/kernels/flash_attention.py, and the split combine that follows
// its pallas_call.  Same contract: head h = kv_head * group + g; lane b's
// query sits at position lengths[b] - 1 and sees positions < lengths[b]
// (and, with a window, positions > lengths[b] - 1 - window); logical
// position p lives at pool[tables[b, p / block_size], p % block_size];
// q multiplied by 1/sqrt(head_dim) before the dot; float32 (acc, m, l)
// partials per split; a lane with lengths[b] == 0 gives exact zeros.
//
// What bounds it on the card: the bytes of KV read (every live cached
// token's k and v row once per kv head); the operations are 4 * hd per
// (query head, live token), far below the tensor cores' rate.
//
// What this simple design does about that: one thread block per (split,
// kv head, lane) reads each live k/v row once from device memory into shared
// memory and serves the whole GQA group's queries from it, so the bytes
// moved are the live cache once; the block reads the physical block ids from
// the table itself (the TPU's scalar prefetch), stops at lengths[b] and
// starts at the window's first position, so dead blocks are never read and
// no read goes past the table's width; the split axis gives enough blocks
// to fill the card at small batch.  The second kernel combines the splits.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int NT = 128;   // threads per block
constexpr int TK = 64;    // cached tokens per shared-memory chunk
constexpr int MAXG = 8;   // largest GQA group

template <int HD>
constexpr size_t smem_floats() {
  return MAXG * HD         // the group's queries, pre-scaled
         + TK * (HD + 1)   // k rows (padded against bank conflicts)
         + TK * HD         // v rows
         + MAXG * (TK + 1) // logits, then probabilities
         + 3 * MAXG;       // running max m, normaliser l, rescale alpha
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool, const int* __restrict__ tables,
                      const int* __restrict__ lengths, float* __restrict__ o_parts,
                      float* __restrict__ m_parts, float* __restrict__ l_parts,
                      int n_heads, int n_kv_heads, int num_blocks, int block_size,
                      int max_blocks, int num_splits, int blocks_per_split,
                      int window, float softcap, float scale) {
  constexpr int KS = HD + 1, PS = TK + 1;
  constexpr int NR = NT / HD;          // threads sharing one column d
  constexpr int ROWS = MAXG / NR;      // group rows owned per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + MAXG * HD;
  float* v_s = k_s + TK * KS;
  float* p_s = v_s + TK * HD;
  float* m_s = p_s + MAXG * PS;
  float* l_s = m_s + MAXG;
  float* a_s = l_s + MAXG;
  __shared__ int64_t row_off[TK];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = tid % HD, g0 = tid / HD;

  const int length = lengths[b];
  const int qpos = length - 1;
  // live logical positions of this split: [tok_lo, tok_hi)
  const int blk_hi = min((split + 1) * blocks_per_split, max_blocks);
  int tok_lo = split * blocks_per_split * block_size;
  const int tok_hi = min(blk_hi * block_size, length);
  if (window > 0) tok_lo = max(tok_lo, qpos - window + 1);

  const T* q_base = q + ((int64_t)b * n_heads + (int64_t)kvh * group) * HD;
  for (int idx = tid; idx < group * HD; idx += NT) q_s[idx] = to_f32(q_base[idx]) * scale;
  if (tid < MAXG) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;

  const int* table = tables + (int64_t)b * max_blocks;
  for (int c0 = tok_lo; c0 < tok_hi; c0 += TK) {
    const int n = min(TK, tok_hi - c0);
    __syncthreads();  // the previous chunk is done with k_s, v_s, p_s
    if (tid < n) {
      const int p = c0 + tid;
      int phys = table[p / block_size];
      phys = min(max(phys, 0), num_blocks - 1);
      row_off[tid] = (((int64_t)phys * block_size + p % block_size) * n_kv_heads + kvh) * HD;
    }
    __syncthreads();
    for (int idx = tid; idx < n * HD; idx += NT) {
      const int r = idx / HD, dd = idx % HD;
      const int64_t off = row_off[r] + dd;
      k_s[r * KS + dd] = to_f32(k_pool[off]);
      v_s[r * HD + dd] = to_f32(v_pool[off]);
    }
    __syncthreads();

    for (int idx = tid; idx < group * TK; idx += NT) {
      const int g = idx / TK, r = idx % TK;
      float s = MASKED;
      if (r < n) {
        float dot = 0.f;
#pragma unroll 8
        for (int j = 0; j < HD; ++j) dot = fmaf(q_s[g * HD + j], k_s[r * KS + j], dot);
        s = apply_softcap(dot, softcap);
      }
      p_s[g * PS + r] = s;
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 4; each lane 2 tokens of a row
    for (int g = warp; g < group; g += NT / 32) {
      const float s0 = p_s[g * PS + lane], s1 = p_s[g * PS + lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      p_s[g * PS + lane] = p0;
      p_s[g * PS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + row_sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int g = g0 + NR * i;
      if (g < group) {
        float a = acc[i] * a_s[g];
        for (int r = 0; r < n; ++r) a = fmaf(p_s[g * PS + r], v_s[r * HD + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  const int64_t part = ((int64_t)b * n_kv_heads + kvh) * num_splits + split;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int g = g0 + NR * i;
    if (g < group) o_parts[(part * group + g) * HD + d] = acc[i];
  }
  if (tid < group) {
    m_parts[part * group + tid] = m_s[tid];
    l_parts[part * group + tid] = l_s[tid];
  }
}

// Exact logsumexp combine over the splits: dead splits carry (m = -1e30,
// l = 0) and weigh exp(-1e30 - m) = 0 next to a live one; a lane with no
// live split has l = 0 everywhere and gives 0.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ o_parts, const float* __restrict__ m_parts,
                      const float* __restrict__ l_parts, T* __restrict__ out,
                      int n_heads, int n_kv_heads, int num_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int group = n_heads / n_kv_heads;
  const int kvh = h / group, g = h % group;
  const int64_t base = ((int64_t)b * n_kv_heads + kvh) * num_splits;
  float m = NEG_INF;
  for (int s = 0; s < num_splits; ++s) m = fmaxf(m, m_parts[(base + s) * group + g]);
  float acc = 0.f, l = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const int64_t row = (base + s) * group + g;
    const float w = expf(m_parts[row] - m);
    acc = fmaf(w, o_parts[row * HD + d], acc);
    l = fmaf(w, l_parts[row], l);
  }
  out[((int64_t)b * n_heads + h) * HD + d] = from_f32<T>(acc / (l == 0.f ? 1.f : l));
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* lengths, float* o_parts, float* m_parts, float* l_parts,
           void* out, int batch, int n_heads, int n_kv_heads, int num_blocks,
           int block_size, int max_blocks, int num_splits, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks_per_split = (max_blocks + num_splits - 1) / num_splits;
  decode_partial_kernel<T, HD><<<dim3(num_splits, n_kv_heads, batch), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, o_parts, m_parts, l_parts, n_heads, n_kv_heads, num_blocks,
      block_size, max_blocks, num_splits, blocks_per_split, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, HD><<<dim3(n_heads, batch), HD, 0, stream>>>(
      o_parts, m_parts, l_parts, static_cast<T*>(out), n_heads, n_kv_heads, num_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, hd); k_pool/v_pool: (num_blocks, block_size, Hkv, hd);
// tables: (B, max_blocks) int32; lengths: (B,) int32; o_parts:
// (B, Hkv, num_splits, group, hd) float32; m_parts/l_parts:
// (B, Hkv, num_splits, group) float32; out: (B, H, hd).  All contiguous.
// dtype: 0 float32, 1 bfloat16; head_dim 64 or 128; group <= 8;
// 1 <= num_splits <= max_blocks.  Returns a cudaError_t (0 on success).
extern "C" int flash_decode(const void* q, const void* k_pool, const void* v_pool,
                            const int* tables, const int* lengths, float* o_parts,
                            float* m_parts, float* l_parts, void* out, int batch,
                            int n_heads, int n_kv_heads, int head_dim, int num_blocks,
                            int block_size, int max_blocks, int num_splits, int dtype,
                            int window, float softcap, float scale, void* stream) {
  if (batch == 0) return (int)cudaSuccess;
  if (n_heads / n_kv_heads > MAXG || num_splits < 1 || num_splits > max_blocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(T, HD)                                                              \
  return launch<T, HD>(q, k_pool, v_pool, tables, lengths, o_parts, m_parts, l_parts,    \
                       out, batch, n_heads, n_kv_heads, num_blocks, block_size,          \
                       max_blocks, num_splits, window, softcap, scale, st)
  if (dtype == repro::DTYPE_F32 && head_dim == 64) REPRO_DECODE(float, 64);
  if (dtype == repro::DTYPE_F32 && head_dim == 128) REPRO_DECODE(float, 128);
  if (dtype == repro::DTYPE_BF16 && head_dim == 64) REPRO_DECODE(__nv_bfloat16, 64);
  if (dtype == repro::DTYPE_BF16 && head_dim == 128) REPRO_DECODE(__nv_bfloat16, 128);
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}
