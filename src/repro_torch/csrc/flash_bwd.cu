// Flash-attention backward for Hopper (sm_90a): dq, dk and dv by
// recomputation from the forward's float32 logsumexp.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` behind
// `flash_attention_bwd` in src/repro/kernels/flash_attention.py.  Same
// contract: logits s = scale * q k^T (softcapped as in the forward), p =
// exp(s - lse) on live entries and 0 elsewhere, dp = do v^T, ds = p (dp -
// delta) times the softcap chain rule 1 - (s / softcap)^2; dq = scale *
// sum_kv ds k, dk = scale * sum_q ds^T q, dv = sum_q p^T do, dk/dv summed
// over the GQA group of q heads that read the kv head.  delta = rowsum(do *
// o) (B, H, T) float32 is the preprocess the TPU wrapper computes outside
// Pallas; here `flash_bwd_delta_kernel` computes it on the same stream
// right before the main kernel, into a float32 scratch the wrapper
// allocates.  Causal, sliding window and kv_len masks as in the
// forward; fully masked tiles are skipped by the loop bounds (TPU
// `_tile_live`).  No float atomics: every sum runs in a fixed order, so dq,
// dk and dv are the same bits on every run (the trainer's kill-and-resume
// contract needs that).
//
// What bounds it on the card: at the training path's shapes (T = S = 128,
// hd 128) the bytes of q, k, v, o, do, lse in and dq, dk, dv out, and
// beyond them each block's chain of dependent tile steps; at long
// sequences the 10 * hd operations per live (query, key) pair.
//
// bf16 (every main path): on the tensor cores (machinery in flash_tc.cuh),
// `flash_bwd_tc_kernel` plus a fixed-order sum, each block (one warpgroup)
// owning its output tile.  One launch holds the two kinds of block, which
// are independent and so run side by side, two blocks an SM:
// * dq: one block per (q tile of 64 rows, head, batch);
//   Q and dO loaded once by TMA, K and V tiles of 64 keys through a
//   two-stage TMA ring.  Per tile S = Q K^T and dP = dO V^T by wgmma from
//   shared memory, P = exp(S - lse) and dS in float32 registers, dS rounded
//   to bf16 in registers, dQ += dS K with K read transposed.
// * dk/dv: one block per (kv tile of 64 keys, q head, batch), so the grid
//   has H, not Hkv, blocks per kv tile (at the training shape 128 blocks
//   for 132 SMs, not 64).  It computes the transposed products, so P and dS
//   never leave registers: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK +=
//   dS^T Q, with Q and dO tiles through the ring and dK, dV in float32
//   registers.  With one q head per kv head it writes dk, dv directly;
//   with a GQA group it writes float32 partials (B, S, H, hd) that
//   `group_sum_kernel` adds in head order and rounds once: deterministic,
//   and the same float32 sum the CUDA-core kernel forms in its loop.
//
// delta (both dtypes): one warp per (b, t, h) row, 16-byte loads of o and
// do, each lane's products summed in order and the lanes' sums by a fixed
// butterfly, written in lse's (B, H, T) layout.  It replaces four torch
// launches (two casts, a product and a sum) and their host time.
//
// float32: `flash_bwd_dq_kernel` / `flash_bwd_dkv_kernel`, the products on
// the CUDA cores in float32 (the tensor cores would round float32 operands
// to TF32, beyond the 1e-4 float32 tolerance).  One block per output tile
// keeps its tiles in shared memory and accumulates in float32 registers;
// the dk/dv block loops over the group's q heads.
#include <cstdint>

#include "common.cuh"
#include "flash_tc.cuh"

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
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int start,
                                          int len, int64_t row_stride, float mul) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, pos = start + r;
    dst[r * (HD + 1) + d] = pos < len ? base[pos * row_stride + d] * mul : 0.f;
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

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int t_len, int s_len, int n_heads,
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

  load_tile<HD>(q_s, q + q_off, q_start, t_len, q_row, scale);
  load_tile<HD>(do_s, dout + q_off, q_start, t_len, q_row, 1.f);
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
    load_tile<HD>(k_s, k + k_off, k_start, s_len, k_row, 1.f);
    load_tile<HD>(v_s, v + k_off, k_start, s_len, k_row, 1.f);
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
      float* row = dq + q_off + t * q_row;
#pragma unroll
      for (int c = 0; c < TC; ++c) row[tx + 16 * c] = acc[i][c] * scale;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int t_len, int s_len,
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

  load_tile<HD>(k_s, k + k_off, k_start, s_len, k_row, 1.f);
  load_tile<HD>(v_s, v + k_off, k_start, s_len, k_row, 1.f);

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
      load_tile<HD>(q_s, q + q_off, q_start, t_len, q_row, scale);
      load_tile<HD>(do_s, dout + q_off, q_start, t_len, q_row, 1.f);
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
      float* dk_row = dk + k_off + s * k_row;
      float* dv_row = dv + k_off + s * k_row;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        dk_row[tx + 16 * c] = dk_acc[i][c];
        dv_row[tx + 16 * c] = dv_acc[i][c];
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int batch, int t_len, int s_len, int n_heads, int n_kv_heads,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  if (t_len > 0) {
    const size_t smem = dq_smem_floats<HD>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
    flash_bwd_dq_kernel<HD><<<grid, NT, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<float*>(dq), t_len, s_len, n_heads,
        n_kv_heads, causal, window, softcap, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (s_len > 0) {
    const size_t smem = dkv_smem_floats<HD>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((s_len + BK - 1) / BK, n_kv_heads, batch);
    flash_bwd_dkv_kernel<HD><<<grid, NT, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), t_len,
        s_len, n_heads, n_kv_heads, causal, window, softcap, scale);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16, tensor cores
constexpr int TC_STAGES = 2;   // tiles of the streamed side in flight

// Shared memory of both bf16 kernels, in bytes from a 1024-aligned base:
// the resident pair (Q, dO for dq; K, V for dk/dv), the ring's stages (the
// streamed pair), the mbarriers, then (dk/dv) lse and delta of two q tiles.
template <int HD>
struct BwdTc {
  static constexpr int BOXES = HD / 64;
  static constexpr int PAIR = 2 * BOXES * tc::BOX_BYTES;
  static constexpr int RING = PAIR;
  static constexpr int BAR = RING + TC_STAGES * PAIR;
  static constexpr int ROWS = BAR + 8 * (1 + 2 * TC_STAGES);
  static constexpr int SMEM = ROWS + 4 * 64 * 4 + 1024;
};

// dq of one (q tile qb of 64 rows, head h, batch b).
template <int HD>
__device__ __forceinline__ void dq_block(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         __nv_bfloat16* __restrict__ dq, int t_len, int s_len,
                                         int n_heads, int n_kv_heads, int causal, int window,
                                         float softcap, float scale, int h, int b, int qb) {
  using L = BwdTc<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = tc::align_1024(tc::smem_u32(smem_raw));
  const uint32_t in_bar = base + L::BAR;
  const tc::Ring<TC_STAGES> ring{in_bar + 8};

  const int kvh = h / (n_heads / n_kv_heads);
  const int t = threadIdx.x;
  const int q_start = qb * 64;
  const int q_last = min(q_start + 64, t_len) - 1;

  // kv tiles reachable from this q tile (TPU `_tile_live`)
  int kb_end = (s_len + 63) / 64;
  if (causal) kb_end = min(kb_end, q_last / 64 + 1);
  int kb_begin = 0;
  if (window > 0 && q_start - window + 1 > 0) kb_begin = (q_start - window + 1) / 64;
  const int n_tiles = max(0, kb_end - kb_begin);

  if (t == 0) {
    tc::prefetch_tmap(tm_q);
    tc::prefetch_tmap(tm_k);
    tc::prefetch_tmap(tm_v);
    tc::prefetch_tmap(tm_do);
    tc::mbar_init(in_bar, 1);
    ring.init(128);
    tc::mbar_init_fence();
  }
  __syncthreads();

  auto load_kv = [&](int i) {  // one thread: kv tile kb_begin + i into its stage
    const uint32_t st = base + L::RING + (i % TC_STAGES) * L::PAIR;
    const int row = (kb_begin + i) * 64;
    tc::mbar_expect_tx(ring.full(i), L::PAIR);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x) {
      tc::tma_load_4d(st + x * tc::BOX_BYTES, tm_k, ring.full(i), 64 * x, kvh, row, b);
      tc::tma_load_4d(st + (L::BOXES + x) * tc::BOX_BYTES, tm_v, ring.full(i), 64 * x, kvh,
                      row, b);
    }
  };
  if (t == 0 && n_tiles > 0) {
    tc::mbar_expect_tx(in_bar, L::PAIR);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x) {
      tc::tma_load_4d(base + x * tc::BOX_BYTES, tm_q, in_bar, 64 * x, h, q_start, b);
      tc::tma_load_4d(base + (L::BOXES + x) * tc::BOX_BYTES, tm_do, in_bar, 64 * x, h,
                      q_start, b);
    }
    load_kv(0);
  }
  __syncwarp();

  const int row0 = q_start + tc::frag_row(t, 0);  // rows row0 and row0 + 8
  const int64_t r_off = ((int64_t)b * n_heads + h) * t_len;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    lse_r[r] = qpos < t_len ? lse[r_off + qpos] : 0.f;
    dl_r[r] = qpos < t_len ? delta[r_off + qpos] : 0.f;
  }
  const uint32_t q_tile = base, do_tile = base + L::BOXES * tc::BOX_BYTES;

  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;

  if (n_tiles > 0) tc::mbar_wait(in_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    if (t == 0 && i + 1 < n_tiles) {
      ring.acquire(i + 1);
      load_kv(i + 1);
    }
    __syncwarp();
    ring.wait_full(i);
    const int k_start = (kb_begin + i) * 64;
    const uint32_t k_tile = base + L::RING + (i % TC_STAGES) * L::PAIR;
    const uint32_t v_tile = k_tile + L::BOXES * tc::BOX_BYTES;
    float s[32], dp[32];
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      tc::wgmma_ss_n64(s, tc::desc_k(q_tile, j), tc::desc_k(k_tile, j), j > 0);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      tc::wgmma_ss_n64(dp, tc::desc_k(do_tile, j), tc::desc_k(v_tile, j), j > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    const bool edge = k_start + 64 > s_len || (causal && k_start + 63 > q_start) ||
                      (window > 0 && q_start + 63 - k_start >= window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e / 2) % 2;
      float x = s[e] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool ok = true;
      if (edge) ok = is_live(row0 + 8 * r, k_start + tc::frag_col(t, e), t_len, s_len, causal,
                             window);
      const float p = ok ? exp2f((x - lse_r[r]) * tc::LOG2E) : 0.f;
      float g = p * (dp[e] - dl_r[r]);
      if (softcap > 0.f) {
        const float u = x / softcap;
        g *= 1.f - u * u;
      }
      dp[e] = g;
    }
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tc::pack_a(dp, j, a[j]);
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) tc::wgmma_rs(acc, a[j], tc::desc_mn(k_tile, j));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    ring.release(i);
  }

  const int col0 = 2 * (t % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= t_len) continue;
    __nv_bfloat16* row = dq + (((int64_t)b * t_len + qpos) * n_heads + h) * HD + col0;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c) =
          tc::pack_bf16(acc[4 * c + 2 * r] * scale, acc[4 * c + 2 * r + 1] * scale);
  }
}

// dk, dv (or their float32 partials) of one (kv tile kb of 64 keys, q
// head h, batch b).
template <int HD>
__device__ __forceinline__ void dkv_block(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          __nv_bfloat16* __restrict__ dk,
                                          __nv_bfloat16* __restrict__ dv,
                                          float* __restrict__ dk_part,
                                          float* __restrict__ dv_part, int t_len, int s_len,
                                          int n_heads, int n_kv_heads, int causal, int window,
                                          float softcap, float scale, int h, int b, int kb) {
  using L = BwdTc<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = tc::align_1024(tc::smem_u32(smem_raw));
  const uint32_t in_bar = base + L::BAR;
  const tc::Ring<TC_STAGES> ring{in_bar + 8};
  float* rows_s = reinterpret_cast<float*>(smem_raw + (L::ROWS + base - tc::smem_u32(smem_raw)));
  // rows_s[buf * 128 + c]: lse of query c of the tile in buffer buf; + 64: its delta

  const int group = n_heads / n_kv_heads, kvh = h / group;
  const int t = threadIdx.x;
  const int k_start = kb * 64;

  // q tiles that reach this kv tile (TPU `_tile_live`, solved for the q tile)
  const int nq = (t_len + 63) / 64;
  const int qb_begin = causal ? k_start / 64 : 0;
  int qb_end = nq;
  if (window > 0) qb_end = min(nq, (k_start + 64 + window - 2) / 64 + 1);
  const int n_tiles = max(0, qb_end - qb_begin);

  if (t == 0) {
    tc::prefetch_tmap(tm_q);
    tc::prefetch_tmap(tm_k);
    tc::prefetch_tmap(tm_v);
    tc::prefetch_tmap(tm_do);
    tc::mbar_init(in_bar, 1);
    ring.init(128);
    tc::mbar_init_fence();
  }
  __syncthreads();

  auto load_qdo = [&](int i) {  // one thread: q / do tile qb_begin + i into its stage
    const uint32_t st = base + L::RING + (i % TC_STAGES) * L::PAIR;
    const int row = (qb_begin + i) * 64;
    tc::mbar_expect_tx(ring.full(i), L::PAIR);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x) {
      tc::tma_load_4d(st + x * tc::BOX_BYTES, tm_q, ring.full(i), 64 * x, h, row, b);
      tc::tma_load_4d(st + (L::BOXES + x) * tc::BOX_BYTES, tm_do, ring.full(i), 64 * x, h,
                      row, b);
    }
  };
  if (t == 0 && n_tiles > 0) {
    tc::mbar_expect_tx(in_bar, L::PAIR);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x) {
      tc::tma_load_4d(base + x * tc::BOX_BYTES, tm_k, in_bar, 64 * x, kvh, k_start, b);
      tc::tma_load_4d(base + (L::BOXES + x) * tc::BOX_BYTES, tm_v, in_bar, 64 * x, kvh,
                      k_start, b);
    }
    load_qdo(0);
  }
  __syncwarp();

  const int krow0 = k_start + tc::frag_row(t, 0);  // keys krow0 and krow0 + 8
  const int64_t r_off = ((int64_t)b * n_heads + h) * t_len;
  const uint32_t k_tile = base, v_tile = base + L::BOXES * tc::BOX_BYTES;
  // lse and delta of the next q tile, one query per thread of the first 64
  float next_lse = 0.f, next_dl = 0.f;
  auto fetch = [&](int i) {
    const int qpos = (qb_begin + i) * 64 + t;
    if (t < 64 && qpos < t_len) {
      next_lse = lse[r_off + qpos];
      next_dl = delta[r_off + qpos];
    } else {
      next_lse = next_dl = 0.f;
    }
  };
  if (n_tiles > 0) fetch(0);

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  if (n_tiles > 0) tc::mbar_wait(in_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    float* lse_s = rows_s + (i % 2) * 128;
    float* dl_s = lse_s + 64;
    if (t < 64) {
      lse_s[t] = next_lse;
      dl_s[t] = next_dl;
    }
    if (i + 1 < n_tiles) fetch(i + 1);
    if (t == 0 && i + 1 < n_tiles) {
      ring.acquire(i + 1);
      load_qdo(i + 1);
    }
    __syncthreads();  // lse_s / dl_s of this tile are written
    ring.wait_full(i);
    const int q_start = (qb_begin + i) * 64;
    const uint32_t q_tile = base + L::RING + (i % TC_STAGES) * L::PAIR;
    const uint32_t do_tile = q_tile + L::BOXES * tc::BOX_BYTES;
    float s[32], dp[32];  // S^T (keys x queries), dP^T
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      tc::wgmma_ss_n64(s, tc::desc_k(k_tile, j), tc::desc_k(q_tile, j), j > 0);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      tc::wgmma_ss_n64(dp, tc::desc_k(v_tile, j), tc::desc_k(do_tile, j), j > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    const bool edge = q_start + 64 > t_len || k_start + 64 > s_len ||
                      (causal && k_start + 63 > q_start) ||
                      (window > 0 && q_start + 63 - k_start >= window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = tc::frag_col(t, e);
      float x = s[e] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool ok = true;
      if (edge)
        ok = is_live(q_start + c, krow0 + 8 * ((e / 2) % 2), t_len, s_len, causal, window);
      const float p = ok ? exp2f((x - lse_s[c]) * tc::LOG2E) : 0.f;
      float g = p * (dp[e] - dl_s[c]);
      if (softcap > 0.f) {
        const float u = x / softcap;
        g *= 1.f - u * u;
      }
      s[e] = p;
      dp[e] = g;
    }
    uint32_t ap[4][4], ad[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tc::pack_a(s, j, ap[j]);
      tc::pack_a(dp, j, ad[j]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) tc::wgmma_rs(dv_acc, ap[j], tc::desc_mn(do_tile, j));
#pragma unroll
    for (int j = 0; j < 4; ++j) tc::wgmma_rs(dk_acc, ad[j], tc::desc_mn(q_tile, j));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(dv_acc);
    tc::fence_regs(dk_acc);
    ring.release(i);
  }

  const int col0 = 2 * (t % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = krow0 + 8 * r;
    if (kpos >= s_len) continue;
    if (group == 1) {
      const int64_t off = (((int64_t)b * s_len + kpos) * n_kv_heads + kvh) * HD + col0;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * c) =
            tc::pack_bf16(dk_acc[4 * c + 2 * r] * scale, dk_acc[4 * c + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * c) =
            tc::pack_bf16(dv_acc[4 * c + 2 * r], dv_acc[4 * c + 2 * r + 1]);
      }
    } else {
      const int64_t off = (((int64_t)b * s_len + kpos) * n_heads + h) * HD + col0;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        *reinterpret_cast<float2*>(dk_part + off + 8 * c) =
            make_float2(dk_acc[4 * c + 2 * r] * scale, dk_acc[4 * c + 2 * r + 1] * scale);
        *reinterpret_cast<float2*>(dv_part + off + 8 * c) =
            make_float2(dv_acc[4 * c + 2 * r], dv_acc[4 * c + 2 * r + 1]);
      }
    }
  }
}

// One launch for both halves of the backward: blocks z < n_kv_tiles own a
// kv tile (dk, dv; under a causal mask the first kv tiles are the longest,
// and they are dispatched first), the others a q tile (dq, the last q
// tiles first).  The halves are independent, so they run side by side,
// two blocks an SM, instead of one after the other.
template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ dk_part, float* __restrict__ dv_part, int t_len,
                    int s_len, int n_heads, int n_kv_heads, int causal, int window,
                    float softcap, float scale, int n_kv_tiles) {
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  if (z < n_kv_tiles)
    dkv_block<HD>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dk, dv, dk_part, dv_part, t_len,
                  s_len, n_heads, n_kv_heads, causal, window, softcap, scale, h, b, z);
  else
    dq_block<HD>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, dq, t_len, s_len, n_heads,
                 n_kv_heads, causal, window, softcap, scale, h, b, gridDim.z - 1 - z);
}

// dk[b, s, g_kv, :] = sum over the group's heads, in head order, of the
// float32 partials (B, S, H, hd); one rounding to bf16.  Four columns a
// thread.
template <int HD>
__global__ void group_sum_kernel(const float* __restrict__ dk_part,
                                 const float* __restrict__ dv_part,
                                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                 int64_t n_rows, int group) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * (HD / 4)) return;
  const int64_t row = idx / (HD / 4);
  const int d = 4 * (int)(idx % (HD / 4));
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < group; ++g) {
    const int64_t off = (row * group + g) * HD + d;
    const float4 pk = *reinterpret_cast<const float4*>(dk_part + off);
    const float4 pv = *reinterpret_cast<const float4*>(dv_part + off);
    sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
    sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
  }
  uint32_t* k_out = reinterpret_cast<uint32_t*>(dk + row * HD + d);
  uint32_t* v_out = reinterpret_cast<uint32_t*>(dv + row * HD + d);
  k_out[0] = tc::pack_bf16(sk.x, sk.y);
  k_out[1] = tc::pack_bf16(sk.z, sk.w);
  v_out[0] = tc::pack_bf16(sv.x, sv.y);
  v_out[1] = tc::pack_bf16(sv.z, sv.w);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, void* dk, void* dv, float* dk_part,
              float* dv_part, int batch, int t_len, int s_len, int n_heads, int n_kv_heads,
              int causal, int window, float softcap, float scale, cudaStream_t stream) {
  using L = BwdTc<HD>;
  if (t_len == 0 && s_len == 0) return (int)cudaSuccess;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = 0;
  if (t_len > 0) {
    err = tc::make_tmap(&tm_q, q, HD, n_heads, t_len, batch);
    if (err == 0) err = tc::make_tmap(&tm_do, dout, HD, n_heads, t_len, batch);
  }
  if (err == 0 && s_len > 0) {
    err = tc::make_tmap(&tm_k, k, HD, n_kv_heads, s_len, batch);
    if (err == 0) err = tc::make_tmap(&tm_v, v, HD, n_kv_heads, s_len, batch);
  }
  if (err != 0) return err;
  // A side of length 0 is never loaded: any valid map stands in for it.
  if (t_len == 0) tm_q = tm_do = tm_k;
  if (s_len == 0) tm_k = tm_v = tm_q;
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  const int n_q_tiles = (t_len + 63) / 64, n_kv_tiles = (s_len + 63) / 64;
  static uint64_t smem_raised = 0;
  cudaError_t cerr = tc::allow_smem(flash_bwd_tc_kernel<HD>, L::SMEM, smem_raised);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(n_heads, batch, n_kv_tiles + n_q_tiles);
  flash_bwd_tc_kernel<HD><<<grid, 128, L::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq), dk_, dv_, dk_part,
      dv_part, t_len, s_len, n_heads, n_kv_heads, causal, window, softcap, scale, n_kv_tiles);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  const int group = n_heads / n_kv_heads;
  if (s_len > 0 && group > 1) {
    const int64_t n_rows = (int64_t)batch * s_len * n_kv_heads;
    const int64_t threads = n_rows * (HD / 4);
    group_sum_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        dk_part, dv_part, dk_, dv_, n_rows, group);
  }
  return (int)cudaGetLastError();
}

constexpr int DELTA_WARPS = 8;  // rows per block of the delta kernel

__device__ __forceinline__ float dot_piece(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  float s = x.x * y.x;
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  return fmaf(x.w, y.w, s);
}

__device__ __forceinline__ float dot_piece(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(x2[i]), yf = __bfloat1622float2(y2[i]);
    s = fmaf(xf.x, yf.x, s);
    s = fmaf(xf.y, yf.y, s);
  }
  return s;
}

// delta[b, h, t] = sum_d o[b, t, h, d] * dout[b, t, h, d] in float32: one
// warp per row of o, lane j taking the row's 16-byte piece j (a row has
// 8 to 32 of them), the lanes' sums added by a fixed butterfly.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * DELTA_WARPS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t n_rows, int t_len, int n_heads) {
  constexpr int VEC = 16 / sizeof(T), CH = HD / VEC;
  static_assert(CH <= 32, "one 16-byte piece per lane");
  const int64_t row = (int64_t)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // the whole warp
  const float s = warp_sum(lane < CH ? dot_piece(o + row * HD + lane * VEC,
                                                  dout + row * HD + lane * VEC)
                                     : 0.f);
  if (lane == 0) {
    const int64_t bt = row / n_heads;
    const int h = (int)(row % n_heads);
    delta[(bt / t_len * n_heads + h) * t_len + bt % t_len] = s;
  }
}

template <typename T, int HD>
int launch_delta(const void* o, const void* dout, float* delta, int batch, int t_len,
                 int n_heads, cudaStream_t stream) {
  const int64_t n_rows = (int64_t)batch * t_len * n_heads;
  if (n_rows == 0) return (int)cudaSuccess;
  flash_bwd_delta_kernel<T, HD>
      <<<(unsigned)((n_rows + DELTA_WARPS - 1) / DELTA_WARPS), 32 * DELTA_WARPS, 0, stream>>>(
          static_cast<const T*>(o), static_cast<const T*>(dout), delta, n_rows, t_len, n_heads);
  return (int)cudaGetLastError();
}

int delta_dispatch(const void* o, const void* dout, float* delta, int batch, int t_len,
                   int n_heads, int head_dim, int dtype, cudaStream_t st) {
#define REPRO_DELTA(T, HD) \
  return launch_delta<T, HD>(o, dout, delta, batch, t_len, n_heads, st)
  if (dtype == repro::DTYPE_F32 && head_dim == 64) REPRO_DELTA(float, 64);
  if (dtype == repro::DTYPE_F32 && head_dim == 128) REPRO_DELTA(float, 128);
  if (dtype == repro::DTYPE_BF16 && head_dim == 64) REPRO_DELTA(__nv_bfloat16, 64);
  if (dtype == repro::DTYPE_BF16 && head_dim == 128) REPRO_DELTA(__nv_bfloat16, 128);
#undef REPRO_DELTA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// o, dout: (B, T, H, hd) contiguous, 16-byte aligned; delta: (B, H, T)
// float32 out.  dtype: 0 float32, 1 bfloat16; head_dim 64 or 128.  Launches
// the delta preprocess alone.  Returns a cudaError_t (0 on success).
extern "C" int flash_bwd_delta(const void* o, const void* dout, float* delta, int batch,
                               int t_len, int n_heads, int head_dim, int dtype, void* stream) {
  return delta_dispatch(o, dout, delta, batch, t_len, n_heads, head_dim, dtype,
                        static_cast<cudaStream_t>(stream));
}

// q, o, dout, dq: (B, T, H, hd); k, v, dk, dv: (B, S, Hkv, hd); lse (B, H,
// T) float32; all contiguous.  delta: (B, H, T) float32 scratch, written
// here by the delta kernel before the main kernel reads it.  dtype: 0
// float32, 1 bfloat16; head_dim 64 or 128.  dk_part, dv_part: float32 (B,
// S, H, hd) scratch for bf16 with H > Hkv (null otherwise).  Returns a
// cudaError_t (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta,
                         void* dq, void* dk, void* dv, float* dk_part, float* dv_part,
                         int batch, int t_len, int s_len, int n_heads, int n_kv_heads,
                         int head_dim, int dtype, int causal, int window, float softcap,
                         float scale, void* stream) {
  if (batch == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = delta_dispatch(o, dout, delta, batch, t_len, n_heads, head_dim, dtype, st);
  if (err != 0) return err;
#define REPRO_BWD(HD)                                                                  \
  return launch<HD>(q, k, v, dout, lse, delta, dq, dk, dv, batch, t_len, s_len,        \
                    n_heads, n_kv_heads, causal, window, softcap, scale, st)
  if (dtype == repro::DTYPE_F32 && head_dim == 64) REPRO_BWD(64);
  if (dtype == repro::DTYPE_F32 && head_dim == 128) REPRO_BWD(128);
#undef REPRO_BWD
#define REPRO_BWD_BF16(HD)                                                                \
  return launch_tc<HD>(q, k, v, dout, lse, delta, dq, dk, dv, dk_part, dv_part, batch,    \
                       t_len, s_len, n_heads, n_kv_heads, causal, window, softcap, scale, st)
  if (dtype == repro::DTYPE_BF16 && head_dim == 64) REPRO_BWD_BF16(64);
  if (dtype == repro::DTYPE_BF16 && head_dim == 128) REPRO_BWD_BF16(128);
#undef REPRO_BWD_BF16
  return (int)cudaErrorInvalidValue;
}

// Blocks of the bf16 kernel (head_dim 64 or 128) that one SM holds at
// once; 0 for another head_dim or on error.
extern "C" int flash_bwd_blocks_per_sm(int head_dim) {
  static uint64_t raised[2] = {0, 0};
#define REPRO_OCC(HD, I)                                                              \
  if (head_dim == HD) {                                                              \
    const int smem = BwdTc<HD>::SMEM;                                                \
    if (repro::tc::allow_smem(flash_bwd_tc_kernel<HD>, smem, raised[I])) return 0;   \
    return repro::tc::blocks_per_sm(flash_bwd_tc_kernel<HD>, 128, smem);             \
  }
  REPRO_OCC(64, 0)
  REPRO_OCC(128, 1)
#undef REPRO_OCC
  return 0;
}
