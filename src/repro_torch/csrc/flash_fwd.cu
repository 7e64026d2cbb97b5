// Flash-attention forward for Hopper (sm_90a): blocked online-softmax
// attention returning o and the float32 logsumexp lse.
//
// Replaces the TPU kernel `_fwd_kernel` behind `flash_attention_fwd_res` in
// src/repro/kernels/flash_attention.py.  Same contract: causal, sliding
// window and logit softcap masking, GQA (query head h reads kv head
// h / group), logits scaled by 1/sqrt(head_dim) in float32, float32 online
// softmax and accumulation, o in the input dtype, lse (B, H, T) float32; a
// row with no live key gives o = 0 and lse = -1e30.
//
// What bounds it on the card: at long prefill, the 4 * hd operations per
// live (query, key) pair; at the main paths' shapes (T = 128 to ~500) the
// bytes of q, k, v and o are smaller still, so what is left is latency:
// each block's chain of dependent tile steps.
//
// bf16 (every main path): `flash_fwd_tc_kernel`, on the tensor cores
// (machinery in flash_tc.cuh).  A block is one consumer warpgroup owning
// 64 query rows of one head and batch (two warpgroups sharing one K / V
// stream measured no faster at any main-path shape, and one gives short
// sequences twice the blocks).  Its Q tile is loaded once by TMA; K and V tiles of 64
// keys stream through a two-stage ring that TMA fills, the load of tile
// kb + 1 issued by one thread before the block computes on tile kb.  Per
// tile: S = Q K^T by wgmma from shared memory (both K-major as laid out);
// scale, softcap, mask and the online-softmax update in float32 registers,
// row max and sum reduced across the 4 lanes that share a row; P rounded to
// bf16 in registers and O += P V by wgmma with P from registers and V read
// transposed.  The scale is applied to S in float32, not folded into a
// bf16 q (that rounding would move lse by far more than its 1e-4
// tolerance); the normaliser l sums the float32 p, only P V's operand is
// rounded.  Fully masked kv tiles are skipped by the loop bounds (TPU
// `_tile_live`).
//
// float32: `flash_fwd_kernel`, the products on the CUDA cores in float32
// (the tensor cores would round float32 operands to TF32, beyond the 1e-4
// float32 tolerance).  One block per (q tile of 64 rows, head, batch) keeps
// its q tile in shared memory and streams 64-row k/v tiles through shared
// memory, 4x4 and 4x(hd/16) register tiles per thread.
#include <cstdint>

#include "common.cuh"
#include "flash_tc.cuh"

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

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* q_base = q + ((int64_t)b * t_len * n_heads + h) * HD;
  const float* k_base = k + ((int64_t)b * s_len * n_kv_heads + kvh) * HD;
  const float* v_base = v + ((int64_t)b * s_len * n_kv_heads + kvh) * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, t = q_start + r;
    q_s[r * QS + d] = t < t_len ? q_base[t * q_row + d] * scale : 0.f;
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
        kv = k_base[s * k_row + d];
        vv = v_base[s * k_row + d];
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
      float* o_row = o + (((int64_t)b * t_len + t) * n_heads + h) * HD;
#pragma unroll
      for (int c = 0; c < TC; ++c) o_row[tx + 16 * c] = acc[i][c] / denom;
    }
  }
  if (tid < BQ && q_start + tid < t_len) {
    const float l = l_s[tid];
    const float denom = l == 0.f ? 1.f : l;
    lse[((int64_t)b * n_heads + h) * t_len + q_start + tid] = m_s[tid] + logf(denom);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int t_len, int s_len, int n_heads, int n_kv_heads,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BQ - 1) / BQ, n_heads, batch);
  flash_fwd_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, t_len, s_len, n_heads,
      n_kv_heads, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16, tensor cores
constexpr int TC_BK = 64;      // keys per kv tile
constexpr int TC_STAGES = 2;   // kv tiles in flight

// Shared memory, in bytes from a 1024-aligned base: the Q tile (one box per
// 64 columns), then the ring's stages ([K boxes][V boxes]), then the
// mbarriers.
template <int HD>
struct FwdTc {
  static constexpr int BOXES = HD / 64;
  static constexpr int Q = 0;
  static constexpr int KV = BOXES * tc::BOX_BYTES;
  static constexpr int STAGE = 2 * BOXES * tc::BOX_BYTES;
  static constexpr int BAR = KV + TC_STAGES * STAGE;
  static constexpr int SMEM = BAR + 8 * (1 + 2 * TC_STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int t_len, int s_len, int n_heads,
                    int n_kv_heads, int causal, int window, float softcap, float scale) {
  using L = FwdTc<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = tc::align_1024(tc::smem_u32(smem_raw));
  const uint32_t q_bar = base + L::BAR;
  const tc::Ring<TC_STAGES> ring{q_bar + 8};

  // q tiles slowest and in reverse: under a causal mask the longest blocks
  // (the last q tiles) are dispatched first
  const int h = blockIdx.x, b = blockIdx.y, qb = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int t = threadIdx.x;
  const int q_start = qb * 64;
  const int q_last = min(q_start + 64, t_len) - 1;

  // kv tiles reachable from the block's rows (TPU `_tile_live`): every
  // tile in [kb_begin, kb_end) holds a live key for some row
  int kb_end = (s_len + TC_BK - 1) / TC_BK;
  if (causal) kb_end = min(kb_end, q_last / TC_BK + 1);
  int kb_begin = 0;
  if (window > 0 && q_start - window + 1 > 0) kb_begin = (q_start - window + 1) / TC_BK;
  const int n_tiles = max(0, kb_end - kb_begin);

  if (t == 0) {
    tc::prefetch_tmap(&tm_q);
    tc::prefetch_tmap(&tm_k);
    tc::prefetch_tmap(&tm_v);
    tc::mbar_init(q_bar, 1);
    ring.init(128);
    tc::mbar_init_fence();
  }
  __syncthreads();

  auto load_kv = [&](int i) {  // one thread: kv tile kb_begin + i into its stage
    const uint32_t st = base + L::KV + (i % TC_STAGES) * L::STAGE;
    const int row = (kb_begin + i) * TC_BK;
    tc::mbar_expect_tx(ring.full(i), L::STAGE);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x) {
      tc::tma_load_4d(st + x * tc::BOX_BYTES, &tm_k, ring.full(i), 64 * x, kvh, row, b);
      tc::tma_load_4d(st + (L::BOXES + x) * tc::BOX_BYTES, &tm_v, ring.full(i), 64 * x, kvh,
                      row, b);
    }
  };
  if (t == 0 && n_tiles > 0) {
    tc::mbar_expect_tx(q_bar, L::BOXES * tc::BOX_BYTES);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x)
      tc::tma_load_4d(base + L::Q + x * tc::BOX_BYTES, &tm_q, q_bar, 64 * x, h, q_start, b);
    load_kv(0);
  }
  __syncwarp();

  const int row0 = q_start + tc::frag_row(t, 0);  // rows row0 and row0 + 8
  const uint32_t q_tile = base + L::Q;
  const float scale_log2 = scale * tc::LOG2E;

  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the normaliser

  if (n_tiles > 0) tc::mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    if (t == 0 && i + 1 < n_tiles) {
      ring.acquire(i + 1);
      load_kv(i + 1);
    }
    __syncwarp();
    ring.wait_full(i);
    const int k_start = (kb_begin + i) * TC_BK;
    const uint32_t k_tile = base + L::KV + (i % TC_STAGES) * L::STAGE;
    const uint32_t v_tile = k_tile + L::BOXES * tc::BOX_BYTES;
    float s[32];
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      tc::wgmma_ss_n64(s, tc::desc_k(q_tile, j), tc::desc_k(k_tile, j), j > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(s);

    const bool edge = k_start + TC_BK > s_len || (causal && k_start + TC_BK - 1 > q_start) ||
                      (window > 0 && q_start + 63 - k_start >= window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = softcap > 0.f ? softcap * tanhf(s[e] * scale / softcap) * tc::LOG2E
                              : s[e] * scale_log2;
      if (edge) {
        const int qpos = row0 + 8 * ((e / 2) % 2), kpos = k_start + tc::frag_col(t, e);
        bool ok = kpos < s_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        if (!ok) x = MASKED;
      }
      s[e] = x;
      mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], x);
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], tc::quad_max(mx[r]));
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = exp2f(s[e] - m_run[(e / 2) % 2]);
      s[e] = p;
      rsum[(e / 2) % 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] *= alpha[(e / 2) % 2];
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tc::pack_a(s, j, a[j]);
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) tc::wgmma_rs(acc, a[j], tc::desc_mn(v_tile, j));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    ring.release(i);
  }

  float inv[2], l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = tc::quad_sum(l_run[r]);
    inv[r] = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
  }
  const int col0 = 2 * (t % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= t_len) continue;
    __nv_bfloat16* o_row = o + (((int64_t)b * t_len + qpos) * n_heads + h) * HD + col0;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint32_t*>(o_row + 8 * c) =
          tc::pack_bf16(acc[4 * c + 2 * r] * inv[r], acc[4 * c + 2 * r + 1] * inv[r]);
    if (t % 4 == 0)
      lse[((int64_t)b * n_heads + h) * t_len + qpos] =
          l_row[r] > 0.f ? (m_run[r] + log2f(l_row[r])) * tc::LN2 : NEG_INF;
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
              int t_len, int s_len, int n_heads, int n_kv_heads, int causal, int window,
              float softcap, float scale, cudaStream_t stream) {
  using L = FwdTc<HD>;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = tc::make_tmap(&tm_q, q, HD, n_heads, t_len, batch);
  if (err != 0) return err;
  if (s_len > 0) {
    err = tc::make_tmap(&tm_k, k, HD, n_kv_heads, s_len, batch);
    if (err == 0) err = tc::make_tmap(&tm_v, v, HD, n_kv_heads, s_len, batch);
    if (err != 0) return err;
  } else {  // no kv tile is ever loaded: any valid map will do
    tm_k = tm_v = tm_q;
  }
  static uint64_t smem_raised = 0;
  const cudaError_t cerr = tc::allow_smem(flash_fwd_tc_kernel<HD>, L::SMEM, smem_raised);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(n_heads, batch, (t_len + 63) / 64);
  flash_fwd_tc_kernel<HD><<<grid, 128, L::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, t_len, s_len, n_heads,
      n_kv_heads, causal, window, softcap, scale);
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
#define REPRO_FWD(LAUNCH, HD)                                                       \
  return LAUNCH<HD>(q, k, v, o, lse, batch, t_len, s_len, n_heads, n_kv_heads,      \
                    causal, window, softcap, scale, st)
  if (dtype == repro::DTYPE_F32 && head_dim == 64) REPRO_FWD(launch, 64);
  if (dtype == repro::DTYPE_F32 && head_dim == 128) REPRO_FWD(launch, 128);
  if (dtype == repro::DTYPE_BF16 && head_dim == 64) REPRO_FWD(launch_tc, 64);
  if (dtype == repro::DTYPE_BF16 && head_dim == 128) REPRO_FWD(launch_tc, 128);
#undef REPRO_FWD
  return (int)cudaErrorInvalidValue;
}

// Blocks of the bf16 kernel (head_dim 64 or 128) that one SM holds at
// once; 0 for another head_dim or on error.
extern "C" int flash_fwd_blocks_per_sm(int head_dim) {
  static uint64_t raised[2] = {0, 0};
#define REPRO_OCC(HD, I)                                                              \
  if (head_dim == HD) {                                                              \
    const int smem = FwdTc<HD>::SMEM;                                                \
    if (repro::tc::allow_smem(flash_fwd_tc_kernel<HD>, smem, raised[I])) return 0;   \
    return repro::tc::blocks_per_sm(flash_fwd_tc_kernel<HD>, 128, smem);             \
  }
  REPRO_OCC(64, 0)
  REPRO_OCC(128, 1)
#undef REPRO_OCC
  return 0;
}
