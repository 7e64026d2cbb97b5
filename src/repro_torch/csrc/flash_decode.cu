// Paged flash-decode for Hopper (sm_90a): one query token per sequence
// against a paged KV cache, split-KV with an exact logsumexp combine, in one
// launch.
//
// Replaces the TPU kernel `_decode_kernel` behind `flash_decode_paged` in
// src/repro/kernels/flash_attention.py, and the split combine that follows
// its pallas_call.  Same contract: head h = kv_head * group + g, any group;
// lane b's query sits at position lengths[b] - 1 and sees positions <
// lengths[b] (and, with a window, positions > lengths[b] - 1 - window);
// logical position p lives at pool[tables[b, p / block_size], p %
// block_size]; logits s = scale * q k (softcapped); float32 (acc, m, l)
// partials per split, combined exactly; a lane with lengths[b] == 0 gives
// exact zeros.  head_dim 64, 80 or 128, taken as it is (no padding: padding
// the pools would copy the whole cache on every layer of every tick).
//
// What bounds it on the card: the bytes of KV read, every live cached
// token's k and v row once per kv head (~6 MB, 0.0018 ms, at the serve
// path's busiest tick); then, since that is so little, the latency of a
// launch and of each dependent step inside a block.
//
// How the design answers each:
// * one launch: the splits of one (lane, kv head, 32 query rows) form a
//   thread-block cluster along the split axis.  Each split owns a slice
//   of the output and receives, through distributed shared memory, every
//   split's (acc, m, l) partial of that slice by stores (no remote load
//   waits: remote loads, one split after another, would put their latency
//   in series), then combines them in split order from its own shared
//   memory, so no partial goes through device memory and nothing is
//   allocated but the output.  The split count is chosen by the wrapper to
//   fill the card (`choose_num_splits`), at most 16 blocks a cluster;
// * the bytes once, in flight: a block reads its lane's table entries itself
//   (the TPU's scalar prefetch), clamps them to the pool, and fetches the
//   K and V rows of its kv head with 16-byte `cp.async` into a three-stage
//   ring of 64-token chunks (32 in float32) kept in the input's dtype, so
//   chunks c + 1 and c + 2 load while chunk c computes, with one barrier a
//   chunk; the table entries of the next chunk to load are read a chunk
//   ahead, and a pair of threads copies one row (one lookup, one offset),
//   so issuing a chunk's copies is a few instructions a thread (an offset
//   per 16-byte piece made that address work the cost of a chunk); rows
//   past the split's end are zero-filled and masked, never read from
//   device memory;
// * bf16 on the tensor cores: S = Q K^T and O += P V as `mma.sync.m16n8k16`
//   (`ldmatrix` from the padded ring rows, V transposed by `ldmatrix.trans`),
//   the group's query rows in tiles of 16 (the instruction's M; a group of
//   2 pads its tile, a group above 16 takes a second tile, which shares
//   every chunk the block loaded; above 32 a kv head takes more blocks,
//   each reading its pages again), S scaled in float32 after
//   the product (q itself is not rounded again), the online softmax in
//   float32 registers, P rounded to bf16 for the P V product as the
//   tensor-core K3 rounds it.  `wgmma` would waste 62 of its 64 rows at a
//   group of 2;
// * float32 on the CUDA cores with the same loads, ring, warp split and
//   combine (on the tensor cores a float32 product becomes TF32, beyond the
//   1e-4 float32 tolerance): each warp step forms its 16 x 16 logits and
//   P V with scalar FMAs;
// * determinism: the split boundaries depend only on (length, window,
//   splits); every sum (a warp's tokens in order, the warps of a row tile in
//   warp order, the splits in split order) runs in a fixed order, and there
//   are no atomics, so two runs give the same bits.
//
// Inside a block: four warps.  The block's query rows (up to 32 of the
// group) form row tiles of 16; the warps divide into the row tiles, and the
// warps of one row tile take the 16-token steps of each chunk in turn, each
// warp keeping its own (acc, m, l).  After the token loop the warps'
// partials go to shared memory (over the ring) and are combined per row in
// warp order into the block's partial.  A split takes an equal share of the
// lane's live positions, rounded up to 16, so a ragged batch spreads evenly.
// The cluster's barriers: each block arrives when its ring is free and
// waits before storing into its peers (whose rings are then free too); a
// second arrive / wait makes those stores visible.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int NT = 128;              // threads per block: four warps
constexpr int NW = NT / 32;
constexpr int ROWS = 16;             // query rows of a row tile (mma.sync M)
constexpr int MAX_ROWS = 2 * ROWS;   // query rows of a block: two row tiles
constexpr int SUB = 16;              // cached tokens of a warp step (the P V product's K)
constexpr int STAGES = 3;            // chunks in the ring
constexpr int MAX_CLUSTER = 16;      // splits of a cluster (non-portable above 8)
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int HD>
struct Layout {
  static constexpr int TK = sizeof(T) == 2 ? 64 : 32;  // cached tokens of a chunk
  static constexpr int VEC = 16 / sizeof(T);            // elements of a 16-byte piece
  static constexpr int LD = HD + VEC;                   // padded row (against bank conflicts)
  static constexpr int CH = HD / VEC;                   // pieces of a row
  static constexpr size_t RING = (size_t)STAGES * 2 * TK * LD * sizeof(T);
  // after the token loop, over the ring: each warp's (acc, m, l), the
  // block's, and what the peers send for the combine
  static constexpr size_t PARTS =
      ((size_t)NW * ROWS * HD + 2 * NW * ROWS + (size_t)MAX_ROWS * HD + 2 * MAX_ROWS +
       (size_t)MAX_ROWS * HD + MAX_CLUSTER + 2 * MAX_CLUSTER * MAX_ROWS) *
      sizeof(float);
  static constexpr size_t MAIN = RING > PARTS ? RING : PARTS;
  static constexpr size_t QS = (size_t)MAX_ROWS * LD * sizeof(T);  // the block's query rows
  // float32 only: each warp's probabilities of one step
  static constexpr size_t PS = sizeof(T) == 4 ? (size_t)NW * ROWS * (SUB + 1) * sizeof(float) : 0;
  static constexpr size_t SMEM = MAIN + QS + PS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros if !valid
// (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b: a 16 x 16 bf16 (row-major fragment), b 16 x 8 bf16 (column
// fragment), c 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Barriers of the thread-block cluster, apart: arrive (releasing this
// thread's earlier writes), then wait (acquiring the peers').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warp's share of a row tile on the tensor cores: its 16 query rows as
// A fragments, its accumulator as C fragments (rows g = lane / 4 and g + 8,
// columns 8 i + 2 (lane % 4) + {0, 1}), its running max per row and its
// lanes' partial row sums.
template <int HD>
struct WarpTc {
  using T = __nv_bfloat16;
  static constexpr int LD = Layout<T, HD>::LD;
  uint32_t qa[HD / 16][4];
  float acc[HD / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init(const T* q_tile, int lane) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qa[kk], q_tile + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // 16 cached tokens: rows 0..15 of k_s / v_s, positions tok0 + 0..15, live
  // below tok_hi.
  __device__ __forceinline__ void step(const T* k_s, const T* v_s, int tok0, int tok_hi,
                                       float scale, float softcap, float*, int lane) {
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];   // tokens 0-7 (b[0], b[1]) and 8-15 (b[2], b[3]), d 16 kk ..
      ldmatrix_x4(b, k_s + ((lane % 8) + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = tok0 + nt * 8 + 2 * (lane % 4) + (e % 2);
        const float x = apply_softcap(s[nt][e] * scale, softcap);
        s[nt][e] = tok < tok_hi ? x : MASKED;
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]), fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e / 2]);
        l[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    // P (16 rows x 16 tokens) as the A fragment: the S fragments, rounded
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t b[4];   // d 16 n2 + 0-7 (b[0], b[1]) and + 8-15 (b[2], b[3])
      ldmatrix_x4_trans(b, v_s + ((lane % 8) + ((lane / 8) % 2) * 8) * LD + n2 * 16 +
                               (lane / 16) * 8);
      mma_bf16(acc[2 * n2], pa, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], pa, b[2], b[3]);
    }
  }

  // -> wacc (16 x HD), wm, wl (16) of this warp.
  __device__ __forceinline__ void store(float* wacc, float* wm, float* wl, int lane) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[r];
      x += __shfl_xor_sync(FULL, x, 1);
      x += __shfl_xor_sync(FULL, x, 2);
      if (t == 0) {
        wm[g + 8 * r] = m[r];
        wl[g + 8 * r] = x;
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      *reinterpret_cast<float2*>(wacc + g * HD + 8 * i + 2 * t) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(wacc + (g + 8) * HD + 8 * i + 2 * t) =
          make_float2(acc[i][2], acc[i][3]);
    }
  }
};

// The same share in float32 on the CUDA cores.  Lane (rh, t) = (lane / 16,
// lane % 16) forms the logits of token t for rows rh, rh + 2, ..., rh + 14;
// lane owns output columns lane, lane + 32, ...; every lane keeps the 16
// rows' running max and sum.
template <int HD>
struct WarpF32 {
  static constexpr int LD = Layout<float, HD>::LD;
  static constexpr int DS = (HD + 31) / 32;
  const float* q_tile;
  float acc[ROWS][DS];
  float m[ROWS], l[ROWS];

  __device__ __forceinline__ void init(const float* q, int) {
    q_tile = q;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int k = 0; k < DS; ++k) acc[r][k] = 0.f;
    }
  }

  __device__ __forceinline__ void step(const float* k_s, const float* v_s, int tok0, int tok_hi,
                                       float scale, float softcap, float* p_s, int lane) {
    const int rh = lane / 16, t = lane % 16;
    float s[ROWS / 2];
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) s[i] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + t * LD);
    for (int d = 0; d < HD / 4; ++d) {
      const float4 kv = k4[d];
#pragma unroll
      for (int i = 0; i < ROWS / 2; ++i) {
        const float4 qv = reinterpret_cast<const float4*>(q_tile + (rh + 2 * i) * LD)[d];
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    const bool live = tok0 + t < tok_hi;
    float mx[ROWS / 2], other[ROWS / 2];
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) {
      s[i] = live ? apply_softcap(s[i] * scale, softcap) : MASKED;
      float x = s[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
      mx[i] = x;
      other[i] = __shfl_xor_sync(FULL, x, 16);
    }
    float alpha[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float row_max = (r % 2 == rh) ? mx[r / 2] : other[r / 2];
      const float m_new = fmaxf(m[r], row_max);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) {
      const float p = expf(s[i] - (rh ? m[2 * i + 1] : m[2 * i]));
      p_s[(rh + 2 * i) * (SUB + 1) + t] = p;
      float x = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
      mx[i] = x;
      other[i] = __shfl_xor_sync(FULL, x, 16);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      l[r] = alpha[r] * l[r] + ((r % 2 == rh) ? mx[r / 2] : other[r / 2]);
#pragma unroll
      for (int k = 0; k < DS; ++k) acc[r][k] *= alpha[r];
    }
    __syncwarp();
    for (int tt = 0; tt < SUB; ++tt) {
      float vv[DS];
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        const int d = lane + 32 * k;
        vv[k] = d < HD ? v_s[tt * LD + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = p_s[r * (SUB + 1) + tt];
#pragma unroll
        for (int k = 0; k < DS; ++k) acc[r][k] = fmaf(p, vv[k], acc[r][k]);
      }
    }
    __syncwarp();   // p_s is rewritten by the next step
  }

  __device__ __forceinline__ void store(float* wacc, float* wm, float* wl, int lane) const {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        const int d = lane + 32 * k;
        if (d < HD) wacc[r * HD + d] = acc[r][k];
      }
    }
    if (lane < ROWS) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r == lane) {
          wm[r] = m[r];
          wl[r] = l[r];
        }
    }
  }
};

// grid (splits, n_kv_heads * row_blocks, batch), cluster (splits, 1, 1).
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int n_heads,
                    int n_kv_heads, int num_blocks, int block_size, int max_blocks,
                    int row_blocks, int window, float softcap, float scale) {
  using L = Layout<T, HD>;
  using Warp = std::conditional_t<sizeof(T) == 2, WarpTc<HD>, WarpF32<HD>>;
  constexpr int TK = L::TK, LD = L::LD, CH = L::CH, VEC = L::VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* wacc = reinterpret_cast<float*>(smem);  // over the ring, after the token loop
  float* wm = wacc + NW * ROWS * HD;
  float* wl = wm + NW * ROWS;
  float* bacc = wl + NW * ROWS;
  float* bm = bacc + MAX_ROWS * HD;
  float* bl = bm + MAX_ROWS;
  float* recv = bl + MAX_ROWS;  // the peers' partials of this split's elements
  float* rm = recv + MAX_ROWS * HD + MAX_CLUSTER;
  float* rl = rm + MAX_CLUSTER * MAX_ROWS;
  T* q_s = reinterpret_cast<T*>(smem + L::MAIN);
  float* p_s = reinterpret_cast<float*>(smem + L::MAIN + L::QS);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_splits = gridDim.x;  // the cluster spans the x axis
  const int kvh = blockIdx.y / row_blocks, row0 = blockIdx.y % row_blocks * MAX_ROWS;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const int rows = min(MAX_ROWS, group - row0);
  const int n_rt = (rows + ROWS - 1) / ROWS;  // row tiles, 1 or 2
  const int n_ts = NW / n_rt;                 // warps that share a row tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int my_rt = warp % n_rt, my_ts = warp / n_rt;

  // the block's query rows, in flight first (rows past the group are zeros)
  const T* q_base = q + ((int64_t)b * n_heads + (int64_t)kvh * group + row0) * HD;
  for (int i = tid; i < n_rt * ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    cp_async16(q_s + r * LD + c * VEC, q_base + (r < rows ? (int64_t)r * HD + c * VEC : 0),
               r < rows);
  }
  cp_async_commit();

  // this split's share [tok_lo, tok_hi) of the lane's live positions
  const int length = lengths[b];
  const int hi = min(length, max_blocks * block_size);
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int share = ((max(hi - lo, 0) + n_splits - 1) / n_splits + SUB - 1) / SUB * SUB;
  const int tok_lo = lo + split * share;
  const int tok_hi = min(hi, tok_lo + share);
  const int n_chunks = tok_hi > tok_lo ? (tok_hi - tok_lo + TK - 1) / TK : 0;

  // The ring: chunk c of the split in stage c % STAGES.  Per chunk, TPR
  // threads copy one cached row (one table entry, one offset), each KPT
  // 16-byte pieces of K and of V, neighbours on neighbouring pieces.  The
  // table entry of the chunk a thread issues next is read a chunk ahead,
  // so no table read stands between a barrier and the copies after it.
  constexpr int TPR = NT / TK, KPT = CH / TPR;
  static_assert(NT % TK == 0 && CH % TPR == 0, "whole pieces per thread");
  const int ld_row = tid / TPR, ld_piece = tid % TPR;
  const int* table = tables + (int64_t)b * max_blocks;
  auto lookup = [&](int c) {
    const int p = tok_lo + c * TK + ld_row;
    return p < tok_hi ? table[p / block_size] : 0;
  };
  auto issue = [&](int c, int blk) {
    T* k_s = ring + (size_t)(c % STAGES) * 2 * TK * LD + ld_row * LD;
    T* v_s = k_s + TK * LD;
    const int p = tok_lo + c * TK + ld_row;
    const bool live = p < tok_hi;
    int64_t off = 0;
    if (live)
      off = (((int64_t)min(max(blk, 0), num_blocks - 1) * block_size + p % block_size) *
                 n_kv_heads + kvh) * HD;
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int col = (ld_piece + k * TPR) * VEC;
      cp_async16(k_s + col, k_pool + off + col, live);
      cp_async16(v_s + col, v_pool + off + col, live);
    }
  };

  int next = 0;  // table entry of the next chunk to issue
  if (n_chunks > 0) {
    // chunks 0 .. STAGES - 2 in flight, the table entry of the next read
    int ahead[STAGES - 1];
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) ahead[c] = lookup(c);
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < n_chunks) issue(c, ahead[c]);
      cp_async_commit();
    }
    next = lookup(STAGES - 1);
  }

  // groups committed: the query rows, chunks 0 .. STAGES - 2, then one per
  // iteration; so at iteration c all but the last STAGES - 2 are chunk c's
  // and earlier
  Warp st;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c == 0) st.init(q_s + my_rt * ROWS * LD, lane);
    if (c + STAGES - 1 < n_chunks) {
      issue(c + STAGES - 1, next);  // into chunk c - 1's stage
      next = lookup(c + STAGES);
    }
    cp_async_commit();  // one group an iteration, empty or not
    const T* k_s = ring + (size_t)(c % STAGES) * 2 * TK * LD;
    const T* v_s = k_s + TK * LD;
    const int c0 = tok_lo + c * TK;
    for (int j = my_ts; j < TK / SUB && c0 + j * SUB < tok_hi; j += n_ts)
      st.step(k_s + j * SUB * LD, v_s + j * SUB * LD, c0 + j * SUB, tok_hi, scale, softcap,
              p_s + warp * ROWS * (SUB + 1), lane);
  }
  cp_async_wait<0>();
  if (n_chunks == 0) st.init(q_s, lane);  // a dead split: (m, l, acc) = (-1e30, 0, 0)
  __syncthreads();
  cluster_arrive();  // done with the ring: peers may write into its free part

  st.store(wacc + warp * ROWS * HD, wm + warp * ROWS, wl + warp * ROWS, lane);
  __syncthreads();
  // the block's partial: each row tile's warps combined in warp order
  for (int i = tid; i < rows * HD; i += NT) {
    const int r = i / HD, d = i % HD, tile = r / ROWS, rr = r % ROWS;
    float m = NEG_INF;
    for (int ts = 0; ts < n_ts; ++ts) m = fmaxf(m, wm[(tile + ts * n_rt) * ROWS + rr]);
    float a = 0.f, l = 0.f;
    for (int ts = 0; ts < n_ts; ++ts) {
      const int w = (tile + ts * n_rt) * ROWS + rr;
      const float wgt = expf(wm[w] - m);
      a = fmaf(wgt, wacc[w * HD + d], a);
      l = fmaf(wgt, wl[w], l);
    }
    bacc[i] = a;
    if (d == 0) {
      bm[r] = m;
      bl[r] = l;
    }
  }
  __syncthreads();
  cluster_wait();  // every split of the cluster is done with its ring

  // Each split owns `per` consecutive elements of the (rows x HD) output
  // and receives every split's partial of them, and every split's (m, l)
  // of every row, by stores into its shared memory; then it combines
  // them from its own shared memory.
  const int n_el = rows * HD, per = (n_el + n_splits - 1) / n_splits;
  for (int e = tid; e < n_el; e += NT) {
    const int owner = e / per;
    cluster.map_shared_rank(recv, owner)[split * per + e - owner * per] = bacc[e];
  }
  for (int i = tid; i < n_splits * rows; i += NT) {
    const int owner = i / rows, r = i % rows;
    cluster.map_shared_rank(rm, owner)[split * MAX_ROWS + r] = bm[r];
    cluster.map_shared_rank(rl, owner)[split * MAX_ROWS + r] = bl[r];
  }
  cluster_arrive();
  cluster_wait();  // every store into this block has landed

  // Exact logsumexp combine over the splits, in split order: a dead split
  // (m = -1e30, l = 0) weighs exp(-1e30 - m) = 0 next to a live one; a lane
  // with no live split has l = 0 everywhere and gives 0.
  const int e_lo = split * per, e_hi = min(n_el, e_lo + per);
  for (int e = e_lo + tid; e < e_hi; e += NT) {
    const int r = e / HD;
    float m = NEG_INF;
    for (int s = 0; s < n_splits; ++s) m = fmaxf(m, rm[s * MAX_ROWS + r]);
    float a = 0.f, l = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float wgt = expf(rm[s * MAX_ROWS + r] - m);
      a = fmaf(wgt, recv[s * per + e - e_lo], a);
      l = fmaf(wgt, rl[s * MAX_ROWS + r], l);
    }
    out[((int64_t)b * n_heads + (int64_t)kvh * group + row0) * HD + e] =
        from_f32<T>(a / (l == 0.f ? 1.f : l));
  }
}

// Raises the kernel's dynamic shared memory (and the SM's carveout) and
// allows clusters above 8, once per device.
template <typename T, int HD>
cudaError_t prepare() {
  static uint64_t done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1)) return err;
  err = cudaFuncSetAttribute(flash_decode_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<T, HD>::SMEM);
  if (err == cudaSuccess)  // two blocks of 111 KB an SM at head_dim 128 in bf16
    err = cudaFuncSetAttribute(flash_decode_kernel<T, HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_decode_kernel<T, HD>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

template <typename T, int HD>
cudaLaunchConfig_t config(dim3 grid, int splits, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = Layout<T, HD>::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* lengths, void* out, int batch, int n_heads, int n_kv_heads,
           int num_blocks, int block_size, int max_blocks, int num_splits, int window,
           float softcap, float scale, cudaStream_t stream) {
  cudaError_t err = prepare<T, HD>();
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (n_heads / n_kv_heads + MAX_ROWS - 1) / MAX_ROWS;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, HD>(
      dim3(num_splits, n_kv_heads * row_blocks, batch), num_splits, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, HD>, static_cast<const T*>(q),
                           static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
                           tables, lengths, static_cast<T*>(out), n_heads, n_kv_heads,
                           num_blocks, block_size, max_blocks, row_blocks, window, softcap,
                           scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The largest cluster (16, else 8) of which the card can schedule at least
// one; 0 if neither.
template <typename T, int HD>
int max_cluster() {
  if (prepare<T, HD>() != cudaSuccess) return 0;
  for (int splits = MAX_CLUSTER; splits >= 8; splits /= 2) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config<T, HD>(dim3(splits, 1, 1), splits, 0, &attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, flash_decode_kernel<T, HD>, &cfg) == cudaSuccess &&
        n > 0)
      return splits;
  }
  cudaGetLastError();  // clear a refused query
  return 0;
}

}  // namespace

// q: (B, H, hd); k_pool/v_pool: (num_blocks, block_size, Hkv, hd);
// tables: (B, max_blocks) int32; lengths: (B,) int32; out: (B, H, hd).  All
// contiguous, q and the pools 16-byte aligned.  dtype: 0 float32, 1
// bfloat16; head_dim 64, 80 or 128; any group H / Hkv; 1 <= num_splits <=
// 16 (one cluster per lane and kv head).  Returns a cudaError_t (0 on
// success).
extern "C" int flash_decode(const void* q, const void* k_pool, const void* v_pool,
                            const int* tables, const int* lengths, void* out, int batch,
                            int n_heads, int n_kv_heads, int head_dim, int num_blocks,
                            int block_size, int max_blocks, int num_splits, int dtype,
                            int window, float softcap, float scale, void* stream) {
  if (batch == 0) return (int)cudaSuccess;
  if (num_splits < 1 || num_splits > MAX_CLUSTER || n_kv_heads < 1 || num_blocks < 1 ||
      block_size < 1 || n_heads % n_kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(T, HD)                                                                 \
  return launch<T, HD>(q, k_pool, v_pool, tables, lengths, out, batch, n_heads, n_kv_heads, \
                       num_blocks, block_size, max_blocks, num_splits, window, softcap,     \
                       scale, st)
  if (dtype == repro::DTYPE_F32 && head_dim == 64) REPRO_DECODE(float, 64);
  if (dtype == repro::DTYPE_F32 && head_dim == 80) REPRO_DECODE(float, 80);
  if (dtype == repro::DTYPE_F32 && head_dim == 128) REPRO_DECODE(float, 128);
  if (dtype == repro::DTYPE_BF16 && head_dim == 64) REPRO_DECODE(__nv_bfloat16, 64);
  if (dtype == repro::DTYPE_BF16 && head_dim == 80) REPRO_DECODE(__nv_bfloat16, 80);
  if (dtype == repro::DTYPE_BF16 && head_dim == 128) REPRO_DECODE(__nv_bfloat16, 128);
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}

// The largest split count (cluster size) the current device schedules for
// this head_dim and dtype: 16, 8, or 0 if none.
extern "C" int flash_decode_max_cluster(int head_dim, int dtype) {
#define REPRO_CLUSTER(T, HD) \
  if (head_dim == HD) return max_cluster<T, HD>();
  if (dtype == repro::DTYPE_F32) {
    REPRO_CLUSTER(float, 64)
    REPRO_CLUSTER(float, 80)
    REPRO_CLUSTER(float, 128)
  } else if (dtype == repro::DTYPE_BF16) {
    REPRO_CLUSTER(__nv_bfloat16, 64)
    REPRO_CLUSTER(__nv_bfloat16, 80)
    REPRO_CLUSTER(__nv_bfloat16, 128)
  }
#undef REPRO_CLUSTER
  return 0;
}
