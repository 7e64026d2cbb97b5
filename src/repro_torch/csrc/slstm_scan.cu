// sLSTM scan for Hopper (sm_90a): the stabilised recurrence forward (K7), its
// reverse-time exact VJP (K8), and the dR / db reduction of the backward.
//
// Replaces the TPU kernels `_fwd_kernel` (behind `_fwd_call`, public
// `slstm_scan` / `slstm_scan_fwd_res`) and `_bwd_kernel` (behind
// `slstm_scan_bwd`) in src/repro/kernels/slstm_scan.py.  Same contract:
// gates laid out [i|f|z|o] per head; z = zx + h_prev R + b;
// m' = max(logsigmoid(zf) + m, zi), i = exp(zi - m'), f = exp(logsigmoid(zf)
// + m - m'), c' = f c + i tanh(zz), n' = f n + i, h' = sigmoid(zo) c' /
// max(n', 1e-6), from h = c = m = 0, n = 1; logsigmoid(x) = min(x, 0) -
// log1p(exp(-|x|)).  The forward can write the state entering each chunk of
// `chunk` steps ((Bp, T/chunk, H, hd) float32, Bp = B rounded up to block_b;
// padded rows run the recurrence on zero input).  The backward re-runs each
// chunk forward from that state, then walks it backwards: ties of the max go
// to the forget branch, gradient passes max(n, EPS) only where n >= EPS,
// d logsigmoid(x) = sigmoid(-x).
//
// What bounds it on the card: at the training path's shapes (B 4, T 512,
// H 4, hd 384, float32) the 2 B T H hd 4hd operations of the recurrent
// products (K7: 9.7 GFLOP, 0.144 ms at 67 TFLOP/s; K8 three times that);
// the bytes (zx, h, R) take a sixth of it.  But the T steps depend on each
// other, so the latency of one step bounds any design: the product of a few
// rows of h with one head's R (hd x 4hd float32, 2.25 MiB at hd 384).
//
// The design: one thread-block cluster of `cs` blocks (one block an SM, up
// to 16) runs one (row block, head), so a step's product is spread over cs
// SMs and R never leaves shared memory.  Block r owns the hidden units
// [r u, (r + 1) u), u = ceil(hd / cs) (the last block may own fewer): at the
// start it copies its slice of R, the 4u gate columns {g hd + j} of all hd
// rows k, into shared memory as Rs[k][4 jj + g] (the four gates of a unit
// side by side), 147,456 bytes at hd 384 and cs 16.  The row stride is 4u,
// padded by 4 floats where u is even, so it is an odd number of 16-byte
// words: the forward reads a row along its columns and the backward reads a
// column along k, and both are free of bank conflicts.  Where the slice does
// not fit (hd above ~440), its first `kres` rows stay resident and the rest
// is read from L2 in the same loops.  Each block holds the whole h entering
// the step for its NR rows, double-buffered, so one cluster barrier a step
// is enough:
//
// * K7 step: the block's 512 threads each take one unit's 4 gate columns
//   and one of `slices` interleaved k-slices (k = s, s + slices, ...), sum
//   h[k] R[k] over their slice in order and leave the partial sums in
//   shared memory; the thread of (row, unit) adds the slices in slice order
//   to zx + b, runs `cell_step`, keeps (c, n, m) in registers and writes
//   its new h into the block's next h buffer; then the block's threads copy
//   its units' h, contiguous in that buffer, into every other block's
//   (distributed shared memory, 16-byte stores), and the cluster barrier.
// * K8 pass 1 re-runs a chunk with the same step, stashing z and the
//   entering (c, n, m) (7 floats a row and unit) in device memory, private
//   to the thread that writes and reads them, and the entering h into
//   `hprev`.  Pass 2 walks the chunk backwards: the thread of (row, unit)
//   forms dz (the gating VJP), then thread k forms its block's partial of
//   dh_{t-1}[k] = sum over the block's 4u columns of dz R[k], from the same
//   resident slice (no R^T), and stores it into the receive slot of the
//   block that owns unit k; after the cluster barrier each block adds its
//   cs received partials in rank order.  Fixed orders and no atomics: the
//   backward gives the same bits on every run.
//
// The entering h of every step goes to an output, from which a second
// kernel, a shared-memory-tiled float32 product in a fixed order, forms
// dR = sum_{b,t} h_prev^T dz and db = sum dz.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr float EPS = 1e-6f;
constexpr int MAX_ROWS = 8;         // block_b: rows of one cluster
constexpr int MAX_HD = 512;
constexpr int STASH = 7;            // per step, row and unit: zi, zf, zz, zo, c, n, m
constexpr int NT = 512;             // threads a block
constexpr int MAX_CLUSTER = 16;     // blocks a cluster (non-portable above 8)
constexpr int MAX_SLICES = 16;      // k-slices of the forward product
constexpr int RED_FLOATS = 6144;    // the forward product's partial sums: 24 KB

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

struct Cell {
  float h, c, n, m;
};

// One stabilised step from the gate pre-activations z = (zi, zf, zz, zo).
__device__ __forceinline__ Cell cell_step(const float z[4], float c, float n, float m) {
  const float logf_ = log_sigmoid(z[1]);
  const float m_new = fmaxf(logf_ + m, z[0]);
  const float i_t = expf(z[0] - m_new);
  const float f_t = expf(logf_ + m - m_new);
  Cell s;
  s.c = f_t * c + i_t * tanhf(z[2]);
  s.n = f_t * n + i_t;
  s.m = m_new;
  s.h = sigmoid(z[3]) * s.c / fmaxf(s.n, EPS);
  return s;
}

constexpr int round4(int x) { return (x + 3) & ~3; }

// One block's share of a head and its shared memory, in floats:
// Rs [kres][stride] | h [2][hstride] ([hd][NR] used) | exchange region.
// hstride is hd NR rounded up to 4 floats, so both h buffers start on 16
// bytes.  The exchange region holds the forward product's partial sums
// [slices][NR][4u]; in the backward's pass 2, dz [NR][4u] and the receive
// slots [2][cs][NR][u].
struct Geometry {
  int hd, cs, u, stride, hstride, kres, slices;
  int h_off, x_off, recv_off;
  int smem;  // bytes
};

Geometry make_geometry(int hd, int nr, int cs, bool backward, int smem_max) {
  Geometry g;
  g.hd = hd, g.cs = cs;
  g.u = (hd + cs - 1) / cs;
  g.stride = 4 * g.u + (g.u % 2 == 0 ? 4 : 0);
  g.slices = std::max(1, std::min({MAX_SLICES, NT / g.u, RED_FLOATS / (4 * nr * g.u)}));
  const int red = g.slices * nr * 4 * g.u;
  const int dzs = round4(nr * 4 * g.u);
  const int xch = round4(backward ? std::max(red, dzs + 2 * cs * nr * g.u) : red);
  g.hstride = round4(hd * nr);
  const int hf = 2 * g.hstride;
  g.kres = std::max(0, std::min(hd, (smem_max / 4 - hf - xch) / g.stride));
  g.h_off = g.kres * g.stride;
  g.x_off = g.h_off + hf;
  g.recv_off = g.x_off + dzs;
  g.smem = 4 * (g.x_off + xch);
  return g;
}

__device__ __forceinline__ int64_t seq_index(int row, int t, int head, int t_len,
                                             int n_heads) {
  return ((int64_t)row * t_len + t) * n_heads + head;
}

// The NR rows of h[k] (hs + k NR), 16 bytes at a time where NR allows.
template <int NR>
__device__ __forceinline__ void load_rows(const float* p, float v[NR]) {
  if constexpr (NR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NR; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    }
  } else if constexpr (NR == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int NR>
__device__ __forceinline__ void fma_rows(const float hv[NR], float r0, float r1, float r2,
                                         float r3, float acc[NR][4]) {
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    acc[rr][0] = fmaf(hv[rr], r0, acc[rr][0]);
    acc[rr][1] = fmaf(hv[rr], r1, acc[rr][1]);
    acc[rr][2] = fmaf(hv[rr], r2, acc[rr][2]);
    acc[rr][3] = fmaf(hv[rr], r3, acc[rr][3]);
  }
}

// Loads this block's slice of the head's R into Rs (zero columns past the
// last unit); cluster rank `rank`.
__device__ __forceinline__ void load_slice(const Geometry& g, const float* __restrict__ R,
                                           float* rs, int rank) {
  const int hd4 = 4 * g.hd, u = g.u;
  for (int idx = threadIdx.x; idx < g.kres * 4 * u; idx += NT) {
    const int k = idx / (4 * u), rem = idx % (4 * u), gate = rem / u, jj = rem % u;
    const int j = rank * u + jj;
    rs[k * g.stride + 4 * jj + gate] = j < g.hd ? __ldg(R + (int64_t)k * hd4 + gate * g.hd + j) : 0.f;
  }
}

// The forward product of one step: thread (slice s, unit jj) sums
// h[k] R[k][4 jj + g] over k = s, s + slices, ... in that order (resident
// rows from Rs, the rest from R in device memory) and stores its NR x 4
// partial sums at red[s][row][4 jj + g].
template <int NR>
__device__ __forceinline__ void fwd_product(const Geometry& g, const float* rs,
                                            const float* hs, const float* __restrict__ R,
                                            float* red, int rank) {
  const int s = threadIdx.x / g.u, jj = threadIdx.x % g.u;
  if (s >= g.slices) return;
  float acc[NR][4];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[rr][q] = 0.f;
  int k = s;
#pragma unroll 4
  for (; k < g.kres; k += g.slices) {
    const float4 rv = *reinterpret_cast<const float4*>(rs + k * g.stride + 4 * jj);
    float hv[NR];
    load_rows<NR>(hs + k * NR, hv);
    fma_rows<NR>(hv, rv.x, rv.y, rv.z, rv.w, acc);
  }
  const int j = rank * g.u + jj;
  if (j < g.hd) {
    for (; k < g.hd; k += g.slices) {  // rows of the slice that did not fit
      const float* rk = R + (int64_t)k * 4 * g.hd + j;
      float hv[NR];
      load_rows<NR>(hs + k * NR, hv);
      fma_rows<NR>(hv, __ldg(rk), __ldg(rk + g.hd), __ldg(rk + 2 * g.hd),
                   __ldg(rk + 3 * g.hd), acc);
    }
  }
#pragma unroll
  for (int rr = 0; rr < NR; ++rr)
    *reinterpret_cast<float4*>(red + ((s * NR + rr) * g.u + jj) * 4) =
        make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
}

// sum over slices, in slice order, of the partial sums of (row, unit jj)
template <int NR>
__device__ __forceinline__ float4 slice_sum(const Geometry& g, const float* red, int rr,
                                            int jj) {
  float4 a = *reinterpret_cast<const float4*>(red + (rr * g.u + jj) * 4);
  for (int s = 1; s < g.slices; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(red + ((s * NR + rr) * g.u + jj) * 4);
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  }
  return a;
}

// Barriers of the thread-block cluster, apart: arrive (releasing this
// thread's earlier writes, distributed shared memory included), then wait
// (acquiring the peers').
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();  // the .aligned barrier wants the warp converged
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Copies this block's units of the h buffer `hbuf` ([hd][NR], the block's
// own part written, 16-byte aligned) into the same place of every other
// block of the cluster: neighbouring threads store neighbouring words of one
// peer, 16 bytes each where the alignment allows.
template <int NR>
__device__ __forceinline__ void push_h(cg::cluster_group& cluster, const Geometry& g,
                                       float* hbuf, int rank) {
  float* mine = hbuf + rank * g.u * NR;
  const int n = max(0, min(g.u, g.hd - rank * g.u)) * NR;  // floats of this block's units
  const int others = g.cs - 1;
  if (reinterpret_cast<uintptr_t>(mine) % 16 == 0 && n % 4 == 0) {
    const int nv = n / 4;
    for (int idx = threadIdx.x; idx < others * nv; idx += NT) {
      const int q = idx / nv, w = idx - q * nv;
      reinterpret_cast<float4*>(cluster.map_shared_rank(mine, q + (q >= rank)))[w] =
          reinterpret_cast<const float4*>(mine)[w];
    }
  } else {
    for (int idx = threadIdx.x; idx < others * n; idx += NT) {
      const int q = idx / n, w = idx - q * n;
      cluster.map_shared_rank(mine, q + (q >= rank))[w] = mine[w];
    }
  }
}

// The per-block pieces every kernel derives from its position.
struct Place {
  int rank, head, row0;
  int rr, jj, j;  // this thread's (row, unit) pair, j = rank u + jj
  bool pair;      // a pair of an existing unit (rr < NR, j < hd)
};

template <int NR>
__device__ __forceinline__ Place place(const Geometry& g, const cg::cluster_group& cluster,
                                       int bb) {
  Place p;
  p.rank = (int)cluster.block_rank();
  p.head = blockIdx.y;
  p.row0 = (blockIdx.x / g.cs) * bb;
  p.rr = threadIdx.x / g.u, p.jj = threadIdx.x % g.u;
  p.j = p.rank * g.u + p.jj;
  p.pair = p.rr < NR && p.j < g.hd;
  return p;
}

// K7: grid (Bp / bb * cs, H), cluster (cs, 1, 1), NT threads.  zx (B, T, H,
// 4hd), R (H, hd, 4hd), bias (H, 4hd), out (B, T, H, hd); hb/cb/nb/mb (Bp,
// nt, H, hd) or null.
template <typename T, int NR>
__global__ void __launch_bounds__(NT, 1) slstm_fwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ r, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ hb, float* __restrict__ cb,
    float* __restrict__ nb, float* __restrict__ mb, Geometry g, int batch, int t_len,
    int n_heads, int bb, int chunk, int nt) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place p = place<NR>(g, cluster, bb);
  const int hd = g.hd, hd4 = 4 * hd, head = p.head;
  const float* R = r + (int64_t)head * hd * hd4;
  float* rs = smem;
  float* hs = smem + g.h_off;
  float* red = smem + g.x_off;
  load_slice(g, R, rs, p.rank);
  for (int i = threadIdx.x; i < hd * NR; i += NT) hs[i] = 0.f;
  const int row = p.row0 + p.rr;
  const bool own = p.pair && p.rr < bb, live = own && row < batch;
  float bj[4] = {0.f, 0.f, 0.f, 0.f}, z[4] = {0.f, 0.f, 0.f, 0.f};
  if (p.pair) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bj[q] = bias[(int64_t)head * hd4 + q * hd + p.j];
  }
  if (live) {
    const T* zp = zx + seq_index(row, 0, head, t_len, n_heads) * hd4 + p.j;
#pragma unroll
    for (int q = 0; q < 4; ++q) z[q] = to_f32(zp[q * hd]);
  }
  float h = 0.f, c = 0.f, n = 1.f, m = 0.f;
  cluster.sync();  // every block has started and zeroed its h
  int cur = 0;
  for (int t = 0; t < t_len; ++t) {
    fwd_product<NR>(g, rs, hs + cur * g.hstride, R, red, p.rank);
    __syncthreads();
    const int nxt = cur ^ 1;
    const Cell in = {h, c, n, m};  // the state entering the step
    if (p.pair) {
      const float4 a = slice_sum<NR>(g, red, p.rr, p.jj);
      const float zz[4] = {(z[0] + a.x) + bj[0], (z[1] + a.y) + bj[1],
                           (z[2] + a.z) + bj[2], (z[3] + a.w) + bj[3]};
      const Cell s = cell_step(zz, c, n, m);
      h = s.h, c = s.c, n = s.n, m = s.m;
      hs[nxt * g.hstride + p.j * NR + p.rr] = h;
    }
    __syncthreads();
    push_h<NR>(cluster, g, hs + nxt * g.hstride, p.rank);
    // Device-memory traffic waits until after the arrive, whose release
    // would otherwise wait for it: it overlaps the barrier instead.
    cluster_arrive();
    if (own && hb != nullptr && t % chunk == 0) {
      const int64_t i = (((int64_t)row * nt + t / chunk) * n_heads + head) * hd + p.j;
      hb[i] = in.h, cb[i] = in.c, nb[i] = in.n, mb[i] = in.m;
    }
    if (live) {
      out[seq_index(row, t, head, t_len, n_heads) * hd + p.j] = from_f32<T>(h);
      if (t + 1 < t_len) {  // the next step's input, in flight across the barrier
        const T* zp = zx + seq_index(row, t + 1, head, t_len, n_heads) * hd4 + p.j;
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = to_f32(zp[q * hd]);
      }
    }
    cluster_wait();
    cur = nxt;
  }
}

// K8: grid and cluster as K7.  Inputs as K7 plus the chunk-entering states
// and dh (B, T, H, hd).  Writes dzx (B, T, H, 4hd) in zx's type, dz32 (the
// same in float32) unless null, the entering h of every step hprev (B, T, H,
// hd) float32; scratch holds (Bp / bb) H chunk NR STASH hd floats.  Padded
// rows carry zero adjoints and are skipped.
template <typename T, int NR>
__global__ void __launch_bounds__(NT, 1) slstm_bwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ r, const float* __restrict__ bias,
    const float* __restrict__ hb, const float* __restrict__ cb,
    const float* __restrict__ nb, const float* __restrict__ mb, const T* __restrict__ dh,
    T* __restrict__ dzx, float* __restrict__ dz32, float* __restrict__ hprev,
    float* __restrict__ scratch, Geometry g, int batch, int t_len, int n_heads, int bb,
    int chunk, int nt) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Place p = place<NR>(g, cluster, bb);
  const int hd = g.hd, hd4 = 4 * hd, head = p.head, u = g.u, cs = g.cs;
  const float* R = r + (int64_t)head * hd * hd4;
  float* rs = smem;
  float* hs = smem + g.h_off;
  float* red = smem + g.x_off;   // pass 1: the product's partial sums
  float* dzs = smem + g.x_off;   // pass 2: dz of the step, [NR][4u]
  float* recv = smem + g.recv_off;  // pass 2: [2][cs][NR][u] partials of dh
  const int row_block = blockIdx.x / cs;
  float* scr = scratch + ((int64_t)row_block * n_heads + head) * chunk * NR * STASH * hd;
  load_slice(g, R, rs, p.rank);
  const int row = p.row0 + p.rr;
  const bool live = p.pair && p.rr < bb && row < batch;
  float bj[4] = {0.f, 0.f, 0.f, 0.f};
  if (p.pair) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bj[q] = bias[(int64_t)head * hd4 + q * hd + p.j];
  }
  float dh_s = 0.f, dc_s = 0.f, dn_s = 0.f, dm_s = 0.f;  // adjoints carried back in time
  cluster.sync();  // every block has started
  int dbuf = 0;
  for (int tc = nt - 1; tc >= 0; --tc) {
    const int lo = tc * chunk, hi = min(lo + chunk, t_len);
    // pass 1: re-run the chunk forward from its entering state, stashing z
    // and the entering (c, n, m) per step, the entering h into hprev
    for (int i = threadIdx.x; i < hd * NR; i += NT) {
      const int k = i / NR, rrow = p.row0 + i % NR;
      hs[i] = i % NR < bb && rrow < batch
                  ? hb[(((int64_t)rrow * nt + tc) * n_heads + head) * hd + k]
                  : 0.f;
    }
    float h = 0.f, c = 0.f, n = 1.f, m = 0.f, z[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const int64_t i = (((int64_t)row * nt + tc) * n_heads + head) * hd + p.j;
      h = hb[i], c = cb[i], n = nb[i], m = mb[i];
      const T* zp = zx + seq_index(row, lo, head, t_len, n_heads) * hd4 + p.j;
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] = to_f32(zp[q * hd]);
    }
    __syncthreads();
    int cur = 0;
    for (int t = lo; t < hi; ++t) {
      fwd_product<NR>(g, rs, hs + cur * g.hstride, R, red, p.rank);
      __syncthreads();
      const int nxt = cur ^ 1;
      float zz[4] = {0.f, 0.f, 0.f, 0.f};
      const Cell in = {h, c, n, m};  // the state entering the step
      if (p.pair) {
        const float4 a = slice_sum<NR>(g, red, p.rr, p.jj);
        zz[0] = (z[0] + a.x) + bj[0], zz[1] = (z[1] + a.y) + bj[1];
        zz[2] = (z[2] + a.z) + bj[2], zz[3] = (z[3] + a.w) + bj[3];
        const Cell st = cell_step(zz, c, n, m);
        hs[nxt * g.hstride + p.j * NR + p.rr] = st.h;
        h = st.h, c = st.c, n = st.n, m = st.m;
      }
      __syncthreads();
      push_h<NR>(cluster, g, hs + nxt * g.hstride, p.rank);
      cluster_arrive();  // device memory after it, as in K7
      if (live) {
        float* s = scr + ((int64_t)(t - lo) * NR + p.rr) * STASH * hd + p.j;
        s[0] = zz[0], s[hd] = zz[1], s[2 * hd] = zz[2], s[3 * hd] = zz[3];
        s[4 * hd] = in.c, s[5 * hd] = in.n, s[6 * hd] = in.m;
        hprev[seq_index(row, t, head, t_len, n_heads) * hd + p.j] = in.h;
      }
      if (live && t + 1 < hi) {
        const T* zp = zx + seq_index(row, t + 1, head, t_len, n_heads) * hd4 + p.j;
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = to_f32(zp[q * hd]);
      }
      cluster_wait();
      cur = nxt;
    }
    // pass 2: the exact VJP of the gating math, last step first
    float st[STASH], dh_in = 0.f;
    auto fetch = [&](int t) {  // the step's stash and dh, ahead of their use
      const float* s = scr + ((int64_t)(t - lo) * NR + p.rr) * STASH * hd + p.j;
#pragma unroll
      for (int q = 0; q < STASH; ++q) st[q] = s[q * hd];
      dh_in = to_f32(dh[seq_index(row, t, head, t_len, n_heads) * hd + p.j]);
    };
    if (live) fetch(hi - 1);
    for (int t = hi - 1; t >= lo; --t) {
      float dz[4] = {0.f, 0.f, 0.f, 0.f};
      if (p.pair) {
        if (live) {
          const float zi = st[0], zf = st[1], zg = st[2], zo = st[3];
          const float c_prev = st[4], n_prev = st[5], m_prev = st[6];
          const float a = log_sigmoid(zf) + m_prev;
          const float mm = fmaxf(a, zi);
          const float i_t = expf(zi - mm), f_t = expf(a - mm);
          const float tz = tanhf(zg);
          const float ct = f_t * c_prev + i_t * tz;
          const float n_t = f_t * n_prev + i_t;
          const float nd = fmaxf(n_t, EPS);
          const float so = sigmoid(zo);
          const float hdn = ct / nd;
          const float dht = dh_s + dh_in;
          dz[3] = dht * hdn * so * (1.f - so);
          const float dct = dht * so / nd + dc_s;
          const float dnt = dn_s - (n_t >= EPS ? dht * so * hdn / nd : 0.f);
          const float df = dct * c_prev + dnt * n_prev;
          const float di = dct * tz + dnt;
          dz[2] = dct * i_t * (1.f - tz * tz);
          const float dm = dm_s - di * i_t - df * f_t;
          const bool sel = a >= zi;  // ties of the max: the forget branch
          const float da = df * f_t + (sel ? dm : 0.f);
          dz[0] = di * i_t + (sel ? 0.f : dm);
          dz[1] = da * sigmoid(-zf);
          dc_s = dct * f_t, dn_s = dnt * f_t, dm_s = da;
        }
        *reinterpret_cast<float4*>(dzs + (p.rr * u + p.jj) * 4) =
            make_float4(dz[0], dz[1], dz[2], dz[3]);
      } else if (threadIdx.x < NR * u) {  // a unit past hd: zero columns
        *reinterpret_cast<float4*>(dzs + threadIdx.x * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      // this block's part of dh_{t-1}[k] = sum over its columns of dz R[k],
      // columns in order, to the block that owns unit k
      const int k = threadIdx.x;
      if (k < hd) {
        float acc[NR];
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) acc[rr] = 0.f;
        if (k < g.kres) {
          const float* rk = rs + k * g.stride;
#pragma unroll 4
          for (int c4 = 0; c4 < u; ++c4) {
            const float4 rv = *reinterpret_cast<const float4*>(rk + 4 * c4);
#pragma unroll
            for (int rr = 0; rr < NR; ++rr) {
              const float4 dv = *reinterpret_cast<const float4*>(dzs + (rr * u + c4) * 4);
              acc[rr] = fmaf(dv.x, rv.x, acc[rr]);
              acc[rr] = fmaf(dv.y, rv.y, acc[rr]);
              acc[rr] = fmaf(dv.z, rv.z, acc[rr]);
              acc[rr] = fmaf(dv.w, rv.w, acc[rr]);
            }
          }
        } else {  // a row of the slice that did not fit
          const float* rk = R + (int64_t)k * hd4 + p.rank * u;
          const int own_units = min(u, hd - p.rank * u);
          for (int c4 = 0; c4 < own_units; ++c4) {
            const float r0 = __ldg(rk + c4), r1 = __ldg(rk + hd + c4),
                        r2 = __ldg(rk + 2 * hd + c4), r3 = __ldg(rk + 3 * hd + c4);
#pragma unroll
            for (int rr = 0; rr < NR; ++rr) {
              const float4 dv = *reinterpret_cast<const float4*>(dzs + (rr * u + c4) * 4);
              acc[rr] = fmaf(dv.x, r0, acc[rr]);
              acc[rr] = fmaf(dv.y, r1, acc[rr]);
              acc[rr] = fmaf(dv.z, r2, acc[rr]);
              acc[rr] = fmaf(dv.w, r3, acc[rr]);
            }
          }
        }
        const int owner = k / u, kk = k - owner * u;
        float* slot = cluster.map_shared_rank(recv, owner) +
                      ((dbuf * cs + p.rank) * NR) * u + kk;
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) slot[rr * u] = acc[rr];
      }
      cluster_arrive();  // device memory after it, as in K7
      if (live) {
        const int64_t at = seq_index(row, t, head, t_len, n_heads);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dzx[at * hd4 + q * hd + p.j] = from_f32<T>(dz[q]);
          if (dz32 != nullptr) dz32[at * hd4 + q * hd + p.j] = dz[q];
        }
        if (t > lo) fetch(t - 1);
      }
      cluster_wait();
      if (p.pair) {  // the cs partials of dh for this unit, in rank order
        const float* in = recv + (dbuf * cs * NR + p.rr) * u + p.jj;
        float sum = in[0];
        for (int q = 1; q < cs; ++q) sum += in[q * NR * u];
        dh_s = sum;
      }
      dbuf ^= 1;
    }
  }
}

constexpr int TILE = 64;  // reduction: a 64 x 64 output tile per block
constexpr int TN = 16;    // rows (b, t) per shared-memory stage
constexpr int RED_THREADS = 256;

// dR[h][k][col] (k < hd) and db[h][col] (k == hd) = sum over the nrows rows
// n = b T + t of a[n][k] dz[n][h][col], a = hprev[n][h][k] for k < hd and
// 1 for k == hd; each output summed by one thread, n = 0, 1, ... in order.
// grid (4hd / 64, (hd + 1) / 64 rounded up, H).
__global__ void __launch_bounds__(RED_THREADS) slstm_dr_kernel(
    const float* __restrict__ hprev, const float* __restrict__ dz,
    float* __restrict__ dr, float* __restrict__ db, int nrows, int n_heads, int hd) {
  __shared__ __align__(16) float as[TN][TILE];
  __shared__ __align__(16) float bs[TN][TILE];
  const int hd4 = 4 * hd, head = blockIdx.z;
  const int k0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int n0 = 0; n0 < nrows; n0 += TN) {
    for (int idx = threadIdx.x; idx < TN * TILE; idx += RED_THREADS) {
      const int nn = idx / TILE, kk = idx % TILE, n = n0 + nn;
      const int k = k0 + kk, col = c0 + kk;
      float a = 0.f, b = 0.f;
      if (n < nrows) {
        const int64_t row = (int64_t)n * n_heads + head;
        a = k < hd ? hprev[row * hd + k] : (k == hd ? 1.f : 0.f);
        if (col < hd4) b = dz[row * hd4 + col];
      }
      as[nn][kk] = a;
      bs[nn][kk] = b;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < TN; ++nn) {
      const float4 av = *reinterpret_cast<const float4*>(&as[nn][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[nn][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a4[i], b4[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c0 + tx * 4 + q;
      if (col >= hd4) continue;
      if (k < hd) dr[((int64_t)head * hd + k) * hd4 + col] = acc[i][q];
      else if (k == hd) db[(int64_t)head * hd4 + col] = acc[i][q];
    }
  }
}

int rows_compiled(int bb) {
  return bb <= 1 ? 1 : bb <= 2 ? 2 : bb <= 4 ? 4 : bb <= MAX_ROWS ? 8 : 0;
}

// The largest dynamic shared memory a block of this device may use.
cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Raises the kernel's dynamic shared memory to the device's limit (and the
// SM's carveout) and allows clusters above 8, once per device.
template <typename K>
cudaError_t prepare(K kernel, uint64_t* done, int smem_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (*done >> dev & 1)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) *done |= 1ull << dev;
  return err;
}

template <typename T, int NR, bool BWD>
struct Kernel {
  static void* fn() {
    return BWD ? reinterpret_cast<void*>(slstm_bwd_kernel<T, NR>)
               : reinterpret_cast<void*>(slstm_fwd_kernel<T, NR>);
  }
  static cudaError_t ready(int smem_max) {
    static uint64_t done = 0;
    if constexpr (BWD) return prepare(slstm_bwd_kernel<T, NR>, &done, smem_max);
    else return prepare(slstm_fwd_kernel<T, NR>, &done, smem_max);
  }
};

cudaLaunchConfig_t config(dim3 grid, int cs, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The geometry of a launch, after the checks every entry makes: 1 <= hd <=
// 512, 1 <= cs <= 16, and every (row, unit) pair of a block has a thread;
// then the kernel made ready for it.
template <typename T, int NR, bool BWD>
cudaError_t plan(int hd, int cs, Geometry* g) {
  if (hd < 1 || hd > MAX_HD || cs < 1 || cs > MAX_CLUSTER) return cudaErrorInvalidValue;
  if (NR * ((hd + cs - 1) / cs) > NT) return cudaErrorInvalidValue;
  int smem_max = 0;
  cudaError_t err = smem_limit(&smem_max);
  if (err == cudaSuccess) err = Kernel<T, NR, BWD>::ready(smem_max);
  if (err == cudaSuccess) *g = make_geometry(hd, NR, cs, BWD, smem_max);
  return err;
}

template <typename T, int NR>
int launch_fwd(const void* zx, const float* r, const float* bias, void* out, float* hb,
               float* cb, float* nb, float* mb, int batch, int t_len, int n_heads, int hd,
               int bb, int chunk, int cs, cudaStream_t stream) {
  Geometry g;
  cudaError_t err = plan<T, NR, false>(hd, cs, &g);
  if (err != cudaSuccess) return (int)err;
  const int nt = (t_len + chunk - 1) / chunk;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(dim3((batch + bb - 1) / bb * cs, n_heads), cs, g.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, slstm_fwd_kernel<T, NR>, static_cast<const T*>(zx), r,
                           bias, static_cast<T*>(out), hb, cb, nb, mb, g, batch, t_len,
                           n_heads, bb, chunk, nt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int NR>
int launch_bwd(const void* zx, const float* r, const float* bias, const float* hb,
               const float* cb, const float* nb, const float* mb, const void* dh,
               void* dzx, float* dz32, float* hprev, float* scratch, float* dr, float* db,
               int batch, int t_len, int n_heads, int hd, int bb, int chunk, int cs,
               cudaStream_t stream) {
  Geometry g;
  cudaError_t err = plan<T, NR, true>(hd, cs, &g);
  if (err != cudaSuccess) return (int)err;
  const int nt = (t_len + chunk - 1) / chunk;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(dim3((batch + bb - 1) / bb * cs, n_heads), cs, g.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, slstm_bwd_kernel<T, NR>, static_cast<const T*>(zx), r,
                           bias, hb, cb, nb, mb, static_cast<const T*>(dh),
                           static_cast<T*>(dzx), dz32, hprev, scratch, g, batch, t_len,
                           n_heads, bb, chunk, nt);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((4 * hd + TILE - 1) / TILE, (hd + 1 + TILE - 1) / TILE, n_heads);
  slstm_dr_kernel<<<rgrid, RED_THREADS, 0, stream>>>(
      hprev, dz32 != nullptr ? dz32 : static_cast<const float*>(dzx), dr, db,
      batch * t_len, n_heads, hd);
  return (int)cudaGetLastError();
}

template <typename T, int NR, bool BWD>
int query(int hd, int cs, int* info) {
  Geometry g;
  const cudaError_t err = plan<T, NR, BWD>(hd, cs, &g);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(cs, 1, 1), cs, g.smem, 0, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, Kernel<T, NR, BWD>::fn(), &cfg) !=
      cudaSuccess) {
    cudaGetLastError();  // clear a refused query: the size does not schedule
    clusters = 0;
  }
  info[0] = clusters, info[1] = g.kres, info[2] = g.smem, info[3] = g.slices, info[4] = g.u;
  info[5] = NT;
  return (int)cudaSuccess;
}

}  // namespace

// zx: (B, T, H, 4hd) float32 or bfloat16 (dtype 0 / 1), r: (H, hd, 4hd) and
// bias: (H, 4hd) float32, out: (B, T, H, hd) in zx's type; hb, cb, nb, mb:
// (Bp, ceil(T / chunk), H, hd) float32, all four or none (null).  All
// contiguous; 1 <= bb <= 8, 1 <= hd <= 512; cs blocks a cluster (1 to 16,
// rows x ceil(hd / cs) <= 512).  Returns a cudaError_t: one for a cluster
// size the card does not schedule.
extern "C" int slstm_fwd(const void* zx, const float* r, const float* bias, void* out,
                         float* hb, float* cb, float* nb, float* mb, int batch, int t_len,
                         int n_heads, int hd, int bb, int chunk, int cs, int dtype,
                         void* stream) {
  if (batch == 0 || t_len == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(T, NR)                                                                 \
  return launch_fwd<T, NR>(zx, r, bias, out, hb, cb, nb, mb, batch, t_len, n_heads, hd, \
                           bb, chunk, cs, st)
#define REPRO_ROWS(T)                       \
  switch (rows_compiled(bb)) {              \
    case 1: REPRO_FWD(T, 1);                \
    case 2: REPRO_FWD(T, 2);                \
    case 4: REPRO_FWD(T, 4);                \
    case 8: REPRO_FWD(T, 8);                \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == repro::DTYPE_F32) REPRO_ROWS(float);
  if (dtype == repro::DTYPE_BF16) REPRO_ROWS(__nv_bfloat16);
#undef REPRO_ROWS
#undef REPRO_FWD
  return (int)cudaErrorInvalidValue;
}

// K8 and the dR / db reduction.  Inputs as slstm_fwd plus the four
// chunk-entering states, dh: (B, T, H, hd) in zx's type.  Outputs dzx: (B,
// T, H, 4hd) in zx's type, dr: (H, hd, 4hd) and db: (H, 4hd) float32.
// Scratch: dz32 (B, T, H, 4hd) float32 for a bfloat16 zx, null for float32
// (the reduction then reads dzx); hprev (B, T, H, hd) float32; stash (Bp /
// bb, H, chunk, NR, 7, hd) float32 with NR = bb rounded up to 1, 2, 4 or 8.
// Returns a cudaError_t.
extern "C" int slstm_bwd(const void* zx, const float* r, const float* bias,
                         const float* hb, const float* cb, const float* nb,
                         const float* mb, const void* dh, void* dzx, float* dz32,
                         float* hprev, float* stash, float* dr, float* db, int batch,
                         int t_len, int n_heads, int hd, int bb, int chunk, int cs, int dtype,
                         void* stream) {
  if (batch == 0 || t_len == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(T, NR)                                                              \
  return launch_bwd<T, NR>(zx, r, bias, hb, cb, nb, mb, dh, dzx, dz32, hprev, stash,  \
                           dr, db, batch, t_len, n_heads, hd, bb, chunk, cs, st)
#define REPRO_ROWS(T)                       \
  switch (rows_compiled(bb)) {              \
    case 1: REPRO_BWD(T, 1);                \
    case 2: REPRO_BWD(T, 2);                \
    case 4: REPRO_BWD(T, 4);                \
    case 8: REPRO_BWD(T, 8);                \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == repro::DTYPE_F32) {
    if (dz32 != nullptr) return (int)cudaErrorInvalidValue;
    REPRO_ROWS(float);
  }
  if (dtype == repro::DTYPE_BF16) {
    if (dz32 == nullptr) return (int)cudaErrorInvalidValue;
    REPRO_ROWS(__nv_bfloat16);
  }
#undef REPRO_ROWS
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

// What a launch of K7 (backward 0) or K8 (backward 1) with cs blocks a
// cluster would use on the current device: info[0] the clusters of that
// size the card can hold at once (0: it does not schedule), info[1] the
// rows of the R slice resident in shared memory (hd: all), info[2] the
// shared memory bytes a block, info[3] the forward product's k-slices,
// info[4] the units a block, info[5] the threads a block (each (row, unit)
// pair needs one).  Returns a cudaError_t (invalid value for a shape no
// entry takes).
extern "C" int slstm_plan(int hd, int bb, int cs, int dtype, int backward, int* info) {
#define REPRO_Q(T, NR)                                                    \
  return backward ? query<T, NR, true>(hd, cs, info) : query<T, NR, false>(hd, cs, info)
#define REPRO_ROWS(T)                       \
  switch (rows_compiled(bb)) {              \
    case 1: REPRO_Q(T, 1);                  \
    case 2: REPRO_Q(T, 2);                  \
    case 4: REPRO_Q(T, 4);                  \
    case 8: REPRO_Q(T, 8);                  \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == repro::DTYPE_F32) REPRO_ROWS(float);
  if (dtype == repro::DTYPE_BF16) REPRO_ROWS(__nv_bfloat16);
#undef REPRO_ROWS
#undef REPRO_Q
  return (int)cudaErrorInvalidValue;
}
