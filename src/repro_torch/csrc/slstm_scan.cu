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
// other, so in practice the latency of one step bounds this design.
//
// What the design does about R: one head's R is hd x 4hd float32 = 2.25 MiB
// at hd 384, ten times the 227 KB of shared memory a block may use, so it is
// not staged.  One block runs one (row block, head) with one thread per
// hidden unit j, which keeps unit j's (h, c, n, m) of the block's rows in
// registers for the whole sequence.  Each step it streams R from the 50 MB
// L2 (all heads' R, 9.4 MB, stays resident): thread j reads columns j, hd+j,
// 2hd+j, 3hd+j of each row of R, so neighbouring threads read neighbouring
// words, and all rows of the block share that one pass.  h goes through
// shared memory, double-buffered, one __syncthreads a step.  The backward's
// per-step stash (z and the entering c, n, m: 7 floats per row and unit) is
// scratch in device memory, private to the thread that writes and reads it;
// the entering h of every step goes to an output, from which a second
// kernel, a shared-memory-tiled float32 product in a fixed order, forms
// dR = sum_{b,t} h_prev^T dz and db = sum dz.  dh_{t-1} = dz R^T reads R^T
// (transposed once by the wrapper) so that the read is coalesced.  No float
// atomics: the backward gives the same bits on every run.  A faster design
// (R split across a thread-block cluster's shared memory, h exchanged
// through distributed shared memory) is left for a later change.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace repro;

constexpr float EPS = 1e-6f;
constexpr int MAX_ROWS = 8;    // block_b: rows of one block
constexpr int MAX_HD = 512;    // one thread per hidden unit, <= 128 registers each
constexpr int STASH = 7;       // per step, row and unit: zi, zf, zz, zo, c, n, m

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

// acc[r][g] = sum_k hs[k * NR + r] * R[k, g hd + j], k = 0, 1, ... in order.
template <int NR>
__device__ __forceinline__ void recurrent(const float* __restrict__ R, const float* hs,
                                          int hd, int j, float acc[NR][4]) {
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  const int64_t hd4 = 4 * hd;
#pragma unroll 4
  for (int k = 0; k < hd; ++k) {
    const float* rk = R + k * hd4 + j;
    const float r0 = __ldg(rk), r1 = __ldg(rk + hd), r2 = __ldg(rk + 2 * hd),
                r3 = __ldg(rk + 3 * hd);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float hv = hs[k * NR + r];
      acc[r][0] = fmaf(hv, r0, acc[r][0]);
      acc[r][1] = fmaf(hv, r1, acc[r][1]);
      acc[r][2] = fmaf(hv, r2, acc[r][2]);
      acc[r][3] = fmaf(hv, r3, acc[r][3]);
    }
  }
}

__device__ __forceinline__ int64_t seq_index(int row, int t, int head, int t_len,
                                             int n_heads) {
  return ((int64_t)row * t_len + t) * n_heads + head;
}

// K7: grid (Bp / bb, H), hd threads.  zx (B, T, H, 4hd), R (H, hd, 4hd),
// bias (H, 4hd), out (B, T, H, hd); hb/cb/nb/mb (Bp, nt, H, hd) or null.
template <typename T, int NR>
__global__ void __launch_bounds__(MAX_HD) slstm_fwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ r, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ hb, float* __restrict__ cb,
    float* __restrict__ nb, float* __restrict__ mb, int batch, int t_len, int n_heads,
    int hd, int bb, int chunk, int nt) {
  extern __shared__ float hs[];  // [2][hd][NR]: h entering the step
  const int j = threadIdx.x, head = blockIdx.y, row0 = blockIdx.x * bb;
  const int hd4 = 4 * hd;
  const float* R = r + (int64_t)head * hd * hd4;
  float bj[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bj[g] = bias[(int64_t)head * hd4 + g * hd + j];
  float h[NR], c[NR], n[NR], m[NR];
  bool own[NR], live[NR];  // row of this block; row of the input (not padding)
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    h[rr] = 0.f, c[rr] = 0.f, n[rr] = 1.f, m[rr] = 0.f;
    own[rr] = rr < bb;
    live[rr] = own[rr] && row0 + rr < batch;
    hs[j * NR + rr] = 0.f;
  }
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < t_len; ++t) {
    if (hb != nullptr && t % chunk == 0) {
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        if (!own[rr]) continue;
        const int64_t i = (((int64_t)(row0 + rr) * nt + t / chunk) * n_heads + head) * hd + j;
        hb[i] = h[rr], cb[i] = c[rr], nb[i] = n[rr], mb[i] = m[rr];
      }
    }
    float z[NR][4];
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      const T* zp = zx + seq_index(row0 + rr, t, head, t_len, n_heads) * hd4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) z[rr][g] = live[rr] ? to_f32(zp[g * hd]) : 0.f;
    }
    float acc[NR][4];
    recurrent<NR>(R, hs + cur * hd * NR, hd, j, acc);
    const int nxt = cur ^ 1;
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      float zz[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) zz[g] = (z[rr][g] + acc[rr][g]) + bj[g];
      const Cell s = cell_step(zz, c[rr], n[rr], m[rr]);
      h[rr] = s.h, c[rr] = s.c, n[rr] = s.n, m[rr] = s.m;
      hs[(nxt * hd + j) * NR + rr] = s.h;
      if (live[rr])
        out[seq_index(row0 + rr, t, head, t_len, n_heads) * hd + j] = from_f32<T>(s.h);
    }
    __syncthreads();
    cur = nxt;
  }
}

// K8: grid (Bp / bb, H), hd threads.  Inputs as K7 plus R^T (H, 4hd, hd),
// the chunk-entering states and dh (B, T, H, hd).  Writes dzx (B, T, H, 4hd)
// in zx's type, dz32 (the same in float32) unless null, the entering h of
// every step hprev (B, T, H, hd) float32; scratch holds (Bp / bb) H chunk NR
// STASH hd floats.  Padded rows carry zero adjoints and are skipped.
template <typename T, int NR>
__global__ void __launch_bounds__(MAX_HD) slstm_bwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ r, const float* __restrict__ rt,
    const float* __restrict__ bias, const float* __restrict__ hb,
    const float* __restrict__ cb, const float* __restrict__ nb,
    const float* __restrict__ mb, const T* __restrict__ dh, T* __restrict__ dzx,
    float* __restrict__ dz32, float* __restrict__ hprev, float* __restrict__ scratch,
    int batch, int t_len, int n_heads, int hd, int bb, int chunk, int nt) {
  extern __shared__ float smem[];
  float* hs = smem;                 // [2][hd][NR]: h entering the step (pass 1)
  float* dzs = smem + 2 * hd * NR;  // [2][NR][4hd]: dz of the step (pass 2)
  const int j = threadIdx.x, head = blockIdx.y, row0 = blockIdx.x * bb;
  const int hd4 = 4 * hd;
  const float* R = r + (int64_t)head * hd * hd4;
  const float* RT = rt + (int64_t)head * hd4 * hd;
  float* scr = scratch + ((int64_t)blockIdx.x * n_heads + head) * chunk * NR * STASH * hd;
  float bj[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bj[g] = bias[(int64_t)head * hd4 + g * hd + j];
  bool live[NR];
  float dh_s[NR], dc_s[NR], dn_s[NR], dm_s[NR];  // adjoints carried back in time
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    live[rr] = rr < bb && row0 + rr < batch;
    dh_s[rr] = 0.f, dc_s[rr] = 0.f, dn_s[rr] = 0.f, dm_s[rr] = 0.f;
  }
  int dbuf = 0;
  for (int tc = nt - 1; tc >= 0; --tc) {
    const int lo = tc * chunk, hi = min(lo + chunk, t_len);
    // pass 1: re-run the chunk forward from its entering state, stashing z
    // and the entering (c, n, m) per step, the entering h into hprev
    float h[NR], c[NR], n[NR], m[NR];
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      h[rr] = 0.f, c[rr] = 0.f, n[rr] = 1.f, m[rr] = 0.f;
      if (live[rr]) {
        const int64_t i = (((int64_t)(row0 + rr) * nt + tc) * n_heads + head) * hd + j;
        h[rr] = hb[i], c[rr] = cb[i], n[rr] = nb[i], m[rr] = mb[i];
      }
      hs[j * NR + rr] = h[rr];
    }
    __syncthreads();
    int cur = 0;
    for (int t = lo; t < hi; ++t) {
      float z[NR][4];
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        const T* zp = zx + seq_index(row0 + rr, t, head, t_len, n_heads) * hd4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[rr][g] = live[rr] ? to_f32(zp[g * hd]) : 0.f;
      }
      float acc[NR][4];
      recurrent<NR>(R, hs + cur * hd * NR, hd, j, acc);
      const int nxt = cur ^ 1;
      float* sp = scr + (int64_t)(t - lo) * NR * STASH * hd + j;
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        float zz[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) zz[g] = (z[rr][g] + acc[rr][g]) + bj[g];
        if (live[rr]) {
          float* s = sp + rr * STASH * hd;
          s[0] = zz[0], s[hd] = zz[1], s[2 * hd] = zz[2], s[3 * hd] = zz[3];
          s[4 * hd] = c[rr], s[5 * hd] = n[rr], s[6 * hd] = m[rr];
          hprev[seq_index(row0 + rr, t, head, t_len, n_heads) * hd + j] = h[rr];
        }
        const Cell st = cell_step(zz, c[rr], n[rr], m[rr]);
        h[rr] = st.h, c[rr] = st.c, n[rr] = st.n, m[rr] = st.m;
        hs[(nxt * hd + j) * NR + rr] = st.h;
      }
      __syncthreads();
      cur = nxt;
    }
    // pass 2: the exact VJP of the gating math, last step first
    for (int t = hi - 1; t >= lo; --t) {
      const float* sp = scr + (int64_t)(t - lo) * NR * STASH * hd + j;
      float* dzb = dzs + dbuf * NR * hd4;
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        float dz[4] = {0.f, 0.f, 0.f, 0.f};
        if (live[rr]) {
          const float* s = sp + rr * STASH * hd;
          const float zi = s[0], zf = s[hd], zg = s[2 * hd], zo = s[3 * hd];
          const float c_prev = s[4 * hd], n_prev = s[5 * hd], m_prev = s[6 * hd];
          const int64_t at = seq_index(row0 + rr, t, head, t_len, n_heads);
          const float a = log_sigmoid(zf) + m_prev;
          const float mm = fmaxf(a, zi);
          const float i_t = expf(zi - mm), f_t = expf(a - mm);
          const float tz = tanhf(zg);
          const float ct = f_t * c_prev + i_t * tz;
          const float n_t = f_t * n_prev + i_t;
          const float nd = fmaxf(n_t, EPS);
          const float so = sigmoid(zo);
          const float hdn = ct / nd;
          const float dht = dh_s[rr] + to_f32(dh[at * hd + j]);
          dz[3] = dht * hdn * so * (1.f - so);
          const float dct = dht * so / nd + dc_s[rr];
          const float dnt = dn_s[rr] - (n_t >= EPS ? dht * so * hdn / nd : 0.f);
          const float df = dct * c_prev + dnt * n_prev;
          const float di = dct * tz + dnt;
          dz[2] = dct * i_t * (1.f - tz * tz);
          const float dm = dm_s[rr] - di * i_t - df * f_t;
          const bool sel = a >= zi;  // ties of the max: the forget branch
          const float da = df * f_t + (sel ? dm : 0.f);
          dz[0] = di * i_t + (sel ? 0.f : dm);
          dz[1] = da * sigmoid(-zf);
          dc_s[rr] = dct * f_t, dn_s[rr] = dnt * f_t, dm_s[rr] = da;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            dzx[at * hd4 + g * hd + j] = from_f32<T>(dz[g]);
            if (dz32 != nullptr) dz32[at * hd4 + g * hd + j] = dz[g];
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) dzb[rr * hd4 + g * hd + j] = dz[g];
      }
      __syncthreads();
      // dh_{t-1} = dz_t R^T: column j of R^T's rows, col = 0, 1, ... in order
      float acc[NR];
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) acc[rr] = 0.f;
#pragma unroll 4
      for (int col = 0; col < hd4; ++col) {
        const float rv = __ldg(RT + (int64_t)col * hd + j);
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) acc[rr] = fmaf(dzb[rr * hd4 + col], rv, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) dh_s[rr] = acc[rr];
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

template <typename T, int NR>
int launch_fwd(const void* zx, const float* r, const float* bias, void* out, float* hb,
               float* cb, float* nb, float* mb, int batch, int t_len, int n_heads, int hd,
               int bb, int chunk, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)hd * NR * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_fwd_kernel<T, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (t_len + chunk - 1) / chunk;
  const dim3 grid((batch + bb - 1) / bb, n_heads);
  slstm_fwd_kernel<T, NR><<<grid, hd, smem, stream>>>(
      static_cast<const T*>(zx), r, bias, static_cast<T*>(out), hb, cb, nb, mb, batch,
      t_len, n_heads, hd, bb, chunk, nt);
  return (int)cudaGetLastError();
}

template <typename T, int NR>
int launch_bwd(const void* zx, const float* r, const float* rt, const float* bias,
               const float* hb, const float* cb, const float* nb, const float* mb,
               const void* dh, void* dzx, float* dz32, float* hprev, float* scratch,
               float* dr, float* db, int batch, int t_len, int n_heads, int hd, int bb,
               int chunk, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)hd * NR + 2 * (size_t)NR * 4 * hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_bwd_kernel<T, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (t_len + chunk - 1) / chunk;
  const dim3 grid((batch + bb - 1) / bb, n_heads);
  slstm_bwd_kernel<T, NR><<<grid, hd, smem, stream>>>(
      static_cast<const T*>(zx), r, rt, bias, hb, cb, nb, mb, static_cast<const T*>(dh),
      static_cast<T*>(dzx), dz32, hprev, scratch, batch, t_len, n_heads, hd, bb, chunk, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((4 * hd + TILE - 1) / TILE, (hd + 1 + TILE - 1) / TILE, n_heads);
  slstm_dr_kernel<<<rgrid, RED_THREADS, 0, stream>>>(
      hprev, dz32 != nullptr ? dz32 : static_cast<const float*>(dzx), dr, db,
      batch * t_len, n_heads, hd);
  return (int)cudaGetLastError();
}

}  // namespace

// zx: (B, T, H, 4hd) float32 or bfloat16 (dtype 0 / 1), r: (H, hd, 4hd) and
// bias: (H, 4hd) float32, out: (B, T, H, hd) in zx's type; hb, cb, nb, mb:
// (Bp, ceil(T / chunk), H, hd) float32, all four or none (null).  All
// contiguous; 1 <= bb <= 8, 1 <= hd <= 512.  Returns a cudaError_t.
extern "C" int slstm_fwd(const void* zx, const float* r, const float* bias, void* out,
                         float* hb, float* cb, float* nb, float* mb, int batch, int t_len,
                         int n_heads, int hd, int bb, int chunk, int dtype, void* stream) {
  if (batch == 0 || t_len == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(T, NR)                                                                 \
  return launch_fwd<T, NR>(zx, r, bias, out, hb, cb, nb, mb, batch, t_len, n_heads, hd, \
                           bb, chunk, st)
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

// K8 and the dR / db reduction.  Inputs as slstm_fwd plus rt: (H, 4hd, hd)
// float32 (R transposed), the four chunk-entering states, dh: (B, T, H, hd)
// in zx's type.  Outputs dzx: (B, T, H, 4hd) in zx's type, dr: (H, hd, 4hd)
// and db: (H, 4hd) float32.  Scratch: dz32 (B, T, H, 4hd) float32 for a
// bfloat16 zx, null for float32 (the reduction then reads dzx); hprev
// (B, T, H, hd) float32; stash (Bp / bb, H, chunk, NR, 7, hd) float32 with NR
// = bb rounded up to 1, 2, 4 or 8.  Returns a cudaError_t.
extern "C" int slstm_bwd(const void* zx, const float* r, const float* rt,
                         const float* bias, const float* hb, const float* cb,
                         const float* nb, const float* mb, const void* dh, void* dzx,
                         float* dz32, float* hprev, float* stash, float* dr, float* db,
                         int batch, int t_len, int n_heads, int hd, int bb, int chunk,
                         int dtype, void* stream) {
  if (batch == 0 || t_len == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(T, NR)                                                                \
  return launch_bwd<T, NR>(zx, r, rt, bias, hb, cb, nb, mb, dh, dzx, dz32, hprev, stash, \
                           dr, db, batch, t_len, n_heads, hd, bb, chunk, st)
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
