// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py::ssd_scan_bh (body `_kernel`)
// and computes src/repro/models/ssm.py::ssd_reference with the Pallas
// kernel's numerics: per chunk of Q rows, cum = cumsum(dt*a), xdt = x*dt,
// scores C B^T and the decay matrix exp(cum[q] - cum[k]) (k <= q) all in f32;
// y = (scores * decay) @ xdt + exp(cum) * (C @ S_in^T), with S_in the f32
// (P, N) state carried in from the chunks before; the chunk's state update
// S_out = exp(cum[-1]) * S_in + sum_k exp(cum[-1] - cum[k]) xdt[k] (x) b[k].
// A ragged tail counts as dt = 0 (decay 1, zero input: the state is
// unchanged), as the Pallas kernel pads it.
//
// Bound: bytes, at mamba2-130m's widths. At B=1, L=2048 the least work is
// about 2.5 GFLOP (C B^T once per chunk for all heads and only on and below
// the diagonal; per head the weighted scores times x*dt, the chunk states
// and the inter-chunk term) against 14.6 MB moved once (x in, y out, dt, b,
// c, the final state): 0.0025 ms at the bf16 tensor-core peak, 0.0044 ms at
// 3.35 TB/s. This first version computes the scores per head, in f32, on
// CUDA cores, and is far from either.
//
// Design. The TPU grid walks (B*H, chunks) with the chunks in order, which
// gives only B*H = 24 blocks at B=1 for mamba2-130m, against 132 SMs. This
// port takes the reference's own decomposition into three launches, so the
// two heavy passes run in parallel over (b, h, chunk):
//   1. ssd_chunk_state: per (b, h, chunk), the chunk's own state
//      sum_k exp(cum[-1] - cum[k]) xdt[k] (x) b[k] and its total log-decay
//      cum[-1], into f32 scratch;
//   2. ssd_state_pass: per (b, h) and state element, the short sequential
//      pass over the chunks S_in[c] = S; S = exp(tot[c]) * S + chunk[c],
//      writing each chunk's incoming state over its scratch slot and the
//      final state out;
//   3. ssd_chunk_output: per (b, h, chunk, 64-row tile) the intra-chunk
//      term over the key tiles up to the diagonal and the inter-chunk term
//      from S_in. The 256x256 f32 score tile of a full chunk (256 KB) does
//      not fit a block's 227 KB, so the query rows are tiled by 64 and the
//      keys by 64. S_in shares its buffer with the key tiles' b rows
//      (about 100 KB in all at mamba2-130m's P=64, N=128: two blocks fit
//      an SM).
// Each block recomputes the chunk's cumsum (a warp scan over Q values).
// Plain CUDA-core arithmetic staged in shared memory as f32; no wgmma or
// TMA yet.
//
// Layout: x (B, L, H, P), dt (B, L, H), b and c (B, L, N) are read through
// their strides (x's and b/c's innermost dim must be contiguous); b and c
// are shared by all heads and never copied per head. y is a contiguous
// (B, L, H, P) in x's type, the state a contiguous (B, H, P, N) in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int ST = 32;           // rows staged per step in ssd_chunk_state
constexpr int QT = 64;           // query rows (and key rows) per tile in ssd_chunk_output
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int MAX_Q = 1024;
constexpr int PC = MAX_P / 16;   // p columns per thread
constexpr int NC = MAX_N / 16;   // n columns per thread (ssd_chunk_state)
constexpr int RT = QT / 16;      // rows per thread (ssd_chunk_output)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Dims {
  int B, L, H, P, N, Q, nc;
};

// cum[i] = sum_{j <= i} dt[l0 + j] * a for the chunk's Q rows (rows at or
// past L count as dt = 0). Needs a __syncthreads() before cum is read.
__device__ void chunk_cumsum(const float* __restrict__ dtb, int64_t dt_sl, float a,
                             int l0, int L, int Q, float* cum) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const int l = l0 + i;
    cum[i] = l < L ? dtb[l * dt_sl] * a : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int seg = (Q + 31) / 32;
    const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
    float part = 0.f;
    for (int i = lo; i < hi; ++i) part += cum[i];
    float incl = part;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    float run = incl - part;
    for (int i = lo; i < hi; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
}

// 1. grid (nc, B*H): the chunk's own state into chunk_state[bh][c] (P, N),
// its total log-decay into tot[bh][c].
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const T* __restrict__ x, int64_t x_sb, int64_t x_sl, int64_t x_sh,
                const float* __restrict__ dt, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                const float* __restrict__ a,
                const T* __restrict__ bm, int64_t b_sb, int64_t b_sl,
                float* __restrict__ chunk_state, float* __restrict__ tot, Dims dm) {
  extern __shared__ float smem[];
  const int P = dm.P, N = dm.N, Q = dm.Q;
  float* cum = smem;                 // [Q]
  float* xs = cum + Q;               // [ST][P]  x*dt*to_end
  float* bs = xs + ST * P;           // [ST][N]

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* xb = x + b * x_sb + h * x_sh;
  const T* bb = bm + b * b_sb;

  chunk_cumsum(dtb, dt_sl, a[h], l0, dm.L, Q, cum);
  __syncthreads();
  const float total = cum[Q - 1];
  if (tid == 0) tot[(int64_t)bh * dm.nc + c] = total;

  float acc[PC][NC];
#pragma unroll
  for (int i = 0; i < PC; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < Q; r0 += ST) {
    for (int e = tid; e < ST * P; e += THREADS) {
      const int r = e / P, p = e - r * P;
      const int l = l0 + r0 + r;
      float val = 0.f;
      if (r0 + r < Q && l < dm.L)
        val = to_f(xb[l * x_sl + p]) * dtb[l * dt_sl] * expf(total - cum[r0 + r]);
      xs[e] = val;
    }
    for (int e = tid; e < ST * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      const int l = l0 + r0 + r;
      bs[e] = (r0 + r < Q && l < dm.L) ? to_f(bb[l * b_sl + n]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < ST; ++r) {
      float xr[PC], br[NC];
#pragma unroll
      for (int i = 0; i < PC; ++i) {
        const int p = ty + 16 * i;
        xr[i] = p < P ? xs[r * P + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int n = tx + 16 * j;
        br[j] = n < N ? bs[r * N + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PC; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(xr[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = chunk_state + ((int64_t)bh * dm.nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < PC; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = tx + 16 * j;
      if (p < P && n < N) out[p * N + n] = acc[i][j];
    }
  }
}

// 2. grid (ceil(P*N / THREADS), B*H): the sequential pass over the chunks.
// chunk_state[bh][c] becomes the state coming into chunk c.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ chunk_state, const float* __restrict__ tot,
               float* __restrict__ state_out, Dims dm) {
  const int PN = dm.P * dm.N;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  float s = 0.f;
  for (int c = 0; c < dm.nc; ++c) {
    float* slot = chunk_state + ((int64_t)bh * dm.nc + c) * PN + e;
    const float own = *slot;
    *slot = s;
    s = s * expf(tot[(int64_t)bh * dm.nc + c]) + own;
  }
  state_out[(int64_t)bh * PN + e] = s;
}

// 3. grid (nc * ceil(Q / QT), B*H): y for one 64-row tile of one chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_output(const T* __restrict__ x, int64_t x_sb, int64_t x_sl, int64_t x_sh,
                 const float* __restrict__ dt, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                 const float* __restrict__ a,
                 const T* __restrict__ bm, int64_t b_sb, int64_t b_sl,
                 const T* __restrict__ cm, int64_t c_sb, int64_t c_sl,
                 const float* __restrict__ state_in, T* __restrict__ y, Dims dm) {
  extern __shared__ float smem[];
  const int P = dm.P, N = dm.N, Q = dm.Q;
  const int ldb = N + 1, ldw = QT + 1;
  float* cum = smem;                 // [Q]
  float* cs = cum + Q;               // [QT][N]    c rows of this tile
  float* bs = cs + QT * N;           // [QT][N+1]  b rows of a key tile
  float* sin = bs;                   // [P][N+1]   incoming state, read
                                     //            before the first b tile
  float* xs = bs + (P > QT ? P : QT) * ldb;  // [QT][P] x*dt of a key tile
  float* ws = xs + QT * P;           // [QT][QT+1] scores * decay

  const int n_qt = (Q + QT - 1) / QT;
  const int c = blockIdx.x / n_qt, qt = blockIdx.x - c * n_qt;
  const int bh = blockIdx.y;
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q, r0 = qt * QT;     // chunk start; tile start within the chunk
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* xb = x + b * x_sb + h * x_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;

  chunk_cumsum(dtb, dt_sl, a[h], l0, dm.L, Q, cum);
  for (int e = tid; e < QT * N; e += THREADS) {
    const int r = e / N, n = e - r * N;
    const int l = l0 + r0 + r;
    cs[e] = (r0 + r < Q && l < dm.L) ? to_f(cb[l * c_sl + n]) : 0.f;
  }
  const float* sb = state_in + ((int64_t)bh * dm.nc + c) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    sin[p * ldb + n] = sb[e];
  }
  __syncthreads();

  // inter-chunk term: exp(cum[q]) * sum_n c[q][n] * S_in[p][n]
  float acc[RT][PC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cr[RT], sr[PC];
#pragma unroll
    for (int i = 0; i < RT; ++i) cr[i] = cs[(ty + 16 * i) * N + n];
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int p = tx + 16 * j;
      sr[j] = p < P ? sin[p * ldb + n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(cr[i], sr[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + ty + 16 * i;
    const float g = r < Q ? expf(cum[r]) : 0.f;
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] *= g;
  }

  // intra-chunk term over the key tiles up to the diagonal
  for (int k0 = 0; k0 <= r0; k0 += QT) {
    __syncthreads();                 // last tile's readers done
    for (int e = tid; e < QT * N; e += THREADS) {
      const int t = e / N, n = e - t * N;
      const int l = l0 + k0 + t;
      bs[t * ldb + n] = (k0 + t < Q && l < dm.L) ? to_f(bb[l * b_sl + n]) : 0.f;
    }
    for (int e = tid; e < QT * P; e += THREADS) {
      const int t = e / P, p = e - t * P;
      const int l = l0 + k0 + t;
      xs[e] = (k0 + t < Q && l < dm.L) ? to_f(xb[l * x_sl + p]) * dtb[l * dt_sl] : 0.f;
    }
    __syncthreads();

    float sc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cr[RT], br[4];
#pragma unroll
      for (int i = 0; i < RT; ++i) cr[i] = cs[(ty + 16 * i) * N + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = bs[(tx + 16 * j) * ldb + n];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cr[i], br[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qr = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = k0 + tx + 16 * j;
        const bool ok = kr <= qr && qr < Q;
        ws[(ty + 16 * i) * ldw + tx + 16 * j] = ok ? sc[i][j] * expf(cum[qr] - cum[kr]) : 0.f;
      }
    }
    __syncthreads();
    for (int t = 0; t < QT; ++t) {
      float wr[RT], xr[PC];
#pragma unroll
      for (int i = 0; i < RT; ++i) wr[i] = ws[(ty + 16 * i) * ldw + t];
#pragma unroll
      for (int j = 0; j < PC; ++j) {
        const int p = tx + 16 * j;
        xr[j] = p < P ? xs[t * P + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(wr[i], xr[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + ty + 16 * i;
    const int l = l0 + r;
    if (r >= Q || l >= dm.L) continue;
    T* yrow = y + (((int64_t)b * dm.L + l) * dm.H + h) * P;
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int p = tx + 16 * j;
      if (p < P) yrow[p] = from_f<T>(acc[i][j]);
    }
  }
}

size_t state_smem(int P, int N, int Q) {
  return sizeof(float) * ((size_t)Q + (size_t)ST * P + (size_t)ST * N);
}

size_t output_smem(int P, int N, int Q) {
  const size_t b_rows = P > QT ? P : QT;   // key-tile b rows or S_in
  return sizeof(float) * ((size_t)Q + (size_t)QT * N + b_rows * (N + 1)
                          + (size_t)QT * P + (size_t)QT * (QT + 1));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch(const void* x, long long x_sb, long long x_sl, long long x_sh,
           const float* dt, long long dt_sb, long long dt_sl, long long dt_sh,
           const float* a, const void* bm, long long b_sb, long long b_sl,
           const void* cm, long long c_sb, long long c_sl,
           void* y, float* state, float* chunk_state, float* tot, Dims dm,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  const size_t s1 = state_smem(dm.P, dm.N, dm.Q), s3 = output_smem(dm.P, dm.N, dm.Q);
  cudaError_t err = allow_smem(ssd_chunk_state<T>, s1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(ssd_chunk_output<T>, s3);
  if (err != cudaSuccess) return (int)err;
  const int BH = dm.B * dm.H;

  ssd_chunk_state<T><<<dim3(dm.nc, BH), THREADS, s1, stream>>>(
      xt, x_sb, x_sl, x_sh, dt, dt_sb, dt_sl, dt_sh, a, bt, b_sb, b_sl, chunk_state, tot, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_pass<<<dim3((dm.P * dm.N + THREADS - 1) / THREADS, BH), THREADS, 0, stream>>>(
      chunk_state, tot, state, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (dm.Q + QT - 1) / QT;
  ssd_chunk_output<T><<<dim3(dm.nc * n_qt, BH), THREADS, s3, stream>>>(
      xt, x_sb, x_sl, x_sh, dt, dt_sb, dt_sl, dt_sh, a, bt, b_sb, b_sl, ct, c_sb, c_sl,
      chunk_state, static_cast<T*>(y), dm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the wrapper checks before a launch: head dim P, state N, chunk Q.
int ssd_scan_max_p() { return MAX_P; }
int ssd_scan_max_n() { return MAX_N; }
int ssd_scan_max_q() { return MAX_Q; }

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; dt and a are f32.
// Strides are in elements. y is a contiguous (B, L, H, P), state a
// contiguous f32 (B, H, P, N); chunk_state (B*H*nc*P*N) and tot (B*H*nc)
// are f32 scratch. Q is the chunk length, nc = ceil(L / Q). Returns the
// cudaError_t of the launches (0 = success); the caller raises on nonzero.
int ssd_scan_launch(int dtype,
                    const void* x, long long x_sb, long long x_sl, long long x_sh,
                    const void* dt, long long dt_sb, long long dt_sl, long long dt_sh,
                    const void* a, const void* bm, long long b_sb, long long b_sl,
                    const void* cm, long long c_sb, long long c_sl,
                    void* y, void* state, void* chunk_state, void* tot,
                    int B, int L, int H, int P, int N, int Q, void* stream) {
  if (P > MAX_P || N > MAX_N || Q > MAX_Q || P < 1 || N < 1 || Q < 1)
    return (int)cudaErrorInvalidValue;
  Dims dm{B, L, H, P, N, Q, (L + Q - 1) / Q};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* st = static_cast<float*>(state);
  float* cs = static_cast<float*>(chunk_state);
  float* tt = static_cast<float*>(tot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, x_sb, x_sl, x_sh, dtf, dt_sb, dt_sl, dt_sh, af, bm, b_sb, b_sl,
                         cm, c_sb, c_sl, y, st, cs, tt, dm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, x_sb, x_sl, x_sh, dtf, dt_sb, dt_sl, dt_sh, af, bm, b_sb,
                                 b_sl, cm, c_sb, c_sl, y, st, cs, tt, dm, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
