// Backward of the Mamba2 SSD chunk scan, for Hopper (sm_90a).
//
// Computes the gradients of src/repro/models/ssm.py::ssd_reference (the
// forward of csrc/ssd_scan.cu, which replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan.py::ssd_scan_bh); the reference leaves its
// backward to XLA's autodiff. Written from the mathematics. Per (b, chunk,
// head), with u_k = x_k * dt_k (rounded to x's type, as the forward rounds
// it), cum_q = sum_{j <= q} dt_j * a, L_qk = exp(cum_q - cum_k) for k <= q,
// s_qk = C_q . B_k (the same for every head) and M_qk = dy_q . u_k:
//   du_k  = sum_{q >= k} s_qk L_qk dy_q + exp(cum_last - cum_k) dS_out B_k
//   dC_q += sum_{k <= q} L_qk M_qk B_k + exp(cum_q) S_in^T dy_q
//   dB_k += sum_{q >= k} L_qk M_qk C_q + exp(cum_last - cum_k) dS_out^T u_k
//   dcum  = row sums of T = s L M - its column sums + dy_q . y_inter_q
//           - V_k, and at the last row sum_k V_k + exp(cum_last) <dS_out, S_in>
//           (V_k = exp(cum_last - cum_k) <dS_out, u_k B_k^T>)
// and d(dA) the reverse cumulative sum of dcum within the chunk;
// ddt = d(dA) a + du . x, dx = du dt, da = sum d(dA) dt. db and dc sum over
// the heads, da over batch and sequence. S_in (the incoming state) and
// dS_out (the cotangent of the outgoing one) come from a forward and a
// reverse pass over the chunks: dS_out[last] = dS, dS_in[c] = G_c +
// exp(cum_last) dS_out[c] with G_c = sum_q exp(cum_q) dy_q C_q^T,
// dS_out[c-1] = dS_in[c]. A ragged tail counts as dt = 0, as in the
// forward; its rows are never written.
//
// Every decay is taken from a difference of cumulative sums, each at most 1
// (cum falls along the chunk): exp(-cum_k) alone overflows at mamba2's
// widths.
//
// Launches, all on the caller's stream, the forward's decomposition run
// backwards, so the heavy passes run in parallel over (b, chunk, head):
//   1. ssd_bwd_chunk_states, grid (nc, B*H): cum and its total; the
//      chunk's own state sum_k exp(cum_last - cum_k) u_k B_k^T and G_c,
//      (P, N) f32 each.
//   2. ssd_bwd_state_pass, grid (P*N / 256, B*H): the forward pass over the
//      chunks (S_in[c] over the chunk's state) and the reverse one (dS_out[c]
//      over G_c), per state element.
//   3. ssd_bwd_keys, grid (nc * key tiles, B*H): per 64-key tile, over the
//      query tiles at and below it: du (then dx), the head's dB, the column
//      sums of T, V_k and du . x.
//   4. ssd_bwd_queries, grid (nc * query tiles, B*H): per 64-query tile,
//      over the key tiles up to it: the head's dC, the row sums of T and
//      dy . y_inter.
//   5. ssd_bwd_finish, grid (nc, B*H): dcum, its reverse cumulative sum, ddt
//      and the chunk's share of da.
//   6. ssd_bwd_reduce and ssd_bwd_da: db and dc as sums over the heads,
//      da as a sum over (b, chunk), each in a fixed order.
// No float atomics: every sum runs in an order fixed by the code, so two
// calls on the same inputs give the same bits (the train loop's restart
// check needs it).
//
// Bound: operations, at mamba2-130m's widths. The least work
// (chip_smoke.py's _ssd_bwd_ops: C B^T once per chunk for all heads and the
// per-head Q x Q products only on and below the diagonal, the (P, N)
// products once) is 9.75 GFLOP at B=1, L=2048 against 21.3 MB moved once:
// 0.0099 ms at the bf16 tensor-core peak. This first version runs every
// product on the CUDA cores in f32, for both dtypes: each 256-thread block
// holds 16 outputs a thread of each 64 x 64 product in registers, its operands
// staged in padded shared memory (no bank conflicts), and recomputes C B^T
// and dy u^T per head and in both tile passes (3 and 4). It is far from
// the bound (PERF.md); the tensor-core redesign is later work.
//
// Layout: x, dy (B, L, H, P), dt (B, L, H), b and c (B, L, N) are read
// through their strides (their innermost dim contiguous); dS is a
// contiguous f32 (B, H, P, N) or null (zero). dx (B, L, H, P), ddt
// (B, L, H), db and dc (B, L, N) are written contiguous, da (H,) f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int MAX_Q = 1024;
constexpr int THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int TQ = 64;           // rows of a query or key tile
constexpr int ST = 32;           // rows staged per step in ssd_bwd_chunk_states
constexpr int RT = TQ / 16;      // tile rows a thread owns
constexpr int PC = MAX_P / 16;   // p columns a thread owns
constexpr int NC = MAX_N / 16;   // n columns a thread owns
constexpr int LDW = TQ + 1;      // padded row of a 64 x 64 tile

struct Dims {
  int B, L, H, P, N, Q, nc, nt;  // nt: 64-row tiles of a chunk
};

struct Scratch {
  float* st;      // [B*H][nc][P*N]: chunk state, then S_in
  float* gs;      // [B*H][nc][P*N]: G_c, then dS_out
  float* tot;     // [B*H][nc]: cum_last
  float* rowt;    // [B*H][nc][Q]: row sums of T + dy . y_inter
  float* colt;    // [B*H][nc][Q]: -(column sums of T) - V_k
  float* dux;     // [B*H][nc][Q]: du . x
  float* vpart;   // [B*H][nc][nt]: sum of V_k over a key tile
  float* dapart;  // [B][nc][H]: the chunk's share of da
  float* dbp;     // [B][L][H][N]: one head's dB
  float* dcp;     // [B][L][H][N]: one head's dC
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x * dt rounded to x's type, as the forward rounds it
template <typename T>
__device__ __forceinline__ float xdt(T x, float dt) {
  return to_f(from_f<T>(__fmul_rn(to_f(x), dt)));
}

// One warp: out[i] = scale * sum of in[j] over j <= i (REV: j >= i), for
// i < n, in shared memory (out may be in: each lane reads its own rows
// before it writes them).
template <bool REV>
__device__ void warp_scan(const float* in, float scale, int n, float* out) {
  const int lane = threadIdx.x & 31;
  const int seg = (n + 31) / 32;
  const int lo = min(n, lane * seg), hi = min(n, lo + seg);
  auto at = [&](int i) { return REV ? n - 1 - i : i; };
  float part = 0.f;
  for (int i = lo; i < hi; ++i) part += __fmul_rn(in[at(i)], scale);
  float incl = part;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float run = incl - part;
  for (int i = lo; i < hi; ++i) {
    run += __fmul_rn(in[at(i)], scale);
    out[at(i)] = run;
  }
}

// dt of the chunk's Q rows into dts (zero at or past L) and cum = the
// cumulative sum of dt * a over them. Ends with a barrier.
__device__ void load_cum(const float* __restrict__ dtb, int64_t dt_sl, float a, int l0, int L,
                         int Q, float* dts, float* cum) {
  for (int i = threadIdx.x; i < Q; i += THREADS) {
    const int l = l0 + i;
    dts[i] = l < L ? dtb[l * dt_sl] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_scan<false>(dts, a, Q, cum);
  __syncthreads();
}

// Sum over the 16 threads of a half-warp (the tx of one ty).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + TQ) of a (rows, W) matrix whose row r starts at src + r *
// ld into dst[TQ][W + 1] as f32; rows at or past rows_ok are zero (the
// padding column is never read as data).
template <typename T>
__device__ void stage(float* dst, const T* __restrict__ src, int64_t ld, int r0, int rows_ok,
                      int W) {
  for (int e = threadIdx.x; e < TQ * W; e += THREADS) {
    const int r = e / W, k = e - r * W;
    dst[r * (W + 1) + k] = r0 + r < rows_ok ? to_f(src[(r0 + r) * ld + k]) : 0.f;
  }
}

// u = x * dt of rows [r0, r0 + TQ) of the chunk into dst[TQ][P + 1].
template <typename T>
__device__ void stage_u(float* dst, const T* __restrict__ xb, int64_t x_sl, const float* dts,
                        int r0, int rows_ok, int P) {
  for (int e = threadIdx.x; e < TQ * P; e += THREADS) {
    const int r = e / P, p = e - r * P;
    dst[r * (P + 1) + p] = r0 + r < rows_ok ? xdt(xb[(r0 + r) * x_sl + p], dts[r0 + r]) : 0.f;
  }
}

// A (P, N) f32 matrix into dst[P][N + 1].
__device__ void stage_state(float* dst, const float* __restrict__ src, int P, int N) {
  for (int e = threadIdx.x; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    dst[p * (N + 1) + n] = src[e];
  }
}

// The scores s and the products M of one (query tile, key tile) pair: the
// thread's rows q = ty + 16 i, keys k = tx + 16 j. cs, bs [TQ][N + 1];
// ds, us [TQ][P + 1].
__device__ __forceinline__ void scores_and_m(const float* cs, const float* bs, const float* ds,
                                             const float* us, int P, int N, int ty, int tx,
                                             float (&sc)[RT][4], float (&mm)[RT][4]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = mm[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cr[RT], br[4];
#pragma unroll
    for (int i = 0; i < RT; ++i) cr[i] = cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) br[j] = bs[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cr[i], br[j], sc[i][j]);
  }
  for (int p = 0; p < P; ++p) {
    float dr[RT], ur[4];
#pragma unroll
    for (int i = 0; i < RT; ++i) dr[i] = ds[(ty + 16 * i) * (P + 1) + p];
#pragma unroll
    for (int j = 0; j < 4; ++j) ur[j] = us[(tx + 16 * j) * (P + 1) + p];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mm[i][j] = fmaf(dr[i], ur[j], mm[i][j]);
  }
}

// The inputs: base pointers and strides in elements.
template <typename T>
struct In {
  const T* x;
  int64_t x_sb, x_sl, x_sh;
  const float* dt;
  int64_t dt_sb, dt_sl, dt_sh;
  const float* a;
  const T* b;
  int64_t b_sb, b_sl;
  const T* c;
  int64_t c_sb, c_sl;
  const T* dy;
  int64_t dy_sb, dy_sl, dy_sh;
  const float* dstate;
};

// 1. grid (nc, B*H): the chunk's own state and G_c into st and gs, cum_last
// into tot.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_states(In<T> in, Scratch sc, Dims dm) {
  extern __shared__ float smem[];
  const int P = dm.P, N = dm.N, Q = dm.Q;
  float* dts = smem;                 // [Q]
  float* cum = dts + Q;              // [Q]
  float* us = cum + Q;               // [ST][P]  u * exp(cum_last - cum)
  float* ds = us + ST * P;           // [ST][P]  dy * exp(cum)
  float* bs = ds + ST * P;           // [ST][N]
  float* cs = bs + ST * N;           // [ST][N]

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q, qlen = min(Q, dm.L - l0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* dtb = in.dt + b * in.dt_sb + h * in.dt_sh;
  const T* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h * in.x_sh;
  const T* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h * in.dy_sh;
  const T* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const T* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;

  load_cum(dtb, in.dt_sl, in.a[h], l0, dm.L, Q, dts, cum);
  const float total = cum[Q - 1];
  const int64_t slot = (int64_t)bh * dm.nc + c;
  if (tid == 0) sc.tot[slot] = total;

  float acc_s[PC][NC], acc_g[PC][NC];
#pragma unroll
  for (int i = 0; i < PC; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_s[i][j] = acc_g[i][j] = 0.f;

  for (int r0 = 0; r0 < qlen; r0 += ST) {
    for (int e = tid; e < ST * P; e += THREADS) {
      const int r = e / P, p = e - r * P, q = r0 + r;
      const bool ok = q < qlen;
      us[e] = ok ? xdt(xb[q * in.x_sl + p], dts[q]) * expf(total - cum[q]) : 0.f;
      ds[e] = ok ? to_f(yb[q * in.dy_sl + p]) * expf(cum[q]) : 0.f;
    }
    for (int e = tid; e < ST * N; e += THREADS) {
      const int r = e / N, n = e - r * N, q = r0 + r;
      const bool ok = q < qlen;
      bs[e] = ok ? to_f(bb[q * in.b_sl + n]) : 0.f;
      cs[e] = ok ? to_f(cb[q * in.c_sl + n]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < ST; ++r) {
      float ur[PC], dr[PC], br[NC], cr[NC];
#pragma unroll
      for (int i = 0; i < PC; ++i) {
        const int p = ty + 16 * i;
        ur[i] = p < P ? us[r * P + p] : 0.f;
        dr[i] = p < P ? ds[r * P + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int n = tx + 16 * j;
        br[j] = n < N ? bs[r * N + n] : 0.f;
        cr[j] = n < N ? cs[r * N + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PC; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          acc_s[i][j] = fmaf(ur[i], br[j], acc_s[i][j]);
          acc_g[i][j] = fmaf(dr[i], cr[j], acc_g[i][j]);
        }
    }
    __syncthreads();
  }

  float* so = sc.st + slot * P * N;
  float* go = sc.gs + slot * P * N;
#pragma unroll
  for (int i = 0; i < PC; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = tx + 16 * j;
      if (p < P && n < N) {
        so[p * N + n] = acc_s[i][j];
        go[p * N + n] = acc_g[i][j];
      }
    }
  }
}

// 2. grid (ceil(P*N / THREADS), B*H): per state element, S_in[c] over the
// chunk's state (forward) and dS_out[c] over G_c (reverse).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_pass(const float* __restrict__ dstate, Scratch sc, Dims dm) {
  const int PN = dm.P * dm.N;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  float s = 0.f;
  for (int c = 0; c < dm.nc; ++c) {
    const int64_t slot = (int64_t)bh * dm.nc + c;
    const float own = sc.st[slot * PN + e];
    sc.st[slot * PN + e] = s;
    s = s * expf(sc.tot[slot]) + own;
  }
  float g = dstate ? dstate[(int64_t)bh * PN + e] : 0.f;
  for (int c = dm.nc - 1; c >= 0; --c) {
    const int64_t slot = (int64_t)bh * dm.nc + c;
    const float gc = sc.gs[slot * PN + e];
    sc.gs[slot * PN + e] = g;
    g = gc + expf(sc.tot[slot]) * g;
  }
}

// Shared memory of the tile passes (floats): dt and cum, then the four
// staged operand tiles, then one (ssd_bwd_queries) or two (ssd_bwd_keys) 64 x 64
// product tiles.
__host__ __device__ inline size_t tile_smem_floats(int P, int N, int Q, int products) {
  return 2 * (size_t)Q + 2 * (size_t)TQ * (N + 1) + 2 * (size_t)TQ * (P + 1) +
         (size_t)products * TQ * LDW;
}

// 3. grid (nc * nt, B*H): one 64-key tile of one chunk and head.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_keys(In<T> in, Scratch sc, Dims dm, T* __restrict__ dx) {
  extern __shared__ float smem[];
  const int P = dm.P, N = dm.N, Q = dm.Q;
  float* dts = smem;                         // [Q]
  float* cum = dts + Q;                      // [Q]
  float* bs = cum + Q;                       // [TQ][N+1]  b of the keys
  float* us = bs + TQ * (N + 1);             // [TQ][P+1]  u of the keys
  float* cs = us + TQ * (P + 1);             // [TQ][N+1]  c of a query tile; then dS_out
  float* ds = cs + TQ * (N + 1);             // [TQ][P+1]  dy of a query tile
  float* ws = ds + TQ * (P + 1);             // [TQ][LDW]  s L, [q][k]
  float* xs = ws + TQ * LDW;                 // [TQ][LDW]  L M, [q][k]

  const int c = blockIdx.x / dm.nt, kt = blockIdx.x - c * dm.nt;
  const int bh = blockIdx.y, b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q, qlen = min(Q, dm.L - l0), k0 = kt * TQ;
  if (k0 >= qlen) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t slot = (int64_t)bh * dm.nc + c;
  const T* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h * in.x_sh;
  const T* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h * in.dy_sh;
  const T* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const T* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;

  load_cum(in.dt + b * in.dt_sb + h * in.dt_sh, in.dt_sl, in.a[h], l0, dm.L, Q, dts, cum);
  stage(bs, bb, in.b_sl, k0, qlen, N);
  stage_u(us, xb, in.x_sl, dts, k0, qlen, P);

  // du[k][p] (k = ty + 16 i, p = tx + 16 j), dB[k][n] (n = tx + 16 j), and
  // the column sums of T for keys tx + 16 j (this thread's query rows)
  float du[RT][PC], db[RT][NC], colt[4] = {};
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < PC; ++j) du[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) db[i][j] = 0.f;
  }

  for (int q0 = k0; q0 < qlen; q0 += TQ) {
    __syncthreads();                         // the last tile's readers are done
    stage(cs, cb, in.c_sl, q0, qlen, N);
    stage(ds, yb, in.dy_sl, q0, qlen, P);
    __syncthreads();
    float s[RT][4], m[RT][4];
    scores_and_m(cs, bs, ds, us, P, N, ty, tx, s, m);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int q = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        const float l = k <= q && q < qlen ? expf(cum[q] - cum[k]) : 0.f;
        const float w = s[i][j] * l, x = l * m[i][j];
        colt[j] = fmaf(w, m[i][j], colt[j]);
        ws[(ty + 16 * i) * LDW + tx + 16 * j] = w;
        xs[(ty + 16 * i) * LDW + tx + 16 * j] = x;
      }
    }
    __syncthreads();
    const int rows = min(TQ, qlen - q0);
    for (int r = 0; r < rows; ++r) {
      float wr[RT], xr[RT], dr[PC], cr[NC];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        wr[i] = ws[r * LDW + ty + 16 * i];
        xr[i] = xs[r * LDW + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < PC; ++j) dr[j] = ds[r * (P + 1) + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < NC; ++j) cr[j] = cs[r * (N + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < PC; ++j) du[i][j] = fmaf(wr[i], dr[j], du[i][j]);
#pragma unroll
        for (int j = 0; j < NC; ++j) db[i][j] = fmaf(xr[i], cr[j], db[i][j]);
      }
    }
  }

  // the outgoing state's terms: dS_out B_k and dS_out^T u_k, times
  // exp(cum_last - cum_k)
  __syncthreads();
  stage_state(cs, sc.gs + slot * P * N, P, N);
  __syncthreads();
  float sb[RT][PC] = {}, su[RT][NC] = {};
  for (int n = 0; n < N; ++n) {
    float br[RT], gr[PC];
#pragma unroll
    for (int i = 0; i < RT; ++i) br[i] = bs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
    for (int j = 0; j < PC; ++j) gr[j] = tx + 16 * j < P ? cs[(tx + 16 * j) * (N + 1) + n] : 0.f;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < PC; ++j) sb[i][j] = fmaf(br[i], gr[j], sb[i][j]);
  }
  for (int p = 0; p < P; ++p) {
    float ur[RT], gr[NC];
#pragma unroll
    for (int i = 0; i < RT; ++i) ur[i] = us[(ty + 16 * i) * (P + 1) + p];
#pragma unroll
    for (int j = 0; j < NC; ++j) gr[j] = cs[p * (N + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) su[i][j] = fmaf(ur[i], gr[j], su[i][j]);
  }
  const float total = cum[Q - 1];
  float* vrow = ws;                          // [TQ]: V_k, then the column sums
  float* red = xs;                           // [16][TQ]
  T* dxb = dx + (((int64_t)b * dm.L + l0) * dm.H + h) * P;
  float* dbb = sc.dbp + (((int64_t)b * dm.L + l0) * dm.H + h) * N;
  __syncthreads();                           // ws and xs are free
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i, k = k0 + r;
    const bool ok = k < qlen;
    const float e = ok ? expf(total - cum[k]) : 0.f;
    float v = 0.f, dux = 0.f;
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int p = tx + 16 * j;
      if (p < P) {
        v = fmaf(us[r * (P + 1) + p], sb[i][j], v);
        du[i][j] = fmaf(e, sb[i][j], du[i][j]);
        if (ok) {
          dux = fmaf(du[i][j], to_f(xb[k * in.x_sl + p]), dux);
          dxb[(int64_t)k * dm.H * P + p] = from_f<T>(du[i][j] * dts[k]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = tx + 16 * j;
      if (ok && n < N) dbb[(int64_t)k * dm.H * N + n] = fmaf(e, su[i][j], db[i][j]);
    }
    v = sum16(v) * e;
    dux = sum16(dux);
    if (tx == 0) {
      vrow[r] = v;
      if (ok) sc.dux[slot * Q + k] = dux;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * TQ + tx + 16 * j] = colt[j];
  __syncthreads();
  if (tid < TQ && k0 + tid < qlen) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[t * TQ + tid];
    sc.colt[slot * Q + k0 + tid] = -s - vrow[tid];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < min(TQ, qlen - k0); ++r) s += vrow[r];
    sc.vpart[slot * dm.nt + kt] = s;
  }
}

// 4. grid (nc * nt, B*H): one 64-query tile of one chunk and head.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_queries(In<T> in, Scratch sc, Dims dm) {
  extern __shared__ float smem[];
  const int P = dm.P, N = dm.N, Q = dm.Q;
  float* dts = smem;                         // [Q]
  float* cum = dts + Q;                      // [Q]
  float* cs = cum + Q;                       // [TQ][N+1]  c of the queries
  float* ds = cs + TQ * (N + 1);             // [TQ][P+1]  dy of the queries
  float* bs = ds + TQ * (P + 1);             // [TQ][N+1]  b of a key tile; then S_in
  float* us = bs + TQ * (N + 1);             // [TQ][P+1]  u of a key tile
  float* xs = us + TQ * (P + 1);             // [TQ][LDW]  L M, [q][k]

  const int c = blockIdx.x / dm.nt, qt = blockIdx.x - c * dm.nt;
  const int bh = blockIdx.y, b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q, qlen = min(Q, dm.L - l0), q0 = qt * TQ;
  if (q0 >= qlen) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t slot = (int64_t)bh * dm.nc + c;
  const T* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h * in.x_sh;
  const T* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h * in.dy_sh;
  const T* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const T* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;

  load_cum(in.dt + b * in.dt_sb + h * in.dt_sh, in.dt_sl, in.a[h], l0, dm.L, Q, dts, cum);
  stage(cs, cb, in.c_sl, q0, qlen, N);
  stage(ds, yb, in.dy_sl, q0, qlen, P);

  // dC[q][n] (q = ty + 16 i, n = tx + 16 j); the row sums of T for rows
  // ty + 16 i over this thread's keys
  float dc[RT][NC], rowt[RT] = {};
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dc[i][j] = 0.f;

  for (int k0 = 0; k0 <= q0; k0 += TQ) {
    __syncthreads();                         // the last tile's readers are done
    stage(bs, bb, in.b_sl, k0, qlen, N);
    stage_u(us, xb, in.x_sl, dts, k0, qlen, P);
    __syncthreads();
    float s[RT][4], m[RT][4];
    scores_and_m(cs, bs, ds, us, P, N, ty, tx, s, m);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int q = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        const float l = k <= q && q < qlen ? expf(cum[q] - cum[k]) : 0.f;
        const float x = l * m[i][j];
        rowt[i] = fmaf(s[i][j], x, rowt[i]);
        xs[(ty + 16 * i) * LDW + tx + 16 * j] = x;
      }
    }
    __syncthreads();
    const int keys = min(TQ, qlen - k0);
    for (int k = 0; k < keys; ++k) {
      float xr[RT], br[NC];
#pragma unroll
      for (int i = 0; i < RT; ++i) xr[i] = xs[(ty + 16 * i) * LDW + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) br[j] = bs[k * (N + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) dc[i][j] = fmaf(xr[i], br[j], dc[i][j]);
    }
  }

  // the incoming state's terms (zero in the first chunk): y_inter_q =
  // exp(cum_q) S_in C_q and exp(cum_q) S_in^T dy_q
  float yd[RT] = {};
  if (c > 0) {
    __syncthreads();
    stage_state(bs, sc.st + slot * P * N, P, N);
    __syncthreads();
    float yi[RT][PC] = {}, si[RT][NC] = {};
    for (int n = 0; n < N; ++n) {
      float cr[RT], sr[PC];
#pragma unroll
      for (int i = 0; i < RT; ++i) cr[i] = cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
      for (int j = 0; j < PC; ++j) sr[j] = tx + 16 * j < P ? bs[(tx + 16 * j) * (N + 1) + n] : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) yi[i][j] = fmaf(cr[i], sr[j], yi[i][j]);
    }
    for (int p = 0; p < P; ++p) {
      float dr[RT], sr[NC];
#pragma unroll
      for (int i = 0; i < RT; ++i) dr[i] = ds[(ty + 16 * i) * (P + 1) + p];
#pragma unroll
      for (int j = 0; j < NC; ++j) sr[j] = bs[p * (N + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) si[i][j] = fmaf(dr[i], sr[j], si[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty + 16 * i, q = q0 + r;
      const float e = q < qlen ? expf(cum[q]) : 0.f;
#pragma unroll
      for (int j = 0; j < PC; ++j)
        if (tx + 16 * j < P) yd[i] = fmaf(ds[r * (P + 1) + tx + 16 * j], yi[i][j], yd[i]);
      yd[i] *= e;
#pragma unroll
      for (int j = 0; j < NC; ++j) dc[i][j] = fmaf(e, si[i][j], dc[i][j]);
    }
  }

  float* dcb = sc.dcp + (((int64_t)b * dm.L + l0) * dm.H + h) * N;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int q = q0 + ty + 16 * i;
    const float r = sum16(rowt[i] + yd[i]);
    if (q >= qlen) continue;
    if (tx == 0) sc.rowt[slot * Q + q] = r;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = tx + 16 * j;
      if (n < N) dcb[(int64_t)q * dm.H * N + n] = dc[i][j];
    }
  }
}

// Sum of v over the block, in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// 5. grid (nc, B*H): dcum, d(dA) its reverse cumulative sum, ddt, and the
// chunk's share of da.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_finish(const float* __restrict__ dt, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
           const float* __restrict__ a, Scratch sc, Dims dm, float* __restrict__ ddt) {
  extern __shared__ float smem[];
  const int Q = dm.Q;
  float* dts = smem;                 // [Q]
  float* cum = dts + Q;              // [Q]
  float* dcum = cum + Q;             // [Q]
  float* red = dcum + Q;             // [THREADS]

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q, qlen = min(Q, dm.L - l0);
  const int tid = threadIdx.x;
  const int64_t slot = (int64_t)bh * dm.nc + c;
  const int64_t PN = (int64_t)dm.P * dm.N;

  float dot = 0.f;                   // <dS_out, S_in>
  for (int64_t e = tid; e < PN; e += THREADS)
    dot = fmaf(sc.gs[slot * PN + e], sc.st[slot * PN + e], dot);
  dot = block_sum(dot, red);
  load_cum(dt + b * dt_sb + h * dt_sh, dt_sl, a[h], l0, dm.L, Q, dts, cum);
  for (int i = tid; i < qlen; i += THREADS)
    dcum[i] = sc.rowt[slot * Q + i] + sc.colt[slot * Q + i];
  __syncthreads();
  if (tid == 0) {
    float v = 0.f;
    for (int t = 0; t * TQ < qlen; ++t) v += sc.vpart[slot * dm.nt + t];
    dcum[qlen - 1] += v + expf(cum[Q - 1]) * dot;
  }
  __syncthreads();
  if (tid < 32) warp_scan<true>(dcum, 1.f, qlen, dcum);
  __syncthreads();
  float part = 0.f;
  const float ah = a[h];
  for (int i = tid; i < qlen; i += THREADS) {
    const float g = dcum[i];
    ddt[((int64_t)b * dm.L + l0 + i) * dm.H + h] = fmaf(g, ah, sc.dux[slot * Q + i]);
    part = fmaf(g, dts[i], part);
  }
  part = block_sum(part, red);
  if (tid == 0) sc.dapart[((int64_t)b * dm.nc + c) * dm.H + h] = part;
}

// 6. grid (ceil(B*L*N / THREADS)): db and dc, each a sum over the heads in
// head order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(Scratch sc, Dims dm, T* __restrict__ db, T* __restrict__ dc) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (int64_t)dm.B * dm.L * dm.N) return;
  const int64_t bl = e / dm.N, n = e - bl * dm.N;
  float sb = 0.f, scc = 0.f;
  for (int h = 0; h < dm.H; ++h) {
    const int64_t i = (bl * dm.H + h) * dm.N + n;
    sb += sc.dbp[i];
    scc += sc.dcp[i];
  }
  db[e] = from_f<T>(sb);
  dc[e] = from_f<T>(scc);
}

// grid (ceil(H / THREADS)): da, a sum over (b, chunk) in order.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_da(Scratch sc, Dims dm, float* __restrict__ da) {
  const int h = blockIdx.x * THREADS + threadIdx.x;
  if (h >= dm.H) return;
  float s = 0.f;
  for (int i = 0; i < dm.B * dm.nc; ++i) s += sc.dapart[(int64_t)i * dm.H + h];
  da[h] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t states_smem(int P, int N, int Q) {
  return sizeof(float) * (2 * (size_t)Q + 2 * (size_t)ST * P + 2 * (size_t)ST * N);
}

Scratch carve(float* base, const Dims& dm) {
  const int64_t BHC = (int64_t)dm.B * dm.H * dm.nc, PN = (int64_t)dm.P * dm.N;
  const int64_t rows = (int64_t)dm.B * dm.L * dm.H * dm.N;
  Scratch s;
  float* p = base;
  auto take = [&](int64_t n) { float* q = p; p += (n + 3) / 4 * 4; return q; };
  s.st = take(BHC * PN);
  s.gs = take(BHC * PN);
  s.tot = take(BHC);
  s.rowt = take(BHC * dm.Q);
  s.colt = take(BHC * dm.Q);
  s.dux = take(BHC * dm.Q);
  s.vpart = take(BHC * dm.nt);
  s.dapart = take(BHC);
  s.dbp = take(rows);
  s.dcp = take(rows);
  return s;
}

Dims dims(int B, int L, int H, int P, int N, int Q) {
  const int nc = (L + Q - 1) / Q;
  return Dims{B, L, H, P, N, Q, nc, (Q + TQ - 1) / TQ};
}

template <typename T>
int launch(const In<T>& in, T* dx, float* ddt, float* da, T* db, T* dc, float* scratch,
           const Dims& dm, cudaStream_t stream) {
  const size_t s1 = states_smem(dm.P, dm.N, dm.Q);
  const size_t sk = sizeof(float) * tile_smem_floats(dm.P, dm.N, dm.Q, 2);
  const size_t sq = sizeof(float) * tile_smem_floats(dm.P, dm.N, dm.Q, 1);
  const size_t sf = sizeof(float) * (3 * (size_t)dm.Q + THREADS);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_chunk_states<T>, s1)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_bwd_keys<T>, sk)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_bwd_queries<T>, sq)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_bwd_finish, sf)) != cudaSuccess) return (int)err;
  const Scratch sc = carve(scratch, dm);
  const int BH = dm.B * dm.H;
  ssd_bwd_chunk_states<T><<<dim3(dm.nc, BH), THREADS, s1, stream>>>(in, sc, dm);
  ssd_bwd_state_pass<<<dim3((dm.P * dm.N + THREADS - 1) / THREADS, BH), THREADS, 0, stream>>>(
      in.dstate, sc, dm);
  ssd_bwd_keys<T><<<dim3(dm.nc * dm.nt, BH), THREADS, sk, stream>>>(in, sc, dm, dx);
  ssd_bwd_queries<T><<<dim3(dm.nc * dm.nt, BH), THREADS, sq, stream>>>(in, sc, dm);
  ssd_bwd_finish<<<dim3(dm.nc, BH), THREADS, sf, stream>>>(in.dt, in.dt_sb, in.dt_sl,
                                                           in.dt_sh, in.a, sc, dm, ddt);
  const int64_t rows = (int64_t)dm.B * dm.L * dm.N;
  ssd_bwd_reduce<T><<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(sc, dm, db,
                                                                                     dc);
  ssd_bwd_da<<<(dm.H + THREADS - 1) / THREADS, THREADS, 0, stream>>>(sc, dm, da);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the wrapper checks before a launch: head dim P, state N, chunk Q.
int ssd_scan_bwd_max_p() { return MAX_P; }
int ssd_scan_bwd_max_n() { return MAX_N; }
int ssd_scan_bwd_max_q() { return MAX_Q; }

// f32 scratch the launch needs, in floats.
long long ssd_scan_bwd_scratch_floats(int B, int L, int H, int P, int N, int Q) {
  const Dims dm = dims(B, L, H, P, N, Q);
  Scratch s = carve(nullptr, dm);
  return (long long)(reinterpret_cast<uintptr_t>(s.dcp) / sizeof(float)) +
         (long long)B * L * H * N;
}

// dtype (of x, b, c, dy and of dx, db, dc): 0 = float32, 1 = bfloat16; dt,
// a, dstate, ddt and da are f32. Strides are in elements. dstate may be
// null (a zero cotangent for the final state). Q is the chunk length.
// Returns the cudaError_t of the launches (0 = success); the caller raises
// on nonzero.
int ssd_scan_bwd_launch(int dtype,
                        const void* x, long long x_sb, long long x_sl, long long x_sh,
                        const void* dt, long long dt_sb, long long dt_sl, long long dt_sh,
                        const void* a, const void* bm, long long b_sb, long long b_sl,
                        const void* cm, long long c_sb, long long c_sl,
                        const void* dy, long long dy_sb, long long dy_sl, long long dy_sh,
                        const void* dstate, void* dx, void* ddt, void* da, void* db, void* dc,
                        void* scratch, int B, int L, int H, int P, int N, int Q, void* stream) {
  if (P > MAX_P || N > MAX_N || Q > MAX_Q || P < 1 || N < 1 || Q < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const Dims dm = dims(B, L, H, P, N, Q);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* ds = static_cast<const float*>(dstate);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) {
    using T = float;
    const In<T> in{static_cast<const T*>(x), x_sb, x_sl, x_sh, dtf, dt_sb, dt_sl, dt_sh, af,
                   static_cast<const T*>(bm), b_sb, b_sl, static_cast<const T*>(cm), c_sb, c_sl,
                   static_cast<const T*>(dy), dy_sb, dy_sl, dy_sh, ds};
    return launch<T>(in, static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(da),
                     static_cast<T*>(db), static_cast<T*>(dc), sc, dm, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const In<T> in{static_cast<const T*>(x), x_sb, x_sl, x_sh, dtf, dt_sb, dt_sl, dt_sh, af,
                   static_cast<const T*>(bm), b_sb, b_sl, static_cast<const T*>(cm), c_sb, c_sl,
                   static_cast<const T*>(dy), dy_sb, dy_sl, dy_sh, ds};
    return launch<T>(in, static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(da),
                     static_cast<T*>(db), static_cast<T*>(dc), sc, dm, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
