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
// backwards, so the heavy passes run in parallel over (b, chunk, heads):
//   1. chunk states: cum and its total; the chunk's own state
//      sum_k exp(cum_last - cum_k) u_k B_k^T and G_c, (P, N) f32 each.
//   2. ssd_bwd_state_pass, grid (P*N / 256, B*H): the forward pass over the
//      chunks (S_in[c] over the chunk's state) and the reverse one (dS_out[c]
//      over G_c), per state element.
//   3. keys: per 64-key tile, over the query tiles at and below it: du
//      (then dx), dB, the column sums of T, V_k and du . x.
//   4. queries: per 64-query tile, over the key tiles up to it: dC, the row
//      sums of T and dy . y_inter.
//   5. ssd_bwd_finish, grid (nc, B*H): dcum, its reverse cumulative sum, ddt
//      and the chunk's share of da.
//   6. ssd_bwd_reduce and ssd_bwd_da: db and dc as sums over the slots of
//      their f32 scratch (one per head, or per head group), da as a sum over
//      (b, chunk), each in a fixed order.
// No float atomics: every sum runs in an order fixed by the code, so two
// calls on the same inputs give the same bits (the train loop's restart
// check needs it).
//
// Bound: operations, at mamba2-130m's widths. The least work
// (chip_smoke.py's _ssd_bwd_ops: C B^T once per chunk for all heads and the
// per-head Q x Q products only on and below the diagonal, the (P, N)
// products once) is 9.75 GFLOP at B=1, L=2048 against 21.3 MB moved once:
// 0.0099 ms at the bf16 tensor-core peak, 0.15 ms at the CUDA cores' f32
// peak. Only the tensor cores come near it, so the bf16 path runs every
// product on them. What keeps it from the bound (PERF.md holds its times):
// the tile passes are latency-bound, each block one warpgroup whose loads,
// products and elementwise work follow one another (a head group of one
// runs as fast as two at mamba2's train shape: the C B^T a group saves is
// not the limit); the state terms, taken as two bf16 parts, double their
// products; and the small passes over the states and partial sums move
// several times the 21.3 MB.
//
// Two paths, chosen by dtype in the C entry point (a dispatch, not a
// fallback: a launch that fails returns its error and the wrapper raises):
//
// * bfloat16 (the models' type): tensor cores. A block is one warpgroup
//   (128 threads); operand tiles are staged by 16-byte cp.async into the
//   forward's swizzled tiles (Tile, in ssd_common.cuh), P run at 64 and N
//   at 128 with zeros past them.
//   - ssd_bwd_chunk_states_bf16, grid (B * nc * H), a two-stage ring of
//     64-row tiles: the state and G_c as the forward's ssd_chunk_state_bf16
//     takes its state (wgmma m64n64k16 per 64 columns of N, both operands
//     MN-major), with the A operands bf16(bf16(x dt) exp(cum_last - cum))
//     and bf16(dy exp(cum)): a rounding each that the f32 formulas do not
//     make.
//   - ssd_bwd_state_pass<true> also writes every S_in and dS_out as two
//     bf16 parts, hi = bf16(s) and lo = bf16(s - hi) (about 16 bits of
//     mantissa), which the tile passes take as two products.
//   - ssd_bwd_keys_bf16, grid (B * nc * ceil(H / HG), key tiles): one
//     64-key tile for a group of HG heads (SSD_BWD_HEAD_GROUP, 2 in the
//     port's build: du's accumulators are per head, so HG = 4 does not fit
//     in registers). Per query tile at or past it, in a two-stage ring of
//     its c and dy rows: S^T = B_k C_q^T once for the group (wgmma, both
//     operands K-major); per head M^T = u_k dy_q^T, then in registers
//     W^T = S^T o L^T, X^T = L^T o M^T and T's column sums from the f32
//     fragments, W^T and X^T rounded to bf16 into the A registers of
//     du += W^T dy_q and dB += X^T C_q (wgmma, dy and c MN-major; dB as two
//     n64 halves). The transposed products are computed directly, so each
//     accumulator is the next product's A operand. dB is summed over the
//     group's heads in the block. Then, from dS_out's two parts, dS_out B_k
//     and dS_out^T u_k.
//   - ssd_bwd_queries_bf16, the same grid, the query tile nearest the
//     chunk's end (the most key tiles) first: per key tile up to the
//     diagonal, S = C_q B_k^T once for the group, per head M = dy_q u_k^T,
//     X = L o M and T's row sums in f32, dC += X B_k summed over the
//     group's heads; then, from S_in's two parts, C_q S_in^T (y_inter) and
//     dy_q S_in.
//   So C B^T is computed ceil(H / HG) times per tile pair in each tile
//   pass, against H times in a block per head. dB and dC go to f32
//   scratch, one slot per head group. Below the diagonal tile the decay is the product of a
//   per-row and a per-column factor, both at most 1, as in the forward. A
//   product issued while registers of a pending one are live makes ptxas
//   serialize (its C7517/C7519 notes), so every group of products is
//   waited for before its registers are read or written; the two blocks
//   an SM holds overlap each other's waits.
//
// * float32 (parity cases only): CUDA-core kernels ssd_bwd_chunk_states,
//   ssd_bwd_keys and ssd_bwd_queries, every product an fmaf in f32 (the
//   tensor cores would round f32 inputs): each 256-thread block holds 16
//   outputs a thread of each 64 x 64 product in registers, its operands
//   staged in padded shared memory (no bank conflicts), and recomputes
//   C B^T and dy u^T per head and in both tile passes.
//
// Layout: x, dy (B, L, H, P), dt (B, L, H), b and c (B, L, N) are read
// through their strides (their innermost dim contiguous; for bf16 also P
// and N multiples of 8, 16-byte aligned bases and strides of 16-byte
// multiples: the wrapper checks x, b and c and copies a dy that fails);
// dS is a contiguous f32 (B, H, P, N) or null (zero). dx (B, L, H, P), ddt
// (B, L, H), db and dc (B, L, N) are written contiguous, da (H,) f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_common.cuh"

namespace {

constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int MAX_Q = 1024;

// ------------------------------------------------------------------ f32 path

constexpr int THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int ST = 32;           // rows staged per step in ssd_bwd_chunk_states
constexpr int RT = TILE / 16;    // tile rows a thread owns
constexpr int PC = MAX_P / 16;   // p columns a thread owns
constexpr int NC = MAX_N / 16;   // n columns a thread owns
constexpr int LDW = TILE + 1;    // padded row of a 64 x 64 tile

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
  float* dbp;     // [B][L][parts][N]: dB of one head (f32) or head group (bf16)
  float* dcp;     // [B][L][parts][N]: the same for dC
  __nv_bfloat16* sin2;  // bf16 only, [B*H][nc][2][P*N]: S_in's two parts
  __nv_bfloat16* gs2;   // bf16 only, [B*H][nc][2][P*N]: dS_out's two parts
  int parts;      // slots of dbp and dcp a row: H, or ceil(H / HG) for bf16
};


template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

// Rows [r0, r0 + TILE) of a (rows, W) matrix whose row r starts at src + r *
// ld into dst[TILE][W + 1] as f32; rows at or past rows_ok are zero (the
// padding column is never read as data).
__device__ void stage(float* dst, const float* __restrict__ src, int64_t ld, int r0, int rows_ok,
                      int W) {
  for (int e = threadIdx.x; e < TILE * W; e += THREADS) {
    const int r = e / W, k = e - r * W;
    dst[r * (W + 1) + k] = r0 + r < rows_ok ? src[(r0 + r) * ld + k] : 0.f;
  }
}

// u = x * dt of rows [r0, r0 + TILE) of the chunk into dst[TILE][P + 1].
__device__ void stage_u(float* dst, const float* __restrict__ xb, int64_t x_sl, const float* dts,
                        int r0, int rows_ok, int P) {
  for (int e = threadIdx.x; e < TILE * P; e += THREADS) {
    const int r = e / P, p = e - r * P;
    dst[r * (P + 1) + p] = r0 + r < rows_ok ? __fmul_rn(xb[(r0 + r) * x_sl + p], dts[r0 + r]) : 0.f;
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
// thread's rows q = ty + 16 i, keys k = tx + 16 j. cs, bs [TILE][N + 1];
// ds, us [TILE][P + 1].
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
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_states(In<float> in, Scratch sc, Dims dm) {
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
  const float* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h * in.x_sh;
  const float* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h * in.dy_sh;
  const float* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const float* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;

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
      us[e] = ok ? __fmul_rn(xb[q * in.x_sl + p], dts[q]) * expf(total - cum[q]) : 0.f;
      ds[e] = ok ? yb[q * in.dy_sl + p] * expf(cum[q]) : 0.f;
    }
    for (int e = tid; e < ST * N; e += THREADS) {
      const int r = e / N, n = e - r * N, q = r0 + r;
      const bool ok = q < qlen;
      bs[e] = ok ? bb[q * in.b_sl + n] : 0.f;
      cs[e] = ok ? cb[q * in.c_sl + n] : 0.f;
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

// 2. grid (ceil(P*N / (V*THREADS)), B*H): per state element, S_in[c] over
// the chunk's state (forward) and dS_out[c] over G_c (reverse), on V
// consecutive elements a thread. SPLIT (the bf16 path, V = 4: P*N is a
// multiple of 64) also writes each as two bf16 parts, hi = bf16(s) and
// lo = bf16(s - hi), to sin2 and gs2; f32 has V = 1. The loads of eight
// chunks are issued before their stores, so their latencies overlap.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_pass(const float* __restrict__ dstate, Scratch sc, Dims dm) {
  constexpr int V = SPLIT ? 4 : 1;
  using Vec = typename std::conditional<SPLIT, float4, float>::type;
  const int PN = dm.P * dm.N;
  const int e = (blockIdx.x * THREADS + threadIdx.x) * V;
  const int64_t first = (int64_t)blockIdx.y * dm.nc;     // slot of (b, h)'s chunk 0
  if (e >= PN) return;
  // s at slot: f32 into `full`, and for SPLIT its two parts into `parts`
  auto put = [&](float* full, __nv_bfloat16* parts, int64_t slot, const float (&s)[V]) {
    *reinterpret_cast<Vec*>(full + slot * PN + e) = *reinterpret_cast<const Vec*>(s);
    if constexpr (SPLIT) {
      uint32_t hi[V / 2], lo[V / 2];
#pragma unroll
      for (int v = 0; v < V; v += 2) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(s[v], s[v + 1]);
        const float2 hf = __bfloat1622float2(h2);
        hi[v / 2] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[v / 2] = pack_bf16(s[v] - hf.x, s[v + 1] - hf.y);
      }
      *reinterpret_cast<uint2*>(parts + 2 * slot * PN + e) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(parts + (2 * slot + 1) * PN + e) = make_uint2(lo[0], lo[1]);
    }
  };
  float s[V] = {};
  for (int c0 = 0; c0 < dm.nc; c0 += 8) {
    Vec own[8];
    float decay[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < dm.nc) {
        own[i] = *reinterpret_cast<const Vec*>(sc.st + (first + c0 + i) * PN + e);
        decay[i] = expf(sc.tot[first + c0 + i]);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i >= dm.nc) break;
      put(sc.st, sc.sin2, first + c0 + i, s);
      const float* o = reinterpret_cast<const float*>(&own[i]);
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = s[v] * decay[i] + o[v];
    }
  }
  float g[V] = {};
  if (dstate)
    *reinterpret_cast<Vec*>(g) =
        *reinterpret_cast<const Vec*>(dstate + blockIdx.y * (int64_t)PN + e);
  for (int c1 = dm.nc - 1; c1 >= 0; c1 -= 8) {           // chunks c1, c1 - 1, ...
    Vec gc[8];
    float decay[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c1 - i >= 0) {
        gc[i] = *reinterpret_cast<const Vec*>(sc.gs + (first + c1 - i) * PN + e);
        decay[i] = expf(sc.tot[first + c1 - i]);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c1 - i < 0) break;
      put(sc.gs, sc.gs2, first + c1 - i, g);
      const float* o = reinterpret_cast<const float*>(&gc[i]);
#pragma unroll
      for (int v = 0; v < V; ++v) g[v] = o[v] + decay[i] * g[v];
    }
  }
}

// Shared memory of the tile passes (floats): dt and cum, then the four
// staged operand tiles, then one (ssd_bwd_queries) or two (ssd_bwd_keys) 64 x 64
// product tiles.
__host__ __device__ inline size_t tile_smem_floats(int P, int N, int Q, int products) {
  return 2 * (size_t)Q + 2 * (size_t)TILE * (N + 1) + 2 * (size_t)TILE * (P + 1) +
         (size_t)products * TILE * LDW;
}

// 3. grid (nc * nt, B*H): one 64-key tile of one chunk and head.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_keys(In<float> in, Scratch sc, Dims dm, float* __restrict__ dx) {
  extern __shared__ float smem[];
  const int P = dm.P, N = dm.N, Q = dm.Q;
  float* dts = smem;                         // [Q]
  float* cum = dts + Q;                      // [Q]
  float* bs = cum + Q;                       // [TILE][N+1]  b of the keys
  float* us = bs + TILE * (N + 1);             // [TILE][P+1]  u of the keys
  float* cs = us + TILE * (P + 1);             // [TILE][N+1]  c of a query tile; then dS_out
  float* ds = cs + TILE * (N + 1);             // [TILE][P+1]  dy of a query tile
  float* ws = ds + TILE * (P + 1);             // [TILE][LDW]  s L, [q][k]
  float* xs = ws + TILE * LDW;                 // [TILE][LDW]  L M, [q][k]

  const int c = blockIdx.x / dm.nt, kt = blockIdx.x - c * dm.nt;
  const int bh = blockIdx.y, b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q, qlen = min(Q, dm.L - l0), k0 = kt * TILE;
  if (k0 >= qlen) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t slot = (int64_t)bh * dm.nc + c;
  const float* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h * in.x_sh;
  const float* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h * in.dy_sh;
  const float* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const float* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;

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

  for (int q0 = k0; q0 < qlen; q0 += TILE) {
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
    const int rows = min(TILE, qlen - q0);
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
  float* vrow = ws;                          // [TILE]: V_k, then the column sums
  float* red = xs;                           // [16][TILE]
  float* dxb = dx + (((int64_t)b * dm.L + l0) * dm.H + h) * P;
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
          dux = fmaf(du[i][j], xb[k * in.x_sl + p], dux);
          dxb[(int64_t)k * dm.H * P + p] = du[i][j] * dts[k];
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
  for (int j = 0; j < 4; ++j) red[ty * TILE + tx + 16 * j] = colt[j];
  __syncthreads();
  if (tid < TILE && k0 + tid < qlen) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[t * TILE + tid];
    sc.colt[slot * Q + k0 + tid] = -s - vrow[tid];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < min(TILE, qlen - k0); ++r) s += vrow[r];
    sc.vpart[slot * dm.nt + kt] = s;
  }
}

// 4. grid (nc * nt, B*H): one 64-query tile of one chunk and head.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_queries(In<float> in, Scratch sc, Dims dm) {
  extern __shared__ float smem[];
  const int P = dm.P, N = dm.N, Q = dm.Q;
  float* dts = smem;                         // [Q]
  float* cum = dts + Q;                      // [Q]
  float* cs = cum + Q;                       // [TILE][N+1]  c of the queries
  float* ds = cs + TILE * (N + 1);             // [TILE][P+1]  dy of the queries
  float* bs = ds + TILE * (P + 1);             // [TILE][N+1]  b of a key tile; then S_in
  float* us = bs + TILE * (N + 1);             // [TILE][P+1]  u of a key tile
  float* xs = us + TILE * (P + 1);             // [TILE][LDW]  L M, [q][k]

  const int c = blockIdx.x / dm.nt, qt = blockIdx.x - c * dm.nt;
  const int bh = blockIdx.y, b = bh / dm.H, h = bh - b * dm.H;
  const int l0 = c * Q, qlen = min(Q, dm.L - l0), q0 = qt * TILE;
  if (q0 >= qlen) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t slot = (int64_t)bh * dm.nc + c;
  const float* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h * in.x_sh;
  const float* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h * in.dy_sh;
  const float* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const float* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;

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

  for (int k0 = 0; k0 <= q0; k0 += TILE) {
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
    const int keys = min(TILE, qlen - k0);
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
    for (int t = 0; t * TILE < qlen; ++t) v += sc.vpart[slot * dm.nt + t];
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

// 6. grid (ceil(B*L*N / THREADS)): db and dc, each a sum over the slots of
// a row (heads or head groups) in slot order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(Scratch sc, Dims dm, T* __restrict__ db, T* __restrict__ dc) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (int64_t)dm.B * dm.L * dm.N) return;
  const int64_t bl = e / dm.N, n = e - bl * dm.N;
  float sb = 0.f, scc = 0.f;
  for (int h = 0; h < sc.parts; ++h) {
    const int64_t i = (bl * sc.parts + h) * dm.N + n;
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

// ----------------------------------------------------------------- bf16 path

// Heads per tile-pass block (see the header).
#ifndef SSD_BWD_HEAD_GROUP
#define SSD_BWD_HEAD_GROUP 2
#endif
constexpr int HEAD_GROUP = SSD_BWD_HEAD_GROUP;
static_assert(HEAD_GROUP >= 1 && HEAD_GROUP <= 4, "one warp takes each head's cumsum");

using TB = Tile<TILE, MAX_N>;    // 64 rows of b or c
using TU = Tile<TILE, MAX_P>;    // 64 rows of x, u or dy of one head
using TS = Tile<MAX_P, MAX_N>;   // one bf16 part of a (P, N) state, rows p
constexpr uint32_t B_TILE = TB::BYTES, U_TILE = TU::BYTES, S_PART = TS::BYTES;

__host__ __device__ inline int padded_q(int Q) { return (Q + TILE - 1) / TILE * TILE; }

// Sum over the four lanes that hold one accumulator row, in a fixed order
// (each lane gets the same bits).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bf16 pair at row r, columns 8*n8 + c + {0, 1} of a TU tile.
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int r, int n8, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + TU::off(r, n8) + c * 2));
}

// x * dt in place for rows [0, rows) of a TU tile (row r's dt at dts[r]),
// rounded to bf16 as the forward rounds it.
__device__ __forceinline__ void scale_rows(uint8_t* tile, const float* dts, int rows, int P) {
  for (int e = threadIdx.x; e < TILE * TU::NJ; e += WG) {
    const int r = e / TU::NJ, j = e % TU::NJ;
    if (j >= P / 8 || r >= rows) continue;
    uint4* p = reinterpret_cast<uint4*>(tile + TU::off(r, j));
    uint4 v = *p;
    scale_chunk(v, dts[r]);
    *p = v;
  }
}

// (hi, lo) parts of one head's state (P, N) into TS tiles at dst and
// dst + S_PART (rows past P and columns past N zero).
__device__ __forceinline__ void stage_parts(uint32_t dst, const __nv_bfloat16* parts, int P,
                                            int N) {
  const int64_t PN = (int64_t)P * N;
  stage_tile<MAX_P, MAX_N>(dst, parts, N, P, N / 8);
  stage_tile<MAX_P, MAX_N>(dst + S_PART, parts + PN, N, P, N / 8);
}

// -- pass 1: chunk states and G_c

// A ring stage: b and c rows (TB), then x and dy rows (TU), of 64 keys.
constexpr uint32_t STATE_STAGE = 2 * B_TILE + 2 * U_TILE;

size_t states_smem_bf16(int Q) { return 2 * STATE_STAGE + 2 * (size_t)Q * sizeof(float) + 1024; }

// grid (B * nc * H): cum_last, the chunk's own state and G_c of one head.
__global__ void __launch_bounds__(WG, 2)
ssd_bwd_chunk_states_bf16(In<__nv_bfloat16> in, Scratch sc, Dims dm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  const uint32_t s0 = smem_u32(base);
  float* dts = reinterpret_cast<float*>(base + 2 * STATE_STAGE);  // [Q]
  float* cums = dts + dm.Q;                                        // [Q]

  const int h = blockIdx.x % dm.H, bc = blockIdx.x / dm.H;
  const int c = bc % dm.nc, b = bc / dm.nc;
  const int l0 = c * dm.Q, qlen = min(dm.Q, dm.L - l0);
  const int n_kt = (qlen + TILE - 1) / TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t slot = ((int64_t)b * dm.H + h) * dm.nc + c;
  const __nv_bfloat16* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const __nv_bfloat16* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;
  const __nv_bfloat16* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h * in.x_sh;
  const __nv_bfloat16* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h * in.dy_sh;
  // one copy group per tile (the first also holds dt)
  auto load = [&](int it) {
    const uint32_t st = s0 + (it & 1) * STATE_STAGE;
    const int t0 = it * TILE;
    stage_tile<TILE, MAX_N>(st, bb + (int64_t)t0 * in.b_sl, in.b_sl, qlen - t0, dm.N / 8);
    stage_tile<TILE, MAX_N>(st + B_TILE, cb + (int64_t)t0 * in.c_sl, in.c_sl, qlen - t0,
                            dm.N / 8);
    stage_tile<TILE, MAX_P>(st + 2 * B_TILE, xb + (int64_t)t0 * in.x_sl, in.x_sl, qlen - t0,
                            dm.P / 8);
    stage_tile<TILE, MAX_P>(st + 2 * B_TILE + U_TILE, yb + (int64_t)t0 * in.dy_sl, in.dy_sl,
                            qlen - t0, dm.P / 8);
    cp_async_commit();
  };
  stage_dt(dts, in.dt + b * in.dt_sb + h * in.dt_sh, in.dt_sl, l0, dm.L, qlen);
  load(0);

  // [p][n] in two 64-column halves of n: the state, G_c
  float sacc[2][32], gacc[2][32];
#pragma unroll
  for (int pn = 0; pn < 2; ++pn)
#pragma unroll
    for (int r = 0; r < 32; ++r) sacc[pn][r] = gacc[pn][r] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const uint32_t so = (it & 1) * STATE_STAGE;
    const int t0 = it * TILE;
    cp_async_wait<0>();
    __syncthreads();                     // tile it landed; tile it-1's readers done
    if (it == 0) {
      if (warp == 0) {
        warp_scan<false>(dts, in.a[h], qlen, cums);
        __syncwarp();
        if (lane == 0) sc.tot[slot] = cums[qlen - 1];
      }
      __syncthreads();
    }
    if (it + 1 < n_kt) load(it + 1);
    // the A operands in place: bf16(bf16(x dt) exp(cum_last - cum)) and
    // bf16(dy exp(cum))
    const float total = cums[qlen - 1];
    for (int e = tid; e < TILE * TU::NJ; e += WG) {
      const int r = e / TU::NJ, j = e % TU::NJ;
      if (j >= dm.P / 8 || t0 + r >= qlen) continue;
      uint4* px = reinterpret_cast<uint4*>(base + so + 2 * B_TILE + TU::off(r, j));
      uint4* py = reinterpret_cast<uint4*>(base + so + 2 * B_TILE + U_TILE + TU::off(r, j));
      uint4 v = *px, w = *py;
      scale_chunk(v, dts[t0 + r]);
      scale_chunk(v, __expf(total - cums[t0 + r]));
      scale_chunk(w, __expf(cums[t0 + r]));
      *px = v;
      *py = w;
    }
    fence_proxy_async();
    __syncthreads();
    // state += A_u^T b, G += A_dy^T c, all four operands MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < 2; ++pn) {
        wgmma_ss<1, 1>(sacc[pn], TU::desc_mn(s0 + so + 2 * B_TILE, 0, kk),
                       TB::desc_mn(s0 + so, pn, kk), 1);
        wgmma_ss<1, 1>(gacc[pn], TU::desc_mn(s0 + so + 2 * B_TILE + U_TILE, 0, kk),
                       TB::desc_mn(s0 + so + B_TILE, pn, kk), 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int pn = 0; pn < 2; ++pn) {
      fence_regs(sacc[pn]);
      fence_regs(gacc[pn]);
    }
  }

  const int r_lo = warp * 16 + (lane >> 2), c_lane = 2 * (lane & 3);
  const int64_t PN = (int64_t)dm.P * dm.N;
  float* so = sc.st + slot * PN;
  float* go = sc.gs + slot * PN;
#pragma unroll
  for (int pn = 0; pn < 2; ++pn)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = r_lo + 8 * i, n = pn * 64 + 8 * n8 + c_lane, r = 4 * n8 + 2 * i;
        if (p < dm.P && n < dm.N) {
          *reinterpret_cast<float2*>(so + p * dm.N + n) = make_float2(sacc[pn][r], sacc[pn][r + 1]);
          *reinterpret_cast<float2*>(go + p * dm.N + n) = make_float2(gacc[pn][r], gacc[pn][r + 1]);
        }
      }
}

// -- passes 3 and 4: the key tiles and the query tiles

// Shared memory of a tile-pass block for HG heads: its own rows (b or c,
// and one 64 x P tile per head), two ring stages of the other side's rows
// (the same shapes), which after the loop hold the heads' state parts, then
// per head dt, cum and a decay over the chunk (Q rounded up to a multiple
// of TILE), and V_k of the key rows.
template <int HG>
struct PairGeom {
  static constexpr uint32_t OWN = B_TILE + HG * U_TILE;
  static constexpr uint32_t STAGE = OWN;
  static constexpr uint32_t STATES = HG * 2 * S_PART;
  static constexpr uint32_t RING = 2 * STAGE > STATES ? 2 * STAGE : STATES;
  static size_t smem(int Q) {
    return OWN + RING + (3 * (size_t)HG * padded_q(Q) + (size_t)HG * TILE) * sizeof(float) + 1024;
  }
};

// grid (B * nc * ceil(H / HG), nt): one 64-key tile of one chunk for HG
// heads; blockIdx.y = 0 is key tile 0 (the most query tiles).
template <int HG>
__global__ void __launch_bounds__(WG, 2)
ssd_bwd_keys_bf16(In<__nv_bfloat16> in, Scratch sc, Dims dm, __nv_bfloat16* __restrict__ dx) {
  using Gm = PairGeom<HG>;
  constexpr uint32_t O0 = Gm::OWN, O1 = Gm::OWN + Gm::STAGE;     // the ring's stages
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  const uint32_t s0 = smem_u32(base);                            // b rows, then u per head
  const int QS = padded_q(dm.Q);
  float* dts = reinterpret_cast<float*>(base + Gm::OWN + Gm::RING);  // [HG][QS]
  float* cums = dts + HG * QS;                                   // [HG][QS]
  float* qdec = cums + HG * QS;                                  // [HG][QS]
  float* vrow = qdec + HG * QS;                                  // [HG][TILE]

  const int G = (dm.H + HG - 1) / HG;
  const int g0 = blockIdx.x % G, bc = blockIdx.x / G;
  const int c = bc % dm.nc, b = bc / dm.nc;
  const int h0 = g0 * HG, n_heads = min(HG, dm.H - h0);
  const int l0 = c * dm.Q, qlen = min(dm.Q, dm.L - l0);
  const int kt = blockIdx.y, k0 = kt * TILE;
  if (k0 >= qlen) return;                          // a key tile past the ragged end
  const int nq = (qlen + TILE - 1) / TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2), c_lane = 2 * (lane & 3);
  const __nv_bfloat16* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const __nv_bfloat16* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;
  const __nv_bfloat16* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h0 * in.x_sh;
  const __nv_bfloat16* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h0 * in.dy_sh;

  // the key rows (b, x per head) and dt per head in one copy group
  stage_tile<TILE, MAX_N>(s0, bb + (int64_t)k0 * in.b_sl, in.b_sl, qlen - k0, dm.N / 8);
#pragma unroll
  for (int g = 0; g < HG; ++g)
    if (g < n_heads) {
      stage_tile<TILE, MAX_P>(s0 + B_TILE + g * U_TILE,
                              xb + (int64_t)k0 * in.x_sl + g * in.x_sh, in.x_sl, qlen - k0,
                              dm.P / 8);
      stage_dt(dts + g * QS, in.dt + b * in.dt_sb + (h0 + g) * in.dt_sh, in.dt_sl, l0, dm.L,
               qlen);
    }
  cp_async_commit();
  // one copy group per query tile: its c rows, and its dy rows per head
  auto load = [&](int qt) {
    const uint32_t st = s0 + (((qt - kt) & 1) ? O1 : O0);
    const int t0 = qt * TILE;
    stage_tile<TILE, MAX_N>(st, cb + (int64_t)t0 * in.c_sl, in.c_sl, qlen - t0, dm.N / 8);
#pragma unroll
    for (int g = 0; g < HG; ++g)
      if (g < n_heads)
        stage_tile<TILE, MAX_P>(st + B_TILE + g * U_TILE,
                                yb + (int64_t)t0 * in.dy_sl + g * in.dy_sh, in.dy_sl, qlen - t0,
                                dm.P / 8);
    cp_async_commit();
  };
  load(kt);
  cp_async_wait<1>();
  __syncthreads();
  if (warp < n_heads) warp_scan<false>(dts + warp * QS, in.a[h0 + warp], qlen, cums + warp * QS);
  __syncthreads();
  // u = x dt in place; for each query q past this key tile its decay from
  // the start of its own tile, exp(cum[q] - cum[q & ~63]) (zero past the
  // chunk): below the diagonal, exp(cum[q] - cum[k]) is that times
  // exp(cum[q0] - cum[k]), both at most 1
#pragma unroll
  for (int g = 0; g < HG; ++g)
    if (g < n_heads) {
      scale_rows(base + B_TILE + g * U_TILE, dts + g * QS + k0, qlen - k0, dm.P);
      const float* cg = cums + g * QS;
      for (int q = k0 + TILE + tid; q < nq * TILE; q += WG)
        qdec[g * QS + q] = q < qlen ? __expf(cg[q] - cg[q & ~(TILE - 1)]) : 0.f;
    }

  // Accumulator rows k = k0 + r_lo + 8 i (keys), columns 8 n8 + c_lane + j
  // (queries in S^T and M^T, p in du, n in dB). du per head; dB summed over
  // the group's heads, in two 64-column halves; T's column sums per head.
  float du[HG][32], db[2][32], colt[HG][2];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
#pragma unroll
    for (int g = 0; g < HG; ++g) du[g][r] = 0.f;
    db[0][r] = db[1][r] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < HG; ++g) colt[g][0] = colt[g][1] = 0.f;

  for (int qt = kt; qt < nq; ++qt) {
    const uint32_t so = ((qt - kt) & 1) ? O1 : O0;
    const int q0 = qt * TILE;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                     // tile qt landed; tile qt-1's readers done
    if (qt + 1 < nq) load(qt + 1);
    float st[32];                        // S^T = B_k C_q^T, for the group
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= n_heads) continue;
      const uint32_t ug = s0 + B_TILE + g * U_TILE, yg = s0 + so + B_TILE + g * U_TILE;
      float mt[32];                      // M^T = u_k dy_q^T
      wgmma_fence();
      if (g == 0) {
#pragma unroll
        for (int kk = 0; kk < MAX_N / 16; ++kk)
          wgmma_ss<0, 0>(st, TB::desc_k(s0, kk), TB::desc_k(s0 + so, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < MAX_P / 16; ++kk)
        wgmma_ss<0, 0>(mt, TU::desc_k(ug, kk), TU::desc_k(yg, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      if (g == 0) fence_regs(st);
      fence_regs(mt);

      // W^T = S^T o L^T and X^T = L^T o M^T as bf16 A registers of key
      // step n8 / 2: register (n8 % 2) * 2 + i holds row r_lo + 8 i,
      // queries 8 n8 + c_lane + {0, 1}
      const float* cg = cums + g * QS;
      uint32_t pw[4][4], px[4][4];
      if (qt > kt) {                     // below the diagonal: the factored decay
        float kf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) kf[i] = __expf(cg[q0] - cg[k0 + r_lo + 8 * i]);
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const float2 qd = *reinterpret_cast<const float2*>(qdec + g * QS + q0 + 8 * n8 + c_lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * n8 + 2 * i;
            const float l0_ = kf[i] * qd.x, l1_ = kf[i] * qd.y;
            const float w0 = st[r] * l0_, w1 = st[r + 1] * l1_;
            colt[g][i] = fmaf(w1, mt[r + 1], fmaf(w0, mt[r], colt[g][i]));
            pw[n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(w0, w1);
            px[n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(l0_ * mt[r], l1_ * mt[r + 1]);
          }
        }
      } else {                           // the diagonal tile: exp per pair, masked
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = k0 + r_lo + 8 * i;
          const float ck = cg[min(k, qlen - 1)];
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
            float w[2], x[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int q = q0 + 8 * n8 + c_lane + j, r = 4 * n8 + 2 * i + j;
              const float l = k <= q && q < qlen ? __expf(cg[min(q, qlen - 1)] - ck) : 0.f;
              w[j] = st[r] * l;
              x[j] = l * mt[r];
              colt[g][i] = fmaf(w[j], mt[r], colt[g][i]);
            }
            pw[n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(w[0], w[1]);
            px[n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(x[0], x[1]);
          }
        }
      }

      // du += W^T dy_q; dB += X^T C_q (dy and c MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        wgmma_rs(du[g], pw[kk], TU::desc_mn(yg, 0, kk));
        wgmma_rs(db[0], px[kk], TB::desc_mn(s0 + so, 0, kk));
        wgmma_rs(db[1], px[kk], TB::desc_mn(s0 + so, 1, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(du[g]);
      fence_regs(db[0]);
      fence_regs(db[1]);
    }
  }

  // the outgoing state's terms, from dS_out's two parts (into the ring)
  const int64_t PN = (int64_t)dm.P * dm.N;
  __syncthreads();                       // the ring's readers are done
#pragma unroll
  for (int g = 0; g < HG; ++g)
    if (g < n_heads)
      stage_parts(s0 + O0 + 2 * g * S_PART,
                  sc.gs2 + 2 * (((int64_t)b * dm.H + h0 + g) * dm.nc + c) * PN, dm.P, dm.N);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= n_heads) continue;
    const int h = h0 + g;
    const int64_t slot = ((int64_t)b * dm.H + h) * dm.nc + c;
    const float* cg = cums + g * QS;
    const float total = cg[qlen - 1];
    const uint32_t ug = s0 + B_TILE + g * U_TILE;
    const uint32_t hi = s0 + O0 + 2 * g * S_PART, lo = hi + S_PART;
    float e[2];                          // exp(cum_last - cum_k)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + r_lo + 8 * i;
      e[i] = k < qlen ? __expf(total - cg[k]) : 0.f;
    }
    // t = dS_out B_k, [k][p]: V_k = e_k <u_k, t_k>, du += e_k t
    float t[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MAX_N / 16; ++kk) {
      wgmma_ss<0, 0>(t, TB::desc_k(s0, kk), TS::desc_k(hi, kk), kk > 0);
      wgmma_ss<0, 0>(t, TB::desc_k(s0, kk), TS::desc_k(lo, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(t);
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 4 * n8 + 2 * i;
        const float2 u = tile_pair(base + B_TILE + g * U_TILE, r_lo + 8 * i, n8, c_lane);
        v[i] = fmaf(u.y, t[r + 1], fmaf(u.x, t[r], v[i]));
        du[g][r] = fmaf(e[i], t[r], du[g][r]);
        du[g][r + 1] = fmaf(e[i], t[r + 1], du[g][r + 1]);
      }
    // du . x, dx = du dt, V_k and the column sums of T, per key row
    const __nv_bfloat16* xg = xb + g * in.x_sh;
    __nv_bfloat16* dxg = dx + (((int64_t)b * dm.L + l0) * dm.H + h) * dm.P;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + 8 * i, k = k0 + row;
      const bool ok = k < qlen;
      const float dtk = ok ? dts[g * QS + k] : 0.f;
      float dux = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int p = 8 * n8 + c_lane, r = 4 * n8 + 2 * i;
        if (ok && p < dm.P) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xg + (int64_t)k * in.x_sl + p));
          dux = fmaf(du[g][r + 1], xv.y, fmaf(du[g][r], xv.x, dux));
          *reinterpret_cast<uint32_t*>(dxg + (int64_t)k * dm.H * dm.P + p) =
              pack_bf16(du[g][r] * dtk, du[g][r + 1] * dtk);
        }
      }
      dux = quad_sum(dux);
      const float vk = quad_sum(v[i]) * e[i];
      const float ct = quad_sum(colt[g][i]);
      if ((lane & 3) == 0) {
        vrow[g * TILE + row] = vk;
        if (ok) {
          sc.dux[slot * dm.Q + k] = dux;
          sc.colt[slot * dm.Q + k] = -ct - vk;
        }
      }
    }
    // t2 = dS_out^T u_k, [k][n], one 64-column half at a time:
    // dB += e_k t2 (dS_out MN-major)
#pragma unroll
    for (int pn = 0; pn < 2; ++pn) {
      float t2[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MAX_P / 16; ++kk) {
        wgmma_ss<0, 1>(t2, TU::desc_k(ug, kk), TS::desc_mn(hi, pn, kk), kk > 0);
        wgmma_ss<0, 1>(t2, TU::desc_k(ug, kk), TS::desc_mn(lo, pn, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(t2);
#pragma unroll
      for (int r = 0; r < 32; ++r) db[pn][r] = fmaf(e[(r >> 1) & 1], t2[r], db[pn][r]);
    }
  }

  // the group's dB into its slot of the partial sums
#pragma unroll
  for (int pn = 0; pn < 2; ++pn)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + r_lo + 8 * i, n = pn * 64 + 8 * n8 + c_lane, r = 4 * n8 + 2 * i;
        if (k < qlen && n < dm.N)
          *reinterpret_cast<float2*>(sc.dbp + (((int64_t)b * dm.L + l0 + k) * sc.parts + g0) *
                                                  dm.N + n) = make_float2(db[pn][r], db[pn][r + 1]);
      }
  __syncthreads();
  if (tid < n_heads) {                   // sum of V_k over the tile, in row order
    float s = 0.f;
    for (int r = 0; r < min(TILE, qlen - k0); ++r) s += vrow[tid * TILE + r];
    sc.vpart[(((int64_t)b * dm.H + h0 + tid) * dm.nc + c) * dm.nt + kt] = s;
  }
}

// grid (B * nc * ceil(H / HG), nt): one 64-query tile of one chunk for HG
// heads; blockIdx.y = 0 is the last query tile (the most key tiles).
template <int HG>
__global__ void __launch_bounds__(WG, 2)
ssd_bwd_queries_bf16(In<__nv_bfloat16> in, Scratch sc, Dims dm) {
  using Gm = PairGeom<HG>;
  constexpr uint32_t O0 = Gm::OWN, O1 = Gm::OWN + Gm::STAGE;     // the ring's stages
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  const uint32_t s0 = smem_u32(base);                            // c rows, then dy per head
  const int QS = padded_q(dm.Q);
  float* dts = reinterpret_cast<float*>(base + Gm::OWN + Gm::RING);  // [HG][QS]
  float* cums = dts + HG * QS;                                   // [HG][QS]
  float* kdec = cums + HG * QS;                                  // [HG][QS]

  const int G = (dm.H + HG - 1) / HG;
  const int g0 = blockIdx.x % G, bc = blockIdx.x / G;
  const int c = bc % dm.nc, b = bc / dm.nc;
  const int h0 = g0 * HG, n_heads = min(HG, dm.H - h0);
  const int l0 = c * dm.Q, qlen = min(dm.Q, dm.L - l0);
  const int qt = dm.nt - 1 - blockIdx.y, q0 = qt * TILE;
  if (q0 >= qlen) return;                          // a query tile past the ragged end
  const int kend = min(qlen, q0 + TILE);           // keys [0, kend), queries [q0, kend)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2), c_lane = 2 * (lane & 3);
  const __nv_bfloat16* bb = in.b + b * in.b_sb + (int64_t)l0 * in.b_sl;
  const __nv_bfloat16* cb = in.c + b * in.c_sb + (int64_t)l0 * in.c_sl;
  const __nv_bfloat16* xb = in.x + b * in.x_sb + (int64_t)l0 * in.x_sl + h0 * in.x_sh;
  const __nv_bfloat16* yb = in.dy + b * in.dy_sb + (int64_t)l0 * in.dy_sl + h0 * in.dy_sh;

  // the query rows (c, dy per head) and dt per head in one copy group
  stage_tile<TILE, MAX_N>(s0, cb + (int64_t)q0 * in.c_sl, in.c_sl, qlen - q0, dm.N / 8);
#pragma unroll
  for (int g = 0; g < HG; ++g)
    if (g < n_heads) {
      stage_tile<TILE, MAX_P>(s0 + B_TILE + g * U_TILE,
                              yb + (int64_t)q0 * in.dy_sl + g * in.dy_sh, in.dy_sl, qlen - q0,
                              dm.P / 8);
      stage_dt(dts + g * QS, in.dt + b * in.dt_sb + (h0 + g) * in.dt_sh, in.dt_sl, l0, dm.L,
               kend);
    }
  cp_async_commit();
  // one copy group per key tile: its b rows, and its x rows per head
  auto load = [&](int it) {
    const uint32_t st = s0 + ((it & 1) ? O1 : O0);
    const int t0 = it * TILE;
    stage_tile<TILE, MAX_N>(st, bb + (int64_t)t0 * in.b_sl, in.b_sl, qlen - t0, dm.N / 8);
#pragma unroll
    for (int g = 0; g < HG; ++g)
      if (g < n_heads)
        stage_tile<TILE, MAX_P>(st + B_TILE + g * U_TILE,
                                xb + (int64_t)t0 * in.x_sl + g * in.x_sh, in.x_sl, qlen - t0,
                                dm.P / 8);
    cp_async_commit();
  };
  load(0);
  cp_async_wait<1>();
  __syncthreads();
  if (warp < n_heads) warp_scan<false>(dts + warp * QS, in.a[h0 + warp], kend, cums + warp * QS);
  __syncthreads();
  // below the diagonal tile exp(cum[q] - cum[k]) = exp(cum[q] - cum[q0]) *
  // exp(cum[q0] - cum[k]), both at most 1: qdec per row in registers, kdec
  // per key in shared memory (read after the loop's barriers)
  for (int e = tid; e < HG * q0; e += WG) {
    const int g = e / q0, k = e - g * q0;
    if (g < n_heads) kdec[g * QS + k] = __expf(cums[g * QS + q0] - cums[g * QS + k]);
  }
  float qdec[HG][2];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + r_lo + 8 * i;
      qdec[g][i] = g < n_heads && q < kend ? __expf(cums[g * QS + q] - cums[g * QS + q0]) : 0.f;
    }

  // Accumulator rows q = q0 + r_lo + 8 i, columns 8 n8 + c_lane + j (keys
  // in S and M, n in dC). dC summed over the group's heads, in two
  // 64-column halves; T's row sums per head.
  float dc[2][32], rowt[HG][2];
#pragma unroll
  for (int r = 0; r < 32; ++r) dc[0][r] = dc[1][r] = 0.f;
#pragma unroll
  for (int g = 0; g < HG; ++g) rowt[g][0] = rowt[g][1] = 0.f;

  for (int it = 0; it <= qt; ++it) {
    const uint32_t so = (it & 1) ? O1 : O0;
    const int t0 = it * TILE;
    cp_async_wait<0>();
    __syncthreads();                     // tile it landed; tile it-1's readers done
    if (it < qt) load(it + 1);
#pragma unroll
    for (int g = 0; g < HG; ++g)
      if (g < n_heads)
        scale_rows(base + so + B_TILE + g * U_TILE, dts + g * QS + t0, kend - t0, dm.P);
    fence_proxy_async();
    __syncthreads();
    float s[32];                         // S = C_q B_k^T, for the group
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= n_heads) continue;
      const uint32_t yg = s0 + B_TILE + g * U_TILE, ug = s0 + so + B_TILE + g * U_TILE;
      float m[32];                       // M = dy_q u_k^T
      wgmma_fence();
      if (g == 0) {
#pragma unroll
        for (int kk = 0; kk < MAX_N / 16; ++kk)
          wgmma_ss<0, 0>(s, TB::desc_k(s0, kk), TB::desc_k(s0 + so, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < MAX_P / 16; ++kk)
        wgmma_ss<0, 0>(m, TU::desc_k(yg, kk), TU::desc_k(ug, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      if (g == 0) fence_regs(s);
      fence_regs(m);

      // X = L o M as bf16 A registers; T's row sums S o X in f32
      const float* cg = cums + g * QS;
      uint32_t px[4][4];
      if (it < qt) {                     // below the diagonal: the factored decay
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const float2 kd = *reinterpret_cast<const float2*>(kdec + g * QS + t0 + 8 * n8 + c_lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * n8 + 2 * i;
            const float x0 = qdec[g][i] * kd.x * m[r], x1 = qdec[g][i] * kd.y * m[r + 1];
            rowt[g][i] = fmaf(s[r + 1], x1, fmaf(s[r], x0, rowt[g][i]));
            px[n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(x0, x1);
          }
        }
      } else {                           // the diagonal tile: exp per pair, masked
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = q0 + r_lo + 8 * i;
          const bool q_ok = q < kend;
          const float cq = q_ok ? cg[q] : 0.f;
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
            float x[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int k = t0 + 8 * n8 + c_lane + j, r = 4 * n8 + 2 * i + j;
              const float l = q_ok && k <= q ? __expf(cq - cg[min(k, kend - 1)]) : 0.f;
              x[j] = l * m[r];
              rowt[g][i] = fmaf(s[r], x[j], rowt[g][i]);
            }
            px[n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(x[0], x[1]);
          }
        }
      }

      // dC += X B_k (b MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        wgmma_rs(dc[0], px[kk], TB::desc_mn(s0 + so, 0, kk));
        wgmma_rs(dc[1], px[kk], TB::desc_mn(s0 + so, 1, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dc[0]);
      fence_regs(dc[1]);
    }
  }

  // the incoming state's terms (zero in the first chunk), from S_in's two
  // parts (into the ring): y_inter_q = exp(cum_q) S_in C_q, and
  // dC += exp(cum_q) S_in^T dy_q
  float yd[HG][2];
#pragma unroll
  for (int g = 0; g < HG; ++g) yd[g][0] = yd[g][1] = 0.f;
  if (c > 0) {
    const int64_t PN = (int64_t)dm.P * dm.N;
    __syncthreads();                     // the ring's readers are done
#pragma unroll
    for (int g = 0; g < HG; ++g)
      if (g < n_heads)
        stage_parts(s0 + O0 + 2 * g * S_PART,
                    sc.sin2 + 2 * (((int64_t)b * dm.H + h0 + g) * dm.nc + c) * PN, dm.P, dm.N);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= n_heads) continue;
      const uint32_t yg = s0 + B_TILE + g * U_TILE;
      const uint32_t hi = s0 + O0 + 2 * g * S_PART, lo = hi + S_PART;
      float e[2];                        // exp(cum_q)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + r_lo + 8 * i;
        e[i] = q < kend ? __expf(cums[g * QS + q]) : 0.f;
      }
      float y[32];                       // C_q S_in^T, [q][p]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MAX_N / 16; ++kk) {
        wgmma_ss<0, 0>(y, TB::desc_k(s0, kk), TS::desc_k(hi, kk), kk > 0);
        wgmma_ss<0, 0>(y, TB::desc_k(s0, kk), TS::desc_k(lo, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(y);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * n8 + 2 * i;
          const float2 d = tile_pair(base + B_TILE + g * U_TILE, r_lo + 8 * i, n8, c_lane);
          yd[g][i] = fmaf(d.y, y[r + 1], fmaf(d.x, y[r], yd[g][i]));
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) yd[g][i] *= e[i];
      float t2[2][32];                   // dy_q S_in, [q][n] (S_in MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MAX_P / 16; ++kk)
#pragma unroll
        for (int pn = 0; pn < 2; ++pn) {
          wgmma_ss<0, 1>(t2[pn], TU::desc_k(yg, kk), TS::desc_mn(hi, pn, kk), kk > 0);
          wgmma_ss<0, 1>(t2[pn], TU::desc_k(yg, kk), TS::desc_mn(lo, pn, kk), 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(t2[0]);
      fence_regs(t2[1]);
#pragma unroll
      for (int pn = 0; pn < 2; ++pn)
#pragma unroll
        for (int r = 0; r < 32; ++r) dc[pn][r] = fmaf(e[(r >> 1) & 1], t2[pn][r], dc[pn][r]);
    }
  }

  // T's row sums + dy . y_inter per row; the group's dC into its slot
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    if (g >= n_heads) continue;
    const int64_t slot = ((int64_t)b * dm.H + h0 + g) * dm.nc + c;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + r_lo + 8 * i;
      const float r = quad_sum(rowt[g][i] + yd[g][i]);
      if ((lane & 3) == 0 && q < kend) sc.rowt[slot * dm.Q + q] = r;
    }
  }
#pragma unroll
  for (int pn = 0; pn < 2; ++pn)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + r_lo + 8 * i, n = pn * 64 + 8 * n8 + c_lane, r = 4 * n8 + 2 * i;
        if (q < kend && n < dm.N)
          *reinterpret_cast<float2*>(sc.dcp + (((int64_t)b * dm.L + l0 + q) * sc.parts + g0) *
                                                  dm.N + n) = make_float2(dc[pn][r], dc[pn][r + 1]);
      }
}

// ----------------------------------------------------------------- launches

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t states_smem(int P, int N, int Q) {
  return sizeof(float) * (2 * (size_t)Q + 2 * (size_t)ST * P + 2 * (size_t)ST * N);
}

// The scratch's arrays from base (null: sizes only), and the floats they
// take in all.
Scratch carve(float* base, const Dims& dm, bool bf16, int64_t* floats = nullptr) {
  const int64_t BHC = (int64_t)dm.B * dm.H * dm.nc, PN = (int64_t)dm.P * dm.N;
  Scratch s;
  s.parts = bf16 ? (dm.H + HEAD_GROUP - 1) / HEAD_GROUP : dm.H;
  const int64_t rows = (int64_t)dm.B * dm.L * s.parts * dm.N;
  int64_t used = 0;
  auto take = [&](int64_t n) {
    float* q = base ? base + used : nullptr;
    used += (n + 3) / 4 * 4;             // 16-byte aligned, for cp.async
    return q;
  };
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
  // two bf16 parts of a state take the floats of one f32 state
  s.sin2 = bf16 ? reinterpret_cast<__nv_bfloat16*>(take(BHC * PN)) : nullptr;
  s.gs2 = bf16 ? reinterpret_cast<__nv_bfloat16*>(take(BHC * PN)) : nullptr;
  if (floats) *floats = used;
  return s;
}

Dims dims(int B, int L, int H, int P, int N, int Q) {
  const int nc = (L + Q - 1) / Q;
  return Dims{B, L, H, P, N, Q, nc, (Q + TILE - 1) / TILE};
}

// Launches 5 and 6 (both paths), then the error of all launches so far.
template <typename T>
int launch_tail(const In<T>& in, float* ddt, float* da, T* db, T* dc, const Scratch& sc,
                const Dims& dm, cudaStream_t stream) {
  const size_t sf = sizeof(float) * (3 * (size_t)dm.Q + THREADS);
  const cudaError_t err = allow_smem(ssd_bwd_finish, sf);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_finish<<<dim3(dm.nc, dm.B * dm.H), THREADS, sf, stream>>>(in.dt, in.dt_sb, in.dt_sl,
                                                                    in.dt_sh, in.a, sc, dm, ddt);
  const int64_t rows = (int64_t)dm.B * dm.L * dm.N;
  ssd_bwd_reduce<T><<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(sc, dm, db,
                                                                                     dc);
  ssd_bwd_da<<<(dm.H + THREADS - 1) / THREADS, THREADS, 0, stream>>>(sc, dm, da);
  return (int)cudaGetLastError();
}

int launch_f32(const In<float>& in, float* dx, float* ddt, float* da, float* db, float* dc,
               float* scratch, const Dims& dm, cudaStream_t stream) {
  const size_t s1 = states_smem(dm.P, dm.N, dm.Q);
  const size_t sk = sizeof(float) * tile_smem_floats(dm.P, dm.N, dm.Q, 2);
  const size_t sq = sizeof(float) * tile_smem_floats(dm.P, dm.N, dm.Q, 1);
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_chunk_states, s1)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_bwd_keys, sk)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(ssd_bwd_queries, sq)) != cudaSuccess) return (int)err;
  const Scratch sc = carve(scratch, dm, false);
  const int BH = dm.B * dm.H;
  ssd_bwd_chunk_states<<<dim3(dm.nc, BH), THREADS, s1, stream>>>(in, sc, dm);
  ssd_bwd_state_pass<false><<<dim3((dm.P * dm.N + THREADS - 1) / THREADS, BH), THREADS, 0,
                              stream>>>(in.dstate, sc, dm);
  ssd_bwd_keys<<<dim3(dm.nc * dm.nt, BH), THREADS, sk, stream>>>(in, sc, dm, dx);
  ssd_bwd_queries<<<dim3(dm.nc * dm.nt, BH), THREADS, sq, stream>>>(in, sc, dm);
  return launch_tail(in, ddt, da, db, dc, sc, dm, stream);
}

int launch_bf16(const In<__nv_bfloat16>& in, __nv_bfloat16* dx, float* ddt, float* da,
                __nv_bfloat16* db, __nv_bfloat16* dc, float* scratch, const Dims& dm,
                cudaStream_t stream) {
  using Gm = PairGeom<HEAD_GROUP>;
  if (dm.P % 8 || dm.N % 8) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;          // once, for the longest chunk
  if (!attr_set) {
    cudaError_t err;
    if ((err = allow_smem(ssd_bwd_chunk_states_bf16, states_smem_bf16(MAX_Q))) != cudaSuccess)
      return (int)err;
    if ((err = allow_smem(ssd_bwd_keys_bf16<HEAD_GROUP>, Gm::smem(MAX_Q))) != cudaSuccess)
      return (int)err;
    if ((err = allow_smem(ssd_bwd_queries_bf16<HEAD_GROUP>, Gm::smem(MAX_Q))) != cudaSuccess)
      return (int)err;
    attr_set = true;
  }
  const Scratch sc = carve(scratch, dm, true);
  const int bc = dm.B * dm.nc, G = sc.parts;
  ssd_bwd_chunk_states_bf16<<<bc * dm.H, WG, states_smem_bf16(dm.Q), stream>>>(in, sc, dm);
  ssd_bwd_state_pass<true><<<dim3((dm.P * dm.N + 4 * THREADS - 1) / (4 * THREADS), dm.B * dm.H),
                             THREADS, 0, stream>>>(in.dstate, sc, dm);
  ssd_bwd_keys_bf16<HEAD_GROUP><<<dim3(bc * G, dm.nt), WG, Gm::smem(dm.Q), stream>>>(in, sc, dm,
                                                                                   dx);
  ssd_bwd_queries_bf16<HEAD_GROUP><<<dim3(bc * G, dm.nt), WG, Gm::smem(dm.Q), stream>>>(in, sc,
                                                                                      dm);
  return launch_tail(in, ddt, da, db, dc, sc, dm, stream);
}

}  // namespace

extern "C" {

// Limits the wrapper checks before a launch: head dim P, state N, chunk Q.
int ssd_scan_bwd_max_p() { return MAX_P; }
int ssd_scan_bwd_max_n() { return MAX_N; }
int ssd_scan_bwd_max_q() { return MAX_Q; }

// f32 scratch the launch needs, in floats, for dtype (as in the launch).
long long ssd_scan_bwd_scratch_floats(int dtype, int B, int L, int H, int P, int N, int Q) {
  int64_t floats = 0;
  carve(nullptr, dims(B, L, H, P, N, Q), dtype == 1, &floats);
  return (long long)floats;
}

// dtype (of x, b, c, dy and of dx, db, dc): 0 = float32 (CUDA cores),
// 1 = bfloat16 (tensor cores); dt, a, dstate, ddt and da are f32. Strides
// are in elements. dstate may be null (a zero cotangent for the final
// state). Q is the chunk length. Returns the cudaError_t of the launches
// (0 = success); the caller raises on nonzero.
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
    return launch_f32(in, static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(da),
                      static_cast<T*>(db), static_cast<T*>(dc), sc, dm, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const In<T> in{static_cast<const T*>(x), x_sb, x_sl, x_sh, dtf, dt_sb, dt_sl, dt_sh, af,
                   static_cast<const T*>(bm), b_sb, b_sl, static_cast<const T*>(cm), c_sb, c_sl,
                   static_cast<const T*>(dy), dy_sb, dy_sl, dy_sh, ds};
    return launch_bf16(in, static_cast<T*>(dx), static_cast<float*>(ddt),
                       static_cast<float*>(da), static_cast<T*>(db), static_cast<T*>(dc), sc, dm,
                       st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
