// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py::ssd_scan_bh (body `_kernel`)
// and computes src/repro/models/ssm.py::ssd_reference: per chunk of Q rows,
// cum = cumsum(dt*a), xdt = x*dt, the scores C B^T weighted by the decay
// exp(cum[q] - cum[k]) (k <= q); y = (scores * decay) @ xdt
// + exp(cum) * (C @ S_in^T), with S_in the f32 (P, N) state carried in from
// the chunks before; the chunk's state update S_out = exp(cum[-1]) * S_in
// + sum_k exp(cum[-1] - cum[k]) xdt[k] (x) b[k]. A ragged tail counts as
// dt = 0 (decay 1, zero input: the state is unchanged), as the Pallas
// kernel pads it.
//
// Bound: bytes, at mamba2-130m's widths. At B=1, L=2048 the least work is
// about 2.5 GFLOP (C B^T once per chunk for all heads and only on and below
// the diagonal; per head the weighted scores times x*dt, the chunk states
// and the inter-chunk term) against 14.6 MB moved once (x in, y out, dt, b,
// c, the final state): 0.0025 ms at the bf16 tensor-core peak, 0.0044 ms at
// 3.35 TB/s. Only the tensor cores come near either, so the bf16 path runs
// every product on them. What it does not reach is the bytes: the passes
// fill shared memory from L2 with several times the 14.6 MB (each q tile
// reads its key tiles and incoming states again), and each block runs one
// warpgroup whose loads, products and barriers follow one another.
//
// The TPU grid walks (B*H, chunks) with the chunks in order, which gives
// only B*H = 24 blocks at B=1 for mamba2-130m, against 132 SMs. This port
// takes the reference's own decomposition into three launches, so the two
// heavy passes run in parallel over (b, chunk, heads):
//   1. chunk states: per (b, chunk, head), the chunk's own state
//      sum_k exp(cum[-1] - cum[k]) xdt[k] (x) b[k] and its total log-decay
//      cum[-1], into f32 scratch;
//   2. ssd_state_pass: per (b, h) and state element, the short sequential
//      pass over the chunks S_in[c] = S; S = exp(tot[c]) * S + chunk[c],
//      writing each chunk's incoming state and the final state out;
//   3. outputs: per (b, chunk, 64-row q tile) the intra-chunk term over the
//      key tiles up to the diagonal and the inter-chunk term from S_in.
//
// Two paths, chosen by dtype in the C entry point (dispatch by dtype, not a
// fallback; a launch that fails returns its error and the wrapper raises):
//
// * bfloat16 (the models' type): tensor cores. A block is one warpgroup
//   (128 threads). Operand tiles are staged by 16-byte cp.async, eight
//   threads to a 128-byte row segment (zeros past the chunk, past L, past P
//   and past N), into the swizzled layout TMA would write (Tile, in
//   ssd_common.cuh), in a ring of stages.
//   - ssd_chunk_state_bf16, grid (B * nc * H), a four-stage ring of 64-key
//     tiles: per head state = (xdt * to_end)^T . B_chunk, wgmma m64n64k16
//     per 64 columns of N with both operands MN-major from shared memory
//     (transpose bits set). The A operand is x*dt rounded to bf16 (the
//     reference's rounding of xdt), times to_end = exp(cum[-1] - cum[k]),
//     rounded to bf16 again: one rounding the reference, which takes this
//     product in f32, does not make (PERF.md records the state's error).
//   - ssd_state_pass<true> writes each S_in as two bf16 parts, a high part
//     and the bf16 rounding of the rest (about 16 bits of mantissa; the
//     state is never carried as a single bf16).
//   - ssd_chunk_output_bf16, grid (B * nc * ceil(H/HG), q tiles), the q tile
//     nearest the chunk's end (the most key tiles) dispatched first: one
//     64-row q tile of one (b, chunk) for a group of HG = 2 heads (the
//     fastest of 1, 2 and 4 at mamba2-130m's widths, PERF.md; HG is the
//     SSD_HEAD_GROUP macro so that kernels/ssd_head_groups.py can build
//     the others and time them). The c rows of the
//     tile are staged once. Per key tile up to the diagonal, in a two-stage
//     ring: S = C . B^T (wgmma m64n64k16, both K-major) once for all HG
//     heads; per head W = S * exp(cum[q] - cum[k]) on the accumulator
//     fragment in registers (below the diagonal tile as the product of a
//     per-row and a per-key factor, both at most 1; on it per pair, zero
//     above the diagonal and past the chunk), rounded to bf16 into the A
//     registers of y += W . xdt (wgmma m64nPk16, xdt MN-major from shared
//     memory). x is staged raw and scaled by dt in place, rounded to bf16 as
//     the reference rounds xdt. Last, per head, the inter-chunk term
//     exp(cum[q]) * C . S_in^T as two bf16 products (high and low part),
//     its parts loaded into the stages the key tiles free. y goes out
//     through shared memory in 16-byte stores. So C B^T is computed
//     ceil(H/HG) times per (b, chunk, q tile, key tile): 12 times at
//     mamba2-130m's 24 heads with HG = 2, against 24 in a kernel per head.
//   P is run at the next of 8, 16, 32, 64 and N at the next of 16, 32,
//   64, 128 (the wgmma widths and the 16-deep k step), with zeros in the
//   columns past them. x, b and c must have P and N multiples of 8, a
//   16-byte aligned base and strides of 16-byte multiples (the wrapper
//   checks and raises).
//
// * float32 (parity cases only): CUDA-core kernels ssd_chunk_state_f32
//   and ssd_chunk_output_f32 (the tensor cores would round f32 inputs),
//   staged in shared memory as f32 with every product an fmaf.
//
// Layout: x (B, L, H, P), dt (B, L, H), b and c (B, L, N) are read through
// their strides (x's and b/c's innermost dim contiguous); b and c are
// shared by all heads and never copied per head. y is a contiguous
// (B, L, H, P) in x's type, the state a contiguous (B, H, P, N) in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_common.cuh"

namespace {

constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int MAX_Q = 1024;

struct Dims {
  int B, L, H, P, N, Q, nc;
};

// ------------------------------------------------------------------ f32 path

constexpr int THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int ST = 32;           // rows staged per step in ssd_chunk_state_f32
constexpr int QT = 64;           // query rows (and key rows) per tile in ssd_chunk_output_f32
constexpr int PC = MAX_P / 16;   // p columns per thread
constexpr int NC = MAX_N / 16;   // n columns per thread (ssd_chunk_state_f32)
constexpr int RT = QT / 16;      // rows per thread (ssd_chunk_output_f32)

// cum[i] = sum_{j <= i} dt[l0 + j] * a for the chunk's Q rows (rows at or
// past L count as dt = 0). Needs a __syncthreads() before cum is read.
__device__ void chunk_cumsum(const float* __restrict__ dtb, int64_t dt_sl, float a,
                             int l0, int L, int Q, float* cum) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const int l = l0 + i;
    cum[i] = l < L ? dtb[l * dt_sl] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_scan<false>(cum, a, Q, cum);
}

// f32 pass 1, grid (nc, B*H): the chunk's own state into chunk_state[bh][c] (P, N),
// its total log-decay into tot[bh][c].
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_f32(const float* __restrict__ x, int64_t x_sb, int64_t x_sl, int64_t x_sh,
                    const float* __restrict__ dt, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                    const float* __restrict__ a,
                    const float* __restrict__ bm, int64_t b_sb, int64_t b_sl,
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
  const float* xb = x + b * x_sb + h * x_sh;
  const float* bb = bm + b * b_sb;

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
        val = xb[l * x_sl + p] * dtb[l * dt_sl] * expf(total - cum[r0 + r]);
      xs[e] = val;
    }
    for (int e = tid; e < ST * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      const int l = l0 + r0 + r;
      bs[e] = (r0 + r < Q && l < dm.L) ? bb[l * b_sl + n] : 0.f;
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

// Pass 2 (both types), grid (ceil(P*N / (V*THREADS)), B*H): the sequential
// pass over the chunks, S_in[c] = S; S = exp(tot[c]) * S + chunk[c], on V
// consecutive state elements a thread. f32 (V = 1) writes S_in[c] over
// chunk_state[bh][c]; SPLIT (bf16, V = 4) writes it to sin[bh][c] as two
// row-major (P, N) bf16 parts, hi = bf16(S) and lo = bf16(S - hi). The loads
// of eight chunks are issued before their stores, so their latencies
// overlap.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ chunk_state, const float* __restrict__ tot,
               float* __restrict__ state_out, __nv_bfloat16* __restrict__ sin, Dims dm) {
  constexpr int V = SPLIT ? 4 : 1;
  using Vec = typename std::conditional<SPLIT, float4, float>::type;
  const int PN = dm.P * dm.N;            // a multiple of V
  const int e = (blockIdx.x * THREADS + threadIdx.x) * V;
  const int bh = blockIdx.y;
  if (e >= PN) return;
  float s[V] = {};
  for (int c0 = 0; c0 < dm.nc; c0 += 8) {
    Vec own[8];
    float decay[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t slot = (int64_t)bh * dm.nc + c0 + i;
      if (c0 + i < dm.nc) {
        own[i] = *reinterpret_cast<const Vec*>(chunk_state + slot * PN + e);
        decay[i] = expf(tot[slot]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i >= dm.nc) break;
      const int64_t slot = (int64_t)bh * dm.nc + c0 + i;
      const float* o = reinterpret_cast<const float*>(&own[i]);
      if constexpr (SPLIT) {
        uint32_t hi[V / 2], lo[V / 2];
#pragma unroll
        for (int v = 0; v < V; v += 2) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(s[v], s[v + 1]);
          const float2 hf = __bfloat1622float2(h2);
          hi[v / 2] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[v / 2] = pack_bf16(s[v] - hf.x, s[v + 1] - hf.y);
        }
        *reinterpret_cast<uint2*>(sin + 2 * slot * PN + e) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(sin + (2 * slot + 1) * PN + e) = make_uint2(lo[0], lo[1]);
      } else {
        chunk_state[slot * PN + e] = s[0];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = s[v] * decay[i] + o[v];
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) state_out[(int64_t)bh * PN + e + v] = s[v];
}

// f32 pass 3, grid (nc * ceil(Q / QT), B*H): y for one 64-row tile of one chunk.
__global__ void __launch_bounds__(THREADS)
ssd_chunk_output_f32(const float* __restrict__ x, int64_t x_sb, int64_t x_sl, int64_t x_sh,
                     const float* __restrict__ dt, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                     const float* __restrict__ a,
                     const float* __restrict__ bm, int64_t b_sb, int64_t b_sl,
                     const float* __restrict__ cm, int64_t c_sb, int64_t c_sl,
                     const float* __restrict__ state_in, float* __restrict__ y, Dims dm) {
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
  const float* xb = x + b * x_sb + h * x_sh;
  const float* bb = bm + b * b_sb;
  const float* cb = cm + b * c_sb;

  chunk_cumsum(dtb, dt_sl, a[h], l0, dm.L, Q, cum);
  for (int e = tid; e < QT * N; e += THREADS) {
    const int r = e / N, n = e - r * N;
    const int l = l0 + r0 + r;
    cs[e] = (r0 + r < Q && l < dm.L) ? cb[l * c_sl + n] : 0.f;
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
      bs[t * ldb + n] = (k0 + t < Q && l < dm.L) ? bb[l * b_sl + n] : 0.f;
    }
    for (int e = tid; e < QT * P; e += THREADS) {
      const int t = e / P, p = e - t * P;
      const int l = l0 + k0 + t;
      xs[e] = (k0 + t < Q && l < dm.L) ? xb[l * x_sl + p] * dtb[l * dt_sl] : 0.f;
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
    float* yrow = y + (((int64_t)b * dm.L + l) * dm.H + h) * P;
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int p = tx + 16 * j;
      if (p < P) yrow[p] = acc[i][j];
    }
  }
}

// ----------------------------------------------------------------- bf16 path

// Heads per output block (see the header).
#ifndef SSD_HEAD_GROUP
#define SSD_HEAD_GROUP 2
#endif
constexpr int HEAD_GROUP = SSD_HEAD_GROUP;
constexpr int STATE_STAGES = 4;  // ring depth of the chunk-state pass

// -- pass 1: chunk states

template <int NPAD>
struct StateGeom {
  using TB = Tile<TILE, NPAD>;                          // b rows of 64 keys
  using TA = Tile<TILE, 64>;                            // x*dt*to_end of 64 keys, 64 p columns
  static constexpr uint32_t STAGE = TB::BYTES + TA::BYTES;
  // the ring, then dt and cum
  static size_t smem(int Q) { return STATE_STAGES * STAGE + 2 * (size_t)Q * sizeof(float) + 1024; }
};

// grid (B * nc * H): the state of one chunk for one head.
template <int NPAD>
__global__ void __launch_bounds__(WG)
ssd_chunk_state_bf16(const __nv_bfloat16* __restrict__ x, int64_t x_sb, int64_t x_sl,
                     int64_t x_sh, const float* __restrict__ dt, int64_t dt_sb, int64_t dt_sl,
                     int64_t dt_sh, const float* __restrict__ a,
                     const __nv_bfloat16* __restrict__ bm, int64_t b_sb, int64_t b_sl,
                     float* __restrict__ chunk_state, float* __restrict__ tot, Dims dm) {
  using Gm = StateGeom<NPAD>;
  constexpr int S = STATE_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  const uint32_t s0 = smem_u32(base);
  float* dts = reinterpret_cast<float*>(base + S * Gm::STAGE);    // [Q]
  float* cums = dts + dm.Q;                                        // [Q]

  const int h = blockIdx.x % dm.H, bc = blockIdx.x / dm.H;
  const int c = bc % dm.nc, b = bc / dm.nc;
  const int l0 = c * dm.Q, qlen = min(dm.Q, dm.L - l0);
  const int n_kt = (qlen + TILE - 1) / TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* bb = bm + b * b_sb + (int64_t)l0 * b_sl;
  const __nv_bfloat16* xb = x + b * x_sb + (int64_t)l0 * x_sl + h * x_sh;
  // one copy group per tile: its b rows and x rows (the first also dt)
  auto load = [&](int it) {
    if (it < n_kt) {
      const uint32_t st = s0 + (it % S) * Gm::STAGE;
      const int t0 = it * TILE;
      stage_tile<TILE, NPAD>(st, bb + (int64_t)t0 * b_sl, b_sl, qlen - t0, dm.N / 8);
      stage_tile<TILE, 64>(st + Gm::TB::BYTES, xb + (int64_t)t0 * x_sl, x_sl, qlen - t0,
                           dm.P / 8);
    }
    cp_async_commit();
  };

  stage_dt(dts, dt + b * dt_sb + h * dt_sh, dt_sl, l0, dm.L, qlen);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load(i);

  // one accumulator per 64-column panel of b
  float acc[Gm::TB::NP][Gm::TB::PW / 2];
#pragma unroll
  for (int p = 0; p < Gm::TB::NP; ++p)
#pragma unroll
    for (int r = 0; r < Gm::TB::PW / 2; ++r) acc[p][r] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();                     // tile it (and dt) landed; tile it-1's readers done
    if (it == 0) {
      if (warp == 0) {
        warp_scan<false>(dts, a[h], qlen, cums);
        __syncwarp();
        if (lane == 0) tot[(int64_t)(b * dm.H + h) * dm.nc + c] = cums[qlen - 1];
      }
      __syncthreads();
    }
    load(it + S - 1);
    // A in place: bf16(bf16(x * dt) * to_end), to_end = exp(cum[-1] - cum[k])
    const uint32_t so = (it % S) * Gm::STAGE;
    const int t0 = it * TILE;
    const float total = cums[qlen - 1];
    uint8_t* at = base + so + Gm::TB::BYTES;
#pragma unroll
    for (int e = tid; e < TILE * 8; e += WG) {
      const int r = e / 8, j = e % 8;
      if (j >= dm.P / 8 || t0 + r >= qlen) continue;
      uint4* p = reinterpret_cast<uint4*>(at + Gm::TA::off(r, j));
      uint4 v = *p;
      scale_chunk(v, dts[t0 + r]);
      scale_chunk(v, __expf(total - cums[t0 + r]));
      *p = v;
    }
    fence_proxy_async();
    __syncthreads();
    // state (P x N) += A^T (P x 64 keys) . b (64 keys x N), both MN-major,
    // one product per 64-column panel of b
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
      for (int p = 0; p < Gm::TB::NP; ++p)
        wgmma_ss<1, 1>(acc[p], Gm::TA::desc_mn(s0 + so + Gm::TB::BYTES, 0, kk),
                       Gm::TB::desc_mn(s0 + so, p, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < Gm::TB::NP; ++p) fence_regs(acc[p]);
  }
  cp_async_wait<0>();                    // no copy may land after the block exits

  const int r_lo = warp * 16 + (lane >> 2), c_lane = 2 * (lane & 3);
  float* out = chunk_state + ((int64_t)(b * dm.H + h) * dm.nc + c) * dm.P * dm.N;
#pragma unroll
  for (int pn = 0; pn < Gm::TB::NP; ++pn)
#pragma unroll
    for (int n8 = 0; n8 < Gm::TB::PW / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = r_lo + 8 * i, n = pn * Gm::TB::PW + 8 * n8 + c_lane;
        if (p < dm.P && n < dm.N)
          *reinterpret_cast<float2*>(out + p * dm.N + n) =
              make_float2(acc[pn][4 * n8 + 2 * i], acc[pn][4 * n8 + 2 * i + 1]);
      }
}

// -- pass 3: outputs

template <int PP, int NPAD, int HG>
struct OutGeom {
  using TC = Tile<TILE, NPAD>;                              // c rows of the q tile
  using TB = Tile<TILE, NPAD>;                              // b rows of a key tile
  using TX = Tile<TILE, PP>;                                // x*dt of a key tile, one head
  using TS = Tile<PP, NPAD>;                                // one bf16 part of a head's S_in
  static constexpr uint32_t C_TILE = TC::BYTES, B_TILE = TB::BYTES, X_TILE = TX::BYTES;
  static constexpr uint32_t STAGE = B_TILE + HG * X_TILE;
  static constexpr uint32_t S_IN = TS::BYTES;
  static constexpr uint32_t Y_ROW = PP * 2 + 16;            // padded: no bank conflicts
  static constexpr uint32_t Y = HG * TILE * Y_ROW;
  // Two regions of R bytes: the two stages of the key-tile ring, then the
  // S_in parts of half the group's heads each, then y (region 0).
  static constexpr uint32_t R_IN = (HG + 1) / 2 * 2 * S_IN;
  static constexpr uint32_t R_MAX = STAGE > Y ? STAGE : Y;
  static constexpr uint32_t R = ((R_MAX > R_IN ? R_MAX : R_IN) + 1023) / 1024 * 1024;
  // c rows, the two regions, then dt, cum and the key decays of HG heads
  // (Q rounded up to a multiple of 4 each)
  static size_t smem(int Q) {
    return C_TILE + 2 * R + 3 * (size_t)HG * ((Q + 3) & ~3) * sizeof(float) + 1024;
  }
};

// grid (B * nc * ceil(H / HG), q tiles): y for one 64-row q tile of one
// chunk for HG heads; blockIdx.y = 0 is the last q tile (the most key tiles).
template <int PP, int NPAD, int HG>
__global__ void __launch_bounds__(WG)
ssd_chunk_output_bf16(const __nv_bfloat16* __restrict__ x, int64_t x_sb, int64_t x_sl,
                      int64_t x_sh, const float* __restrict__ dt, int64_t dt_sb, int64_t dt_sl,
                      int64_t dt_sh, const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ bm, int64_t b_sb, int64_t b_sl,
                      const __nv_bfloat16* __restrict__ cm, int64_t c_sb, int64_t c_sl,
                      const __nv_bfloat16* __restrict__ sin, __nv_bfloat16* __restrict__ y,
                      Dims dm) {
  using Gm = OutGeom<PP, NPAD, HG>;
  constexpr uint32_t O0 = Gm::C_TILE, O1 = Gm::C_TILE + Gm::R;     // the two regions
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  const uint32_t sc = smem_u32(base);                               // c rows
  const int QS = (dm.Q + 3) & ~3;                                   // per-head stride
  float* dts = reinterpret_cast<float*>(base + O1 + Gm::R);         // [HG][QS]
  float* cums = dts + HG * QS;                                      // [HG][QS]
  float* kdec = cums + HG * QS;                                     // [HG][QS]

  const int n_qt = (dm.Q + TILE - 1) / TILE;
  const int qt = n_qt - 1 - blockIdx.y, r0 = qt * TILE;
  const int G = (dm.H + HG - 1) / HG;
  const int g0 = blockIdx.x % G, bc = blockIdx.x / G;
  const int c = bc % dm.nc, b = bc / dm.nc;
  const int h0 = g0 * HG, n_heads = min(HG, dm.H - h0);
  const int l0 = c * dm.Q, qlen = min(dm.Q, dm.L - l0);
  if (r0 >= qlen) return;                          // a q tile past the ragged end
  const int kend = min(qlen, r0 + TILE);           // keys [0, kend), queries [r0, kend)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* bb = bm + b * b_sb + (int64_t)l0 * b_sl;
  const __nv_bfloat16* xb = x + b * x_sb + (int64_t)l0 * x_sl + h0 * x_sh;
  const int64_t PN = (int64_t)dm.P * dm.N;
  // one copy group per key tile: its b rows, and its x rows per head
  auto load = [&](int it) {
    const uint32_t st = sc + ((it & 1) ? O1 : O0);
    const int t0 = it * TILE;
    stage_tile<TILE, NPAD>(st, bb + (int64_t)t0 * b_sl, b_sl, qlen - t0, dm.N / 8);
#pragma unroll
    for (int g = 0; g < HG; ++g)
      if (g < n_heads)
        stage_tile<TILE, PP>(st + Gm::B_TILE + g * Gm::X_TILE,
                             xb + (int64_t)t0 * x_sl + g * x_sh, x_sl, qlen - t0, dm.P / 8);
    cp_async_commit();
  };

  // the c rows and dt in one copy group, key tile 0 in the next
  stage_tile<TILE, NPAD>(sc, cm + b * c_sb + (int64_t)(l0 + r0) * c_sl, c_sl, qlen - r0,
                         dm.N / 8);
#pragma unroll
  for (int g = 0; g < HG; ++g)
    if (g < n_heads)
      stage_dt(dts + g * QS, dt + b * dt_sb + (h0 + g) * dt_sh, dt_sl, l0, dm.L, kend);
  cp_async_commit();
  load(0);
  cp_async_wait<1>();
  __syncthreads();
  if (warp < n_heads) warp_scan<false>(dts + warp * QS, a[h0 + warp], kend, cums + warp * QS);
  __syncthreads();

  // Below the diagonal tile every key k precedes every query q of the tile,
  // and exp(cum[q] - cum[k]) = exp(cum[q] - cum[r0]) * exp(cum[r0] - cum[k])
  // with both factors at most 1: qdec per row in registers, kdec per key in
  // shared memory (read after the loop's barriers).
  for (int e = tid; e < HG * r0; e += WG) {
    const int g = e / r0, k = e - g * r0;
    if (g < n_heads) kdec[g * QS + k] = __expf(cums[g * QS + r0] - cums[g * QS + k]);
  }
  // Accumulator rows: q = r0 + r_lo + 8*i; columns p = 8*n8 + c_lane + j.
  const int r_lo = warp * 16 + (lane >> 2), c_lane = 2 * (lane & 3);
  float qdec[HG][2];
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = r0 + r_lo + 8 * i;
      qdec[g][i] = g < n_heads && q < kend ? __expf(cums[g * QS + q] - cums[g * QS + r0])
                                           : 0.f;
    }
  float acc[HG][PP / 2];

  // The heads' S_in parts come after the key tiles, into the regions they
  // free: the first half of the heads during the last tile, the rest after.
  constexpr int HG1 = (HG + 1) / 2;
  auto load_state_in = [&](uint32_t region, int g_begin, int g_end) {
    for (int g = g_begin; g < g_end && g < n_heads; ++g) {
      const __nv_bfloat16* sg = sin + 2 * (((int64_t)b * dm.H + h0 + g) * dm.nc + c) * PN;
      const uint32_t dst = sc + region + 2 * (g - g_begin) * Gm::S_IN;
      stage_tile<PP, NPAD>(dst, sg, dm.N, dm.P, dm.N / 8);
      stage_tile<PP, NPAD>(dst + Gm::S_IN, sg + PN, dm.N, dm.P, dm.N / 8);
    }
    cp_async_commit();
  };

  // intra-chunk term over the key tiles up to the diagonal
  for (int it = 0; it <= qt; ++it) {
    const uint32_t so = (it & 1) ? O1 : O0;
    const int t0 = it * TILE;
    cp_async_wait<0>();
    __syncthreads();                     // tile it landed; tile it-1's readers done
    if (it < qt)
      load(it + 1);
    else if (c > 0)
      load_state_in(so == O0 ? O1 : O0, 0, HG1);
    // x * dt in place, rounded to bf16 as the reference rounds xdt
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= n_heads) continue;
      const float* dg = dts + g * QS;
      uint8_t* xt = base + so + Gm::B_TILE + g * Gm::X_TILE;
#pragma unroll
      for (int i = 0; i < (TILE * Gm::TX::NJ + WG - 1) / WG; ++i) {
        const int e = i * WG + tid;
        if (TILE * Gm::TX::NJ % WG && e >= TILE * Gm::TX::NJ) break;
        const int r = e / Gm::TX::NJ, j = e % Gm::TX::NJ;
        if (j >= dm.P / 8 || t0 + r >= kend) continue;
        uint4* p = reinterpret_cast<uint4*>(xt + Gm::TX::off(r, j));
        uint4 v = *p;
        scale_chunk(v, dg[t0 + r]);
        *p = v;
      }
    }
    fence_proxy_async();
    __syncthreads();

    // S = C . B^T, once for the group's heads
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NPAD / 16; ++kk)
      wgmma_ss<0, 0>(s, Gm::TC::desc_k(sc, kk), Gm::TB::desc_k(sc + so, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // per head W = S * exp(cum[q] - cum[k]) under the mask, as bf16 A
    // registers of key step n8 / 2: register (n8 % 2) * 2 + i holds row
    // r_lo + 8*i, keys 8*n8 + c_lane + {0, 1}
    uint32_t pa[HG][4][4];
    if (it < qt) {                       // below the diagonal: the factored decay
#pragma unroll
      for (int g = 0; g < HG; ++g)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const float2 kd = *reinterpret_cast<const float2*>(kdec + g * QS + t0 + 8 * n8 +
                                                             c_lane);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            pa[g][n8 / 2][(n8 % 2) * 2 + i] =
                pack_bf16(s[4 * n8 + 2 * i] * qdec[g][i] * kd.x,
                          s[4 * n8 + 2 * i + 1] * qdec[g][i] * kd.y);
        }
    } else {                             // the diagonal tile: exp per pair, masked
#pragma unroll
      for (int g = 0; g < HG; ++g) {
        const float* cg = cums + g * QS;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = r0 + r_lo + 8 * i;
          const bool q_ok = g < n_heads && q < kend;
          const float cq = q_ok ? cg[q] : 0.f;
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
            float w[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int k = t0 + 8 * n8 + c_lane + j;
              w[j] = q_ok && k <= q ? s[4 * n8 + 2 * i + j] * __expf(cq - cg[min(k, kend - 1)])
                                    : 0.f;
            }
            pa[g][n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(w[0], w[1]);
          }
        }
      }
    }

    // y += W . xdt, xdt MN-major; the first product overwrites the
    // accumulator
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= n_heads) continue;
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs(acc[g], pa[g][kk],
                 Gm::TX::desc_mn(sc + so + Gm::B_TILE + g * Gm::X_TILE, 0, kk), it > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int g = 0; g < HG; ++g) fence_regs(acc[g]);
  }

  // inter-chunk term, per head: exp(cum[q]) * C . (S_in hi + S_in lo)^T
  if (c > 0) {
    const uint32_t last = (qt & 1) ? O1 : O0;
    __syncthreads();                     // the last tile's region is free
    load_state_in(last, HG1, HG);
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      if (g >= n_heads) continue;
      if (g == 0 || g == HG1) {          // this half's parts landed, for wgmma too
        if (g == 0)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        fence_proxy_async();
        __syncthreads();
      }
      const uint32_t part = sc + (g < HG1 ? (last == O0 ? O1 : O0) + 2 * g * Gm::S_IN
                                          : last + 2 * (g - HG1) * Gm::S_IN);
      float t[PP / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NPAD / 16; ++kk) {
        wgmma_ss<0, 0>(t, Gm::TC::desc_k(sc, kk), Gm::TS::desc_k(part, kk), kk > 0);
        wgmma_ss<0, 0>(t, Gm::TC::desc_k(sc, kk), Gm::TS::desc_k(part + Gm::S_IN, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = r0 + r_lo + 8 * i;
        const float e = q < kend ? __expf(cums[g * QS + q]) : 0.f;
#pragma unroll
        for (int r = 0; r < PP / 8; ++r) {
          acc[g][4 * r + 2 * i] += e * t[4 * r + 2 * i];
          acc[g][4 * r + 2 * i + 1] += e * t[4 * r + 2 * i + 1];
        }
      }
    }
  }

  // y through shared memory (region 0, free now), then 16-byte stores
  __syncthreads();
  uint8_t* ys = base + O0;
#pragma unroll
  for (int g = 0; g < HG; ++g)
#pragma unroll
    for (int n8 = 0; n8 < PP / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(ys + (g * TILE + r_lo + 8 * i) * Gm::Y_ROW +
                                     (8 * n8 + c_lane) * 2) =
            pack_bf16(acc[g][4 * n8 + 2 * i], acc[g][4 * n8 + 2 * i + 1]);
  __syncthreads();
  const int nj = dm.P / 8;
  for (int e = tid; e < TILE * HG * nj; e += WG) {
    const int j = e % nj, rest = e / nj, g = rest % HG, row = rest / HG;
    const int q = r0 + row;
    if (g >= n_heads || q >= kend) continue;
    *reinterpret_cast<uint4*>(y + (((int64_t)b * dm.L + l0 + q) * dm.H + h0 + g) * dm.P + j * 8) =
        *reinterpret_cast<const uint4*>(ys + (g * TILE + row) * Gm::Y_ROW + j * 16);
  }
}

// ----------------------------------------------------------------- launches

// Everything a launch takes: pointers, strides in elements, sizes, stream.
struct Args {
  const void* x;
  int64_t x_sb, x_sl, x_sh;
  const float* dt;
  int64_t dt_sb, dt_sl, dt_sh;
  const float* a;
  const void* b;
  int64_t b_sb, b_sl;
  const void* c;
  int64_t c_sb, c_sl;
  void* y;
  float* state;
  float* chunk_state;
  float* tot;
  Dims dm;
  cudaStream_t stream;
};

size_t state_smem_f32(int P, int N, int Q) {
  return sizeof(float) * ((size_t)Q + (size_t)ST * P + (size_t)ST * N);
}

size_t output_smem_f32(int P, int N, int Q) {
  const size_t b_rows = P > QT ? P : QT;   // key-tile b rows or S_in
  return sizeof(float) * ((size_t)Q + (size_t)QT * N + b_rows * (N + 1)
                          + (size_t)QT * P + (size_t)QT * (QT + 1));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Pass 2, then the error of all launches so far.
template <bool SPLIT>
int launch_state_pass(const Args& g, __nv_bfloat16* sin) {
  const Dims& dm = g.dm;
  const int per_block = (SPLIT ? 4 : 1) * THREADS;
  ssd_state_pass<SPLIT><<<dim3((dm.P * dm.N + per_block - 1) / per_block, dm.B * dm.H), THREADS,
                          0, g.stream>>>(g.chunk_state, g.tot, g.state, sin, dm);
  return (int)cudaGetLastError();
}

int launch_f32(const Args& g) {
  const Dims& dm = g.dm;
  const float* x = static_cast<const float*>(g.x);
  const float* bm = static_cast<const float*>(g.b);
  const float* cm = static_cast<const float*>(g.c);
  const size_t s1 = state_smem_f32(dm.P, dm.N, dm.Q), s3 = output_smem_f32(dm.P, dm.N, dm.Q);
  cudaError_t err = allow_smem(ssd_chunk_state_f32, s1);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(ssd_chunk_output_f32, s3);
  if (err != cudaSuccess) return (int)err;
  const int BH = dm.B * dm.H;
  ssd_chunk_state_f32<<<dim3(dm.nc, BH), THREADS, s1, g.stream>>>(
      x, g.x_sb, g.x_sl, g.x_sh, g.dt, g.dt_sb, g.dt_sl, g.dt_sh, g.a, bm, g.b_sb, g.b_sl,
      g.chunk_state, g.tot, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_state_pass<false>(g, nullptr);
  if (rc != 0) return rc;
  const int n_qt = (dm.Q + QT - 1) / QT;
  ssd_chunk_output_f32<<<dim3(dm.nc * n_qt, BH), THREADS, s3, g.stream>>>(
      x, g.x_sb, g.x_sl, g.x_sh, g.dt, g.dt_sb, g.dt_sl, g.dt_sh, g.a, bm, g.b_sb, g.b_sl, cm,
      g.c_sb, g.c_sl, g.chunk_state, static_cast<float*>(g.y), dm);
  return (int)cudaGetLastError();
}

// The three passes of the bf16 path at widths PP, NPAD. The incoming states
// go as bf16 parts into the second half of chunk_state.
template <int PP, int NPAD>
int launch_bf16(const Args& g) {
  using Gs = StateGeom<NPAD>;
  using Go = OutGeom<PP, NPAD, HEAD_GROUP>;
  static bool attr_set = false;          // once, for the longest chunk
  if (!attr_set) {
    cudaError_t err = allow_smem(ssd_chunk_state_bf16<NPAD>, Gs::smem(MAX_Q));
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(ssd_chunk_output_bf16<PP, NPAD, HEAD_GROUP>, Go::smem(MAX_Q));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const Dims& dm = g.dm;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(g.x);
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(g.b);
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(g.c);
  const int bc = dm.B * dm.nc;
  ssd_chunk_state_bf16<NPAD><<<bc * dm.H, WG, Gs::smem(dm.Q), g.stream>>>(
      x, g.x_sb, g.x_sl, g.x_sh, g.dt, g.dt_sb, g.dt_sl, g.dt_sh, g.a, bm, g.b_sb, g.b_sl,
      g.chunk_state, g.tot, dm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  __nv_bfloat16* sin = reinterpret_cast<__nv_bfloat16*>(
      g.chunk_state + (int64_t)bc * dm.H * dm.P * dm.N);
  const int rc = launch_state_pass<true>(g, sin);
  if (rc != 0) return rc;
  const dim3 grid(bc * ((dm.H + HEAD_GROUP - 1) / HEAD_GROUP), (dm.Q + TILE - 1) / TILE);
  ssd_chunk_output_bf16<PP, NPAD, HEAD_GROUP><<<grid, WG, Go::smem(dm.Q), g.stream>>>(
      x, g.x_sb, g.x_sl, g.x_sh, g.dt, g.dt_sb, g.dt_sl, g.dt_sh, g.a, bm, g.b_sb, g.b_sl, cm,
      g.c_sb, g.c_sl, sin, static_cast<__nv_bfloat16*>(g.y), dm);
  return (int)cudaGetLastError();
}

template <int PP>
int launch_bf16_n(int N, const Args& g) {
  if (N <= 16) return launch_bf16<PP, 16>(g);
  if (N <= 32) return launch_bf16<PP, 32>(g);
  if (N <= 64) return launch_bf16<PP, 64>(g);
  return launch_bf16<PP, 128>(g);
}

int launch_bf16_any(const Args& g) {
  const int P = g.dm.P, N = g.dm.N;
  if (P % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if (P <= 8) return launch_bf16_n<8>(N, g);
  if (P <= 16) return launch_bf16_n<16>(N, g);
  if (P <= 32) return launch_bf16_n<32>(N, g);
  return launch_bf16_n<64>(N, g);
}

}  // namespace

extern "C" {

// Limits the wrapper checks before a launch: head dim P, state N, chunk Q.
int ssd_scan_max_p() { return MAX_P; }
int ssd_scan_max_n() { return MAX_N; }
int ssd_scan_max_q() { return MAX_Q; }

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; dt and a are f32.
// Strides are in elements. y is a contiguous (B, L, H, P), state a
// contiguous f32 (B, H, P, N); chunk_state (B*H*nc*P*N, twice that for
// bfloat16) and tot (B*H*nc) are f32 scratch. Q is the chunk length,
// nc = ceil(L / Q). Returns the cudaError_t of the launches (0 = success);
// the caller raises on nonzero.
int ssd_scan_launch(int dtype,
                    const void* x, long long x_sb, long long x_sl, long long x_sh,
                    const void* dt, long long dt_sb, long long dt_sl, long long dt_sh,
                    const void* a, const void* bm, long long b_sb, long long b_sl,
                    const void* cm, long long c_sb, long long c_sl,
                    void* y, void* state, void* chunk_state, void* tot,
                    int B, int L, int H, int P, int N, int Q, void* stream) {
  if (P > MAX_P || N > MAX_N || Q > MAX_Q || P < 1 || N < 1 || Q < 1)
    return (int)cudaErrorInvalidValue;
  const Args g{x,  x_sb,  x_sl,  x_sh,  static_cast<const float*>(dt),
               dt_sb, dt_sl, dt_sh, static_cast<const float*>(a),
               bm, b_sb, b_sl, cm, c_sb, c_sl, y,
               static_cast<float*>(state), static_cast<float*>(chunk_state),
               static_cast<float*>(tot), Dims{B, L, H, P, N, Q, (L + Q - 1) / Q},
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_f32(g);
  if (dtype == 1) return launch_bf16_any(g);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
