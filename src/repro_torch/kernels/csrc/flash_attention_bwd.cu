// Flash attention backward for Hopper (sm_90a): dq, dk and dv of causal or
// non-causal attention over a whole sequence (the train path).
//
// There is no Pallas kernel to replace: the reference computes this in XLA,
// as the `bwd` of the custom_vjp in
//   src/repro/models/flash_xla.py::_make_flash (lines 105-156)
// and this source computes what that function computes, with its numerics:
// delta = rowsum(dout * out) in f32; the scores recomputed in f32 from q and
// k, scaled by D**-0.5, under the optional softcap cap*tanh(s/cap), masked
// (causal with q and k positions both from 0, sliding window, past the end);
// p = exp(s - lse) in f32 from the forward's row log-sum-exp; p rounded to
// dout's type before dv = p^T dout; ds = p * (dout v^T - delta), times
// (1 - t^2) under the softcap, rounded to q's type before dq = ds k and
// dk = ds^T q; dq and dk carry the scale once, at the end; every sum in f32.
// A masked pair contributes nothing (p = 0). With a key offset `koff` (key
// row j at absolute position koff + j, the segment-parallel context
// attention of flash_xla.py::_make_seg_flash, whose bwd this is then per
// segment) every position test runs on the query row minus koff; given the
// merged out and lse of all segments, dk and dv are the segment's own and dq
// its part of the sum over segments.
//
// Bound: operations. Per live (q, k) pair the backward needs 10*D flops
// (the scores, dout v^T, dv, dk and dq, 2*D each) against reading q, k, v,
// out, dout and lse and writing dq, dk and dv once: for qwen2-0.5b at
// B=1, S=2048 (H=14, K=2, D=64, causal) 18.8 GFLOP against ~17 MB, 0.019 ms
// at the bf16 tensor-core peak and 0.005 ms at 3.35 TB/s. Only the tensor
// cores come near that, so the bf16 path runs every product on wgmma.
//
// Deterministic: no float atomics; every sum runs in an order fixed by the
// shape and the dk/dv plan, so repeated calls on one card are bit-equal
// (the train loop's restart check relies on it). The plan depends on the
// card too (its SM count and this kernel's occupancy there): another card,
// or a build with other occupancy, may cut the key tiles differently and so
// round dk and dv differently. Two kernel families, chosen by dtype:
//
// * bfloat16 (the models' type), two launches:
//   1. `attn_bwd_stats`: two threads per query row, delta =
//      rowsum(dout*out) and lse*log2(e) into a (B, H, q tiles, 2, 64) f32
//      buffer, so that a tile's 64 + 64 values are one 512-byte TMA copy;
//      rows past Sq are zeros. It also zeroes the dk/dv chunks' counters.
//   2. `attn_bwd_bf16`, one warpgroup a block, the dk/dv blocks and the dq
//      blocks in one grid: the dk/dv chunks first, then the dq blocks, the
//      query tiles nearest the end (the most causal work) first. In one
//      launch the short blocks of either kind fill the SMs around the long
//      ones instead of a second launch waiting for the first's tail
//      (PERF.md).
//   dk/dv block (`dkdv_block`): a 64-key tile of one (b, kv head) and a
//      chunk of that tile's work list: the live query tiles of each of the
//      kv head's G query heads, heads in order (h = kh*G + g). K and V come
//      once by TMA; the Q and dO tiles and the tile's statistics stream
//      through a two-stage TMA ring (cp.async.bulk.tensor, an mbarrier a
//      stage; thread 0 issues item i + 1 before the warpgroup computes item
//      i, as the forward kernel does). S^T = K Q^T and dP^T = V dO^T are
//      wgmma from shared memory, both operands K-major, committed as two
//      groups so that p is computed while dP^T is still on the tensor
//      cores. P^T and dS^T are rounded to bf16 straight from the
//      accumulator fragment into A registers (where the reference rounds
//      them), and dV += P^T dO, dK += dS^T Q are wgmma with A from
//      registers and dO, Q as MN-major B (transpose bit), the move the
//      forward makes for O += P V. dK and dV of every item of the chunk
//      build up in registers: GQA's query heads are summed on chip.
//      Chunks are cut by work, not by head count: a key tile's G * nq items
//      are split into ceil(G * nq / wt) equal runs, wt chosen from the
//      card's share of the work and the longest dq walk. The wrapper
//      (flash_attention.py::dkdv_plan) makes that choice alone and hands
//      the kernel one row per chunk (key tile, live query tiles, items,
//      the tile's chunks); a block reads its row. Under a causal mask the
//      first key tiles see every query tile and the last few, so a fixed
//      number of head groups would leave the first tiles' blocks as the
//      tail; here every block holds at most wt items. A tile
//      cut into one chunk writes dk and dv as bf16; a tile cut into several
//      has each chunk write its f32 partial (fragment order, coalesced),
//      and the chunk that arrives last (an integer counter) adds all of
//      them in chunk order and writes the tile: the sum's order is the
//      chunks' order, whichever block arrives last.
//   dq block (`dq_block`): a 64-query tile of one (b, h): Q and dO by TMA
//      once, K and V tiles through a two-stage TMA ring over the live key
//      tiles (the forward's walk); S = Q K^T and dP = dO V^T on wgmma,
//      dQ += dS K with dS from registers and K as MN-major B. The scores are
//      computed a second time here (14*D flops per live pair against the
//      bound's 10*D): the price of writing dq once, without atomics.
//   The softcap is a template argument of the p loops (`probs_t`,
//   `probs_q`), not a branch per element. Tiles are swizzled as TMA writes
//   them (TileGeom: 64-column panels with the 128-byte swizzle for D = 64,
//   128, 256; one panel with the 64- or 32-byte swizzle for D = 32, 16;
//   other multiples of 16 run the next of these widths, the columns past D
//   zeros from TMA, as are rows past Sq or Skv; the masks still apply to the
//   scores). A head dim past 128 is split into panels of 128 accumulator
//   columns (grid y), each recomputing the scores: two 64 x 256 f32
//   accumulators do not fit in one warpgroup's registers. Registers (ptxas,
//   no spills): 172 at D = 64 (two blocks an SM), 255 at D = 128 and 256.
//   Shared memory: the larger of the dk/dv block's 2 + 2*2 tiles and the dq
//   block's 6 (50 KB at D = 64, 193 KB at D = 256).
// * float32 (the parity cases): `attn_bwd_delta`, `attn_bwd_dkdv` and
//   `attn_bwd_dq` on the CUDA cores (the tensor cores would round f32 to
//   tf32), 256 threads, each a (BT/16)^2 block of the score tile; tiles of
//   BT = 64 rows for D <= 128 and 32 above (four BT x D f32 tiles in shared
//   memory, rows padded to D + 1 against bank conflicts); a dk/dv block
//   takes all G query heads of its kv head, a dq block one query head.
//
// Layout: q, out, dout (B, Sq, H, D); k, v (B, Skv, K, D), read through
// their strides (the head dim contiguous; for bf16 the base 16-byte aligned
// and every stride a multiple of 16 bytes, as TMA needs: the wrapper checks);
// lse (B, H, Sq) f32 contiguous; dq (B, Sq, H, D), dk and dv (B, Skv, K, D)
// contiguous, in the inputs' type. Query head h reads kv head h / G.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_D = 256;
constexpr int THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int PANEL = 128;       // head-dim columns per block, at most

__device__ __forceinline__ float ld(const float* p) { return *p; }
// x rounded to T, as the reference's .astype(T) before a product
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

struct Strides {
  int64_t b, s, h;
};

// koff: the absolute position of key row 0 (the segment-parallel context
// attention's key offset; 0 for a whole sequence). Query row i sits at i.
struct Problem {
  int B, H, G, Sq, Skv, D, causal, window, koff;
  float cap, scale;
};

// ------------------------------------------------------------------ delta

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_delta(const T* __restrict__ out, Strides so, const T* __restrict__ dout, Strides sd,
               float* __restrict__ delta, Problem pr) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const int rows = pr.B * pr.Sq * pr.H;
  if (warp >= rows) return;
  const int h = warp % pr.H, q = (warp / pr.H) % pr.Sq, b = warp / (pr.H * pr.Sq);
  const T* o = out + b * so.b + q * so.s + h * so.h;
  const T* g = dout + b * sd.b + q * sd.s + h * sd.h;
  float acc = 0.f;
  for (int d = lane; d < pr.D; d += 32) acc += ld(o + d) * ld(g + d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((int64_t)b * pr.H + h) * pr.Sq + q] = acc;
}

// ------------------------------------------------------------------ shared pieces

// rows [r0, r0 + BT) of a (B, S, heads, D) f32 tensor at (b, head) into a
// tile with row stride D + 1; rows past S are zeros
template <int BT>
__device__ __forceinline__ void load_tile(float* dst, const float* base, Strides s, int b,
                                          int head, int r0, int S, int D) {
  const float* src = base + b * s.b + head * s.h;
  for (int e = threadIdx.x; e < BT * D; e += THREADS) {
    const int r = e / D, d = e - r * D, row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? src[row * s.s + d] : 0.f;
  }
}

// whether query row qp sees key row kp (at position pr.koff + kp)
__device__ __forceinline__ bool live(const Problem& pr, int qp, int kp) {
  bool ok = qp < pr.Sq && kp < pr.Skv;
  const int qk = qp - pr.koff;
  if (pr.causal) ok = ok && qk >= kp;
  if (pr.window) ok = ok && qk - kp < pr.window;
  return ok;
}

// p and ds of one (q, k) pair from the raw dot products q.k and dout.v
template <typename T>
__device__ __forceinline__ void p_ds(const Problem& pr, float qk, float dov, float lse,
                                     float delta, bool ok, float* p_out, float* ds_out) {
  float s = qk * pr.scale, t = 0.f;
  if (pr.cap != 0.f) {
    t = tanhf(s / pr.cap);
    s = pr.cap * t;
  }
  const float p = ok ? expf(s - lse) : 0.f;
  float ds = p * (dov - delta);
  if (pr.cap != 0.f) ds *= 1.f - t * t;
  *p_out = round_to(p, (const T*)nullptr);
  *ds_out = round_to(ds, (const T*)nullptr);
}

template <int BT>
size_t smem_floats(int D, int score_tiles) {
  return (size_t)4 * BT * (D + 1) + (size_t)score_tiles * BT * (BT + 1) + 2 * BT;
}

// ------------------------------------------------------------------ dk, dv

// DC = head-dim columns per thread in the block's panel (PANEL / 16 at most)
template <int BT, int DC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv(const float* __restrict__ q, Strides sq, const float* __restrict__ k, Strides sk,
              const float* __restrict__ v, Strides sv, const float* __restrict__ dout,
              Strides sd, const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, Problem pr) {
  constexpr int R = BT / 16;             // keys per thread: ty + 16*i
  extern __shared__ float smem[];
  const int D = pr.D, ld_ = D + 1;
  float* ks = smem;                      // [BT][D+1]
  float* vs = ks + BT * ld_;             // [BT][D+1]
  float* qs = vs + BT * ld_;             // [BT][D+1]
  float* dos = qs + BT * ld_;            // [BT][D+1]
  float* ps = dos + BT * ld_;            // [BT keys][BT+1 queries], p rounded
  float* dss = ps + BT * (BT + 1);       // [BT keys][BT+1 queries], ds rounded
  float* lse_s = dss + BT * (BT + 1);    // [BT]
  float* del_s = lse_s + BT;             // [BT]

  const int k0 = blockIdx.x * BT;
  const int K = pr.H / pr.G;
  const int b = blockIdx.y / K, kh = blockIdx.y - b * K;
  const int c0 = blockIdx.z * PANEL;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_tile<BT>(ks, k, sk, b, kh, k0, pr.Skv, D);
  load_tile<BT>(vs, v, sv, b, kh, k0, pr.Skv, D);

  float adk[R][DC], adv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = adv[i][c] = 0.f;

  // queries that can see keys [k0, k0 + BT): [q_lo, q_hi)
  const int q_lo = pr.causal ? k0 + pr.koff : 0;
  const int q_hi = pr.window ? min(pr.Sq, k0 + pr.koff + BT - 1 + pr.window) : pr.Sq;

  for (int g = 0; g < pr.G; ++g) {
    const int h = kh * pr.G + g;
    const float* lse_h = lse + ((int64_t)b * pr.H + h) * pr.Sq;
    const float* del_h = delta + ((int64_t)b * pr.H + h) * pr.Sq;
    for (int t0 = (q_lo / BT) * BT; t0 < q_hi; t0 += BT) {
      __syncthreads();                   // K/V written / last tile's readers done
      load_tile<BT>(qs, q, sq, b, h, t0, pr.Sq, D);
      load_tile<BT>(dos, dout, sd, b, h, t0, pr.Sq, D);
      for (int r = tid; r < BT; r += THREADS) {
        const bool in = t0 + r < pr.Sq;
        lse_s[r] = in ? lse_h[t0 + r] : 0.f;
        del_s[r] = in ? del_h[t0 + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16i, queries tx + 16j
      float sc[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kr[R], vr[R], qc[R], gc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kr[i] = ks[(ty + 16 * i) * ld_ + d];
          vr[i] = vs[(ty + 16 * i) * ld_ + d];
          qc[i] = qs[(tx + 16 * i) * ld_ + d];
          gc[i] = dos[(tx + 16 * i) * ld_ + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            sc[i][j] = fmaf(kr[i], qc[j], sc[i][j]);
            dp[i][j] = fmaf(vr[i], gc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int kr_ = ty + 16 * i, qc_ = tx + 16 * j;
          p_ds<float>(pr, sc[i][j], dp[i][j], lse_s[qc_], del_s[qc_],
                  live(pr, t0 + qc_, k0 + kr_), &ps[kr_ * (BT + 1) + qc_],
                  &dss[kr_ * (BT + 1) + qc_]);
        }
      __syncthreads();

      // dv += p^T dout, dk += ds^T q over the tile's queries
      for (int t = 0; t < BT; ++t) {
        float pr_[R], dr[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pr_[i] = ps[(ty + 16 * i) * (BT + 1) + t];
          dr[i] = dss[(ty + 16 * i) * (BT + 1) + t];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = c0 + tx + 16 * c;
          const float gv = d < D ? dos[t * ld_ + d] : 0.f;
          const float qv = d < D ? qs[t * ld_ + d] : 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            adv[i][c] = fmaf(pr_[i], gv, adv[i][c]);
            adk[i][c] = fmaf(dr[i], qv, adk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= pr.Skv) continue;
    const int64_t row = (((int64_t)b * pr.Skv + kp) * K + kh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = c0 + tx + 16 * c;
      if (d < D) {
        dk[row + d] = adk[i][c] * pr.scale;
        dv[row + d] = adv[i][c];
      }
    }
  }
}

// ------------------------------------------------------------------ dq

template <int BT, int DC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const float* __restrict__ q, Strides sq, const float* __restrict__ k, Strides sk,
            const float* __restrict__ v, Strides sv, const float* __restrict__ dout, Strides sd,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, Problem pr) {
  constexpr int R = BT / 16;             // queries per thread: ty + 16*i
  extern __shared__ float smem[];
  const int D = pr.D, ld_ = D + 1;
  float* qs = smem;                      // [BT][D+1]
  float* dos = qs + BT * ld_;            // [BT][D+1]
  float* ks = dos + BT * ld_;            // [BT][D+1]
  float* vs = ks + BT * ld_;             // [BT][D+1]
  float* dss = vs + BT * ld_;            // [BT queries][BT+1 keys], ds rounded
  float* lse_s = dss + BT * (BT + 1);
  float* del_s = lse_s + BT;

  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / pr.H, h = blockIdx.y - b * pr.H, kh = h / pr.G;
  const int c0 = blockIdx.z * PANEL;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_tile<BT>(qs, q, sq, b, h, q0, pr.Sq, D);
  load_tile<BT>(dos, dout, sd, b, h, q0, pr.Sq, D);
  const float* lse_h = lse + ((int64_t)b * pr.H + h) * pr.Sq;
  const float* del_h = delta + ((int64_t)b * pr.H + h) * pr.Sq;
  for (int r = tid; r < BT; r += THREADS) {
    const bool in = q0 + r < pr.Sq;
    lse_s[r] = in ? lse_h[q0 + r] : 0.f;
    del_s[r] = in ? del_h[q0 + r] : 0.f;
  }

  float adq[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adq[i][c] = 0.f;

  // live keys: [k_begin, k_end), as the forward walks them
  const int qk = q0 - pr.koff;
  const int k_begin = pr.window ? max(0, qk - pr.window + 1) : 0;
  const int k_end = pr.causal ? min(pr.Skv, qk + BT) : pr.Skv;

  for (int t0 = (k_begin / BT) * BT; t0 < k_end; t0 += BT) {
    __syncthreads();                     // q/dout written / last tile's readers done
    load_tile<BT>(ks, k, sk, b, kh, t0, pr.Skv, D);
    load_tile<BT>(vs, v, sv, b, kh, t0, pr.Skv, D);
    __syncthreads();

    float sc[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qr[R], gr[R], kc[R], vc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qr[i] = qs[(ty + 16 * i) * ld_ + d];
        gr[i] = dos[(ty + 16 * i) * ld_ + d];
        kc[i] = ks[(tx + 16 * i) * ld_ + d];
        vc[i] = vs[(tx + 16 * i) * ld_ + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sc[i][j] = fmaf(qr[i], kc[j], sc[i][j]);
          dp[i][j] = fmaf(gr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qr_ = ty + 16 * i, kc_ = tx + 16 * j;
        float p;
        p_ds<float>(pr, sc[i][j], dp[i][j], lse_s[qr_], del_s[qr_], live(pr, q0 + qr_, t0 + kc_),
                &p, &dss[qr_ * (BT + 1) + kc_]);
      }
    __syncthreads();

    for (int t = 0; t < BT; ++t) {
      float dr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dr[i] = dss[(ty + 16 * i) * (BT + 1) + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = c0 + tx + 16 * c;
        const float kv = d < D ? ks[t * ld_ + d] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) adq[i][c] = fmaf(dr[i], kv, adq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= pr.Sq) continue;
    const int64_t row = (((int64_t)b * pr.Sq + qp) * pr.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = c0 + tx + 16 * c;
      if (d < D) dq[row + d] = adq[i][c] * pr.scale;
    }
  }
}


// ------------------------------------------------------------------ bf16: wgmma and TMA

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;           // rows of a tile: keys (dk/dv) or queries (dq)
constexpr int WG = 128;          // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
// a query tile's statistics: 64 values of lse*log2(e), then 64 of delta
constexpr uint32_t STAT_BYTES = 2 * BM * sizeof(float);

// Geometry at head width PD (16, 32, 64, 128 or 256): TileGeom's swizzled
// 64 x PD tiles, and the AP <= PANEL accumulator columns a block owns (NPA
// shared-memory panels of PW columns).
template <int PD>
struct BwdGeom : TileGeom<PD> {
  static constexpr int AP = PD < PANEL ? PD : PANEL;
  static constexpr int NPA = AP / TileGeom<PD>::PW;
  // a dk/dv ring stage: Q, dO, the statistics (padded to keep 1 KB
  // alignment). Two stages: three were no faster at D = 64 and slower at
  // D = 128, where they leave one block an SM (PERF.md)
  static constexpr uint32_t STAGE = 2 * TileGeom<PD>::TILE + 1024;
  static constexpr int STAGES = 2;
  // dk/dv: K, V, the stages, 1 + STAGES mbarriers; dq: Q, dO, two stages of
  // K and V, three mbarriers; each with slack to align to 1 KB
  static constexpr size_t SMEM_KV =
      2 * (size_t)TileGeom<PD>::TILE + STAGES * (size_t)STAGE + 64 + 1024;
  static constexpr size_t SMEM_Q = 6 * (size_t)TileGeom<PD>::TILE + 64 + 1024;
  static constexpr size_t SMEM = SMEM_KV > SMEM_Q ? SMEM_KV : SMEM_Q;
};

// Two threads per padded query row (b, h, q), q < 64 * q tiles: stats
// (B, H, q tiles, 2, 64) gets lse*log2(e) and delta = rowsum(dout*out)
// (16-byte loads: D is a multiple of 16 and the rows 16-byte aligned),
// zeros past Sq. The first n_count threads zero the dk/dv counters.
__global__ void __launch_bounds__(THREADS)
attn_bwd_stats(const bf16* __restrict__ out, Strides so, const bf16* __restrict__ dout,
               Strides sd, const float* __restrict__ lse, float* __restrict__ stats,
               int* __restrict__ count, int n_count, Problem pr) {
  const int64_t gtid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (gtid < n_count) count[gtid] = 0;
  const int n_qt = (pr.Sq + BM - 1) / BM, sqp = n_qt * BM;
  const int64_t row = gtid >> 1;
  if (row >= (int64_t)pr.B * pr.H * sqp) return;         // both threads of a row
  const int half = (int)(gtid & 1), q = (int)(row % sqp), bh = (int)(row / sqp);
  const int b = bh / pr.H, h = bh - b * pr.H, hd = pr.D / 2;
  float acc = 0.f;
  if (q < pr.Sq) {
    const bf16* o = out + b * so.b + q * so.s + h * so.h + half * hd;
    const bf16* g = dout + b * sd.b + q * sd.s + h * sd.h + half * hd;
    for (int d = 0; d < hd; d += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + d);
      const uint4 y = *reinterpret_cast<const uint4*>(g + d);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
        acc += xf.x * yf.x + xf.y * yf.y;
      }
    }
  }
  acc += __shfl_xor_sync(__activemask(), acc, 1);
  if (half == 0) {
    float* st = stats + ((int64_t)bh * n_qt + q / BM) * (2 * BM) + q % BM;
    st[0] = q < pr.Sq ? lse[(int64_t)bh * pr.Sq + q] * LOG2E : 0.f;
    st[BM] = acc;
  }
}

// P^T of one 64 x 64 dk/dv score fragment S^T (rows keys from k0,
// columns queries from t0; lse2 = lse*log2(e) by column): p = exp(s - lse),
// zero outside the mask where `edge`; pa gets P^T rounded to bf16 as the A
// fragments over the queries (register (n8 % 2) * 2 + i of query step
// n8 / 2 holds key r_lo + 8*i, queries 8*n8 + c_lane + {0, 1}), and s keeps
// p, times the softcap's 1 - t^2 under CAP, for dS^T. The softcap is a
// template argument so that no element carries its branch.
template <bool CAP>
__device__ __forceinline__ void probs_t(const Problem& pr, float (&s)[32], uint32_t (&pa)[4][4],
                                        const float* lse2, int t0, int k0, int r_lo, int c_lane,
                                        bool edge) {
  const float sl = pr.scale * LOG2E;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * n8 + c_lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float pv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 4 * n8 + 2 * i + j;
        const float l = j ? l2.y : l2.x;
        float p, f = 1.f;
        if (CAP) {
          const float t = tanhf(s[r] * pr.scale / pr.cap);
          f = 1.f - t * t;
          p = exp2f(fmaf(pr.cap * t, LOG2E, -l));
        } else {
          p = exp2f(fmaf(s[r], sl, -l));
        }
        if (edge && !live(pr, t0 + 8 * n8 + c_lane + j, k0 + r_lo + 8 * i)) p = 0.f;
        pv[j] = p;
        s[r] = CAP ? p * f : p;
      }
      pa[n8 >> 1][(n8 & 1) * 2 + i] = pack_bf16(pv[0], pv[1]);
    }
  }
}

// The same for a dq score fragment S (rows queries from q0 with lse2 l2[i]
// for row r_lo + 8*i, columns keys from t0): s gets p (times 1 - t^2 under
// CAP), masked where `edge`.
template <bool CAP>
__device__ __forceinline__ void probs_q(const Problem& pr, float (&s)[32], const float (&l2)[2],
                                        int q0, int t0, int r_lo, int c_lane, bool edge) {
  const float sl = pr.scale * LOG2E;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 4 * n8 + 2 * i + j;
        float p, f = 1.f;
        if (CAP) {
          const float t = tanhf(s[r] * pr.scale / pr.cap);
          f = 1.f - t * t;
          p = exp2f(fmaf(pr.cap * t, LOG2E, -l2[i]));
        } else {
          p = exp2f(fmaf(s[r], sl, -l2[i]));
        }
        if (edge && !live(pr, q0 + r_lo + 8 * i, t0 + 8 * n8 + c_lane + j)) p = 0.f;
        s[r] = CAP ? p * f : p;
      }
}

// Chunk `p` of a (b, kv head)'s dk/dv work: the p-th row of the plan that
// flash_attention.py::dkdv_plan lays out, 8 ints (two int4 loads): key
// tile j, first live query row t_first, live query tiles nq, items
// [lo, hi) (item i: query head kh*G + i / nq, query tile i % nq), the
// tile's first chunk `start` and its chunk count n_c.
struct Chunk {
  int j, k0, t_first, nq, lo, hi, start, n_c;
};

__device__ __forceinline__ Chunk read_chunk(const int* __restrict__ plan, int p) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(plan) + 2 * p);
  const int4 y = __ldg(reinterpret_cast<const int4*>(plan) + 2 * p + 1);
  return Chunk{x.x, x.x * BM, x.y, x.z, x.w, y.x, y.y, y.z};
}

// Thread 0: the Q and dO tiles of item i and their statistics into ring
// stage `st` (at sq: Q, then dO, then the statistics), counted on `bar`.
template <int PD>
__device__ __forceinline__ void load_item(const CUtensorMap* tq, const CUtensorMap* tdo,
                                          const float* stats, const Problem& pr,
                                          const Chunk& ch, int i, uint32_t sq, uint32_t bar,
                                          int kh, int b) {
  using Gm = BwdGeom<PD>;
  const int g = i / ch.nq, h = kh * pr.G + g, t0 = ch.t_first + (i - g * ch.nq) * BM;
  const int n_qt = (pr.Sq + BM - 1) / BM;
  mbar_expect_tx(bar, 2 * Gm::TILE + STAT_BYTES);
#pragma unroll
  for (int p = 0; p < Gm::NP; ++p) {
    tma_load_4d(sq + p * Gm::PANEL, tq, bar, p * Gm::PW, h, t0, b);
    tma_load_4d(sq + Gm::TILE + p * Gm::PANEL, tdo, bar, p * Gm::PW, h, t0, b);
  }
  tma_load_1d(sq + 2 * Gm::TILE, stats + (((int64_t)b * pr.H + h) * n_qt + t0 / BM) * (2 * BM),
              STAT_BYTES, bar);
}

// Thread 0: K and V rows [t0, t0 + 64) of kv head kh, all panels, to sk and
// sk + TILE, counted on `bar`.
template <int PD>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* tk, const CUtensorMap* tv,
                                             uint32_t sk, uint32_t bar, int t0, int kh, int b) {
  using Gm = BwdGeom<PD>;
  mbar_expect_tx(bar, 2 * Gm::TILE);
#pragma unroll
  for (int p = 0; p < Gm::NP; ++p) {
    tma_load_4d(sk + p * Gm::PANEL, tk, bar, p * Gm::PW, kh, t0, b);
    tma_load_4d(sk + Gm::TILE + p * Gm::PANEL, tv, bar, p * Gm::PW, kh, t0, b);
  }
}

// 64 x 64 f32 fragment (+)= A . B^T over PD head-dim columns, A and B both
// K-major swizzled tiles: S^T = K Q^T, dP^T = V dO^T, S = Q K^T, dP = dO V^T.
template <int PD>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a, uint32_t b) {
  using Gm = BwdGeom<PD>;
#pragma unroll
  for (int kk = 0; kk < PD / 16; ++kk)
    wgmma_ss<0, 0>(d, smem_desc(a + Gm::k_off(kk), 16, Gm::GROUP, Gm::LAYOUT),
                   smem_desc(b + Gm::k_off(kk), 16, Gm::GROUP, Gm::LAYOUT), kk > 0);
}

// acc[NPA] += A (64 x 64, bf16 fragments in registers) . the panel's columns
// of the 64 x PD tile at b, read as MN-major B.
template <int PD>
__device__ __forceinline__ void accumulate(float (&acc)[BwdGeom<PD>::NPA][BwdGeom<PD>::PW / 2],
                                           const uint32_t (&a)[4][4], uint32_t b, int panel) {
  using Gm = BwdGeom<PD>;
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
    for (int pp = 0; pp < Gm::NPA; ++pp)
      wgmma_rs(acc[pp],  a[kk],
               smem_desc(b + (panel * Gm::NPA + pp) * Gm::PANEL + kk * 16 * Gm::ROW, Gm::GROUP,
                         Gm::GROUP, Gm::LAYOUT));
}

// Row r_lo + 8 i, columns panel*AP + pp*PW + 8 n8 + c_lane + {0, 1} of a
// 64-row accumulator to bf16 rows of `dst` (row stride `stride` elements),
// times `mul`; rows from `row0`, at most `rows`.
template <int PD>
__device__ __forceinline__ void store_rows(
    const float (&acc)[BwdGeom<PD>::NPA][BwdGeom<PD>::PW / 2], bf16* dst, int64_t stride,
    int rows, int r_lo, int c_lane, int panel, int D, float mul) {
  using Gm = BwdGeom<PD>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int pp = 0; pp < Gm::NPA; ++pp)
#pragma unroll
      for (int n8 = 0; n8 < Gm::PW / 8; ++n8) {
        const int col = panel * Gm::AP + pp * Gm::PW + 8 * n8 + c_lane;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + col) = __floats2bfloat162_rn(
              acc[pp][4 * n8 + 2 * i] * mul, acc[pp][4 * n8 + 2 * i + 1] * mul);
      }
  }
}

// A dk/dv block: chunk `p` of (b * K + kv head) = bk, head-dim panel
// `panel`; see the note at the top.
template <int PD>
__device__ __forceinline__ void dkdv_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                           const CUtensorMap* tv, const CUtensorMap* tdo,
                                           const float* __restrict__ stats, bf16* __restrict__ dk,
                                           bf16* __restrict__ dv, float* __restrict__ part,
                                           int* __restrict__ count, const Problem& pr,
                                           const int* __restrict__ plan, int n_chunks, int bk,
                                           int p, int panel,
                                           uint8_t* smem_raw) {
  using Gm = BwdGeom<PD>;
  constexpr int PW = Gm::PW, NPA = Gm::NPA, AP = Gm::AP, NS = Gm::STAGES;
  __shared__ int is_last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;                  // K, then V
  const uint32_t ring = sk + 2 * Gm::TILE;                     // [NS] stages: Q, dO, stats
  const uint32_t bar = ring + NS * Gm::STAGE;                  // K/V; bar + 8 (1 + stage)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = pr.H / pr.G, b = bk / K, kh = bk - b * K;
  const int unit = panel * pr.B * K + bk;
  const Chunk ch = read_chunk(plan, p);
  const int n_items = ch.hi - ch.lo;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st <= NS; ++st) mbar_init(bar + 8 * st, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_kv_tile<PD>(tk, tv, sk, bar, ch.k0, kh, b);
    for (int it = 0; it < NS - 1 && it < n_items; ++it)
      load_item<PD>(tq, tdo, stats, pr, ch, ch.lo + it, ring + it * Gm::STAGE,
                    bar + 8 + 8 * it, kh, b);
  }

  // Accumulator fragment of a 64xN wgmma: register 4*n8 + 2*i + j holds row
  // r_lo + 8*i, column 8*n8 + c_lane + j. Rows are keys, columns queries.
  const int r_lo = warp * 16 + (lane >> 2), c_lane = 2 * (lane & 3);
  float adk[NPA][PW / 2], adv[NPA][PW / 2];
#pragma unroll
  for (int pp = 0; pp < NPA; ++pp)
#pragma unroll
    for (int r = 0; r < PW / 2; ++r) adk[pp][r] = adv[pp][r] = 0.f;
  mbar_wait(bar, 0);

  for (int it = 0; it < n_items; ++it) {
    const int i = ch.lo + it, st = it % NS;
    const uint32_t sq = ring + st * Gm::STAGE, sdo = sq + Gm::TILE;
    // item it + NS - 1 into the stage item it - 1 left (free since the
    // barrier that ended the last iteration)
    if (tid == 0 && it + NS - 1 < n_items) {
      const int nx = (it + NS - 1) % NS;
      load_item<PD>(tq, tdo, stats, pr, ch, i + NS - 1, ring + nx * Gm::STAGE,
                    bar + 8 + 8 * nx, kh, b);
    }
    mbar_wait(bar + 8 + 8 * st, (it / NS) & 1);
    const float* stat = reinterpret_cast<const float*>(smem_raw + (sdo + Gm::TILE - raw));
    const int t0 = ch.t_first + (i % ch.nq) * BM;

    float s[32], dp[32];                   // S^T, dP^T: 64 keys x 64 queries
    wgmma_fence();
    scores<PD>(s, sk, sq);
    wgmma_commit();
    scores<PD>(dp, sk + Gm::TILE, sdo);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const int kabs = ch.k0 + pr.koff;     // the key tile's first position
    const bool edge = t0 + BM > pr.Sq || ch.k0 + BM > pr.Skv ||
                      (pr.causal && kabs + BM - 1 > t0) ||
                      (pr.window && t0 + BM - 1 - kabs >= pr.window);
    uint32_t pa[4][4];                     // P^T, bf16, A over the queries
    if (pr.cap == 0.f)
      probs_t<false>(pr, s, pa, stat, t0, ch.k0, r_lo, c_lane, edge);
    else
      probs_t<true>(pr, s, pa, stat, t0, ch.k0, r_lo, c_lane, edge);
    wgmma_fence();
    accumulate<PD>(adv, pa, sdo, panel);   // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();                       // dP^T done; dV may still run
    fence_regs(dp);

    uint32_t da[4][4];                     // dS^T, as P^T
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const float2 d2 = *reinterpret_cast<const float2*>(stat + BM + 8 * n8 + c_lane);
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int r = 4 * n8 + 2 * i2;
        da[n8 >> 1][(n8 & 1) * 2 + i2] =
            pack_bf16(s[r] * (dp[r] - d2.x), s[r + 1] * (dp[r + 1] - d2.y));
      }
    }
    wgmma_fence();
    accumulate<PD>(adk, da, sq, panel);    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(da);
#pragma unroll
    for (int pp = 0; pp < NPA; ++pp) {
      fence_regs(adk[pp]);
      fence_regs(adv[pp]);
    }
    __syncthreads();                       // stage st is read by all: it may be refilled
  }

  const int64_t stride = (int64_t)K * pr.D;
  const int64_t row0 = ((int64_t)b * pr.Skv + ch.k0) * stride + (int64_t)kh * pr.D;
  const int rows = min(BM, pr.Skv - ch.k0);
  if (ch.n_c > 1) {
    // this chunk's f32 partial, in fragment order (float4 a thread, the
    // block's threads side by side); the last chunk to arrive adds them all
    constexpr int V4 = AP / 8;             // float4s of dk (and of dv) a thread
    const int64_t span = 2 * BM * AP;
    float4* mine = reinterpret_cast<float4*>(part + ((int64_t)unit * n_chunks + p) * span);
#pragma unroll
    for (int e = 0; e < V4; ++e) {
      const int pp = e / (PW / 8), r = 4 * (e % (PW / 8));
      mine[e * WG + tid] = make_float4(adk[pp][r], adk[pp][r + 1], adk[pp][r + 2], adk[pp][r + 3]);
      mine[(V4 + e) * WG + tid] =
          make_float4(adv[pp][r], adv[pp][r + 1], adv[pp][r + 2], adv[pp][r + 3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(count + (int64_t)unit * ((pr.Skv + BM - 1) / BM) + ch.j, 1) ==
                ch.n_c - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int pp = 0; pp < NPA; ++pp)
#pragma unroll
      for (int r = 0; r < PW / 2; ++r) adk[pp][r] = adv[pp][r] = 0.f;
    for (int c = 0; c < ch.n_c; ++c) {     // chunk order: the same sum every call
      const float4* src =
          reinterpret_cast<const float4*>(part + ((int64_t)unit * n_chunks + ch.start + c) * span);
#pragma unroll
      for (int e = 0; e < V4; ++e) {
        const int pp = e / (PW / 8), r = 4 * (e % (PW / 8));
        const float4 x = __ldcg(src + e * WG + tid), y = __ldcg(src + (V4 + e) * WG + tid);
        adk[pp][r] += x.x;
        adk[pp][r + 1] += x.y;
        adk[pp][r + 2] += x.z;
        adk[pp][r + 3] += x.w;
        adv[pp][r] += y.x;
        adv[pp][r + 1] += y.y;
        adv[pp][r + 2] += y.z;
        adv[pp][r + 3] += y.w;
      }
    }
  }
  store_rows<PD>(adk, dk + row0, stride, rows, r_lo, c_lane, panel, pr.D, pr.scale);
  store_rows<PD>(adv, dv + row0, stride, rows, r_lo, c_lane, panel, pr.D, 1.f);
}

// A dq block: query tile q0 of (b * H + h) = bh, head-dim panel `panel`:
// dq of those queries over the live key tiles.
template <int PD>
__device__ __forceinline__ void dq_block(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const float* __restrict__ stats, bf16* __restrict__ dq,
                                         const Problem& pr, int bh, int q0, int panel,
                                         uint8_t* smem_raw) {
  using Gm = BwdGeom<PD>;
  constexpr int PW = Gm::PW, NPA = Gm::NPA;
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q, then dO
  const uint32_t ring = sq + 2 * Gm::TILE;                     // [2] stages: K, V
  const uint32_t bar = ring + 4 * Gm::TILE;                    // Q/dO; bar + 8 (1 + stage)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = bh / pr.H, h = bh - b * pr.H, kh = h / pr.G;
  const int n_qt = (pr.Sq + BM - 1) / BM;

  // live keys: [k_begin, k_end), walked in whole tiles, as the forward does
  const int qk = q0 - pr.koff;
  const int k_begin = pr.window ? max(0, qk - pr.window + 1) : 0;
  const int k_end = pr.causal ? min(pr.Skv, qk + BM) : pr.Skv;
  const int t_first = (k_begin / BM) * BM;
  const int n_tiles = k_end > t_first ? (k_end - t_first + BM - 1) / BM : 0;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_init(bar + 16, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * Gm::TILE);
#pragma unroll
    for (int p = 0; p < Gm::NP; ++p) {
      tma_load_4d(sq + p * Gm::PANEL, tq, bar, p * PW, h, q0, b);
      tma_load_4d(sq + Gm::TILE + p * Gm::PANEL, tdo, bar, p * PW, h, q0, b);
    }
    if (n_tiles > 0) load_kv_tile<PD>(tk, tv, ring, bar + 8, t_first, kh, b);
  }

  // rows are queries r_lo + 8*i, columns keys
  const int r_lo = warp * 16 + (lane >> 2), c_lane = 2 * (lane & 3);
  const float* srow = stats + ((int64_t)bh * n_qt + q0 / BM) * (2 * BM);
  const float l2[2] = {srow[r_lo], srow[r_lo + 8]};
  const float dl[2] = {srow[BM + r_lo], srow[BM + r_lo + 8]};
  float adq[NPA][PW / 2];
#pragma unroll
  for (int pp = 0; pp < NPA; ++pp)
#pragma unroll
    for (int r = 0; r < PW / 2; ++r) adq[pp][r] = 0.f;
  mbar_wait(bar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * BM, st = it & 1;
    const uint32_t sk = ring + st * 2 * Gm::TILE;
    if (tid == 0 && it + 1 < n_tiles)
      load_kv_tile<PD>(tk, tv, ring + (st ^ 1) * 2 * Gm::TILE, bar + 8 + 8 * (st ^ 1),
                       t0 + BM, kh, b);
    mbar_wait(bar + 8 + 8 * st, (it >> 1) & 1);

    float s[32], dp[32];                   // S, dP: 64 queries x 64 keys
    wgmma_fence();
    scores<PD>(s, sq, sk);
    wgmma_commit();
    scores<PD>(dp, sq + Gm::TILE, sk + Gm::TILE);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const bool edge = t0 + BM > pr.Skv || q0 + BM > pr.Sq || (pr.causal && t0 + BM - 1 > qk) ||
                      (pr.window && qk + BM - 1 - t0 >= pr.window);
    if (pr.cap == 0.f)
      probs_q<false>(pr, s, l2, q0, t0, r_lo, c_lane, edge);
    else
      probs_q<true>(pr, s, l2, q0, t0, r_lo, c_lane, edge);
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[4][4];                     // dS rounded to bf16, A of key step n8 / 2
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int r = 4 * n8 + 2 * i2;
        da[n8 >> 1][(n8 & 1) * 2 + i2] =
            pack_bf16(s[r] * (dp[r] - dl[i2]), s[r + 1] * (dp[r + 1] - dl[i2]));
      }
    wgmma_fence();
    accumulate<PD>(adq, da, sk, panel);    // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(da);
#pragma unroll
    for (int pp = 0; pp < NPA; ++pp) fence_regs(adq[pp]);
    __syncthreads();                       // stage st is read by all: it may be refilled
  }

  const int64_t stride = (int64_t)pr.H * pr.D;
  store_rows<PD>(adq, dq + ((int64_t)b * pr.Sq + q0) * stride + (int64_t)h * pr.D, stride,
                 min(BM, pr.Sq - q0), r_lo, c_lane, panel, pr.D, pr.scale);
}

// The bf16 dk/dv and dq blocks in one launch, dk/dv first: blocks
// [0, n_kv) are (chunk, b * K + kv head) in chunk order, the rest (query
// tile, b * H + h) with the tiles nearest the end (most causal work) first;
// grid y is the head-dim panel. The plan makes no chunk shorter than the
// longest dq walk, so the longest blocks start first and the short dq
// blocks fill the SMs at the end. Needs the statistics of attn_bwd_stats.
template <int PD>
__global__ void __launch_bounds__(WG)
attn_bwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ stats, bf16* __restrict__ dq, bf16* __restrict__ dk,
              bf16* __restrict__ dv, float* __restrict__ part, int* __restrict__ count,
              Problem pr, const int* __restrict__ plan, int n_chunks) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int n_qt = (pr.Sq + BM - 1) / BM, n_bh = pr.B * pr.H, n_dq = n_qt * n_bh;
  const int n_kv = gridDim.x - n_dq, id = blockIdx.x;
  if (id >= n_kv) {
    const int jd = id - n_kv;
    dq_block<PD>(&tq, &tk, &tv, &tdo, stats, dq, pr, jd % n_bh, (n_qt - 1 - jd / n_bh) * BM,
                 blockIdx.y, smem_raw);
  } else {
    const int n_bk = pr.B * (pr.H / pr.G), c = id;
    dkdv_block<PD>(&tq, &tk, &tv, &tdo, stats, dk, dv, part, count, pr, plan, n_chunks,
                   c % n_bk, c / n_bk, blockIdx.y, smem_raw);
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *out, *dout;
  Strides sq, sk, sv, so, sd;
  const float* lse;
  float* delta;         // f32: (B, H, Sq); bf16: the (B, H, q tiles, 2, 64) statistics
  void *dq, *dk, *dv;
  float* part;          // bf16: the dk/dv chunks' f32 partials (null if no tile splits)
  int* count;           // bf16: a counter per (panel, b, kv head, key tile)
  const int* plan;      // bf16: the dk/dv plan, a row of 8 ints per chunk
  int n_chunks;         // bf16: its rows, the chunks per (panel, b, kv head)
};

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
template <int BT, int DC>
int launch_f32_tiles(const Args& a, const Problem& pr, cudaStream_t stream) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int K = pr.H / pr.G;
  const int panels = (pr.D + PANEL - 1) / PANEL;

  const int rows = pr.B * pr.Sq * pr.H;
  attn_bwd_delta<float><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      static_cast<const float*>(a.out), a.so, dout, a.sd, a.delta, pr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t kv_bytes = sizeof(float) * smem_floats<BT>(pr.D, 2);
  err = allow_smem(attn_bwd_dkdv<BT, DC>, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 kv_grid((pr.Skv + BT - 1) / BT, pr.B * K, panels);
  attn_bwd_dkdv<BT, DC><<<kv_grid, THREADS, kv_bytes, stream>>>(
      q, a.sq, k, a.sk, v, a.sv, dout, a.sd, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), pr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t q_bytes = sizeof(float) * smem_floats<BT>(pr.D, 1);
  err = allow_smem(attn_bwd_dq<BT, DC>, q_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 q_grid((pr.Sq + BT - 1) / BT, pr.B * pr.H, panels);
  attn_bwd_dq<BT, DC><<<q_grid, THREADS, q_bytes, stream>>>(
      q, a.sq, k, a.sk, v, a.sv, dout, a.sd, a.lse, a.delta, static_cast<float*>(a.dq), pr);
  return (int)cudaGetLastError();
}

int launch_f32(const Args& a, const Problem& pr, cudaStream_t stream) {
  if (pr.D <= 16) return launch_f32_tiles<64, 1>(a, pr, stream);
  if (pr.D <= 32) return launch_f32_tiles<64, 2>(a, pr, stream);
  if (pr.D <= 64) return launch_f32_tiles<64, 4>(a, pr, stream);
  if (pr.D <= 128) return launch_f32_tiles<64, 8>(a, pr, stream);
  return launch_f32_tiles<32, 8>(a, pr, stream);
}

template <int PD>
int launch_bf16_pd(const Args& a, const Problem& pr, cudaStream_t stream) {
  using Gm = BwdGeom<PD>;
  const int K = pr.H / pr.G;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, a.q, pr.D, pr.H, pr.Sq, pr.B, a.sq.h, a.sq.s, a.sq.b, Gm::PW) ||
      !make_map(&tk, a.k, pr.D, K, pr.Skv, pr.B, a.sk.h, a.sk.s, a.sk.b, Gm::PW) ||
      !make_map(&tv, a.v, pr.D, K, pr.Skv, pr.B, a.sv.h, a.sv.s, a.sv.b, Gm::PW) ||
      !make_map(&tdo, a.dout, pr.D, pr.H, pr.Sq, pr.B, a.sd.h, a.sd.s, a.sd.b, Gm::PW))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = allow_smem(attn_bwd_bf16<PD>, Gm::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int panels = (pr.D + Gm::AP - 1) / Gm::AP;
  const int n_kt = (pr.Skv + BM - 1) / BM, n_qt = (pr.Sq + BM - 1) / BM;
  const int n_count = panels * pr.B * K * n_kt;
  const int64_t threads = 2 * (int64_t)pr.B * pr.H * n_qt * BM;
  const int64_t blocks = ((threads > n_count ? threads : n_count) + THREADS - 1) / THREADS;
  attn_bwd_stats<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const bf16*>(a.out), a.so, static_cast<const bf16*>(a.dout), a.sd, a.lse,
      a.delta, a.count, n_count, pr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned n_blocks = (unsigned)(n_qt * pr.B * pr.H + a.n_chunks * pr.B * K);
  attn_bwd_bf16<PD><<<dim3(n_blocks, panels), WG, Gm::SMEM, stream>>>(
      tq, tk, tv, tdo, a.delta, static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.part, a.count, pr, a.plan, a.n_chunks);
  return (int)cudaGetLastError();
}

template <int PD>
int dkdv_blocks_per_sm() {
  using Gm = BwdGeom<PD>;
  int n = 0;
  if (allow_smem(attn_bwd_bf16<PD>, Gm::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_bwd_bf16<PD>, WG, Gm::SMEM) !=
          cudaSuccess)
    return 0;
  return n;
}

int launch_bf16(const Args& a, const Problem& pr, cudaStream_t stream) {
  if (pr.D % 16 || a.plan == nullptr || a.n_chunks < 1 || a.count == nullptr)
    return (int)cudaErrorInvalidValue;
  if (pr.D <= 16) return launch_bf16_pd<16>(a, pr, stream);
  if (pr.D <= 32) return launch_bf16_pd<32>(a, pr, stream);
  if (pr.D <= 64) return launch_bf16_pd<64>(a, pr, stream);
  if (pr.D <= 128) return launch_bf16_pd<128>(a, pr, stream);
  return launch_bf16_pd<256>(a, pr, stream);
}

}  // namespace

extern "C" {

// Largest head dim the kernels take.
int flash_attention_bwd_max_d() { return MAX_D; }

// Blocks of the bf16 dk/dv kernel at head dim D that one SM of the current
// device holds at once (0 on an error): the wrapper's plan fills them.
int flash_attention_bwd_dkdv_blocks_per_sm(int D) {
  if (D < 1 || D > MAX_D || D % 16) return 0;
  if (D <= 16) return dkdv_blocks_per_sm<16>();
  if (D <= 32) return dkdv_blocks_per_sm<32>();
  if (D <= 64) return dkdv_blocks_per_sm<64>();
  if (D <= 128) return dkdv_blocks_per_sm<128>();
  return dkdv_blocks_per_sm<256>();
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv all of
// it). Strides in elements (batch, sequence, head). lse (B, H, Sq) f32 from
// the forward. delta: f32 scratch, (B, H, Sq) for float32, (B, H, q tiles,
// 2, 64) for bfloat16. For bfloat16 also: part, f32 scratch of
// (panels, B, K, n_chunks, 2, 64, min(128, PD)) for the dk/dv partials
// (null when every key tile is one chunk), count, int scratch of
// panels * B * K * key tiles, and the dk/dv plan on the device (n_chunks
// rows of 8 ints, one per chunk of a (panel, b, kv head):
// flash_attention.py::dkdv_plan);
// unused for float32. koff: the absolute position of key row 0 (query row
// i at i; dq is then this segment's part, to be summed over segments, and lse
// the whole row's). dq (B, Sq, H, D), dk and dv (B, Skv, K, D)
// contiguous. Launches three kernels (float32) or two (bfloat16) on
// `stream`; returns the first launch's cudaError_t that is not 0 (the
// caller raises), else 0.
int flash_attention_bwd_launch(int dtype,
                               const void* q, long long q_sb, long long q_ss, long long q_sh,
                               const void* k, long long k_sb, long long k_ss, long long k_sh,
                               const void* v, long long v_sb, long long v_ss, long long v_sh,
                               const void* out, long long o_sb, long long o_ss, long long o_sh,
                               const void* dout, long long d_sb, long long d_ss, long long d_sh,
                               const float* lse, float* delta, float* part, int* count,
                               void* dq, void* dk, void* dv, int B, int H, int G, int Sq,
                               int Skv, int D, int causal, int window, int koff, float cap,
                               float scale, const int* plan, int n_chunks, void* stream) {
  if (D < 1 || D > MAX_D || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, dout,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
         {o_sb, o_ss, o_sh}, {d_sb, d_ss, d_sh},
         lse, delta, dq, dk, dv, part, count, plan, n_chunks};
  Problem pr{B, H, G, Sq, Skv, D, causal, window, koff, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, pr, st);
  if (dtype == 1) return launch_bf16(a, pr, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
