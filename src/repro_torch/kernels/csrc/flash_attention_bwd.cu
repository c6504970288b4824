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
// A masked pair contributes nothing (p = 0).
//
// Bound: operations. Per live (q, k) pair the backward needs 10*D flops
// (the scores, dout v^T, dv, dk and dq, 2*D each) against reading q, k, v,
// out, dout and lse and writing dq, dk and dv once: for qwen2-0.5b at
// B=1, S=2048 (H=14, K=2, D=64, causal) 18.8 GFLOP against ~17 MB, 0.019 ms
// at the bf16 tensor-core peak and 0.005 ms at 3.35 TB/s.
//
// Two kernel families, chosen by dtype, each three launches per call (four
// in bf16 with G > 1) and deterministic (no atomics, every sum in a fixed order, which the train
// loop's restart check relies on):
//
// 1. `attn_bwd_delta`: one warp per (b, q, h) row, delta = rowsum(dout*out).
// 2. dk and dv. A block owns a 64-key tile and a panel of at most 128
//    head-dim columns, keeps its keys' K and V rows in shared memory and
//    walks the query tiles that can see its keys (from the key tile's first
//    key when causal; up to the window's last query), recomputing S^T and
//    dP^T = V dout^T for the tile, then accumulating dv += p^T dout and
//    dk += ds^T q in registers. In f32 a block takes all G query heads of
//    its kv head and writes dk and dv once. In bf16 a block takes one query
//    head, so that GQA's G heads fill the card (qwen2's (1, 2048) gives 448
//    blocks, not 64); with G > 1 it writes f32 partials and
//    `attn_bwd_sum_heads` adds each kv head's G of them in a fixed order.
// 3. dq, one block per (64-query tile, b * H + h, panel), walking the live
//    key tiles as the forward does, dq += ds k in registers.
// A head dim past 128 is split into panels (grid z), each recomputing the
// scores, so that the accumulators stay in registers.
//
// * bfloat16 (the models' type): `attn_bwd_dkdv_mma` and `attn_bwd_dq_mma`
//   run every product on the tensor cores, mma.sync m16n8k16 with bf16
//   operands from shared memory (16-byte copies in) and f32 accumulators;
//   four warps, 16 rows each; p and ds are rounded to bf16 as they are
//   packed into the next product's A fragments, which is where the
//   reference rounds them. The products of bf16 values are exact in f32, so
//   these agree with the f32 arithmetic up to summation order.
// * float32 (the parity cases): `attn_bwd_dkdv` and `attn_bwd_dq` on the
//   CUDA cores (the tensor cores would round f32 to tf32), 256 threads,
//   each a (BT/16)^2 block of the score tile; tiles of BT = 64 rows for
//   D <= 128 and 32 above (four BT x D f32 tiles in shared memory, rows
//   padded to D + 1 against bank conflicts).
//
// wgmma and TMA are later steps.
//
// Layout: q, out, dout (B, Sq, H, D); k, v (B, Skv, K, D), read through
// their strides (the head dim contiguous); lse and delta (B, H, Sq) f32
// contiguous; dq (B, Sq, H, D), dk and dv (B, Skv, K, D) contiguous, in the
// inputs' type. Query head h reads kv head h / G.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 256;
constexpr int THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int PANEL = 128;       // head-dim columns per block, at most

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
// x rounded to T, as the reference's .astype(T) before a product
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Strides {
  int64_t b, s, h;
};

struct Problem {
  int B, H, G, Sq, Skv, D, causal, window;
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

__device__ __forceinline__ bool live(const Problem& pr, int qp, int kp) {
  bool ok = qp < pr.Sq && kp < pr.Skv;
  if (pr.causal) ok = ok && qp >= kp;
  if (pr.window) ok = ok && qp - kp < pr.window;
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
  const int q_lo = pr.causal ? k0 : 0;
  const int q_hi = pr.window ? min(pr.Sq, k0 + BT - 1 + pr.window) : pr.Sq;

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
  const int k_begin = pr.window ? max(0, q0 - pr.window + 1) : 0;
  const int k_end = pr.causal ? min(pr.Skv, q0 + BT) : pr.Skv;

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

// ------------------------------------------------------------------ bf16: tensor cores

// The bf16 kernels run every product on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate): one block is 4 warps, a tile 64 rows
// (16 a warp), each bf16 tile in shared memory with rows of DMAX + 8
// elements (16-byte aligned rows, conflict-free fragment loads). Fragments
// of a 16x16 A / 16x8 B / 16x8 C tile: with g = lane / 4, c = 2 * (lane % 4),
// A regs hold (row g, cols c..c+1), (g+8, c..), (g, c+8..), (g+8, c+8..);
// B regs (rows c..c+1, col g), (rows c+8.., col g); C (g, c..c+1) and
// (g+8, c..c+1). The C fragments of two neighbouring n-tiles of P or dS
// are, rounded to bf16, the A fragment of one k-step of the next product.

constexpr int MMA_THREADS = 128;
constexpr int MT = 64;           // rows of a tile

typedef __nv_bfloat16 bf16;

template <int DMAX>
struct MmaGeom {
  static constexpr int LDS = DMAX + 8;                     // row stride, elements
  static constexpr int PW = DMAX < PANEL ? DMAX : PANEL;   // accumulator columns
  static constexpr int NT = PW / 8;                        // accumulator n-tiles
  static constexpr size_t SMEM = 4 * (size_t)MT * LDS * sizeof(bf16) + 2 * MT * sizeof(float);
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);     // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment: rows r0.., columns k0.. of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* t, int lds, int r0, int k0,
                                     int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  a[0] = ld32(t + (r0 + g) * lds + k0 + c);
  a[1] = ld32(t + (r0 + g + 8) * lds + k0 + c);
  a[2] = ld32(t + (r0 + g) * lds + k0 + c + 8);
  a[3] = ld32(t + (r0 + g + 8) * lds + k0 + c + 8);
}

// B fragment with B[k][n] = t[n0 + n][k0 + k]: k runs along a tile row
__device__ __forceinline__ void ld_b_row(uint32_t (&b)[2], const bf16* t, int lds, int n0,
                                         int k0, int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  b[0] = ld32(t + (n0 + g) * lds + k0 + c);
  b[1] = ld32(t + (n0 + g) * lds + k0 + c + 8);
}

// B fragment with B[k][n] = t[k0 + k][n0 + n]: k runs down a tile column
__device__ __forceinline__ void ld_b_col(uint32_t (&b)[2], const bf16* t, int lds, int k0,
                                         int n0, int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  b[0] = pack2(t[(k0 + c) * lds + n0 + g], t[(k0 + c + 1) * lds + n0 + g]);
  b[1] = pack2(t[(k0 + c + 8) * lds + n0 + g], t[(k0 + c + 9) * lds + n0 + g]);
}

// rows [r0, r0 + MT) of a (B, S, heads, D) bf16 tensor at (b, head), 16
// bytes a copy (D a multiple of 16, rows 16-byte aligned: the wrapper
// checks); rows past S are zeros
__device__ __forceinline__ void load_tile_bf16(bf16* dst, int lds, const bf16* base, Strides s,
                                               int b, int head, int r0, int S, int D) {
  const bf16* src = base + b * s.b + head * s.h;
  const int vecs = D / 8;
  for (int e = threadIdx.x; e < MT * vecs; e += MMA_THREADS) {
    const int r = e / vecs, c8 = e - r * vecs, row = r0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < S) x = *reinterpret_cast<const uint4*>(src + row * s.s + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * lds + c8 * 8) = x;
  }
}

// S (or S^T) and dP (or dP^T) of this warp's 16 rows against the tile's 64
// columns: sc = A1 . B1^T, dp = A2 . B2^T over D
template <int DMAX>
__device__ __forceinline__ void scores(float (&sc)[8][4], float (&dp)[8][4], const bf16* a1,
                                       const bf16* b1, const bf16* a2, const bf16* b2, int r0,
                                       int D, int lane) {
  constexpr int LDS = MmaGeom<DMAX>::LDS;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk * 16 >= D) break;
    uint32_t x[4], y[4];
    ld_a(x, a1, LDS, r0, kk * 16, lane);
    ld_a(y, a2, LDS, r0, kk * 16, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bx[2], by[2];
      ld_b_row(bx, b1, LDS, nt * 8, kk * 16, lane);
      ld_b_row(by, b2, LDS, nt * 8, kk * 16, lane);
      mma_bf16(sc[nt], x, bx);
      mma_bf16(dp[nt], y, by);
    }
  }
}

// One block per (64-key tile, b * H + query head h, panel): the keys' share
// of dk and dv from head h's queries. With G = 1 that is all of it, written
// as bf16; with G > 1 it is written in f32 to part (2, B, Skv, H, D) and
// attn_bwd_sum_heads adds the G heads of each kv head in a fixed order.
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dkdv_mma(const bf16* __restrict__ q, Strides sq, const bf16* __restrict__ k, Strides sk,
                  const bf16* __restrict__ v, Strides sv, const bf16* __restrict__ dout,
                  Strides sd, const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                  Problem pr) {
  using Gm = MmaGeom<DMAX>;
  constexpr int LDS = Gm::LDS, NT = Gm::NT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + MT * LDS;
  bf16* qs = vs + MT * LDS;
  bf16* dos = qs + MT * LDS;
  float* lse_s = reinterpret_cast<float*>(dos + MT * LDS);
  float* del_s = lse_s + MT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int D = pr.D, K = pr.H / pr.G;
  const int k0 = blockIdx.x * MT, b = blockIdx.y / pr.H, h = blockIdx.y - b * pr.H;
  const int kh = h / pr.G, c0 = blockIdx.z * Gm::PW;
  const int kw = warp * 16;                       // this warp's keys in the tile

  load_tile_bf16(ks, LDS, k, sk, b, kh, k0, pr.Skv, D);
  load_tile_bf16(vs, LDS, v, sv, b, kh, k0, pr.Skv, D);

  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  const int q_lo = pr.causal ? k0 : 0;
  const int q_hi = pr.window ? min(pr.Sq, k0 + MT - 1 + pr.window) : pr.Sq;

  const float* lse_h = lse + ((int64_t)b * pr.H + h) * pr.Sq;
  const float* del_h = delta + ((int64_t)b * pr.H + h) * pr.Sq;
  for (int t0 = (q_lo / MT) * MT; t0 < q_hi; t0 += MT) {
    __syncthreads();                  // K/V written / last tile's readers done
    load_tile_bf16(qs, LDS, q, sq, b, h, t0, pr.Sq, D);
    load_tile_bf16(dos, LDS, dout, sd, b, h, t0, pr.Sq, D);
    for (int r = threadIdx.x; r < MT; r += MMA_THREADS) {
      const bool in = t0 + r < pr.Sq;
      lse_s[r] = in ? lse_h[t0 + r] : 0.f;
      del_s[r] = in ? del_h[t0 + r] : 0.f;
    }
    __syncthreads();

    float sc[8][4], dp[8][4];         // S^T, dP^T: this warp's keys x 64 queries
    scores<DMAX>(sc, dp, ks, qs, vs, dos, kw, D, lane);
    uint32_t pa[4][4], da[4][4];      // P^T, dS^T as A fragments over queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = kw + g + 8 * (e >> 1), qc = nt * 8 + c2 + (e & 1);
        float pe, dse;
        p_ds<bf16>(pr, sc[nt][e], dp[nt][e], lse_s[qc], del_s[qc],
                   live(pr, t0 + qc, k0 + kr), &pe, &dse);
        p[e] = pe;
        ds[e] = dse;
      }
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dv += P^T dout, dk += dS^T q over the tile's queries, this panel
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = c0 + nt * 8;
        if (col >= D) break;
        uint32_t bd[2], bq[2];
        ld_b_col(bd, dos, LDS, j * 16, col, lane);
        ld_b_col(bq, qs, LDS, j * 16, col, lane);
        mma_bf16(adv[nt], pa[j], bd);
        mma_bf16(adk[nt], da[j], bq);
      }
  }

  const int64_t part_v = (int64_t)pr.B * pr.Skv * pr.H * D;   // dv's partials after dk's
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = k0 + kw + g + 8 * half;
    if (kp >= pr.Skv) continue;
    const int64_t row = (((int64_t)b * pr.Skv + kp) * K + kh) * D;
    const int64_t prow = (((int64_t)b * pr.Skv + kp) * pr.H + h) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = c0 + nt * 8 + c2;
      if (col >= D) break;
      if (pr.G == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row + col) = __floats2bfloat162_rn(
            adk[nt][2 * half] * pr.scale, adk[nt][2 * half + 1] * pr.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
            __floats2bfloat162_rn(adv[nt][2 * half], adv[nt][2 * half + 1]);
      } else {
        *reinterpret_cast<float2*>(part + prow + col) =
            make_float2(adk[nt][2 * half], adk[nt][2 * half + 1]);
        *reinterpret_cast<float2*>(part + part_v + prow + col) =
            make_float2(adv[nt][2 * half], adv[nt][2 * half + 1]);
      }
    }
  }
}

// dk and dv (B, Skv, K, D) bf16 from the per-head partials: the G query
// heads of each kv head summed in order; dk scaled once
__global__ void __launch_bounds__(THREADS)
attn_bwd_sum_heads(const float* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Problem pr) {
  const int K = pr.H / pr.G;
  const int64_t n = (int64_t)pr.B * pr.Skv * K * pr.D;
  const int64_t part_v = (int64_t)pr.B * pr.Skv * pr.H * pr.D;
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const int d = (int)(i % pr.D);
    const int64_t bs = i / ((int64_t)K * pr.D);           // b * Skv + kp
    const int kh = (int)((i / pr.D) % K);
    const float* pk = part + (bs * pr.H + (int64_t)kh * pr.G) * pr.D + d;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < pr.G; ++g) {
      sk += pk[(int64_t)g * pr.D];
      sv += pk[part_v + (int64_t)g * pr.D];
    }
    dk[i] = __float2bfloat16(sk * pr.scale);
    dv[i] = __float2bfloat16(sv);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dq_mma(const bf16* __restrict__ q, Strides sq, const bf16* __restrict__ k, Strides sk,
                const bf16* __restrict__ v, Strides sv, const bf16* __restrict__ dout,
                Strides sd, const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, Problem pr) {
  using Gm = MmaGeom<DMAX>;
  constexpr int LDS = Gm::LDS, NT = Gm::NT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + MT * LDS;
  bf16* ks = dos + MT * LDS;
  bf16* vs = ks + MT * LDS;
  float* lse_s = reinterpret_cast<float*>(vs + MT * LDS);
  float* del_s = lse_s + MT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int D = pr.D;
  const int q0 = blockIdx.x * MT, b = blockIdx.y / pr.H, h = blockIdx.y - b * pr.H;
  const int kh = h / pr.G, c0 = blockIdx.z * Gm::PW;
  const int qw = warp * 16;                       // this warp's queries in the tile

  load_tile_bf16(qs, LDS, q, sq, b, h, q0, pr.Sq, D);
  load_tile_bf16(dos, LDS, dout, sd, b, h, q0, pr.Sq, D);
  const float* lse_h = lse + ((int64_t)b * pr.H + h) * pr.Sq;
  const float* del_h = delta + ((int64_t)b * pr.H + h) * pr.Sq;
  for (int r = threadIdx.x; r < MT; r += MMA_THREADS) {
    const bool in = q0 + r < pr.Sq;
    lse_s[r] = in ? lse_h[q0 + r] : 0.f;
    del_s[r] = in ? del_h[q0 + r] : 0.f;
  }

  float adq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[nt][e] = 0.f;

  const int k_begin = pr.window ? max(0, q0 - pr.window + 1) : 0;
  const int k_end = pr.causal ? min(pr.Skv, q0 + MT) : pr.Skv;

  for (int t0 = (k_begin / MT) * MT; t0 < k_end; t0 += MT) {
    __syncthreads();                    // q/dout written / last tile's readers done
    load_tile_bf16(ks, LDS, k, sk, b, kh, t0, pr.Skv, D);
    load_tile_bf16(vs, LDS, v, sv, b, kh, t0, pr.Skv, D);
    __syncthreads();

    float sc[8][4], dp[8][4];           // S, dP: this warp's queries x 64 keys
    scores<DMAX>(sc, dp, qs, ks, dos, vs, qw, D, lane);
    uint32_t da[4][4];                  // dS as A fragments over keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = qw + g + 8 * (e >> 1), kc = nt * 8 + c2 + (e & 1);
        float pe;
        p_ds<bf16>(pr, sc[nt][e], dp[nt][e], lse_s[qr], del_s[qr],
                   live(pr, q0 + qr, t0 + kc), &pe, &ds[e]);
      }
      da[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dq += dS k over the tile's keys, this panel
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = c0 + nt * 8;
        if (col >= D) break;
        uint32_t bk[2];
        ld_b_col(bk, ks, LDS, j * 16, col, lane);
        mma_bf16(adq[nt], da[j], bk);
      }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + qw + g + 8 * half;
    if (qp >= pr.Sq) continue;
    const int64_t row = (((int64_t)b * pr.Sq + qp) * pr.H + h) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = c0 + nt * 8 + c2;
      if (col >= D) break;
      *reinterpret_cast<__nv_bfloat162*>(dq + row + col) = __floats2bfloat162_rn(
          adq[nt][2 * half] * pr.scale, adq[nt][2 * half + 1] * pr.scale);
    }
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *out, *dout;
  Strides sq, sk, sv, so, sd;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float* part;          // bf16 with G > 1: f32 (2, B, Skv, H, D) scratch
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

int launch_delta_bf16(const Args& a, const Problem& pr, cudaStream_t stream) {
  const int rows = pr.B * pr.Sq * pr.H;
  attn_bwd_delta<bf16><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      static_cast<const bf16*>(a.out), a.so, static_cast<const bf16*>(a.dout), a.sd, a.delta,
      pr);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_mma(const Args& a, const Problem& pr, cudaStream_t stream) {
  using Gm = MmaGeom<DMAX>;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int K = pr.H / pr.G;
  const int panels = (pr.D + Gm::PW - 1) / Gm::PW;
  int rc = launch_delta_bf16(a, pr, stream);
  if (rc) return rc;
  cudaError_t err = allow_smem(attn_bwd_dkdv_mma<DMAX>, Gm::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 kv_grid((pr.Skv + MT - 1) / MT, pr.B * pr.H, panels);
  attn_bwd_dkdv_mma<DMAX><<<kv_grid, MMA_THREADS, Gm::SMEM, stream>>>(
      q, a.sq, k, a.sk, v, a.sv, dout, a.sd, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.part, pr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (pr.G > 1) {
    const int64_t n = (int64_t)pr.B * pr.Skv * K * pr.D;
    const int blocks = (int)((n + THREADS - 1) / THREADS < 4096 ? (n + THREADS - 1) / THREADS
                                                                : 4096);
    attn_bwd_sum_heads<<<blocks, THREADS, 0, stream>>>(a.part, static_cast<bf16*>(a.dk),
                                                        static_cast<bf16*>(a.dv), pr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = allow_smem(attn_bwd_dq_mma<DMAX>, Gm::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 q_grid((pr.Sq + MT - 1) / MT, pr.B * pr.H, panels);
  attn_bwd_dq_mma<DMAX><<<q_grid, MMA_THREADS, Gm::SMEM, stream>>>(
      q, a.sq, k, a.sk, v, a.sv, dout, a.sd, a.lse, a.delta, static_cast<bf16*>(a.dq), pr);
  return (int)cudaGetLastError();
}

int launch_bf16(const Args& a, const Problem& pr, cudaStream_t stream) {
  if (pr.D % 16) return (int)cudaErrorInvalidValue;
  if (pr.D <= 32) return launch_mma<32>(a, pr, stream);
  if (pr.D <= 64) return launch_mma<64>(a, pr, stream);
  if (pr.D <= 128) return launch_mma<128>(a, pr, stream);
  return launch_mma<256>(a, pr, stream);
}

}  // namespace

extern "C" {

// Largest head dim the kernels take.
int flash_attention_bwd_max_d() { return MAX_D; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv all of
// it). Strides in elements (batch, sequence, head). lse (B, H, Sq) f32 from
// the forward; delta a (B, H, Sq) f32 scratch; part, for bf16 with G > 1,
// a (2, B, Skv, H, D) f32 scratch (else unused). dq (B, Sq, H, D), dk and
// dv (B, Skv, K, D) contiguous. Launches three or four kernels on `stream`;
// returns the first launch's cudaError_t that is not 0 (the caller
// raises), else 0.
int flash_attention_bwd_launch(int dtype,
                               const void* q, long long q_sb, long long q_ss, long long q_sh,
                               const void* k, long long k_sb, long long k_ss, long long k_sh,
                               const void* v, long long v_sb, long long v_ss, long long v_sh,
                               const void* out, long long o_sb, long long o_ss, long long o_sh,
                               const void* dout, long long d_sb, long long d_ss, long long d_sh,
                               const float* lse, float* delta, float* part, void* dq,
                               void* dk, void* dv, int B, int H, int G, int Sq, int Skv,
                               int D, int causal, int window, float cap, float scale,
                               void* stream) {
  if (D < 1 || D > MAX_D || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && G > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, dout,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
         {o_sb, o_ss, o_sh}, {d_sb, d_ss, d_sh},
         lse, delta, dq, dk, dv, part};
  Problem pr{B, H, G, Sq, Skv, D, causal, window, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, pr, st);
  if (dtype == 1) return launch_bf16(a, pr, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
