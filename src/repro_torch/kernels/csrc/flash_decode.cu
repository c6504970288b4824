// Flash-decode for Hopper (sm_90a): one new token of GQA attention against
// a KV cache.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_decode.py::flash_decode_bkgd (body `_kernel`)
// and computes src/repro/kernels/ref.py::flash_decode_ref with the Pallas
// kernel's numerics: scores in f32 scaled by D**-0.5, optional logit softcap
// cap*tanh(s/cap), per-slot absolute positions `kpos` (< 0 = invalid)
// masked against `cur` and an optional sliding window, an online softmax
// kept in f32, `p` rounded to v's type before the PV product while `l` sums
// the unrounded `p`.
//
// Bound: bytes. Each call streams the K and V rows of one layer's cache once
// (2*B*S*K*D elements) and does ~4*B*S*H*D flops on them: about G flops per
// byte, far below the card's ~295 flop/byte ridge. At serving batch sizes
// the TPU grid's B*K rows give only 2-16 blocks, too few to draw the card's
// bandwidth at long contexts, so a long cache is split across the blocks of
// one thread-block cluster; at short ones (the serving shape, S=128) the
// call is bound by its launch and its latency: one launch per call, no
// scratch tensors, and few dependent steps per key.
//
// Grid (n_split, B*K) with cluster dimension (n_split, 1, 1), n_split <= 8
// (the portable cluster size), launched with cudaLaunchKernelEx. Each block
// of 128 threads takes an even share of the S keys, streams it in 64-key
// tiles (32 in f32) with 16-byte cp.async copies into a ring of stages in
// shared memory, and leaves its partial (m, l, acc[G][D]) in shared memory.
// With one split the block writes `out` itself. Otherwise, after
// cluster.sync(), block rank 0 reads the other blocks' partials through
// distributed shared memory, merges them with weights exp(m_split - m_max)
// and writes `out`; a second cluster.sync() keeps every block alive until
// its shared memory has been read.
//
// Two bodies, chosen by dtype in the C entry point (dispatch by dtype, not
// a fallback):
//
// * bfloat16 (the models' type): `flash_decode_bf16`, tensor cores. The G
//   query rows of a kv head (padded to 16) are the M of mma.sync m16n8k16
//   (bf16 in, f32 accumulate). Each of the 4 warps owns 16 keys of every
//   tile and runs its own online softmax over them, so a tile needs no
//   barrier between warps: S = Q.K^T is 2 x D/16 mma (K read from shared
//   memory with 32-bit loads, rows padded against bank conflicts), the
//   softmax runs on the fragment with quad shuffles, P is rounded to bf16
//   into the A registers of O += P.V (V by ldmatrix.trans), D/8 mma. The
//   ring holds 4 tiles (3 at D=256) of K, V and their kpos, so three are in
//   flight while one is used, with one __syncthreads per tile. The warps' partials are merged
//   in shared memory at the end (the same weights as the splits). Bf16
//   products are exact in f32, so the f32-accumulated products equal the
//   f32 ones up to summation order; the scale is applied to the f32 scores.
//   Tensor cores here are for latency, not rate: on the CUDA cores a tile's
//   dependent shared-memory loads and FMAs take ~9.5 us with four warps per
//   block (measured on an H100: 0.020 ms at S=128, 0.077 ms at S=4096).
//
// * float32 (parity cases only): `flash_decode_f32`, CUDA cores: each
//   thread scores one key against several query rows (q pre-scaled in f32,
//   K rows padded so a warp reads without bank conflicts), one warp per row
//   runs the online softmax, acc = acc*corr + p.V in f32, over a double
//   buffer of 32-key tiles.
//
// Layout: q (B, H, D) and k, v (B, S, K, D) are read through their strides
// (the innermost dim contiguous; for k and v the base and every stride a
// multiple of 16 bytes, as cp.async needs: the wrapper checks), so the
// model's cache is read in place; head h = kh*G + g as the reference's
// reshape(B, 1, K, G, D).
//
// Optional row log-sum-exp: given a non-null `lse` (B, H) f32, the kernel
// also writes lse = m + log(max(l, 1e-37)) of each query row, from the
// (m, l) its block (or the cluster's merge) already holds, so that the
// caller can merge this call's output with others over other keys (the
// split-merge of a decode cache sharded over its slots across ranks). A row
// with no live slot then writes out = 0 and lse = NEG_INF + log(1e-37): its
// merge weight is 0. A null `lse` runs the code without it.
//
// Masked scores take the finite NEG_INF = -0.7 * FLT_MAX, never -inf: a
// split (or warp) whose keys are all masked (common under a window or a
// ring) then ends with m = NEG_INF and a finite l, and its merge weight is
// exp(NEG_INF - m_max) = 0 instead of NaN.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;    // 4 warps
constexpr int MAX_G = 16;
constexpr int MAX_D = 256;
constexpr int MAX_SPLIT = 8;    // portable cluster size
constexpr float NEG_INF = -0.7f * FLT_MAX;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// All blocks of the cluster call this with their partial (m_s[g], l_s[g],
// part[g * ldp + d]) in shared memory; block rank 0 merges them into
// ob[g * D + d] (wts and l_tot are its scratch) and, where lse_row is not
// null, writes lse_row[g] (a row with no live slot: out 0, the sentinel).
// The first cluster.sync() is also the block's barrier after writing its
// partial.
template <typename T>
__device__ void cluster_merge(float* m_s, float* l_s, float* part, int ldp, float* wts,
                              float* l_tot, int G, int D, T* ob, float* lse_row) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks(), tid = threadIdx.x;
  cluster.sync();
  if (cluster.block_rank() == 0) {
    if (tid < G) {
      float m_max = -FLT_MAX;
      for (int r = 0; r < n_split; ++r)
        m_max = fmaxf(m_max, cluster.map_shared_rank(m_s, r)[tid]);
      float l = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float w = expf(cluster.map_shared_rank(m_s, r)[tid] - m_max);
        wts[r * MAX_G + tid] = w;
        l = fmaf(w, cluster.map_shared_rank(l_s, r)[tid], l);
      }
      l_tot[tid] = l;
      if (lse_row != nullptr) {
        const bool dead = m_max <= NEG_INF;
        if (dead)
          for (int r = 0; r < n_split; ++r) wts[r * MAX_G + tid] = 0.f;
        lse_row[tid] = dead ? NEG_INF + logf(1e-37f) : m_max + logf(fmaxf(l, 1e-37f));
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D, d = e - g * D;
      float a = 0.f;
      for (int r = 0; r < n_split; ++r)
        a = fmaf(wts[r * MAX_G + g], cluster.map_shared_rank(part, r)[g * ldp + d], a);
      const float o = a / fmaxf(l_tot[g], 1e-37f);
      if constexpr (sizeof(T) == 2) ob[e] = __float2bfloat16_rn(o);
      else ob[e] = o;
    }
  }
  cluster.sync();                             // partials stay until read
}

// ------------------------------------------------------------------ bf16 path

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed, from rows given per lane.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint8_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// Shared memory of the bf16 kernel for head dims up to DP (64, 128, 256).
template <int DP>
struct Bf16Geom {
  static constexpr int TILE = 64;                     // keys per tile, 16 per warp
  static constexpr int NST = DP <= 128 ? 4 : 3;       // ring stages
  static constexpr int LDB = DP * 2 + 16;             // padded row bytes (K, V, q)
  static constexpr int STAGE = 2 * TILE * LDB;        // K then V
  static constexpr int RING = NST * STAGE;
  static constexpr int LDO = DP + 4;                  // floats per row of a warp's O
  static_assert(4 * 16 * LDO * 4 <= RING, "the warps' partials reuse the ring");
  static constexpr size_t SMEM = (size_t)RING + 16 * LDB  // ring, q
                                 + sizeof(float) * (2 * 4 * MAX_G      // m, l per warp
                                                    + 2 * MAX_G        // m, l per block
                                                    + MAX_SPLIT * MAX_G + MAX_G)  // merge
                                 + sizeof(int) * NST * TILE;           // kpos ring
};

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_decode_bf16(const __nv_bfloat16* __restrict__ q, int64_t q_sb, int64_t q_sh,
                  const __nv_bfloat16* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sk,
                  const __nv_bfloat16* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sk,
                  const int* __restrict__ kpos, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, int K, int G, int S, int D, int cur, int window,
                  float cap, float scale) {
  using Gm = Bf16Geom<DP>;
  constexpr int TILE = Gm::TILE, NST = Gm::NST, LDB = Gm::LDB;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                   // [NST][K, V][TILE][LDB]
  uint8_t* qs = ring + Gm::RING;                          // [16][LDB] q, bf16
  float* m_w = reinterpret_cast<float*>(qs + 16 * LDB);   // [4][MAX_G] per warp
  float* l_w = m_w + 4 * MAX_G;                           // [4][MAX_G]
  float* m_s = l_w + 4 * MAX_G;                           // [MAX_G] the block's
  float* l_s = m_s + MAX_G;                               // [MAX_G]
  float* wts = l_s + MAX_G;                               // [MAX_SPLIT][MAX_G] merge
  float* l_tot = wts + MAX_SPLIT * MAX_G;                 // [MAX_G] merge
  int* kps = reinterpret_cast<int*>(l_tot + MAX_G);       // [NST][TILE] kpos of a tile
  float* o_w = reinterpret_cast<float*>(ring);            // [4][16][LDO] after the loop

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bk = blockIdx.y, b = bk / K, kh = bk - b * K;
  const int s_begin = (int)((int64_t)split * S / n_split);
  const int s_end = (int)((int64_t)(split + 1) * S / n_split);
  const int n_tiles = (s_end - s_begin + TILE - 1) / TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = D / 8;                               // 16-byte copies per row
  constexpr int CPR = DP / 8;                             // ... at most

  // q rows (zero past G) and the ring's columns past D are zeros for the mma
  const __nv_bfloat16* qb = q + b * q_sb + (int64_t)kh * G * q_sh;
  for (int e = tid; e < 16 * DP; e += THREADS) {
    const int g = e / DP, d = e - g * DP;
    reinterpret_cast<__nv_bfloat16*>(qs + g * LDB)[d] =
        g < G && d < D ? qb[g * q_sh + d] : __float2bfloat16_rn(0.f);
  }
  if (D < DP)
    for (int e = tid; e < NST * 2 * TILE * (DP - D); e += THREADS) {
      const int r = e / (DP - D), d = D + e - r * (DP - D);
      reinterpret_cast<__nv_bfloat16*>(ring + r * LDB)[d] = __float2bfloat16_rn(0.f);
    }

  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sk;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sk;
  // tile `it` (K, V and kpos) into stage it % NST; rows past the split's
  // end are zeroed
  auto issue = [&](int it) {
    const int t0 = s_begin + it * TILE, n_t = min(TILE, s_end - t0);
    uint8_t* kd = ring + (it % NST) * Gm::STAGE;
    uint8_t* vd = kd + TILE * LDB;
    if (tid < n_t)
      cp_async4(smem_u32(kps + (it % NST) * TILE + tid), kpos + t0 + tid);
    for (int e = tid; e < TILE * CPR; e += THREADS) {
      const int t = e / CPR, c = e - t * CPR;
      if (c >= chunks) continue;
      if (t < n_t) {
        cp_async16(smem_u32(kd + t * LDB + c * 16), kb + (int64_t)(t0 + t) * k_ss + c * 8);
        cp_async16(smem_u32(vd + t * LDB + c * 16), vb + (int64_t)(t0 + t) * v_ss + c * 8);
      } else {
        *reinterpret_cast<uint4*>(kd + t * LDB + c * 16) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd + t * LDB + c * 16) = make_uint4(0, 0, 0, 0);
      }
    }
  };
#pragma unroll
  for (int it = 0; it < NST - 1; ++it) {
    if (it < n_tiles) issue(it);
    cp_async_commit();
  }

  // Fragments of m16n8: register r holds row lane/4 + 8*(r/2) (a query row
  // g) and column 2*(lane%4) + r%2. This warp's keys in a tile: 16*warp +
  // 8*nt + column, nt = 0, 1.
  const int row = lane >> 2, col = 2 * (lane & 3);
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                                // this lane's columns only

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();              // tile it is in; every warp is done with tile it-1
    if (it + NST - 1 < n_tiles) issue(it + NST - 1);      // into tile it-1's stage
    cp_async_commit();

    const uint8_t* ks = ring + (it % NST) * Gm::STAGE + 16 * warp * LDB;
    const uint8_t* vs = ks + TILE * LDB;
    const int* kp_t = kps + (it % NST) * TILE + 16 * warp;
    const int t0 = s_begin + it * TILE + 16 * warp;       // this warp's first key

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c0 = (kk * 16 + col) * 2;                 // byte column
      const uint32_t a[4] = {lds32(qs + row * LDB + c0), lds32(qs + (row + 8) * LDB + c0),
                             lds32(qs + row * LDB + c0 + 16),
                             lds32(qs + (row + 8) * LDB + c0 + 16)};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint8_t* kr = ks + (8 * nt + row) * LDB + c0;
        mma_bf16(s[nt], a, lds32(kr), lds32(kr + 16));
      }
    }

    // scale, softcap, masks; the tile max of each of this lane's two rows
    float tmax[2] = {-FLT_MAX, -FLT_MAX};                 // below NEG_INF
    bool in[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = t0 + 8 * nt + col + j;
        in[nt][j] = key < s_end;
        bool ok = false;
        if (in[nt][j]) {
          const int kp = kp_t[8 * nt + col + j];
          ok = kp >= 0 && kp <= cur;
          if (window) ok = ok && kp > cur - window;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = s[nt][2 * i + j] * scale;
          if (cap != 0.f) x = cap * tanhf(x / cap);
          x = ok ? x : NEG_INF;
          s[nt][2 * i + j] = x;
          if (in[nt][j]) tmax[i] = fmaxf(tmax[i], x);
        }
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
    // P rounded to bf16 as the A operand over this warp's 16 keys
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = in[nt][0] ? expf(s[nt][2 * i] - m[i]) : 0.f;
        const float p1 = in[nt][1] ? expf(s[nt][2 * i + 1] - m[i]) : 0.f;
        l[i] += p0 + p1;
        pa[2 * nt + i] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[n][r] *= corr[r >> 1];

    // O += P V: V rows are this warp's keys; two n8 tiles per ldmatrix.x4
    const uint8_t* vrow = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDB + 16 * (lane >> 4);
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vrow + np * 32);
      mma_bf16(o[2 * np], pa, bv[0], bv[1]);
      mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
    }
  }

  // merge the four warps' partials: the block's (m, l) and its O in o_w[0]
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if ((lane & 3) == 0) {
    m_w[warp * MAX_G + row] = m[0];
    m_w[warp * MAX_G + row + 8] = m[1];
    l_w[warp * MAX_G + row] = l[0];
    l_w[warp * MAX_G + row + 8] = l[1];
  }
  __syncthreads();                                        // the ring is free now
  float wself[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = row + 8 * i;
    float m_b = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < 4; ++w) m_b = fmaxf(m_b, m_w[w * MAX_G + g]);
    wself[i] = expf(m[i] - m_b);
  }
  float* ow = o_w + warp * 16 * Gm::LDO;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ow[(row + 8 * (r >> 1)) * Gm::LDO + 8 * n + col + (r & 1)] = o[n][r] * wself[r >> 1];
  if (tid < G) {
    float m_b = -FLT_MAX, l_b = 0.f;
    for (int w = 0; w < 4; ++w) m_b = fmaxf(m_b, m_w[w * MAX_G + tid]);
    for (int w = 0; w < 4; ++w) l_b = fmaf(expf(m_w[w * MAX_G + tid] - m_b), l_w[w * MAX_G + tid], l_b);
    m_s[tid] = m_b;
    l_s[tid] = l_b;
  }
  __syncthreads();

  const int H = K * G;
  __nv_bfloat16* ob = out + ((int64_t)b * H + kh * G) * D;
  float* lse_row = lse != nullptr ? lse + (int64_t)b * H + kh * G : nullptr;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e - g * D;
    const float* x = o_w + g * Gm::LDO + d;
    const float a = ((x[0] + x[16 * Gm::LDO]) + x[32 * Gm::LDO]) + x[48 * Gm::LDO];
    if (n_split == 1) {
      const bool dead = lse_row != nullptr && m_s[g] <= NEG_INF;
      ob[e] = __float2bfloat16_rn(dead ? 0.f : a / fmaxf(l_s[g], 1e-37f));
    } else {
      o_w[g * Gm::LDO + d] = a;                            // the block's partial
    }
  }
  if (n_split == 1 && lse_row != nullptr && tid < G)
    lse_row[tid] = m_s[tid] <= NEG_INF ? NEG_INF + logf(1e-37f)
                                       : m_s[tid] + logf(fmaxf(l_s[tid], 1e-37f));
  if (n_split > 1) cluster_merge(m_s, l_s, o_w, Gm::LDO, wts, l_tot, G, D, ob, lse_row);
}

// ------------------------------------------------------------------ f32 path

__device__ __forceinline__ void unpack16(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

struct F32Geom {
  static constexpr int TILE = 32;                     // keys per tile
  static constexpr int CH = 4;                        // floats per 16-byte copy
  static constexpr int NGH = THREADS / TILE;          // query-row groups in the score step
  static constexpr int GPT = MAX_G / NGH;             // query rows per thread there
  // bytes of a padded K/V row: 16 bytes more than the row, so the rows one
  // warp reads at the same column fall in different banks
  __host__ __device__ static int row_bytes(int D) { return D * 4 + 16; }
  static size_t smem(int G, int D) {
    return 4 * (size_t)TILE * row_bytes(D)              // K, V x 2 stages
           + sizeof(float) * ((size_t)2 * G * D          // q, partial acc
                              + (size_t)G * TILE         // p
                              + 3 * MAX_G                // m, l, corr
                              + MAX_SPLIT * MAX_G + MAX_G)  // merge weights, l
           + sizeof(int) * TILE;                         // key state
  }
};

__global__ void __launch_bounds__(THREADS)
flash_decode_f32(const float* __restrict__ q, int64_t q_sb, int64_t q_sh,
                 const float* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sk,
                 const float* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sk,
                 const int* __restrict__ kpos, float* __restrict__ out,
                 float* __restrict__ lse, int K, int G, int S, int D, int cur, int window,
                 float cap, float scale) {
  using Gm = F32Geom;
  constexpr int TILE = Gm::TILE, CH = Gm::CH, NGH = Gm::NGH, GPT = Gm::GPT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ldb = Gm::row_bytes(D);
  uint8_t* ks = smem;                                     // [2][TILE][ldb]
  uint8_t* vs = ks + 2 * TILE * ldb;                      // [2][TILE][ldb]
  float* qs = reinterpret_cast<float*>(vs + 2 * TILE * ldb);  // [G][D] scaled q
  float* part = qs + G * D;                               // [G][D] partial acc
  float* ps = part + G * D;                               // [G][TILE] scores, then p
  float* m_s = ps + G * TILE;                             // [MAX_G]
  float* l_s = m_s + MAX_G;                               // [MAX_G]
  float* corr_s = l_s + MAX_G;                            // [MAX_G]
  float* wts = corr_s + MAX_G;                            // [MAX_SPLIT][MAX_G] merge
  float* l_tot = wts + MAX_SPLIT * MAX_G;                 // [MAX_G] merge
  int* state = reinterpret_cast<int*>(l_tot + MAX_G);     // [TILE] 1 valid, 0 masked, -1 past the end

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bk = blockIdx.y, b = bk / K, kh = bk - b * K;
  const int s_begin = (int)((int64_t)split * S / n_split);
  const int s_end = (int)((int64_t)(split + 1) * S / n_split);
  const int n_tiles = (s_end - s_begin + TILE - 1) / TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = D / CH;                              // 16-byte copies per row

  const float* kb = k + b * k_sb + kh * k_sk;
  const float* vb = v + b * v_sb + kh * v_sk;
  // tile `it` into stage it & 1; rows past the split's end are zeroed
  auto issue = [&](int it) {
    const int t0 = s_begin + it * TILE, n_t = min(TILE, s_end - t0);
    uint8_t* kd = ks + (it & 1) * TILE * ldb;
    uint8_t* vd = vs + (it & 1) * TILE * ldb;
    for (int e = tid; e < TILE * chunks; e += THREADS) {
      const int t = e / chunks, c = e - t * chunks;
      uint8_t* kdst = kd + t * ldb + c * 16;
      uint8_t* vdst = vd + t * ldb + c * 16;
      if (t < n_t) {
        cp_async16(smem_u32(kdst), kb + (int64_t)(t0 + t) * k_ss + c * CH);
        cp_async16(smem_u32(vdst), vb + (int64_t)(t0 + t) * v_ss + c * CH);
      } else {
        *reinterpret_cast<uint4*>(kdst) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vdst) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const float* qb = q + b * q_sb + (int64_t)kh * G * q_sh;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e - g * D;
    qs[e] = qb[g * q_sh + d] * scale;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  // score step: key kt, query rows gh + NGH*i; PV step: columns pc + 64*j,
  // query rows pg + 2*i
  const int kt = tid % TILE, gh = tid / TILE;
  const int pc = tid & 63, pg = tid >> 6;
  float acc[MAX_G / 2][MAX_D / 64];
#pragma unroll
  for (int i = 0; i < MAX_G / 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_D / 64; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s_begin + it * TILE, n_t = min(TILE, s_end - t0);
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* kt_s = ks + (it & 1) * TILE * ldb;
    const uint8_t* vt_s = vs + (it & 1) * TILE * ldb;

    // scores s[g][t] = (q*scale) . k
    {
      float sc[GPT];
#pragma unroll
      for (int i = 0; i < GPT; ++i) sc[i] = 0.f;
      const uint8_t* krow = kt_s + kt * ldb;
      for (int c = 0; c < chunks; ++c) {
        float kf[CH];
        unpack16(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          const int g = gh + NGH * i;
          if (g < G) {
            const float4* qr = reinterpret_cast<const float4*>(qs + g * D + c * CH);
#pragma unroll
            for (int u = 0; u < CH / 4; ++u) {
              const float4 qv = qr[u];
              sc[i] = fmaf(qv.x, kf[4 * u], sc[i]);
              sc[i] = fmaf(qv.y, kf[4 * u + 1], sc[i]);
              sc[i] = fmaf(qv.z, kf[4 * u + 2], sc[i]);
              sc[i] = fmaf(qv.w, kf[4 * u + 3], sc[i]);
            }
          }
        }
      }
      int st = -1;
      if (kt < n_t) {
        const int kp = kpos[t0 + kt];
        bool ok = kp >= 0 && kp <= cur;
        if (window) ok = ok && kp > cur - window;
        st = ok ? 1 : 0;
      }
      if (gh == 0) state[kt] = st;
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        const int g = gh + NGH * i;
        if (g < G) {
          float s = sc[i];
          if (cap != 0.f) s = cap * tanhf(s / cap);
          ps[g * TILE + kt] = st == 0 ? NEG_INF : s;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per query row
    for (int g = warp; g < G; g += THREADS / 32) {
      float tmax = -FLT_MAX;                  // below NEG_INF: any key in range wins
      for (int t = lane; t < TILE; t += 32)
        if (state[t] >= 0) tmax = fmaxf(tmax, ps[g * TILE + t]);
      tmax = warp_max(tmax);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int t = lane; t < TILE; t += 32) {
        float p = 0.f;
        if (state[t] >= 0) p = expf(ps[g * TILE + t] - m_new);
        psum += p;
        ps[g * TILE + t] = p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v (keys past the end have p = 0 and zero rows)
#pragma unroll
    for (int i = 0; i < MAX_G / 2; ++i) {
      const int g = pg + 2 * i;
      if (g < G) {
        const float corr = corr_s[g];
#pragma unroll
        for (int j = 0; j < MAX_D / 64; ++j) acc[i][j] *= corr;
      }
    }
    for (int t = 0; t < TILE; t += 4) {
      float vv[4][MAX_D / 64];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = reinterpret_cast<const float*>(vt_s + (t + u) * ldb);
#pragma unroll
        for (int j = 0; j < MAX_D / 64; ++j) {
          const int d = pc + 64 * j;
          vv[u][j] = d < D ? vrow[d] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_G / 2; ++i) {
        const int g = pg + 2 * i;
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(ps + g * TILE + t);
#pragma unroll
          for (int j = 0; j < MAX_D / 64; ++j) {
            float a = acc[i][j];
            a = fmaf(p.x, vv[0][j], a);
            a = fmaf(p.y, vv[1][j], a);
            a = fmaf(p.z, vv[2][j], a);
            a = fmaf(p.w, vv[3][j], a);
            acc[i][j] = a;
          }
        }
      }
    }
    __syncthreads();                          // this stage may be refilled
  }

  const int H = K * G;
  float* ob = out + ((int64_t)b * H + kh * G) * D;
  float* lse_row = lse != nullptr ? lse + (int64_t)b * H + kh * G : nullptr;
  if (n_split == 1) {                         // the whole cache in this block
#pragma unroll
    for (int i = 0; i < MAX_G / 2; ++i) {
      const int g = pg + 2 * i;
      if (g >= G) continue;
      const float denom = fmaxf(l_s[g], 1e-37f);
      const bool dead = lse_row != nullptr && m_s[g] <= NEG_INF;
#pragma unroll
      for (int j = 0; j < MAX_D / 64; ++j) {
        const int d = pc + 64 * j;
        if (d < D) ob[g * D + d] = dead ? 0.f : acc[i][j] / denom;
      }
    }
    if (lse_row != nullptr && tid < G)
      lse_row[tid] = m_s[tid] <= NEG_INF ? NEG_INF + logf(1e-37f)
                                         : m_s[tid] + logf(fmaxf(l_s[tid], 1e-37f));
    return;
  }

  // leave the partial in shared memory, then merge the cluster's partials
#pragma unroll
  for (int i = 0; i < MAX_G / 2; ++i) {
    const int g = pg + 2 * i;
    if (g >= G) continue;
#pragma unroll
    for (int j = 0; j < MAX_D / 64; ++j) {
      const int d = pc + 64 * j;
      if (d < D) part[g * D + d] = acc[i][j];
    }
  }
  cluster_merge(m_s, l_s, part, D, wts, l_tot, G, D, ob, lse_row);
}

// Launches `kernel` as a cluster of n_split blocks along x.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int n_split, int rows, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, rows);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const void* q, long long q_sb, long long q_sh,
                const void* k, long long k_sb, long long k_ss, long long k_sk,
                const void* v, long long v_sb, long long v_ss, long long v_sk,
                const int* kpos, void* out, float* lse, int B, int K, int G, int S, int D,
                int n_split, int cur, int window, float cap, float scale,
                cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return launch_cluster(flash_decode_bf16<DP>, n_split, B * K, Bf16Geom<DP>::SMEM, stream,
                        static_cast<const bf*>(q), (int64_t)q_sb, (int64_t)q_sh,
                        static_cast<const bf*>(k), (int64_t)k_sb, (int64_t)k_ss, (int64_t)k_sk,
                        static_cast<const bf*>(v), (int64_t)v_sb, (int64_t)v_ss, (int64_t)v_sk,
                        kpos, static_cast<bf*>(out), lse, K, G, S, D, cur, window, cap,
                        scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Strides are
// in elements. Key range of split i: [i*S/n_split, (i+1)*S/n_split). lse:
// null, or a contiguous f32 (B, H) that receives each row's log-sum-exp.
// Returns the cudaError_t of the launch (0 = success); the caller raises on
// nonzero.
int flash_decode_launch(int dtype,
                        const void* q, long long q_sb, long long q_sh,
                        const void* k, long long k_sb, long long k_ss, long long k_sk,
                        const void* v, long long v_sb, long long v_ss, long long v_sk,
                        const void* kpos, void* out, float* lse,
                        int B, int K, int G, int S, int D, int n_split,
                        int cur, int window, float cap, float scale, void* stream) {
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_G || D < 1 || D > MAX_D || n_split < 1 || n_split > MAX_SPLIT ||
      n_split > S)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D % F32Geom::CH) return (int)cudaErrorInvalidValue;
    return launch_cluster(flash_decode_f32, n_split, B * K, F32Geom::smem(G, D), st,
                          static_cast<const float*>(q), (int64_t)q_sb, (int64_t)q_sh,
                          static_cast<const float*>(k), (int64_t)k_sb, (int64_t)k_ss,
                          (int64_t)k_sk, static_cast<const float*>(v), (int64_t)v_sb,
                          (int64_t)v_ss, (int64_t)v_sk, kp, static_cast<float*>(out), lse, K,
                          G, S, D, cur, window, cap, scale);
  }
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
#define FD_ARGS q, q_sb, q_sh, k, k_sb, k_ss, k_sk, v, v_sb, v_ss, v_sk, kp, out, lse, B, K, G, \
                S, D, n_split, cur, window, cap, scale, st
    if (D <= 64) return launch_bf16<64>(FD_ARGS);
    if (D <= 128) return launch_bf16<128>(FD_ARGS);
    return launch_bf16<256>(FD_ARGS);
#undef FD_ARGS
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
