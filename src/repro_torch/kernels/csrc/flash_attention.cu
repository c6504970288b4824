// Flash attention for Hopper (sm_90a): causal or non-causal attention over a
// whole sequence (prefill and the train-mode forward).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd (body `_kernel`)
// and computes src/repro/kernels/ref.py::flash_attention_ref with the Pallas
// kernel's numerics: scores in f32 scaled by D**-0.5, optional logit softcap
// cap*tanh(s/cap), causal (q and k positions both start at 0), sliding
// window and past-the-end (`kv_len`) masks with the finite
// NEG_INF = -0.7 * FLT_MAX, an online softmax kept in f32, `p` rounded to v's
// type before the PV product while `l` sums the unrounded `p`, and
// out = acc / max(l, 1e-37).
//
// Bound: operations at long prompts. Per (b, h) the kernel reads Sq*D q
// values and Skv*D k and v values once from device memory (k, v shared by
// the G query heads of a kv head) and does 4*D flops per (q, k) pair under
// the mask. For qwen2-0.5b at B=1, S=2048 that is 7.5 GFLOP against 8.4 MB:
// 0.0076 ms at the bf16 tensor-core peak, three times the 0.0025 ms of the
// bytes. Only the tensor cores can come near that, so the bf16 kernel runs
// both products on them.
//
// Two kernels, chosen by dtype in the C entry point (dispatch by dtype, not
// a fallback; a launch that fails returns its error and the wrapper raises):
//
// * bfloat16 (the models' type): `flash_attention_bf16`, tensor cores.
//   One block is one warpgroup (128 threads) for a 64-row q tile of one
//   (b, h); the grid is (B*H, q tiles) with the q tiles nearest the end of
//   the sequence (the most causal work) dispatched first. The q tile is
//   loaded once by TMA; 64-key K and V tiles come by TMA
//   (cp.async.bulk.tensor, tensor maps built on the host per call with
//   cuTensorMapEncodeTiled; the TMA, mbarrier and tensor-map helpers are
//   hopper.cuh's, shared with the backward) into a two-stage ring with one
//   mbarrier per stage: thread 0 issues tile j+1 before the warpgroup
//   computes on tile j. Only the live tiles are walked: from the window's first key up to the
//   diagonal. S = Q.K^T is wgmma m64n64k16 (bf16 in, f32 accumulate) with Q
//   and K both K-major from swizzled shared memory; the softmax runs on the
//   accumulator fragment in registers (row max across the four lanes of a
//   quad, the row sum kept per lane and reduced once at the end); P is
//   rounded to bf16 into the A-operand registers of O += P.V, a wgmma with
//   V as an MN-major B operand (transpose bit set), one instruction per
//   panel of D. A tile row is one swizzle row: panels of 64 columns with the
//   128-byte swizzle (D = 64, 128, 256), or one panel of 32 or 16 columns
//   with the 64- or 32-byte swizzle (D = 32, 16); other multiples of 16 run
//   the next of these widths, the columns past D filled with zeros by TMA.
//   Rows past the end of q, k or v are zeros from TMA as well; the kv_len
//   and causal masks still apply to the scores. Bf16 products are exact in
//   f32, so Q.K^T on the tensor cores equals the f32 product up to summation
//   order; the scale is applied to the f32 scores (the Pallas kernel scales
//   q first: the same bits for D = 16, 64, 256, within tolerance otherwise).
//   Shared memory: the q tile and two stages of K and V, 64*D*2 bytes each,
//   40 KB at D = 64 and 160 KB at D = 256 (cudaFuncSetAttribute).
//
// * float32 (parity cases only): `flash_attention_f32`, CUDA cores (the
//   tensor cores would round f32 inputs to tf32): one block of 256 threads
//   per (64-row q tile, b*H + h), q pre-scaled in f32, K and V tiles staged
//   in shared memory as f32, each thread owning a 4x4 block of the 64x64
//   score tile and a 4 x ceil(D/16) block of the output accumulator in
//   registers.
//
// Both kernels write the row log-sum-exp lse = m + log(max(l, 1e-37)), f32
// (B, H, Sq), when they are given a non-null pointer for it: the train
// forward saves it for csrc/flash_attention_bwd.cu. Serving and prefill pass
// null, and the kernels then store nothing more.
//
// Key offset k0 (the segment-parallel context attention of
// src/repro/models/flash_xla.py::_seg_fwd): key row j sits at absolute position
// k0 + j, query row i at i. Every position test (the live key tiles, the edge
// test, the causal and window masks) runs on qp - k0 against the key row, so
// k0 = 0 is the whole-sequence call. A q tile with no live key tile walks
// nothing and writes out = 0 and lse = NEG_INF + log(1e-37); a row whose live
// tiles hold no key it may see ends with m = NEG_INF (its lse ~ NEG_INF + log
// of the keys walked). Either merges with weight exp(lse - lse_tot) = 0.
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, K, D) are read through their
// strides (the head dim contiguous; for bf16 the base 16-byte aligned and
// every other stride a multiple of 16 bytes, as TMA needs: the wrapper
// checks); query head h reads kv head h / G. Nothing is repeated or
// transposed. out is a contiguous (B, Sq, H, D).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int MAX_D = 256;
constexpr float NEG_INF = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------------ bf16 path

constexpr int WG_THREADS = 128;  // one warpgroup

// Shared-memory geometry of one head width PD (16, 32, 64, 128 or 256).
template <int PD>
struct Geom : TileGeom<PD> {
  // q tile, two stages of K and V, three mbarriers, slack to align to 1 KB
  static constexpr size_t SMEM = 5 * (size_t)TileGeom<PD>::TILE + 64 + 1024;
};

// Thread 0: K and V tile `it` (keys from t0) into stage it & 1 of the ring.
template <int PD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t sk, uint32_t sv, uint32_t bar_q, int it,
                                        int t0, int kh, int b) {
  using Gm = Geom<PD>;
  const uint32_t st = it & 1, bar = bar_q + 8 + 8 * st;
  mbar_expect_tx(bar, 2 * Gm::TILE);
#pragma unroll
  for (int p = 0; p < Gm::NP; ++p) {
    tma_load_4d(sk + st * Gm::TILE + p * Gm::PANEL, tk, bar, p * Gm::PW, kh, t0, b);
    tma_load_4d(sv + st * Gm::TILE + p * Gm::PANEL, tv, bar, p * Gm::PW, kh, t0, b);
  }
}

template <int PD>
__global__ void __launch_bounds__(WG_THREADS)
flash_attention_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int H, int G, int Sq, int Skv, int D, int causal,
                     int window, int k0, float cap, float scale) {
  using Gm = Geom<PD>;
  constexpr int PW = Gm::PW, NP = Gm::NP;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms need 1 KB
  const uint32_t sk = sq + Gm::TILE;                           // [2] stages
  const uint32_t sv = sk + 2 * Gm::TILE;                       // [2] stages
  const uint32_t bar_q = sv + 2 * Gm::TILE;                    // then bar_q + 8 (1 + stage)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;            // longest first
  const int qk = q0 - k0;                                      // q0 against the key rows

  // live keys: [k_begin, k_end), walked in whole tiles
  const int k_begin = window ? max(0, qk - window + 1) : 0;
  const int k_end = causal ? min(Skv, qk + BQ) : Skv;
  const int t_first = (k_begin / BK) * BK;
  const int n_tiles = k_end > t_first ? (k_end - t_first + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    mbar_init(bar_q + 16, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, Gm::TILE);
#pragma unroll
    for (int p = 0; p < NP; ++p) tma_load_4d(sq + p * Gm::PANEL, &tq, bar_q, p * PW, h, q0, b);
    if (n_tiles > 0) load_kv<PD>(&tk, &tv, sk, sv, bar_q, 0, t_first, kh, b);
  }

  // Accumulator fragment of a 64xN wgmma: register 4*n8 + 2*i + j holds row
  // r_lo + 8*i, column 8*n8 + c_lane + j.
  const int r_lo = warp * 16 + (lane >> 2);
  const int c_lane = 2 * (lane & 3);
  float o[NP][PW / 2];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < PW / 2; ++r) o[p][r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                                     // this lane's columns only
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * BK;
    const uint32_t st = it & 1;
    if (tid == 0 && it + 1 < n_tiles)
      load_kv<PD>(&tk, &tv, sk, sv, bar_q, it + 1, t0 + BK, kh, b);
    mbar_wait(bar_q + 8 + 8 * st, (it >> 1) & 1);

    // S = Q K^T over PD/16 steps of 16 head-dim columns
    float s[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PD / 16; ++kk) {
      const uint32_t off = (kk * 16) / PW * Gm::PANEL + ((kk * 16) % PW) * 2;
      wgmma_ss<0, 0>(s, smem_desc(sq + off, 16, Gm::GROUP, Gm::LAYOUT),
                   smem_desc(sk + st * Gm::TILE + off, 16, Gm::GROUP, Gm::LAYOUT), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragment: rows r_lo (i = 0) and r_lo + 8 (i = 1)
    const bool edge = t0 + BK > Skv || (causal && t0 + BK - 1 > qk) ||
                      (window && qk + BQ - 1 - t0 >= window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[4 * n8 + 2 * i + j] * scale;
          if (cap != 0.f) x = cap * tanhf(x / cap);
          if (edge) {
            const int kp = t0 + 8 * n8 + c_lane + j, qp = qk + r_lo + 8 * i;
            bool ok = kp < Skv;
            if (causal) ok = ok && qp >= kp;
            if (window) ok = ok && qp - kp < window;
            x = ok ? x : NEG_INF;
          }
          s[4 * n8 + 2 * i + j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      l[i] *= corr[i];
    }
    // P rounded to bf16 as the A operand of key step kk = n8 / 2: register
    // (n8 % 2) * 2 + i holds row r_lo + 8*i, keys 8*n8 + c_lane + {0, 1}
    uint32_t pa[4][4];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f((s[4 * n8 + 2 * i] - m[i]) * LOG2E);
        const float p1 = exp2f((s[4 * n8 + 2 * i + 1] - m[i]) * LOG2E);
        l[i] += p0 + p1;
        pa[n8 / 2][(n8 % 2) * 2 + i] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int r = 0; r < PW / 2; ++r) o[p][r] *= corr[(r >> 1) & 1];

    // O += P V: four steps of 16 keys, one wgmma per panel of D
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs(o[p], pa[kk],
                 smem_desc(sv + st * Gm::TILE + p * Gm::PANEL + kk * 16 * Gm::ROW, Gm::GROUP,
                           Gm::GROUP, Gm::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    __syncthreads();                     // stage st is read by all: it may be refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r_lo + 8 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((int64_t)b * H + h) * Sq + row] = m[i] + logf(denom);
    __nv_bfloat16* orow = out + (((int64_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int n8 = 0; n8 < PW / 8; ++n8) {
        const int col = p * PW + 8 * n8 + c_lane;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              o[p][4 * n8 + 2 * i] / denom, o[p][4 * n8 + 2 * i + 1] / denom);
      }
  }
}

template <int PD>
int launch_bf16(const void* q, long long q_sb, long long q_ss, long long q_sh, const void* k,
                long long k_sb, long long k_ss, long long k_sh, const void* v, long long v_sb,
                long long v_ss, long long v_sh, void* out, float* lse, int B, int H, int G,
                int Sq, int Skv, int D, int causal, int window, int k0, float cap, float scale,
                cudaStream_t stream) {
  using Gm = Geom<PD>;
  const int K = H / G;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, Sq, B, q_sh, q_ss, q_sb, Gm::PW) ||
      !make_map(&tk, k, D, K, Skv, B, k_sh, k_ss, k_sb, Gm::PW) ||
      !make_map(&tv, v, D, K, Skv, B, v_sh, v_ss, v_sb, Gm::PW))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16<PD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Gm::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_bf16<PD><<<grid, WG_THREADS, Gm::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, H, G, Sq, Skv, D, causal, window,
      k0, cap, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ f32 path

constexpr int F32_THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int ROWS = BQ / 16;        // query rows per thread: ty + 16*i
constexpr int KCOLS = BK / 16;       // keys per thread in a tile: tx + 16*j

// Reductions over the 16 lanes that share a ty (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t f32_smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D
                          + (size_t)BQ * (BK + 1));
}

// DC = head-dim columns per thread, ceil(D / 16).
template <int DC>
__global__ void __launch_bounds__(F32_THREADS)
flash_attention_f32(const float* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                    const float* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    const float* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                    float* __restrict__ out, float* __restrict__ lse, int H, int G, int Sq,
                    int Skv, int D, int causal, int window, int k0, float cap, float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;                 // padded rows: no bank conflicts
  const int ldp = BK + 1;
  float* qs = smem;                      // [BQ][D]    q * scale
  float* ks = qs + BQ * D;               // [BK][D+1]
  float* vs = ks + BK * ldk;             // [BK][D]
  float* ps = vs + BK * D;               // [BQ][BK+1] p

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H, kh = h / G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kh * k_sh;
  const float* vb = v + b * v_sb + kh * v_sh;

  for (int e = tid; e < BQ * D; e += F32_THREADS) {
    const int r = e / D, d = e - r * D;
    const int s = q0 + r;
    qs[e] = s < Sq ? qb[s * q_ss + d] * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // live keys: [k_begin, k_end), positions against the key rows (qk = q0 - k0)
  const int qk = q0 - k0;
  const int k_begin = window ? max(0, qk - window + 1) : 0;
  const int k_end = causal ? min(Skv, qk + BQ) : Skv;

  for (int t0 = (k_begin / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();                     // qs written / last tile's readers done
    for (int e = tid; e < BK * D; e += F32_THREADS) {
      const int t = e / D, d = e - t * D;
      const int s = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (s < Skv) {
        kx = kb[s * k_ss + d];
        vx = vb[s * v_ss + d];
      }
      ks[t * ldk + d] = kx;
      vs[t * D + d] = vx;
    }
    __syncthreads();

    float sc[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qr[ROWS], kc[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qr[i] = qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kc[j] = ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) sc[i][j] = fmaf(qr[i], kc[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = qk + ty + 16 * i;
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kp = t0 + tx + 16 * j;
        float s = sc[i][j];
        if (cap != 0.f) s = cap * tanhf(s / cap);
        bool ok = kp < Skv;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && qp - kp < window;
        s = ok ? s : NEG_INF;
        sc[i][j] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = group_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = expf(sc[i][j] - m_new);
        psum += p;
        ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
      }
      psum = group_sum(psum);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int t = 0; t < BK; ++t) {
      float pr[ROWS], vr[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pr[i] = ps[(ty + 16 * i) * ldp + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        vr[c] = d < D ? vs[t * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    if (lse != nullptr && tx == 0) lse[((int64_t)b * H + h) * Sq + r] = m[i] + logf(denom);
    float* orow = out + (((int64_t)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = acc[i][c] / denom;
    }
  }
}

template <int DC>
int launch_f32_dc(const void* q, long long q_sb, long long q_ss, long long q_sh,
                  const void* k, long long k_sb, long long k_ss, long long k_sh,
                  const void* v, long long v_sb, long long v_ss, long long v_sh,
                  void* out, float* lse, int B, int H, int G, int Sq, int Skv, int D,
                  int causal, int window, int k0, float cap, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_f32<DC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_f32<DC><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), q_sb, q_ss, q_sh,
      static_cast<const float*>(k), k_sb, k_ss, k_sh,
      static_cast<const float*>(v), v_sb, v_ss, v_sh,
      static_cast<float*>(out), lse, H, G, Sq, Skv, D, causal, window, k0, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest head dim the kernels take.
int flash_attention_max_d() { return MAX_D; }

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor cores, TMA).
// Strides are in elements. out is a contiguous (B, Sq, H, D); lse, when not
// null, a contiguous f32 (B, H, Sq) that receives the row log-sum-exp. k0:
// the absolute position of key row 0 (0 for a whole sequence).
// Returns the cudaError_t of the launch (0 = success); the caller raises on
// nonzero.
int flash_attention_launch(int dtype,
                           const void* q, long long q_sb, long long q_ss, long long q_sh,
                           const void* k, long long k_sb, long long k_ss, long long k_sh,
                           const void* v, long long v_sb, long long v_ss, long long v_sh,
                           void* out, float* lse, int B, int H, int G, int Sq, int Skv, int D,
                           int causal, int window, int k0, float cap, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh, out, lse, B, H, \
                G, Sq, Skv, D, causal, window, k0, cap, scale, st
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D <= 16) return launch_f32_dc<1>(FA_ARGS);
    if (D <= 32) return launch_f32_dc<2>(FA_ARGS);
    if (D <= 64) return launch_f32_dc<4>(FA_ARGS);
    if (D <= 128) return launch_f32_dc<8>(FA_ARGS);
    return launch_f32_dc<16>(FA_ARGS);
  }
  if (dtype == 1) {
    if (D % 16) return (int)cudaErrorInvalidValue;
    if (D <= 16) return launch_bf16<16>(FA_ARGS);
    if (D <= 32) return launch_bf16<32>(FA_ARGS);
    if (D <= 64) return launch_bf16<64>(FA_ARGS);
    if (D <= 128) return launch_bf16<128>(FA_ARGS);
    return launch_bf16<256>(FA_ARGS);
  }
#undef FA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
