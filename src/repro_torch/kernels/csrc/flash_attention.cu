// Flash attention for Hopper (sm_90a): causal or non-causal attention over a
// whole sequence (prefill and the train-mode forward).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd (body `_kernel`)
// and computes src/repro/kernels/ref.py::flash_attention_ref with the Pallas
// kernel's numerics: q scaled by D**-0.5 in f32, scores in f32, optional
// logit softcap cap*tanh(s/cap), causal (q and k positions both start at 0),
// sliding window and past-the-end (`kv_len`) masks with the finite
// NEG_INF = -0.7 * FLT_MAX, an online softmax kept in f32, `p` rounded to v's
// type before the PV product while `l` sums the unrounded `p`, and
// out = acc / max(l, 1e-37).
//
// Bound: operations at long prompts. Per (b, h) the kernel reads Sq*D q
// values and Skv*D k and v values once from device memory (k, v shared by
// the G query heads of a kv head) and does 4*D flops per (q, k) pair under
// the mask. For qwen2-0.5b at B=1, S=2048 that is 7.5 GFLOP against 8.4 MB:
// 0.0076 ms at the bf16 tensor-core peak, three times the 0.0025 ms of the
// bytes. At B=4, S=512 the 1.9 GFLOP take less than the same 8.4 MB.
//
// Design (a plain CUDA-core kernel, the first correct version; no wgmma or
// TMA yet): one block per (64-row q tile, b*H + h). The block stages its q
// tile (pre-scaled, f32) once, then walks only the live 64-key tiles: from
// the tile holding key q0 - window + 1 under a window, up to the diagonal
// when causal. Each tile's K and V are staged in shared memory as f32; each
// of the 256 threads owns a 4x4 block of the 64x64 score tile and a
// 4 x ceil(D/16) block of the output accumulator, kept in registers. Rows of
// one thread group reduce their max and sum with warp shuffles.
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, K, D) are read through their
// strides (the head dim must be contiguous); query head h reads kv head
// h / G. Nothing is repeated or transposed. out is a contiguous
// (B, Sq, H, D).
//
// Shared memory: (64*D + 64*(D+1) + 64*D + 64*65) floats, 114 KB at D=128
// and 213 KB at D=256, so it is dynamic shared memory set with
// cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // (ty, tx) in 16 x 16
constexpr int ROWS = BQ / 16;    // query rows per thread: ty + 16*i
constexpr int KCOLS = BK / 16;   // keys per thread in a tile: tx + 16*j
constexpr int MAX_D = 256;
constexpr float NEG_INF = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value `x` takes once rounded to T (the Pallas kernel's p.astype(v.dtype)).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Reductions over the 16 lanes that share a ty (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D
                          + (size_t)BQ * (BK + 1));
}

// DC = head-dim columns per thread, ceil(D / 16).
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       const T* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       const T* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       T* __restrict__ out, int H, int G, int Sq, int Skv, int D,
                       int causal, int window, float cap, float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;                 // padded rows: no bank conflicts
  const int ldp = BK + 1;
  float* qs = smem;                      // [BQ][D]    q * scale, f32
  float* ks = qs + BQ * D;               // [BK][D+1]
  float* vs = ks + BK * ldk;             // [BK][D]
  float* ps = vs + BK * D;               // [BQ][BK+1] p rounded to T

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H, kh = h / G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    const int s = q0 + r;
    qs[e] = s < Sq ? to_f(qb[s * q_ss + d]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // live keys: [k_begin, k_end)
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Skv, q0 + BQ) : Skv;

  for (int t0 = (k_begin / BK) * BK; t0 < k_end; t0 += BK) {
    __syncthreads();                     // qs written / last tile's readers done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int t = e / D, d = e - t * D;
      const int s = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (s < Skv) {
        kx = to_f(kb[s * k_ss + d]);
        vx = to_f(vb[s * v_ss + d]);
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
      const int qp = q0 + ty + 16 * i;
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
        ps[(ty + 16 * i) * ldp + tx + 16 * j] = round_to<T>(p);
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
    T* orow = out + (((int64_t)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DC>
int launch_dc(const void* q, long long q_sb, long long q_ss, long long q_sh,
              const void* k, long long k_sb, long long k_ss, long long k_sh,
              const void* v, long long v_sb, long long v_ss, long long v_sh,
              void* out, int B, int H, int G, int Sq, int Skv, int D,
              int causal, int window, float cap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, DC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_ss, q_sh,
      static_cast<const T*>(k), k_sb, k_ss, k_sh,
      static_cast<const T*>(v), v_sb, v_ss, v_sh,
      static_cast<T*>(out), H, G, Sq, Skv, D, causal, window, cap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, long long q_sb, long long q_ss, long long q_sh,
           const void* k, long long k_sb, long long k_ss, long long k_sh,
           const void* v, long long v_sb, long long v_ss, long long v_sh,
           void* out, int B, int H, int G, int Sq, int Skv, int D,
           int causal, int window, float cap, float scale, cudaStream_t stream) {
#define FA_LAUNCH(DC)                                                                 \
  return launch_dc<T, DC>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, \
                          v_sh, out, B, H, G, Sq, Skv, D, causal, window, cap,       \
                          scale, stream)
  if (D <= 16) FA_LAUNCH(1);
  if (D <= 32) FA_LAUNCH(2);
  if (D <= 64) FA_LAUNCH(4);
  if (D <= 128) FA_LAUNCH(8);
  if (D <= MAX_D) FA_LAUNCH(16);
#undef FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest head dim the kernel takes.
int flash_attention_max_d() { return MAX_D; }

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. out is a
// contiguous (B, Sq, H, D). Returns the cudaError_t of the launch
// (0 = success); the caller raises on nonzero.
int flash_attention_launch(int dtype,
                           const void* q, long long q_sb, long long q_ss, long long q_sh,
                           const void* k, long long k_sb, long long k_ss, long long k_sh,
                           const void* v, long long v_sb, long long v_ss, long long v_sh,
                           void* out, int B, int H, int G, int Sq, int Skv, int D,
                           int causal, int window, float cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh,
                         out, B, H, G, Sq, Skv, D, causal, window, cap, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                                 v_sh, out, B, H, G, Sq, Skv, D, causal, window, cap,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
