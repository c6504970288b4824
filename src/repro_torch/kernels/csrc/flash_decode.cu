// Flash-decode for Hopper (sm_90a): one new token of GQA attention against
// a KV cache.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_decode.py::flash_decode_bkgd (body `_kernel`)
// and computes exactly src/repro/kernels/ref.py::flash_decode_ref with the
// Pallas kernel's numerics: q scaled by D**-0.5 in f32, scores in f32,
// optional logit softcap cap*tanh(s/cap), per-slot absolute positions `kpos`
// (< 0 = invalid) masked against `cur` and an optional sliding window, an
// online softmax kept in f32, `p` rounded to v's type before the PV product
// while `l` sums the unrounded `p`.
//
// Bound: bytes. Each call streams the K and V rows of one layer's cache once
// (2*B*S*K*D elements) and does ~4*B*S*H*D flops on them: about G flops per
// byte, far below the card's ~295 flop/byte ridge. At serving batch sizes the
// TPU grid's B*K rows give only 2-16 blocks, which cannot draw the card's
// bandwidth over 132 SMs. So the sequence is split across blocks
// (flash-decoding): grid (B*K, n_split), each block walks its own key range
// with its own running (m, l, acc) and writes them to f32 partials; a second
// small kernel merges the splits with weights exp(m_split - m_max).
//
// Layout: q (B, H, D) and k, v (B, S, K, D) are read through their strides
// (the innermost dim must be contiguous), so the model's cache is read in
// place; head h = kh*G + g as the reference's reshape(B, 1, K, G, D).
//
// Masked scores take the finite NEG_INF = -0.7 * FLT_MAX, never -inf: a
// split whose keys are all masked (common under a window or a ring) then ends
// with m = NEG_INF and a finite l, and its combine weight is
// exp(NEG_INF - m_max) = 0 instead of NaN.
//
// A plain CUDA-core kernel: tiles of TILE keys are staged in shared memory as
// f32; no wgmma, no TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;        // keys staged per step
constexpr int THREADS = 128;    // 4 warps
constexpr int COMBINE_THREADS = 256;
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block per (b*K + kh, split). Writes the split's running max, sum and
// unnormalised accumulator for each of the G query rows of kv head kh.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_sh,
                          const T* __restrict__ k, int64_t k_sb, int64_t k_ss, int64_t k_sk,
                          const T* __restrict__ v, int64_t v_sb, int64_t v_ss, int64_t v_sk,
                          const int* __restrict__ kpos,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc,
                          int K, int G, int S, int D, int split_len,
                          int cur, int window, float cap, float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;                      // padded rows: no bank conflicts
  float* qs = smem;                           // [G][D]   scaled q, f32
  float* ks = qs + G * D;                     // [TILE][D+1]
  float* vs = ks + TILE * ldk;                // [TILE][D]
  float* ps = vs + TILE * D;                  // [G][TILE] scores, then p
  float* acc = ps + G * TILE;                 // [G][D]
  float* m_s = acc + G * D;                   // [G]
  float* l_s = m_s + G;                       // [G]
  float* corr_s = l_s + G;                    // [G]
  int* state = reinterpret_cast<int*>(corr_s + G);  // [TILE] 1 valid, 0 masked, -1 past the end

  const int bk = blockIdx.x;
  const int b = bk / K, kh = bk % K;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = THREADS / 32;

  const T* qb = q + b * q_sb + (int64_t)kh * G * q_sh;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e - g * D;
    qs[e] = to_f(qb[g * q_sh + d]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const T* kb = k + b * k_sb + kh * k_sk;
  const T* vb = v + b * v_sb + kh * v_sk;
  for (int t0 = s_begin; t0 < s_end; t0 += TILE) {
    const int n_t = min(TILE, s_end - t0);
    for (int e = tid; e < TILE * D; e += THREADS) {
      const int t = e / D, d = e - t * D;
      float kx = 0.f, vx = 0.f;
      if (t < n_t) {
        kx = to_f(kb[(t0 + t) * k_ss + d]);
        vx = to_f(vb[(t0 + t) * v_ss + d]);
      }
      ks[t * ldk + d] = kx;
      vs[t * D + d] = vx;
    }
    for (int t = tid; t < TILE; t += THREADS) {
      int st = -1;
      if (t < n_t) {
        const int kp = kpos[t0 + t];
        bool ok = kp >= 0 && kp <= cur;
        if (window) ok = ok && kp > cur - window;
        st = ok ? 1 : 0;
      }
      state[t] = st;
    }
    __syncthreads();

    // scores s[g][t] = (q*scale) . k
    for (int e = tid; e < G * TILE; e += THREADS) {
      const int g = e / TILE, t = e - g * TILE;
      float s = 0.f;
      if (state[t] >= 0) {
        const float* qr = qs + g * D;
        const float* kr = ks + t * ldk;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        if (cap != 0.f) s = cap * tanhf(s / cap);
        if (state[t] == 0) s = NEG_INF;
      }
      ps[e] = s;
    }
    __syncthreads();

    // online softmax update, one warp per query row
    for (int g = warp; g < G; g += n_warps) {
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
        ps[g * TILE + t] = round_to<T>(p);
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

    // acc = acc * corr + p @ v
    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D, d = e - g * D;
      const float* pr = ps + g * TILE;
      float a = 0.f;
      for (int t = 0; t < n_t; ++t) a = fmaf(pr[t], vs[t * D + d], a);
      acc[e] = acc[e] * corr_s[g] + a;
    }
    __syncthreads();
  }

  const int64_t row = (int64_t)bk * n_split + split;
  for (int e = tid; e < G * D; e += THREADS) part_acc[row * G * D + e] = acc[e];
  for (int g = tid; g < G; g += THREADS) {
    part_m[row * G + g] = m_s[g];
    part_l[row * G + g] = l_s[g];
  }
}

// One block per b*K + kh: merges the n_split partials into out (B, H, D).
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine_kernel(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc,
                            T* __restrict__ out, int K, int G, int D, int n_split) {
  const int bk = blockIdx.x;
  const int b = bk / K, kh = bk % K;
  const int H = K * G;
  for (int e = threadIdx.x; e < G * D; e += COMBINE_THREADS) {
    const int g = e / D, d = e - g * D;
    float m_max = -FLT_MAX;
    for (int j = 0; j < n_split; ++j)
      m_max = fmaxf(m_max, part_m[((int64_t)bk * n_split + j) * G + g]);
    float l = 0.f, a = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const int64_t row = (int64_t)bk * n_split + j;
      const float w = expf(part_m[row * G + g] - m_max);
      l = fmaf(w, part_l[row * G + g], l);
      a = fmaf(w, part_acc[row * G * D + e], a);
    }
    out[((int64_t)b * H + kh * G + g) * D + d] = from_f<T>(a / fmaxf(l, 1e-37f));
  }
}

size_t split_smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)TILE * (D + 1) + (size_t)TILE * D
                          + (size_t)G * TILE + 3 * (size_t)G)
         + sizeof(int) * TILE;
}

template <typename T>
int launch(const void* q, long long q_sb, long long q_sh,
           const void* k, long long k_sb, long long k_ss, long long k_sk,
           const void* v, long long v_sb, long long v_ss, long long v_sk,
           const int* kpos, void* out, float* part_m, float* part_l, float* part_acc,
           int B, int K, int G, int S, int D, int n_split, int split_len,
           int cur, int window, float cap, float scale, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(G, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_decode_split_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * K, n_split);
  flash_decode_split_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh,
      static_cast<const T*>(k), k_sb, k_ss, k_sk,
      static_cast<const T*>(v), v_sb, v_ss, v_sk,
      kpos, part_m, part_l, part_acc, K, G, S, D, split_len, cur, window, cap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<T><<<B * K, COMBINE_THREADS, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), K, G, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Keys each split kernel stages per step; the wrapper rounds split lengths to it.
int flash_decode_tile() { return TILE; }

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launches (0 = success); the caller raises on nonzero.
int flash_decode_launch(int dtype,
                        const void* q, long long q_sb, long long q_sh,
                        const void* k, long long k_sb, long long k_ss, long long k_sk,
                        const void* v, long long v_sb, long long v_ss, long long v_sk,
                        const void* kpos, void* out,
                        void* part_m, void* part_l, void* part_acc,
                        int B, int K, int G, int S, int D, int n_split, int split_len,
                        int cur, int window, float cap, float scale, void* stream) {
  const int* kp = static_cast<const int*>(kpos);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, q_sb, q_sh, k, k_sb, k_ss, k_sk, v, v_sb, v_ss, v_sk,
                         kp, out, pm, pl, pa, B, K, G, S, D, n_split, split_len,
                         cur, window, cap, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, q_sb, q_sh, k, k_sb, k_ss, k_sk, v, v_sb, v_ss, v_sk,
                                 kp, out, pm, pl, pa, B, K, G, S, D, n_split, split_len,
                                 cur, window, cap, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
