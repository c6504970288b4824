// Pieces the Mamba2 SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu) share: the chunk's cumulative log-decay taken by one
// warp, and the bf16 paths' operand tiles, swizzled as wgmma reads them and
// filled by 16-byte cp.async.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WG = 128;          // one warpgroup: a bf16 block
constexpr int TILE = 64;         // rows of a query or key tile

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

// A tile of R rows by PD bf16 columns in shared memory, as wgmma reads it
// and as TMA would write it: panels of PW = min(PD, 64) columns, each R rows
// of PW * 2 bytes, the 16-byte chunks of a row XOR-swizzled by the row
// (128-, 64- or 32-byte swizzle for PW = 64, 32, 16; none for PW = 8, whose
// rows are the core matrices' own). Each tile starts on a multiple of its
// swizzle atom (8 rows).
template <int R, int PD>
struct Tile {
  static constexpr int PW = PD < 64 ? PD : 64, NP = PD / PW, NJ = PD / 8, CPR = PW / 8;
  static constexpr uint32_t ROW = PW * 2, GROUP = 8 * ROW, PANEL = R * ROW, BYTES = NP * PANEL;
  static constexpr uint32_t LAYOUT = PW == 64 ? 1 : PW == 32 ? 2 : PW == 16 ? 3 : 0;
  static_assert(R % 8 == 0 && PD % 8 == 0 && NP * PW == PD, "tile shape");
  // byte offset of chunk j (columns 8j .. 8j+7) of row r
  static __device__ __forceinline__ uint32_t off(int r, int j) {
    const int c = j % CPR;
    return (j / CPR) * PANEL + r * ROW + ((c ^ ((r * ROW >> 7) & (CPR - 1))) << 4);
  }
  // K-major operand (rows along M or N, columns along K) at k16 step kk
  static __device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk) {
    static_assert(PW >= 16, "a K-major operand is at least 16 columns wide");
    return smem_desc(base + (kk * 16) / PW * PANEL + (kk * 16) % PW * 2, 16, GROUP, LAYOUT);
  }
  // MN-major operand (rows along K, columns along M or N): panel p, k16 step kk
  static __device__ __forceinline__ uint64_t desc_mn(uint32_t base, int p, int kk) {
    return smem_desc(base + p * PANEL + kk * 16 * ROW, GROUP, GROUP, LAYOUT);
  }
};

// Rows [0, R) of a bf16 matrix whose row r starts at src + r * ld, into a
// Tile<R, PD> by cp.async, eight threads to a 128-byte row segment; rows >=
// rows_ok and chunks >= nj_ok are zeros.
template <int R, int PD>
__device__ __forceinline__ void stage_tile(uint32_t dst, const __nv_bfloat16* src, int64_t ld,
                                           int rows_ok, int nj_ok) {
  using T = Tile<R, PD>;
#pragma unroll
  for (int i = 0; i < (R * T::NJ + WG - 1) / WG; ++i) {
    const int e = i * WG + threadIdx.x;
    if (R * T::NJ % WG && e >= R * T::NJ) break;
    const int r = e / T::NJ, j = e % T::NJ;
    const bool ok = r < rows_ok && j < nj_ok;
    cp_async16(dst + T::off(r, j), ok ? src + r * ld + j * 8 : src, ok ? 16 : 0);
  }
}

// dt of chunk rows [0, n) of one head into dts by cp.async (zeros at or
// past L).
__device__ __forceinline__ void stage_dt(float* dts, const float* dtb, int64_t dt_sl, int l0,
                                         int L, int n) {
  for (int i = threadIdx.x; i < n; i += WG) {
    const bool ok = l0 + i < L;
    cp_async4(smem_u32(dts + i), ok ? dtb + (int64_t)(l0 + i) * dt_sl : dtb, ok ? 4 : 0);
  }
}

// Eight bf16 (one chunk) times s, each product rounded to bf16.
__device__ __forceinline__ void scale_chunk(uint4& v, float s) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(f.x * s, f.y * s);
  }
}

// The shared memory of a block starts at a 1024-byte boundary (the 128-byte
// swizzle's atom).
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

}  // namespace
