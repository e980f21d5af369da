// Shared pieces of the per-channel correlator kernels (taps.cu, fused.cu).
//
// Both kernels correlate ONE channel against an f32 SoA block [A, N]. The
// grid runs over sample tiles of `tile` samples, one CTA each, so a single
// channel spreads over the card (N = 2048 gives 2 CTAs, N = 2^18 gives 256).
//
// Phases per tile (the plain versions in ops/channel_kernels.py compute the
// same values with the same roundings), with n0 = t * tile and the products
// rho * n0, f_cyc * n0 exact in double:
//
//   ph_car = phi_cyc + f32(frac(f_cyc * n0))
//   carrier cycles at tile sample j: j * f_cyc + ph_car, wrapped to [0, 1)
//   code phase phi_code + rho * n0 = chip0 + frac        (tile_code)
//   chip of tap l at tile sample j: (floor((j + delta_l) * rho + frac) + chip0) mod Lc
//
// The rates are the channel's own (the registry signature
// carries no nominal rates), so the per-sample residual of the bank kernels'
// scheme vanishes. Each product and sum is rounded on its own
// (__fmul_rn/__fadd_rn): no contraction into FMAs. Build without
// --use_fast_math.
//
// Reduction: warp shuffles and a fixed-order CTA sum into per-tile partials;
// the last CTA to finish (threadfence + counter) sums the partials in a fixed
// order. One launch, no float atomics, deterministic.

#pragma once

#include <cuda_runtime.h>

namespace channel {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Carrier cycles at the tile start, phi_cyc + base_car (not wrapped).
__device__ __forceinline__ float tile_carrier(float f_cyc, float phi_cyc, int n_begin) {
  double car = static_cast<double>(f_cyc) * static_cast<double>(n_begin);
  car = car - floor(car);
  return __fadd_rn(phi_cyc, static_cast<float>(car));
}

// Code phase at the tile start, phi_code + rho * n0, as whole chips in
// [0, Lc) (`chip0`) and a fraction in [0, 1) (`frac`). The whole parts of
// phi_code and of the exact base add as integers, so the fraction keeps f32
// resolution at any code length, and on the first tile it is exactly
// phi_code's own fraction.
__device__ __forceinline__ void tile_code(float rho, float phi_code, int n_begin,
                                          int code_length, int* chip0, float* frac) {
  const double lc = static_cast<double>(code_length);
  const double code = static_cast<double>(rho) * static_cast<double>(n_begin);
  double base_whole = floor(code);
  const float base_frac = static_cast<float>(code - base_whole);
  base_whole = base_whole - floor(base_whole / lc) * lc;
  const float phi_whole = floorf(phi_code);
  float f = __fadd_rn(__fsub_rn(phi_code, phi_whole), base_frac);
  const float f_whole = floorf(f);
  *frac = __fsub_rn(f, f_whole);
  long long c = static_cast<long long>(base_whole) + static_cast<long long>(phi_whole) +
                static_cast<long long>(f_whole);
  c %= code_length;
  *chip0 = static_cast<int>(c < 0 ? c + code_length : c);
}

// (sin, cos) of the carrier at tile sample j.
__device__ __forceinline__ void carrier(float j, float f_cyc, float ph_car, float* sn,
                                        float* cs) {
  float cyc = __fadd_rn(__fmul_rn(j, f_cyc), ph_car);
  cyc = __fsub_rn(cyc, floorf(cyc));
  sincospif(__fmul_rn(2.0f, cyc), sn, cs);
}

// Sum each thread's NV values over the grid into out_re/out_im[NV / 2]
// (value 2i is the real part of output i, 2i + 1 its imaginary part).
// `partial` holds gridDim.x * NV floats; `counter` starts at 0.
template <int NV>
__device__ __forceinline__ void reduce_tiles(const float (&v)[NV], float* __restrict__ partial,
                                             unsigned int* __restrict__ counter,
                                             float* __restrict__ out_re,
                                             float* __restrict__ out_im) {
  static_assert(NV <= 64, "the finish assigns 64 threads per group");
  constexpr int kGroups = kThreads / 64;
  __shared__ float red[kWarps][NV];
  __shared__ float grp[kGroups][NV];
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  const int num_tiles = gridDim.x;
  if (threadIdx.x < NV) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.x) * NV + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1u) == static_cast<unsigned int>(num_tiles - 1);
  }
  __syncthreads();
  if (!is_last) return;
  // Last CTA: group g sums tiles g, g + kGroups, ...; then the groups in order.
  const int i = threadIdx.x & 63;
  const int g = threadIdx.x >> 6;
  if (i < NV) {
    float s = 0.0f;
#pragma unroll 4
    for (int u = g; u < num_tiles; u += kGroups) {
      s += __ldcg(&partial[static_cast<size_t>(u) * NV + i]);
    }
    grp[g][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) s += grp[q][threadIdx.x];
    if (threadIdx.x & 1) {
      out_im[threadIdx.x >> 1] = s;
    } else {
      out_re[threadIdx.x >> 1] = s;
    }
  }
}

}  // namespace channel
