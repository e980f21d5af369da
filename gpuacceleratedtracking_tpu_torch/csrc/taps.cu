// Single-channel Early/Prompt/Late correlator with a precomputed tap matrix,
// for Hopper (sm_90a).
//
// Replaces: gpuacceleratedtracking_tpu/ops/pallas_epl.py::_taps_kernel
// (wrapper correlate_pallas_taps), the reference's 3431 kernel: the code
// replica comes from outside as an [L, N] f32 tap matrix (the reference's
// global-memory replica strategy), and the kernel fuses the carrier NCO, the
// wipe-off and the tap MAC. Same contract: f32 accumulators [A, L],
//
//   acc[a,l] = sum_n s[a,n] * conj(exp(i 2pi (f n + theta))) * taps[l,n].
//
// What bounds it on the H100: device memory. Per sample it reads 8A bytes of
// signal and 4L bytes of replica and does one sincospi and 2AL multiply-adds;
// at N = 2^18, A = 4, L = 7 that is 15.7 MB (~5 us at 3.35 TB/s). Below
// N ~ 2^16 the launch and the host's per-call set-up (the replica is built by
// plain PyTorch ops) dominate.
//
// What the design does about it: the TPU kernel's row x lane carrier
// factorization exists to keep transcendentals off the TPU's vector unit;
// here each thread evaluates sincospif per sample and reads the signal and
// the L replica rows coalesced, once each. The grid spreads the channel over
// sample tiles, and one launch does the whole reduction (channel.cuh).

#include "channel.cuh"

namespace {

using channel::kThreads;

template <int A, int L>
__global__ void __launch_bounds__(kThreads)
taps_kernel(const float* __restrict__ sre,        // [A, N]
            const float* __restrict__ sim,        // [A, N]
            const float* __restrict__ taps,       // [L, N]
            const float4* __restrict__ params,    // [1]: f_cyc, phi_cyc, (rho, phi_code unused)
            float* __restrict__ partial,          // [tiles, A, L, 2]
            unsigned int* __restrict__ counter,   // zero before the launch
            float* __restrict__ out_re,           // [A, L]
            float* __restrict__ out_im,           // [A, L]
            int num_samples, int tile) {
  const float4 p = params[0];
  const int n_begin = blockIdx.x * tile;
  const float ph_car = channel::tile_carrier(p.x, p.y, n_begin);

  float acc[2 * A * L];
#pragma unroll
  for (int i = 0; i < 2 * A * L; ++i) acc[i] = 0.0f;

  const int n_end = min(n_begin + tile, num_samples);
  for (int n = n_begin + static_cast<int>(threadIdx.x); n < n_end; n += kThreads) {
    const float j = static_cast<float>(n - n_begin);
    float sn, cs;
    channel::carrier(j, p.x, ph_car, &sn, &cs);
    float rep[L];
#pragma unroll
    for (int l = 0; l < L; ++l) rep[l] = taps[static_cast<size_t>(l) * num_samples + n];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float xr = sre[static_cast<size_t>(a) * num_samples + n];
      const float xi = sim[static_cast<size_t>(a) * num_samples + n];
      const float dr = xr * cs + xi * sn;
      const float di = xi * cs - xr * sn;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        acc[(a * L + l) * 2] += dr * rep[l];
        acc[(a * L + l) * 2 + 1] += di * rep[l];
      }
    }
  }
  channel::reduce_tiles<2 * A * L>(acc, partial, counter, out_re, out_im);
}

}  // namespace

// Launch the taps correlator on `stream`. `scratch` holds tiles * 2AL floats
// of partials followed by one zeroed word, the finish counter. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an antenna/tap count with no
// instantiation).
extern "C" int taps_launch(const float* sre, const float* sim, const float* taps,
                           const float* params, float* scratch, float* out_re,
                           float* out_im, int num_ants, int num_taps, int num_samples,
                           int tile, void* stream) {
  const int num_tiles = (num_samples + tile - 1) / tile;
  float* partial = scratch;
  unsigned int* counter = reinterpret_cast<unsigned int*>(
      scratch + static_cast<size_t>(num_tiles) * 2 * num_ants * num_taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TAPS_CASE(A_, L_)                                                          \
  if (num_ants == A_ && num_taps == L_) {                                          \
    taps_kernel<A_, L_><<<num_tiles, kThreads, 0, s>>>(                            \
        sre, sim, taps, reinterpret_cast<const float4*>(params), partial, counter, \
        out_re, out_im, num_samples, tile);                                        \
  } else
  TAPS_CASE(1, 3) TAPS_CASE(1, 5) TAPS_CASE(1, 7)
  TAPS_CASE(2, 3) TAPS_CASE(2, 5) TAPS_CASE(2, 7)
  TAPS_CASE(3, 3) TAPS_CASE(3, 5) TAPS_CASE(3, 7)
  TAPS_CASE(4, 3) TAPS_CASE(4, 5) TAPS_CASE(4, 7)
  { return static_cast<int>(cudaErrorInvalidValue); }
#undef TAPS_CASE
  return static_cast<int>(cudaGetLastError());
}
