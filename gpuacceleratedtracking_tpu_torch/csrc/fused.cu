// Fully fused single-channel Early/Prompt/Late correlator for Hopper (sm_90a).
//
// Replaces: gpuacceleratedtracking_tpu/ops/pallas_epl.py::_fused_kernel
// (wrapper correlate_pallas_fused), the reference's 5431 mega-kernel: code
// replica, carrier NCO, wipe-off and tap MAC in one launch, no intermediates
// in device memory. Same contract: one channel against an f32 SoA block
// [A, N], f32 accumulators [A, L]:
//
//   acc[a,l] = sum_n s[a,n] * conj(exp(i 2pi (f n + theta)))
//                    * code[floor((n + delta_l) * rho + phi) mod Lc]
//
// with delta_l = d_l - d_min >= 0 and phi = code_phase + rho * d_min.
//
// What bounds it on the H100: at N = 2^18, A = 4 the block is 8 MB of signal
// (~2.5 us at 3.35 TB/s) and ~1 M warp-instructions (~2 us); below
// N ~ 2^16 the launch itself and the host's per-call set-up dominate.
//
// What the design does about it: the TPU kernel's one-hot MXU gather,
// _flat_shift's static rolls and the row x lane carrier factorization exist
// because TPU gathers and dynamic rolls are slow. Here each thread looks its
// chip up directly in the channel's code column (read-only cache: a warp's 32
// samples touch at most 33 neighbouring chips below 1 chip/sample), so any
// tap span works without a halo. The grid spreads the one channel over sample
// tiles (channel.cuh), and one launch does the whole reduction.
//
// Chip arithmetic as csrc/bank_rows.cu, with the tile's whole chips kept as
// an integer (channel.cuh, tile_code): the per-sample sum carries only the
// fraction, so a chip boundary lands on the same sample in the kernel and in
// its plain version (correlate_fused_reference).

#include "channel.cuh"

namespace {

using channel::kThreads;

template <int A, int L>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ sre,        // [A, N]
             const float* __restrict__ sim,        // [A, N]
             const float* __restrict__ code,       // [Lc], the channel's column
             const float4* __restrict__ params,    // [1]: f_cyc, phi_cyc, rho, phi_code
             const int* __restrict__ deltas,       // [L]
             float* __restrict__ partial,          // [tiles, A, L, 2]
             unsigned int* __restrict__ counter,   // zero before the launch
             float* __restrict__ out_re,           // [A, L]
             float* __restrict__ out_im,           // [A, L]
             int num_samples, int code_length, int tile) {
  const float4 p = params[0];
  const int n_begin = blockIdx.x * tile;
  const float ph_car = channel::tile_carrier(p.x, p.y, n_begin);
  int chip0;
  float pc_frac;
  channel::tile_code(p.z, p.w, n_begin, code_length, &chip0, &pc_frac);

  float dl[L];
#pragma unroll
  for (int l = 0; l < L; ++l) dl[l] = static_cast<float>(deltas[l]);

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
    for (int l = 0; l < L; ++l) {
      const float x = __fadd_rn(__fmul_rn(__fadd_rn(j, dl[l]), p.z), pc_frac);
      int ci = (static_cast<int>(floorf(x)) + chip0) % code_length;
      if (ci < 0) ci += code_length;
      rep[l] = __ldg(code + ci);
    }
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

// Launch the fused correlator on `stream`. `scratch` holds tiles * 2AL floats
// of partials followed by one zeroed word, the finish counter. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an antenna/tap count with no
// instantiation).
extern "C" int fused_launch(const float* sre, const float* sim, const float* code,
                            const float* params, const int* deltas, float* scratch,
                            float* out_re, float* out_im, int num_ants, int num_taps,
                            int num_samples, int code_length, int tile, void* stream) {
  const int num_tiles = (num_samples + tile - 1) / tile;
  float* partial = scratch;
  unsigned int* counter = reinterpret_cast<unsigned int*>(
      scratch + static_cast<size_t>(num_tiles) * 2 * num_ants * num_taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_CASE(A_, L_)                                                        \
  if (num_ants == A_ && num_taps == L_) {                                         \
    fused_kernel<A_, L_><<<num_tiles, kThreads, 0, s>>>(                          \
        sre, sim, code, reinterpret_cast<const float4*>(params), deltas, partial, \
        counter, out_re, out_im, num_samples, code_length, tile);                 \
  } else
  FUSED_CASE(1, 3) FUSED_CASE(1, 5) FUSED_CASE(1, 7)
  FUSED_CASE(2, 3) FUSED_CASE(2, 5) FUSED_CASE(2, 7)
  FUSED_CASE(3, 3) FUSED_CASE(3, 5) FUSED_CASE(3, 7)
  FUSED_CASE(4, 3) FUSED_CASE(4, 5) FUSED_CASE(4, 7)
  { return static_cast<int>(cudaErrorInvalidValue); }
#undef FUSED_CASE
  return static_cast<int>(cudaGetLastError());
}
