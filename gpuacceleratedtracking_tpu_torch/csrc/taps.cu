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
// What bounds it on the H100: device memory at the top of the paper's sweep.
// Per sample it reads 8A bytes of signal and 4L bytes of replica and does
// one sincospi and 2AL multiply-adds; at N = 2^18, A = 4, L = 7 that is
// 15.7 MB (4.7 us at 3.35 TB/s). Below N ~ 2^16, where most calls are, the
// kernel is latency: memory round trips, barriers and the cross-CTA finish.
//
// What the design does about it (channel.cuh holds the shared parts): the
// launch is the whole call (the CTAs derive the carrier parameters from the
// raw inputs); each thread's signal and tap-row loads, 16-byte vectors, are
// all in flight before any arithmetic, one memory round trip per CTA; the
// transpose warp sum, the cluster sum through distributed shared memory and
// for more than one cluster a last-cluster finish in a fixed order. The
// sincospif per sample stays (the tap rows, not the carrier, are the bytes).
// The launch is a programmatic dependent of the replica kernel that writes
// the tap matrix just before it (csrc/replica.cu, which lets it start once
// its CTAs have their parameters): the CTAs read the carrier parameters and
// the signal under the replica kernel and wait for its grid only before
// the tap rows (wait_primary), which hides most of a launch at small N.

#include "channel.cuh"

namespace {

using channel::kPer;
using channel::kThreads;
using channel::kTile;

template <int A, int L>
__global__ void __launch_bounds__(kThreads) taps_kernel(const channel::Args p) {
  const int tid = threadIdx.x;
  const int n_begin = blockIdx.x * kTile;
  const int n = n_begin + kPer * tid;        // this thread's first sample
  const channel::Raw raw = channel::read_raw(p);
  float4 xr[A], xi[A], tap[L];
  channel::load_rows<A>(p.sre, p.num_samples, n, p.vec, xr);
  channel::load_rows<A>(p.sim, p.num_samples, n, p.vec, xi);
  channel::wait_primary();                   // the replica kernel's tap matrix
  channel::load_rows<L>(p.table, p.num_samples, n, p.vec, tap);
  channel::cluster_arrive();

  const channel::Params q = channel::derive(p, raw);
  const float ph_car = channel::tile_carrier(q.f_cyc, q.phi_cyc, n_begin);

  float acc[2 * A * L];
#pragma unroll
  for (int i = 0; i < 2 * A * L; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    float sn, cs;
    channel::carrier(static_cast<float>(kPer * tid + s), q.f_cyc, ph_car, &sn, &cs);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float x_re = channel::lane_of(xr[a], s);
      const float x_im = channel::lane_of(xi[a], s);
      const float dr = x_re * cs + x_im * sn;
      const float di = x_im * cs - x_re * sn;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float chip = channel::lane_of(tap[l], s);
        acc[(a * L + l) * 2] += dr * chip;
        acc[(a * L + l) * 2 + 1] += di * chip;
      }
    }
  }
  channel::finish<2 * A * L>(acc, p);
}

}  // namespace

// Launch the taps correlator on `stream` over `grid` CTAs, one tile each, in
// clusters of `cluster` (ops/channel_kernels.py::work_split). `taps`: the [L, N] tap
// matrix. The carrier parameters are read through their pointers where those
// are not null, else taken by value. `scratch` and `out` as for fused_launch.
// Returns the first CUDA error (cudaErrorInvalidValue for an antenna/tap
// count with no instantiation).
extern "C" int taps_launch(const float* sre, const float* sim, const float* taps, float* out,
                           float* scratch, const float* fcar_ptr, const float* phicar_ptr,
                           float fcar, float phicar, double fs, int num_ants, int num_taps,
                           int num_samples, int vec, int grid, int cluster, void* stream) {
  const int no_deltas[channel::kMaxTaps] = {};
  const channel::Args args = channel::make_args(
      sre, sim, taps, out, scratch, nullptr, fcar_ptr, phicar_ptr, nullptr, nullptr, 0, 0,
      fcar, phicar, 0.0f, 0.0f, fs, no_deltas, 0, 0, num_samples, 1, 1, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define TAPS_CASE(A_, L_)                                                                 \
  if (num_ants == A_ && num_taps == L_) {                                                 \
    err = channel::launch<taps_kernel<A_, L_>>(args, grid, cluster, 0, s, true);          \
  }
  TAPS_CASE(1, 3) TAPS_CASE(1, 5) TAPS_CASE(1, 7)
  TAPS_CASE(2, 3) TAPS_CASE(2, 5) TAPS_CASE(2, 7)
  TAPS_CASE(3, 3) TAPS_CASE(3, 5) TAPS_CASE(3, 7)
  TAPS_CASE(4, 3) TAPS_CASE(4, 5) TAPS_CASE(4, 7)
#undef TAPS_CASE
  return static_cast<int>(err);
}
