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
// What bounds it on the H100: at N = 2^18, A = 4 the block is 8.4 MB of
// signal, 2.5 us at 3.35 TB/s. But most calls are small (77 % of the paper
// sweep's launches at N <= 32768, 0.26 MB at A = 1), and there the kernel is
// latency: memory round trips, barriers and the cross-CTA finish, not bytes.
//
// What the design does about it (channel.cuh holds the shared parts):
// - The launch is the whole call: the CTAs derive the channel parameters
//   from the raw inputs and read the PRN's column from the code table
//   themselves, so a wrapper call is one device op.
// - One memory round trip per CTA: each thread's signal loads (16-byte
//   vectors) are in flight before any arithmetic; the parameter reads and the
//   replica row's code reads overlap them.
// - Each chip once: the CTA builds the tile's replica row rep[m], m in
//   [0, 1024 + span), in shared memory, while each thread wipes off its
//   samples; tap l reads rep[j + delta_l], a thread's four chips of a tap in
//   one 16-byte load where delta_l % 4 == 0 (every L1 tap from N = 2^13 up).
//   (j + delta_l) is an exact small integer in f32, so this rounds bit for bit
//   like the per-tap formula (tests/test_torch_channel_arith.py). The wrap is
//   one unsigned min where the tile's last chip proves it exact (bank.cuh),
//   else the general modulo (2 chips/sample, negative rates). At the main
//   path's widest span, GPS L1 at N = 2^18 with L = 7 (768 samples), the row
//   holds 1792 chips (7 KB). Spans past kMaxRow - 1024 = 7168 samples take
//   the second branch: each tap's chip looked up directly in the column.
// - The reduction and the finish of channel.cuh: a transpose warp sum, a
//   cluster sum through distributed shared memory, and for more than one
//   cluster a last-cluster finish in a fixed order.

#include "channel.cuh"

namespace {

using channel::kPer;
using channel::kThreads;
using channel::kTile;

// The tile's replica row rep[m] = chip of tile position m, m < width, from
// the PRN's column `col` (stride P). kNear: bank::chips_near holds, and the
// wrap is one unsigned min; else the general wrap. The position steps
// exactly in f32.
template <bool kNear>
__device__ __forceinline__ void replica_row(float* rep, const float* __restrict__ col,
                                            int stride, const bank::Phases& ph, int width,
                                            int code_length, int t) {
  float mf = static_cast<float>(t);
#pragma unroll 4
  for (int m = t; m < width; m += kThreads, mf += static_cast<float>(kThreads)) {
    const int ci = kNear ? bank::chip_index_near(ph, mf, code_length)
                         : bank::chip_index(ph, mf, code_length);
    rep[m] = __ldg(col + static_cast<size_t>(ci) * stride);
  }
}

// Floats of one tile's row: its 1024 + span chips, and 4 more that the
// 16-byte reads of row_chips may touch, rounded to whole 16-byte words.
__host__ __device__ constexpr int row_floats(int span) { return (kTile + span + 4 + 3) / 4 * 4; }

// Chips of row positions m0 .. m0 + 3, m0 = 4 tid + delta: one 16-byte
// shared load (conflict-free across the warp) where delta % 4 == 0, else two
// and a shift by delta % 4 (the same for every thread).
__device__ __forceinline__ float4 row_chips(const float* rep, int m0) {
  const int r = m0 & 3;
  const float4* at = reinterpret_cast<const float4*>(rep + (m0 - r));
  const float4 a = at[0];
  if (r == 0) return a;
  const float4 b = at[1];
  return r == 1 ? make_float4(a.y, a.z, a.w, b.x)
                : r == 2 ? make_float4(a.z, a.w, b.x, b.y) : make_float4(a.w, b.x, b.y, b.z);
}

// The same chips looked up in the column directly: the branch for spans
// whose row would not fit shared memory.
__device__ __forceinline__ float4 column_chips(const float* __restrict__ col, int stride,
                                               const bank::Phases& ph, int m0,
                                               int code_length) {
  float c[kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int ci = bank::chip_index(ph, static_cast<float>(m0 + s), code_length);
    c[s] = __ldg(col + static_cast<size_t>(ci) * stride);
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

template <int A, int L>
__global__ void __launch_bounds__(kThreads) fused_kernel(const channel::Args p) {
  extern __shared__ float4 row[];            // [row_floats] chips when p.row
  float* rep = reinterpret_cast<float*>(row);
  const int tid = threadIdx.x;
  const int n_begin = blockIdx.x * kTile;
  const int n = n_begin + kPer * tid;        // this thread's first sample
  const channel::Raw raw = channel::read_raw(p);
  float4 xr[A], xi[A];
  channel::load_rows<A>(p.sre, p.num_samples, n, p.vec, xr);
  channel::load_rows<A>(p.sim, p.num_samples, n, p.vec, xi);
  channel::cluster_arrive();

  const channel::Params q = channel::derive(p, raw);
  const bank::Phases ph = channel::tile_phases(q, n_begin, p.code_length);
  const float* col = p.table + channel::channel_prn(p, raw);
  if (p.row) {
    const int width = kTile + p.span;
    if (bank::chips_near(ph, static_cast<float>(width - 1), p.code_length)) {
      replica_row<true>(rep, col, p.num_prns, ph, width, p.code_length, tid);
    } else {
      replica_row<false>(rep, col, p.num_prns, ph, width, p.code_length, tid);
    }
  }

  // Wipe-off of the thread's samples while the row is built.
  float dr[A][kPer], di[A][kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    float sn, cs;
    channel::carrier(static_cast<float>(kPer * tid + s), ph.f, ph.ph_car, &sn, &cs);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float x_re = channel::lane_of(xr[a], s);
      const float x_im = channel::lane_of(xi[a], s);
      dr[a][s] = x_re * cs + x_im * sn;
      di[a][s] = x_im * cs - x_re * sn;
    }
  }
  __syncthreads();

  float acc[2 * A * L];
#pragma unroll
  for (int i = 0; i < 2 * A * L; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int m0 = kPer * tid + p.deltas[l];
    const float4 c = p.row ? row_chips(rep, m0)
                           : column_chips(col, p.num_prns, ph, m0, p.code_length);
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const float chip = channel::lane_of(c, s);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        acc[(a * L + l) * 2] += dr[a][s] * chip;
        acc[(a * L + l) * 2 + 1] += di[a][s] * chip;
      }
    }
  }
  channel::finish<2 * A * L>(acc, p);
}

}  // namespace

// Launch the fused correlator on `stream` over `grid` CTAs, one tile each,
// in clusters of `cluster` (ops/channel_kernels.py::work_split). Each channel
// parameter is read through its pointer where that is not null, else taken
// by value. `scratch`: word 0 the finish counter (zero, and left at zero),
// then (grid / cluster) * 2AL floats of partials from 16 bytes on; null for
// a one-cluster grid, which needs none. `out`: [2, A, L].
// Returns the first CUDA error (cudaErrorInvalidValue for an antenna/tap
// count with no instantiation).
extern "C" int fused_launch(const float* sre, const float* sim, const float* codes,
                            float* out, float* scratch, const void* prn_ptr,
                            const float* fcar_ptr, const float* phicar_ptr,
                            const float* fcode_ptr, const float* phicode_ptr, int prn,
                            int prn_is64, float fcar, float phicar, float fcode, float phicode,
                            double fs, const int* deltas, int d_min, int num_ants,
                            int num_taps, int num_samples, int code_length, int num_prns,
                            int vec, int grid, int cluster, void* stream) {
  if (num_taps > channel::kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  const channel::Args args = channel::make_args(
      sre, sim, codes, out, scratch, prn_ptr, fcar_ptr, phicar_ptr, fcode_ptr, phicode_ptr,
      prn, prn_is64, fcar, phicar, fcode, phicode, fs, deltas, num_taps, d_min, num_samples,
      code_length, num_prns, vec);
  const size_t smem = args.row ? row_floats(args.span) * sizeof(float) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define FUSED_CASE(A_, L_)                                                                    \
  if (num_ants == A_ && num_taps == L_) {                                                     \
    err = channel::launch<fused_kernel<A_, L_>>(args, grid, cluster, smem, s);                \
  }
  FUSED_CASE(1, 3) FUSED_CASE(1, 5) FUSED_CASE(1, 7)
  FUSED_CASE(2, 3) FUSED_CASE(2, 5) FUSED_CASE(2, 7)
  FUSED_CASE(3, 3) FUSED_CASE(3, 5) FUSED_CASE(3, 7)
  FUSED_CASE(4, 3) FUSED_CASE(4, 5) FUSED_CASE(4, 7)
#undef FUSED_CASE
  return static_cast<int>(err);
}
