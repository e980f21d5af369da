// Code replica of one channel, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. In the JAX package XLA fuses
// gpuacceleratedtracking_tpu/ops/replica.py::gen_code_replica (and
// gen_code_replica_quantized) with the tap matrix that
// ops/pallas_epl.py::correlate_pallas_taps builds from it
// (ops/correlate.py::_tap_matrix) into the program around the taps kernel.
// This kernel is the port's counterpart of that fusion: one launch writes
// the [R, W] f32 rows out[r, j] = code[chip(j + off_r), prn], either the
// haloed replica row (R = 1, W = N + span, off = min_shift) or the taps
// kernel's [L, N] tap matrix (off_l = d_l).
//
// The chips repeat the plain version's roundings (ops/replica.py), so the
// kernel matches it bit for bit:
//
//   rho = f32(f64(f32(code_frequency)) * f64(1 / fs))   torch's division of a
//         CUDA tensor by a Python scalar multiplies by the double reciprocal
//   exact, sample s >= 0:  fl(fl(fl(rho * 128 q) + fl(rho * i)) + phi),
//         s = 128 q + i (code_phase_steps' rows, origin 0: the prompt tap's
//         chips are the transmitted ones)
//   exact, sample s < 0:   fl(fl(rho * s) + phi)                  (the left halo)
//   quantized, j = s - min_shift from the grid's origin:
//         p = fl(fl(fl(rho * 128 q) + fl(rho * i)) + fl(phi + fl(rho * min_shift))),
//         j = 128 q + i, then rint(fl(p * 2^bits)) * 2^-bits
//   chip = code[(floor(p) as int64) mod Lc]               (non-negative remainder)
//
// every product and sum rounded on its own (__fmul_rn / __fadd_rn): no
// contraction into FMAs. Build without --use_fast_math.
//
// What bounds it on the H100: device memory, and close behind it issue. Per
// element it writes 4 bytes and reads one chip of the PRN's code column
// (L2-resident, 4 Lc bytes in all); at N = 2^18, L = 7 the write is 7.3 MB,
// 2.2 us at 3.35 TB/s. Each element also takes ~30 instructions of phase
// arithmetic and the remainder mod Lc (1.8 M elements there). Below
// N ~ 2^16 it is one launch and one memory round trip.
//
// What the design does about it: one element per thread (8 past ~1 M
// elements), consecutive threads on consecutive samples of a row, so each
// warp's stores are one coalesced 128-byte line and a thread's code reads
// are in flight together; the
// remainder in 32 bits; the channel parameters come from the raw inputs (by
// value, or one element of device memory by pointer, as the per-channel
// correlators take them: channel.cuh), so a call is one device op with no
// host copy and no host read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidePer = 8;                // elements per thread in a launch of kWide or more
constexpr long long kWide = 1 << 20;
constexpr int kMaxRows = 32;               // rows per launch: the wrapper launches more

struct Args {
  const float* codes;        // [Lc, P]
  float* out;                // [R, W]
  const void* prn_ptr;       // int32 or int64 element (prn_is64), or null: `prn`
  const float* fcode_ptr;    // a device element, or null for `fcode`
  const float* phase_ptr;    // a device element, or null for `phase`
  double inv_fs;             // 1 / fs in double
  float fcode, phase, scale, inv_scale;
  int prn, prn_is64, num_prns, code_length;
  int rows, width, min_shift, quantized;
  int offsets[kMaxRows];     // off_r: out[r, j] is the chip of sample j + off_r
};

__device__ __forceinline__ float load_f(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ long long load_prn(const void* p, bool is64) {
  if (is64) {
    long long v;
    asm volatile("ld.global.nc.s64 %0, [%1];" : "=l"(v) : "l"(p));
    return v;
  }
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// code_phase_steps' element n = 128 q + i, n >= 0: fl(fl(rho * 128 q) + fl(rho * i)).
__device__ __forceinline__ float steps(float rho, int n) {
  const int i = n & 127;
  return __fadd_rn(__fmul_rn(rho, static_cast<float>(n - i)),
                   __fmul_rn(rho, static_cast<float>(i)));
}

// The chip index of sample s: the plain version's phase, its floor, then the
// remainder of the whole chips in 32 bits where they fit (every sample below
// 2^24 at a rate below 2^7 chips per sample), the same chip for a fraction
// of the 64-bit remainder's instructions.
__device__ __forceinline__ long long chip_index(const Args& p, float rho, float phi, int s) {
  float phase;
  if (p.quantized) {
    const float offset = __fadd_rn(phi, __fmul_rn(rho, static_cast<float>(p.min_shift)));
    phase = __fadd_rn(steps(rho, s - p.min_shift), offset);
    phase = __fmul_rn(rintf(__fmul_rn(phase, p.scale)), p.inv_scale);
  } else if (s >= 0) {
    phase = __fadd_rn(steps(rho, s), phi);
  } else {
    phase = __fadd_rn(__fmul_rn(rho, static_cast<float>(s)), phi);
  }
  const float whole = floorf(phase);
  if (fabsf(whole) < 0x1p31f) {
    const int c = static_cast<int>(whole) % p.code_length;
    return c < 0 ? c + p.code_length : c;
  }
  const long long c = static_cast<long long>(whole) % p.code_length;
  return c < 0 ? c + p.code_length : c;
}

// A CTA takes kPer * kThreads consecutive elements of one row, thread t the
// elements t, t + kThreads, ...: every store instruction of a warp is one
// coalesced line, and a thread's kPer code reads are in flight together
// after one read of the channel parameters.
template <int kPer>
__global__ void __launch_bounds__(kThreads) replica_kernel(const Args p) {
  const int r = blockIdx.y;
  const int j0 = blockIdx.x * (kPer * kThreads) + threadIdx.x;
  const float fcode = p.fcode_ptr ? load_f(p.fcode_ptr) : p.fcode;
  const float phi = p.phase_ptr ? load_f(p.phase_ptr) : p.phase;
  const long long prn = p.prn_ptr ? load_prn(p.prn_ptr, p.prn_is64) : p.prn;
  if (prn < 0 || prn >= p.num_prns) __trap();   // as index_select's assert would
  const float rho = __double2float_rn(__dmul_rn(static_cast<double>(fcode), p.inv_fs));
  const float* col = p.codes + prn;
  float* out = p.out + static_cast<size_t>(r) * p.width;
  long long chip[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = j0 + k * kThreads;
    chip[k] = j < p.width ? chip_index(p, rho, phi, j + p.offsets[r]) : 0;
  }
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = __ldg(col + static_cast<size_t>(chip[k]) * p.num_prns);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = j0 + k * kThreads;
    if (j < p.width) out[j] = v[k];
  }
}

}  // namespace

// Write `rows` rows of `width` chips into `out` ([rows, width], f32) on
// `stream`: row r holds the chips of samples j + offsets[r]. The code
// frequency, the start code phase and the PRN are read through their
// pointers where those are not null, else taken by value; a PRN outside
// [0, num_prns) traps. `quantized`: the fixed-point replica on the grid that
// starts at sample `min_shift`, with `scale` = 2^bits and `inv_scale` its
// reciprocal. Returns the first CUDA error (cudaErrorInvalidValue for more
// than 32 rows or an empty row).
extern "C" int replica_launch(const float* codes, float* out, const void* prn_ptr,
                              const float* fcode_ptr, const float* phase_ptr, int prn,
                              int prn_is64, float fcode, float phase, double inv_fs,
                              const int* offsets, int rows, int width, int min_shift,
                              int code_length, int num_prns, int quantized, float scale,
                              float inv_scale, void* stream) {
  if (rows < 1 || rows > kMaxRows || width < 1 || code_length < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.codes = codes;
  a.out = out;
  a.prn_ptr = prn_ptr;
  a.fcode_ptr = fcode_ptr;
  a.phase_ptr = phase_ptr;
  a.inv_fs = inv_fs;
  a.fcode = fcode;
  a.phase = phase;
  a.scale = scale;
  a.inv_scale = inv_scale;
  a.prn = prn;
  a.prn_is64 = prn_is64;
  a.num_prns = num_prns;
  a.code_length = code_length;
  a.rows = rows;
  a.width = width;
  a.min_shift = min_shift;
  a.quantized = quantized;
  for (int r = 0; r < rows; ++r) a.offsets[r] = offsets[r];
  // One element per thread fills the card with CTAs; past ~1 M elements
  // (N = 2^18 at L = 7: 7 waves of the card) each thread takes kWidePer, so
  // one wave holds them all and its code reads overlap.
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(rows) * width >= kWide) {
    const dim3 grid((width + kWidePer * kThreads - 1) / (kWidePer * kThreads), rows);
    replica_kernel<kWidePer><<<grid, kThreads, 0, s>>>(a);
  } else {
    const dim3 grid((width + kThreads - 1) / kThreads, rows);
    replica_kernel<1><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
