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
// In both modes a chip is a function of its sample alone, so row r is the
// chips of the samples [off_min, off_max + W) shifted by off_r - off_min:
// the tap matrix is one haloed row read at L offsets, as the plain version
// builds it (ops/replica_kernel.py::tap_matrix_plain).
//
// What bounds it on the H100: at large N the bytes written, 4 R W (at
// N = 2^18, L = 7: 7.3 MB, 2.2 us at 3.35 TB/s; a torch fill_ of the same
// fresh [7, 2^18] takes ~3.5 us of device time there); at small N the
// launch and the round trips under it (the parameters, then the code read),
// with nothing to overlap them: one wave of CTAs, all on the same path. A
// kernel that redoes the phase chain (~30 instructions: the two products,
// the floor, the remainder mod Lc and a strided code read) for every element
// of every row is issue-bound behind those bytes at L = 7.
//
// What the design does about it. From 3 x 2^17 elements in two rows or more
// (N >= 2^17 at L = 3, N >= 65536 at L = 7), a CTA owns a tile of T
// consecutive columns of every row (T a power of 2 in [256, 1024] from W: one
// wave of the 132 SMs, two CTAs per SM past N ~ 2^17, 8 to 32 warps of
// stores per SM). It runs the phase chain once per haloed sample, T + span
// of them, each thread's chains and code reads in flight together (kPer of
// them, a template parameter, so that no unused iteration is compiled in),
// into shared memory; then writes every row's tile from there: each row's
// tile one coalesced run of 16-byte stores, consecutive threads on
// consecutive addresses. A row's tile starts at any word of the haloed
// one, so the tile is kept as up to four copies, copy c shifted by c words:
// each 16-byte store reads one aligned 16-byte word of the copy that its
// row's shift selects, free of bank conflicts. A row's first words up to a
// 16-byte boundary and its last ones past its final full vector are scalar
// stores. Below that size, and for the haloed row, each thread writes one
// element from its own chain (replica_kernel_direct): measured on the H100,
// the tile's shared-memory pass lengthens the one path that every thread
// runs by more than the chains it saves (PERF.md). The code column is read
// through L1. The channel parameters come from the raw inputs (by value, or
// one element of device memory by pointer, as the per-channel correlators
// take them: channel.cuh), so a call is one device op with no host copy and
// no host read. As soon as it has its parameters, each CTA lets a
// programmatic dependent launch (the taps kernel) start: the taps kernel's
// launch, parameter and signal loads then run under this kernel, and its
// wait before the tap matrix still covers all of this grid's writes
// (measured on the H100, 0.5-1.6 us off a pallas_taps call; PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 64;               // rows per launch: the wrapper launches more
constexpr int kMinTile = 256;              // columns per CTA, a power of 2
constexpr int kMaxTile = 1024;
constexpr int kMaxSpan = 1024;             // largest offset less the smallest, per launch
constexpr int kWave = 132;                 // the H100's SMs
constexpr long long kTileElements = 3 << 17;   // from here (two rows or more) the tiles pay

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
  int tile;                  // T: columns per CTA, a power of 2
  int log2_nv;               // log2(T / 4): a row's vectors per tile
  int ragged;                // some row has scalar words (W % 4 != 0 or a misaligned row)
  int off_min, span;         // the smallest offset, and the largest less it
  int stride;                // floats per shifted copy in shared memory, a multiple of 4
  unsigned copies;           // bit c: copy c is read (bit 0 always: the scalar stores)
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

// Lets the next kernel on the stream, where it is a programmatic dependent
// launch (the taps kernel), start its prologue: its griddepcontrol.wait
// still waits for this whole grid to complete and its writes to be visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
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
__device__ __forceinline__ int chip_index(const Args& p, float rho, float phi, int s) {
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
  return static_cast<int>(c < 0 ? c + p.code_length : c);
}

// Words of row r before its first 16-byte boundary at a tile start (tiles
// start on multiples of 4 columns). The launcher picks the copies with the
// same expression.
__host__ __device__ __forceinline__ int row_head(uintptr_t out, int width, int r) {
  const uintptr_t word = (out >> 2) + static_cast<uintptr_t>(r) * static_cast<uintptr_t>(width);
  return static_cast<int>((4 - (word & 3)) & 3);
}

// Few elements (one row, or fewer than kTileElements of them): thread j of CTA
// (b, r) writes column 256 b + j of row r from its own phase chain. Here
// the launch and two memory round trips (the parameters, then the code
// read) are the kernel's time; a tile's shared-memory pass would add to
// that path.
__global__ void __launch_bounds__(256) replica_kernel_direct(const Args p) {
  const int r = blockIdx.y;
  const int j = blockIdx.x * 256 + threadIdx.x;
  const float fcode = p.fcode_ptr ? load_f(p.fcode_ptr) : p.fcode;
  const float phi = p.phase_ptr ? load_f(p.phase_ptr) : p.phase;
  const long long prn = p.prn_ptr ? load_prn(p.prn_ptr, p.prn_is64) : p.prn;
  if (prn < 0 || prn >= p.num_prns) __trap();   // as index_select's assert would
  launch_dependents();
  const float rho = __double2float_rn(__dmul_rn(static_cast<double>(fcode), p.inv_fs));
  if (j < p.width) {
    const int chip = chip_index(p, rho, phi, j + p.offsets[r]);
    p.out[static_cast<size_t>(r) * p.width + j] =
        __ldg(p.codes + prn + static_cast<size_t>(chip) * p.num_prns);
  }
}

// CTA b owns columns [b T, b T + T) of every row: the chips of its haloed
// samples into shared memory, then every row's tile from there. Each of the
// kThreads threads takes kPer haloed samples (kPer >= (T + span) / kThreads),
// all of their phase chains and code reads in flight together.
template <int kThreads, int kPer>
__global__ void __launch_bounds__(kThreads) replica_kernel(const Args p) {
  extern __shared__ __align__(16) float tile[];   // copy c at c * stride: tile[c s + i] = chip i + c
  __shared__ int head[kMaxRows];                   // row r's scalar words before its vectors
  __shared__ int shift[kMaxRows];                  // row r's column e is haloed sample e + shift
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * p.tile;
  const int cols = min(p.tile, p.width - j0);
  const int halo = cols + p.span;
  const float fcode = p.fcode_ptr ? load_f(p.fcode_ptr) : p.fcode;
  const float phi = p.phase_ptr ? load_f(p.phase_ptr) : p.phase;
  const long long prn = p.prn_ptr ? load_prn(p.prn_ptr, p.prn_is64) : p.prn;
  if (prn < 0 || prn >= p.num_prns) __trap();   // as index_select's assert would
  launch_dependents();
  const float rho = __double2float_rn(__dmul_rn(static_cast<double>(fcode), p.inv_fs));
  const float* col = p.codes + prn;
  if (tid < p.rows) {
    head[tid] = min(row_head(reinterpret_cast<uintptr_t>(p.out), p.width, tid), cols);
    shift[tid] = p.offsets[tid] - p.off_min;
  }

  // The haloed samples s = j0 + off_min + h, h < halo: thread t takes
  // h = t, t + kThreads, ....
  int chip[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int h = tid + k * kThreads;
    chip[k] = h < halo ? chip_index(p, rho, phi, j0 + p.off_min + h) : 0;
  }
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = tid + k * kThreads < halo ? __ldg(col + static_cast<size_t>(chip[k]) * p.num_prns)
                                     : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int h = tid + k * kThreads;
    if (h < halo) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (((p.copies >> c) & 1u) && h >= c) tile[c * p.stride + h - c] = v[k];
      }
    }
  }
  __syncthreads();

  // Each row's 16-byte vectors, all rows' at once: item i is vector
  // i % (T / 4) of row i / (T / 4); a row's last vector may end past the
  // tile's columns (the last tile, a ragged row) and is left to the scalars.
  const int items = p.rows << p.log2_nv;
  const int nv_mask = (1 << p.log2_nv) - 1;
#pragma unroll 4
  for (int i = tid; i < items; i += kThreads) {
    const int r = i >> p.log2_nv;
    const int e = head[r] + 4 * (i & nv_mask);             // column in the tile
    if (e + 4 <= cols) {
      const int b = e + shift[r];                          // haloed sample
      const int c = b & 3;
      *reinterpret_cast<float4*>(p.out + static_cast<size_t>(r) * p.width + j0 + e) =
          *reinterpret_cast<const float4*>(tile + c * p.stride + b - c);
    }
  }
  // The scalar words: up to 3 before a row's first vector (k < 4) and up to
  // 3 after its last (k >= 4), from copy 0.
  if (p.ragged) {
    for (int i = tid; i < p.rows * 8; i += kThreads) {
      const int r = i >> 3, k = i & 7;
      const int e = k < 4 ? k : head[r] + 4 * ((cols - head[r]) >> 2) + k - 4;
      if (k < 4 ? e < head[r] : e < cols) {
        p.out[static_cast<size_t>(r) * p.width + j0 + e] = tile[e + shift[r]];
      }
    }
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
// than 64 rows, offsets more than 1024 apart, or an empty row).
extern "C" int replica_launch(const float* codes, float* out, const void* prn_ptr,
                              const float* fcode_ptr, const float* phase_ptr, int prn,
                              int prn_is64, float fcode, float phase, double inv_fs,
                              const int* offsets, int rows, int width, int min_shift,
                              int code_length, int num_prns, int quantized, float scale,
                              float inv_scale, void* stream) {
  if (rows < 1 || rows > kMaxRows || width < 1 || code_length < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int off_min = offsets[0], off_max = offsets[0];
  for (int r = 1; r < rows; ++r) {
    off_min = offsets[r] < off_min ? offsets[r] : off_min;
    off_max = offsets[r] > off_max ? offsets[r] : off_max;
  }
  if (off_max - off_min > kMaxSpan) return static_cast<int>(cudaErrorInvalidValue);
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
  a.off_min = off_min;
  a.span = off_max - off_min;
  for (int r = 0; r < rows; ++r) a.offsets[r] = offsets[r];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 1 || static_cast<long long>(rows) * width < kTileElements) {
    replica_kernel_direct<<<dim3((width + 255) / 256, rows), 256, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // T: the power of 2 in [256, 1024] nearest above one SM's share of the
  // columns: one wave of CTAs up to N ~ 2^17, then two CTAs per SM; 256
  // threads per CTA up to T = 512, 512 from T = 1024, so that the tile's
  // stores come from 8 to 32 warps per SM.
  const int per_sm = (width + kWave - 1) / kWave;
  a.tile = kMinTile;
  while (a.tile < per_sm && a.tile < kMaxTile) a.tile *= 2;
  a.log2_nv = 0;
  while ((4 << a.log2_nv) < a.tile) ++a.log2_nv;
  a.stride = (a.tile + a.span + 3) / 4 * 4;
  a.copies = 1u;
  a.ragged = width & 3;
  for (int r = 0; r < rows; ++r) {
    const int head = row_head(reinterpret_cast<uintptr_t>(out), width, r);
    a.copies |= 1u << ((head + offsets[r] - off_min) & 3);
    a.ragged |= head;
  }
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(a.stride);   // <= 32 KB
  const dim3 grid((width + a.tile - 1) / a.tile);
  const int threads = a.tile <= 512 ? 256 : 512;
  const int per = (a.tile + a.span + threads - 1) / threads;   // 1..6 at 256, 2..4 at 512
#define REPLICA_CASE(T_, P_) \
  if (threads == T_ && per == P_) replica_kernel<T_, P_><<<grid, T_, smem, s>>>(a);
  REPLICA_CASE(256, 1) REPLICA_CASE(256, 2) REPLICA_CASE(256, 3)
  REPLICA_CASE(256, 4) REPLICA_CASE(256, 5) REPLICA_CASE(256, 6)
  REPLICA_CASE(512, 2) REPLICA_CASE(512, 3) REPLICA_CASE(512, 4)
#undef REPLICA_CASE
  return static_cast<int>(cudaGetLastError());
}
