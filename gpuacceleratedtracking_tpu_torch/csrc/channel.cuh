// Shared pieces of the per-channel correlator kernels (taps.cu, fused.cu).
//
// Both kernels correlate ONE channel against an f32 SoA block [A, N].
//
// Launch contract: one device op per call. The kernel takes the registry
// signature's raw inputs (`Args`): each channel parameter comes by value (a
// Python scalar) or by pointer (a one-element device tensor), the PRN as an
// int or a pointer to an int32/int64 element, the tap offsets by value. Every
// CTA derives the channel's rates and phases itself, with the roundings of
// ops/epl_kernels.py::_channel_params (`derive`), and the fused kernel reads
// the PRN's column from the [Lc, P] code table with the PRN's stride. No
// host-to-device copy, no host read, no memset per call.
//
// Work split (the wrapper's `work_split`): 256 threads take one 1024-sample
// phase tile, four consecutive samples each, and issue all of their loads
// (one 16-byte load per row where N % 4 == 0 and the planes are 16-byte
// aligned, four scalar loads otherwise) before any arithmetic: one memory
// round trip per CTA. CTAs form thread block clusters: a channel of up to
// 16 tiles is one cluster (N <= 16384), larger ones take clusters of 8; at
// N = 2^18 the grid holds 256 CTAs, two per SM of the H100. Threads past the
// last tile add zeros.
//
// Phases per tile (the plain versions in ops/channel_kernels.py compute the
// same values with the same roundings), with n0 = t * 1024 and the products
// rho * n0, f_cyc * n0 exact in double:
//
//   ph_car = phi_cyc + f32(frac(f_cyc * n0))
//   carrier cycles at tile sample j: j * f_cyc + ph_car, wrapped to [0, 1)
//   code phase phi_code + rho * n0 = chip0 + frac        (tile_code)
//   chip of tap l at tile sample j: (floor((j + delta_l) * rho + frac) + chip0) mod Lc
//
// Each product and sum is rounded on its own (__fmul_rn/__fadd_rn): no
// contraction into FMAs. Build without --use_fast_math.
//
// Reduction (`finish`), deterministic and without float atomics: a warp's
// 2AL sums by a transpose (reduce-scatter) pattern, about 2AL shuffles in
// place of 5 * 2AL; the warps' in warp order; each CTA's sums pushed into
// the cluster leader's shared memory (distributed shared memory, one cluster
// barrier, whose first half each CTA passes at its start) and added there in
// rank order. A one-cluster grid writes the result there and touches no
// scratch. Else each cluster writes one partial, and the last cluster to
// finish (threadfence + counter) sums them with all its threads in a fixed
// order and sets the counter back to zero for the next launch.

#pragma once

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bank.cuh"

namespace channel {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;               // threads per CTA, one tile
constexpr int kTile = 1024;                 // samples per tile, the phase tile
constexpr int kPer = kTile / kThreads;      // consecutive samples per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 7;
constexpr int kMaxRow = 8192;               // fused: replica rows up to this many chips
constexpr int kMaxCluster = 16;             // CTAs per cluster at most
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)

// One call's inputs as the registry signature gives them.
struct Args {
  const float* sre;          // [A, N]
  const float* sim;          // [A, N]
  const float* table;        // fused: code table [Lc, P]; taps: tap matrix [L, N]
  float* out;                // [2, A, L]: real plane, then imaginary plane
  float* partial;            // [clusters, 2AL]
  unsigned int* counter;     // zero at launch, zero again when the kernel ends
  const void* prn_ptr;       // int32 or int64 element (prn_is64), or null: `prn`
  const float* fcar_ptr;     // each: a device element, or null for the value below
  const float* phicar_ptr;
  const float* fcode_ptr;
  const float* phicode_ptr;
  double fs;
  float fcar, phicar, fcode, phicode;
  int prn, prn_is64;
  int num_samples, code_length, num_prns, d_min, span;
  int vec;                   // 16-byte loads
  int row;                   // fused: the replica row in shared memory
  int deltas[kMaxTaps];      // delta_l = d_l - d_min
};

// The channel's f32 parameters (f_cyc, phi_cyc, rho, phi_code).
struct Params {
  float f_cyc, phi_cyc, rho, phi_code;
};

// 16, 4 and 8 bytes of read-only global memory. Volatile, so that the
// compiler keeps each load where it is written: ahead of the barriers and
// the arithmetic that follow it.
__device__ __forceinline__ float4 load_v4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

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

// The call's channel parameters as given: read first, so that the device
// elements are not queued behind the signal loads.
struct Raw {
  float fcar, phicar, fcode, phicode;
  long long prn;
};

__device__ __forceinline__ Raw read_raw(const Args& p) {
  Raw r;
  r.fcar = p.fcar_ptr ? load_f(p.fcar_ptr) : p.fcar;
  r.phicar = p.phicar_ptr ? load_f(p.phicar_ptr) : p.phicar;
  r.fcode = p.fcode_ptr ? load_f(p.fcode_ptr) : p.fcode;
  r.phicode = p.phicode_ptr ? load_f(p.phicode_ptr) : p.phicode;
  r.prn = p.prn_ptr ? load_prn(p.prn_ptr, p.prn_is64) : p.prn;
  return r;
}

// f32(f64(x) / fs), ops/replica.py::rate.
__device__ __forceinline__ float rate(float x, double fs) {
  return __double2float_rn(__ddiv_rn(static_cast<double>(x), fs));
}

// _channel_params: f_cyc and rho by `rate`, phi_cyc = phase / f32(2 pi) (an
// IEEE f32 divide), phi_code = code_phase + rho * d_min (product, then sum).
__device__ __forceinline__ Params derive(const Args& p, const Raw& r) {
  Params q;
  q.f_cyc = rate(r.fcar, p.fs);
  q.phi_cyc = __fdiv_rn(r.phicar, kTwoPi);
  q.rho = rate(r.fcode, p.fs);
  q.phi_code = __fadd_rn(r.phicode, __fmul_rn(q.rho, static_cast<float>(p.d_min)));
  return q;
}

// The 0-based PRN; one outside [0, P) traps, as index_select's assert would.
__device__ __forceinline__ int channel_prn(const Args& p, const Raw& r) {
  if (r.prn < 0 || r.prn >= p.num_prns) __trap();
  return static_cast<int>(r.prn);
}

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
// phi_code's own fraction. The whole chips wrap once, at the end (the plain
// version wraps the base's first: the same integer mod Lc); in 32 bits
// where the sum fits.
__device__ __forceinline__ void tile_code(float rho, float phi_code, int n_begin,
                                          int code_length, int* chip0, float* frac) {
  const double code = static_cast<double>(rho) * static_cast<double>(n_begin);
  const double base_whole = floor(code);
  const float base_frac = static_cast<float>(code - base_whole);
  const float phi_whole = floorf(phi_code);
  float f = __fadd_rn(__fsub_rn(phi_code, phi_whole), base_frac);
  const float f_whole = floorf(f);
  *frac = __fsub_rn(f, f_whole);
  if (fabs(base_whole) < 0x1p29 && fabsf(phi_whole) < 0x1p29f) {
    int c = static_cast<int>(base_whole) + static_cast<int>(phi_whole) +
            static_cast<int>(f_whole);
    c %= code_length;
    *chip0 = c < 0 ? c + code_length : c;
  } else {
    long long c = static_cast<long long>(base_whole) + static_cast<long long>(phi_whole) +
                  static_cast<long long>(f_whole);
    c %= code_length;
    *chip0 = static_cast<int>(c < 0 ? c + code_length : c);
  }
}

// The tile's phases in bank.cuh's form, for its chip-index helpers.
__device__ __forceinline__ bank::Phases tile_phases(const Params& q, int n_begin,
                                                    int code_length) {
  bank::Phases ph;
  ph.f = q.f_cyc;
  ph.rho = q.rho;
  ph.ph_car = tile_carrier(q.f_cyc, q.phi_cyc, n_begin);
  tile_code(q.rho, q.phi_code, n_begin, code_length, &ph.chip0, &ph.frac);
  return ph;
}

// (sin, cos) of the carrier at tile sample j.
__device__ __forceinline__ void carrier(float j, float f_cyc, float ph_car, float* sn,
                                        float* cs) {
  float cyc = __fadd_rn(__fmul_rn(j, f_cyc), ph_car);
  cyc = __fsub_rn(cyc, floorf(cyc));
  sincospif(__fmul_rn(2.0f, cyc), sn, cs);
}

// Element s (a constant after unrolling) of a float4.
__device__ __forceinline__ float lane_of(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// Samples n .. n + 3 of rows 0 .. R-1 of `base` (row stride N), zero past N:
// one 16-byte load per row when `vec` (N % 4 == 0, so the four samples are
// all in or all out), else four scalar loads. Issued together, before any
// use.
template <int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ base, int num_samples,
                                          int n, bool vec, float4 (&x)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) {
    if (n < num_samples) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = load_v4(base + static_cast<size_t>(r) * num_samples + n);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* row = base + static_cast<size_t>(r) * num_samples;
      if (n < num_samples) x[r].x = load_f(row + n);
      if (n + 1 < num_samples) x[r].y = load_f(row + n + 1);
      if (n + 2 < num_samples) x[r].z = load_f(row + n + 2);
      if (n + 3 < num_samples) x[r].w = load_f(row + n + 3);
    }
  }
}

// Arrive early on the cluster barrier whose wait, in `finish`, precedes the
// first access to another CTA's shared memory: by then every CTA of the
// cluster has started, and the wait costs nothing.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }
__host__ __device__ constexpr int pow2ceil(int x) { return x <= 1 ? 1 : 2 * pow2ceil((x + 1) / 2); }

// Warp transpose sum of C live values per lane: at each lane bit, from 16
// down, a lane keeps the half of its values that its bit selects and sends
// the other half to its partner (C / 2 shuffles), until one value is left;
// the remaining bits add it by butterfly. Afterwards, for P values per lane
// at the start, lane l holds the warp sums of values (P / 32) l + i,
// i < P / 32, where P >= 32, else of value l >> (5 - log2 P).
template <int C, int Off, int P>
__device__ __forceinline__ void transpose_sum(float (&v)[P], int lane) {
  if constexpr (Off > 0) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool upper = (lane & Off) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, Off);
      }
      transpose_sum<H, Off / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], Off);
      transpose_sum<1, Off / 2>(v, lane);
    }
  }
}

// Sum each thread's NV values over the grid into out (value 2i is the real
// part of output i, 2i + 1 its imaginary part). Every CTA of the grid calls
// it; see the header for the order of the sums.
template <int NV>
__device__ __forceinline__ void finish(const float (&acc)[NV], const Args& p) {
  constexpr int P = pow2ceil(NV);
  constexpr int kHeld = P >= 32 ? P / 32 : 1;          // values a lane holds after the transpose
  constexpr int kShift = P >= 32 ? 0 : 5 - ilog2(P);   // lanes 2^kShift apart hold the same one
  constexpr int kGroups = kThreads / NV;               // the last CTA's finish groups
  __shared__ float red[kWarps][P];
  __shared__ float slots[kMaxCluster][NV];             // the leader's: one row per CTA
  __shared__ float grp[kGroups][NV];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = i < NV ? acc[i] : 0.0f;
  transpose_sum<P, 16>(v, lane);
  if ((lane & ((1 << kShift) - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) red[warp][(lane >> kShift) * kHeld + i] = v[i];
  }
  __syncthreads();

  // The CTA's sums, in warp order, into row `rank` of the leader's slots;
  // then the leader adds the rows in rank order.
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int size = cluster.num_blocks();
  const unsigned int rank = cluster.block_rank();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");   // pairs with cluster_arrive
  if (tid < NV) {
    float s = red[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][tid];
    cluster.map_shared_rank(&slots[0][0], 0)[rank * NV + tid] = s;
  }
  cluster.sync();                       // the rows are in place; the others may exit
  if (rank != 0) return;
  float total = 0.0f;
  if (tid < NV) {
    for (unsigned int r = 0; r < size; ++r) total += slots[r][tid];
  }

  float* out_re = p.out;
  float* out_im = p.out + NV / 2;
  const int num_clusters = gridDim.x / size;
  if (num_clusters == 1) {
    if (tid < NV) ((tid & 1) ? out_im : out_re)[tid >> 1] = total;
    return;
  }
  // Partials per cluster; the last cluster to finish sums them: group g of
  // its threads takes clusters g, g + kGroups, ..., then the groups in order.
  if (tid < NV) {
    p.partial[static_cast<size_t>(blockIdx.x / size) * NV + tid] = total;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(p.counter, 1u) == static_cast<unsigned int>(num_clusters - 1);
  }
  __syncthreads();
  if (!is_last) return;
  const int g = tid / NV;
  const int i = tid - g * NV;
  if (g < kGroups) {
    float s = 0.0f;
#pragma unroll 8
    for (int u = g; u < num_clusters; u += kGroups) {
      s += __ldcg(&p.partial[static_cast<size_t>(u) * NV + i]);
    }
    grp[g][i] = s;
  }
  __syncthreads();
  if (tid < NV) {
    float s = grp[0][tid];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) s += grp[q][tid];
    ((tid & 1) ? out_im : out_re)[tid >> 1] = s;
  }
  if (tid == 0) *p.counter = 0u;        // all clusters have counted: ready for the next launch
}

// `err`, with the thread's last CUDA error reset: a refused call leaves its
// error there too, where the next launch's check would find it.
inline cudaError_t cleared(cudaError_t err) {
  (void)cudaGetLastError();
  return err;
}

// Launch `Kernel` over `grid` CTAs, one tile each, in clusters of `cluster`
// (which divides the grid) on `stream`, with `smem` bytes of dynamic shared
// memory per CTA; returns the first CUDA error.
template <void (*Kernel)(Args)>
cudaError_t launch(const Args& args, int grid, int cluster, size_t smem, cudaStream_t stream) {
  if (grid <= 0 || cluster <= 0 || cluster > kMaxCluster || grid % cluster != 0) {
    return cudaErrorInvalidValue;
  }
  // Clusters of 16, the H100's non-portable size, need the kernel's opt-in.
  // A function attribute holds on the device current when it is set, so it
  // is set once per kernel and device (bit d of `allowed`; past 64 devices,
  // at every launch).
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> allowed{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return cleared(err);
    allowed.fetch_or(bit, std::memory_order_release);
  }
  if (smem > 48 * 1024) {  // above 48 KB only with the kernel's opt-in
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return cleared(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args);
  if (err != cudaSuccess) return cleared(err);
  return cudaGetLastError();
}

// The C entry points' common arguments, gathered into `Args`.
inline Args make_args(const float* sre, const float* sim, const float* table, float* out,
                      float* scratch, const void* prn_ptr, const float* fcar_ptr,
                      const float* phicar_ptr, const float* fcode_ptr,
                      const float* phicode_ptr, int prn, int prn_is64, float fcar,
                      float phicar, float fcode, float phicode, double fs, const int* deltas,
                      int num_taps, int d_min, int num_samples, int code_length, int num_prns,
                      int vec) {
  Args a = {};
  a.sre = sre;
  a.sim = sim;
  a.table = table;
  a.out = out;
  a.counter = reinterpret_cast<unsigned int*>(scratch);   // word 0 (null: one cluster)
  a.partial = scratch ? scratch + 4 : nullptr;             // 16 bytes on
  a.prn_ptr = prn_ptr;
  a.fcar_ptr = fcar_ptr;
  a.phicar_ptr = phicar_ptr;
  a.fcode_ptr = fcode_ptr;
  a.phicode_ptr = phicode_ptr;
  a.fs = fs;
  a.fcar = fcar;
  a.phicar = phicar;
  a.fcode = fcode;
  a.phicode = phicode;
  a.prn = prn;
  a.prn_is64 = prn_is64;
  a.num_samples = num_samples;
  a.code_length = code_length;
  a.num_prns = num_prns;
  a.d_min = d_min;
  a.vec = vec;
  int span = 0;
  for (int l = 0; l < num_taps && l < kMaxTaps; ++l) {
    a.deltas[l] = deltas[l];
    span = deltas[l] > span ? deltas[l] : span;
  }
  a.span = span;
  a.row = kTile + span <= kMaxRow;
  return a;
}

}  // namespace channel

// The id of the CUDA graph capture under way on `stream`, or 0 when none is:
// a captured launch takes a scratch of its capture's own
// (ops/channel_kernels.py::_scratch).
extern "C" unsigned long long channel_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive) {
    return 0;
  }
  return id;
}
