// K-channel Early/Prompt/Late bank correlator for Hopper (sm_90a).
//
// Replaces: gpuacceleratedtracking_tpu/ops/pallas_epl.py::_bank_rows_kernel
// (wrapper correlate_pallas_bank_rows). Same contract: one shared f32 SoA
// block [A, N] against K channels, f32 accumulators [K, A, L]:
//
//   acc[k,a,l] = sum_n s[a,n] * conj(exp(i 2pi (f_k n + theta_k)))
//                      * code_k[floor((n + delta_l) * rho_k + phi_k) mod Lc]
//
// with delta_l = d_l - d_min >= 0 and phi_k = code_phase_k + rho_k * d_min.
//
// What bounds it on the H100: instruction throughput, not memory. At K=1024,
// N=32768 a block is ~33.5 M sample-channel products, each one sincospi,
// L chip lookups and 2*A*L multiply-adds; the signal block (256 KB) is
// shared by every channel and stays in L2, so device-memory traffic is
// ~N*A*8 bytes per block.
//
// What the design does about it: the TPU kernel's one-hot MXU row gathers,
// boundary compare-adds and halo rolls exist because TPU gathers and dynamic
// rolls are slow; here each thread looks its chip up directly in a
// shared-memory copy of the channel's code column, so any tap span needs no
// halo. The grid is (sample tile x channel); each thread strides over the
// tile's samples, keeps 2*A*L sums in registers, and the CTA reduces them
// with warp shuffles and shared memory into a per-tile partial. A second
// kernel sums the partials over tiles in a fixed order: no atomics, so the
// result is deterministic.
//
// Phases follow the JAX kernel: a per-tile nominal base computed exactly in
// float64 on the host plus an f32 residual per channel. The phase arithmetic
// uses explicitly rounded __fmul_rn/__fadd_rn so nvcc cannot contract it into
// FMAs: the kernel then rounds exactly like the plain PyTorch version
// (correlate_bank_rows_reference), and a chip boundary lands on the same
// sample in both. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int A, int L>
__global__ void __launch_bounds__(kThreads)
bank_rows_kernel(const float* __restrict__ sre,        // [A, N]
                 const float* __restrict__ sim,        // [A, N]
                 const float* __restrict__ code_tiles, // [K, Lc]
                 const float4* __restrict__ params,    // [K]: f_cyc, phi_cyc, rho, phi_code
                 const float2* __restrict__ base,      // [tiles]: carrier cyc, code chips
                 const int* __restrict__ deltas,       // [L]
                 float* __restrict__ partial,          // [K, tiles, A, L, 2]
                 int num_samples, int code_length, int tile,
                 float rho_nom, float fcar_nom_cyc) {
  extern __shared__ float code[];                      // [Lc]
  __shared__ float red[kWarps][2 * A * L];

  const int t = blockIdx.x;
  const int k = blockIdx.y;
  const int num_tiles = gridDim.x;

  const float* col = code_tiles + static_cast<size_t>(k) * code_length;
  for (int i = threadIdx.x; i < code_length; i += kThreads) code[i] = col[i];

  float dl[L];
#pragma unroll
  for (int l = 0; l < L; ++l) dl[l] = static_cast<float>(deltas[l]);

  const float4 p = params[k];
  const float2 b = base[t];
  const int n_begin = t * tile;
  const float n0 = static_cast<float>(n_begin);  // exact below 2^24
  const float lc = static_cast<float>(code_length);

  // Tile-start phases: exact nominal base + f32 residual (pallas_epl.py
  // _group_row_phasors / _row_chip_setup), code phase wrapped to [0, Lc).
  const float ph_car = __fadd_rn(__fadd_rn(p.y, b.x),
                                 __fmul_rn(__fsub_rn(p.x, fcar_nom_cyc), n0));
  float pc = __fadd_rn(__fadd_rn(p.w, b.y),
                       __fmul_rn(__fsub_rn(p.z, rho_nom), n0));
  pc = __fsub_rn(pc, __fmul_rn(lc, floorf(__fdiv_rn(pc, lc))));
  // Whole chips and fraction apart: the per-sample sum then carries only the
  // fraction, and keeps f32 resolution however large the chip index.
  const float pc_whole = floorf(pc);
  const float pc_frac = __fsub_rn(pc, pc_whole);
  const int chip0 = static_cast<int>(pc_whole);
  __syncthreads();

  float acc_re[A][L];
  float acc_im[A][L];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int l = 0; l < L; ++l) acc_re[a][l] = acc_im[a][l] = 0.0f;

  const int n_end = min(n_begin + tile, num_samples);
  for (int n = n_begin + static_cast<int>(threadIdx.x); n < n_end; n += kThreads) {
    const float j = static_cast<float>(n - n_begin);
    float cyc = __fadd_rn(__fmul_rn(j, p.x), ph_car);
    cyc = __fsub_rn(cyc, floorf(cyc));
    float sn, cs;
    sincospif(__fmul_rn(2.0f, cyc), &sn, &cs);

    float rep[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float x = __fadd_rn(__fmul_rn(__fadd_rn(j, dl[l]), p.z), pc_frac);
      int ci = static_cast<int>(floorf(x)) + chip0;
      if (ci < 0) ci += code_length;
      if (ci >= code_length) ci %= code_length;
      rep[l] = code[ci];
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float xr = sre[static_cast<size_t>(a) * num_samples + n];
      const float xi = sim[static_cast<size_t>(a) * num_samples + n];
      const float dr = xr * cs + xi * sn;
      const float di = xi * cs - xr * sn;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        acc_re[a][l] += dr * rep[l];
        acc_im[a][l] += di * rep[l];
      }
    }
  }

  // CTA reduction: warp shuffles, then the warps' sums in a fixed order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float vr = acc_re[a][l];
      float vi = acc_im[a][l];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vr += __shfl_down_sync(0xffffffffu, vr, off);
        vi += __shfl_down_sync(0xffffffffu, vi, off);
      }
      if (lane == 0) {
        red[warp][(a * L + l) * 2] = vr;
        red[warp][(a * L + l) * 2 + 1] = vi;
      }
    }
  __syncthreads();
  if (threadIdx.x < 2 * A * L) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partial[(static_cast<size_t>(k) * num_tiles + t) * (2 * A * L) + threadIdx.x] = s;
  }
}

// Sum the per-tile partials in tile order: out[k, a, l] (re and im planes).
__global__ void bank_rows_finish(const float* __restrict__ partial,
                                 float* __restrict__ out_re,
                                 float* __restrict__ out_im,
                                 int num_k, int num_tiles, int al) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_k * al) return;
  const int k = idx / al;
  const int r = idx - k * al;
  const float* p = partial + static_cast<size_t>(k) * num_tiles * al * 2 + r * 2;
  float sr = 0.0f, si = 0.0f;
  for (int t = 0; t < num_tiles; ++t) {
    sr += p[static_cast<size_t>(t) * al * 2];
    si += p[static_cast<size_t>(t) * al * 2 + 1];
  }
  out_re[idx] = sr;
  out_im[idx] = si;
}

template <int A, int L>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const float* sre,
            const float* sim, const float* code_tiles, const float* params,
            const float* base, const int* deltas, float* partial,
            int num_samples, int code_length, int tile, float rho_nom,
            float fcar_nom_cyc) {
  bank_rows_kernel<A, L><<<grid, kThreads, smem, stream>>>(
      sre, sim, code_tiles, reinterpret_cast<const float4*>(params),
      reinterpret_cast<const float2*>(base), deltas, partial, num_samples,
      code_length, tile, rho_nom, fcar_nom_cyc);
}

}  // namespace

// Launch the bank on `stream`. Returns cudaGetLastError() after both launches
// (cudaErrorInvalidValue for an antenna/tap count with no instantiation).
extern "C" int bank_rows_launch(const float* sre, const float* sim,
                                const float* code_tiles, const float* params,
                                const float* base, const int* deltas,
                                float* partial, float* out_re, float* out_im,
                                int num_ants, int num_taps, int num_samples,
                                int num_k, int code_length, int tile,
                                float rho_nom, float fcar_nom_cyc,
                                void* stream) {
  const int num_tiles = (num_samples + tile - 1) / tile;
  const dim3 grid(num_tiles, num_k);
  const size_t smem = static_cast<size_t>(code_length) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BANK_ROWS_CASE(A_, L_)                                                 \
  if (num_ants == A_ && num_taps == L_) {                                      \
    launch<A_, L_>(grid, smem, s, sre, sim, code_tiles, params, base, deltas,  \
                   partial, num_samples, code_length, tile, rho_nom,           \
                   fcar_nom_cyc);                                              \
  } else
  BANK_ROWS_CASE(1, 3) BANK_ROWS_CASE(1, 5) BANK_ROWS_CASE(1, 7)
  BANK_ROWS_CASE(2, 3) BANK_ROWS_CASE(2, 5) BANK_ROWS_CASE(2, 7)
  BANK_ROWS_CASE(3, 3) BANK_ROWS_CASE(3, 5) BANK_ROWS_CASE(3, 7)
  BANK_ROWS_CASE(4, 3) BANK_ROWS_CASE(4, 5) BANK_ROWS_CASE(4, 7)
  { return static_cast<int>(cudaErrorInvalidValue); }
#undef BANK_ROWS_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int al = num_ants * num_taps;
  const int total = num_k * al;
  bank_rows_finish<<<(total + 255) / 256, 256, 0, s>>>(partial, out_re, out_im,
                                                       num_k, num_tiles, al);
  return static_cast<int>(cudaGetLastError());
}
