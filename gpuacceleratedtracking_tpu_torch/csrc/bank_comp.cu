// Composite-plane K-channel Early/Prompt/Late bank correlator for Hopper (sm_90a).
//
// Replaces: gpuacceleratedtracking_tpu/ops/pallas_epl.py::_bank_comp_kernel
// (wrapper correlate_pallas_bank_comp). Same contract: one shared f32 SoA
// block [A, N] against K channels, f32 accumulators [K, A, L], by the tone
// identity carrier[u - d] = carrier[u] e^{-2 pi i f d}:
//
//   Z_k[u]     = conj(carrier_k[u]) * code_k[floor(u * rho_k + phi_k) mod Lc]
//   S_{a,l}[u] = s[a, u - delta_l]                      (0 outside [0, N))
//   acc[k,a,l] = e^{+2 pi i f_k delta_l} * sum_{u < N + span} S_{a,l}[u] Z_k[u]
//
// What bounds it on the H100: instruction issue and shared-memory bandwidth.
// Per (channel, antenna) the MAC over a sample is 2 + 2L shared-memory loads
// and 4L FMAs (L taps, four real products of [zc, zs] x [S_re, S_im]); at
// K=1024, A=4, L=7, N=32768 that is ~3.8 G FMAs per block. Device memory
// carries only the signal block (read once per CTA from L2), the code
// columns and the per-tile partials.
//
// What the design does about it: the TPU kernel's XLA prologue built 2AL
// shifted signal planes in HBM (56 planes, 7.3 MB per block at A=4, L=7)
// plus a last-tile halo input; here each CTA copies its signal tile with a
// halo of `span` samples into shared memory once, and reads S_{a,l}[u] as
// s[a][u - delta_l] from it, zero outside [0, N), so every u with
// 0 <= u - delta_l < N is summed and no halo correction is needed. The grid
// is (composite tile of kTile samples x group of kGroup channels). Phase 1
// builds the group's Z planes in shared memory with the phase arithmetic of
// bank_rows.cu (f64-exact tile base on the host, f32 residual rounded with
// __fmul_rn/__fadd_rn, whole chips and fraction apart), so Z's chip
// boundaries land on the plain version's samples. Phase 2 gives each warp one
// (channel, antenna) unit at a time: its lanes stride over the tile's samples
// (neighbouring lanes on neighbouring shared-memory words), keep the 4L sums
// in registers, and reduce them with warp shuffles into the unit's per-tile
// partial. A second kernel sums the partials in tile order, recombines them
// and applies the rotation: no atomics, deterministic. bf16 mode rounds Z and
// S to bf16 as they are stored; the products are exact in f32 and sum in
// f32. No tensor cores yet, and no TF32 anywhere. Build without
// --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;        // channels per CTA
constexpr int kTile = 1024;      // composite samples per CTA (COMP_TILE); divides the phase tile
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int A, int L, bool BF16>
__global__ void __launch_bounds__(kThreads)
bank_comp_kernel(const float* __restrict__ sre,        // [A, N]
                 const float* __restrict__ sim,        // [A, N]
                 const float* __restrict__ code_tiles, // [K, Lc]
                 const float4* __restrict__ params,    // [K]: f_cyc, phi_cyc, rho, phi_code
                 const float2* __restrict__ base,      // [phase tiles]: carrier cyc, code chips
                 const int* __restrict__ deltas,       // [L]
                 float* __restrict__ partial,          // [K, tiles, A, L, 4]
                 int num_samples, int num_k, int code_length, int phase_tile,
                 int span, float rho_nom, float fcar_nom_cyc) {
  extern __shared__ float smem[];
  float* zc = smem;                          // [kGroup][kTile]  cos * code
  float* zs = zc + kGroup * kTile;           // [kGroup][kTile]  sin * code
  const int width = kTile + span;
  float* s_re = zs + kGroup * kTile;         // [A][width]: s[a][u0 - span + i]
  float* s_im = s_re + A * width;

  const int t = blockIdx.x;
  const int num_tiles = gridDim.x;
  const int k0 = blockIdx.y * kGroup;
  const int u0 = t * kTile;

  // The signal tile and its halo, zero outside [0, N).
  for (int i = threadIdx.x; i < A * width; i += kThreads) {
    const int a = i / width;
    const int n = u0 - span + (i - a * width);
    float xr = 0.0f, xi = 0.0f;
    if (n >= 0 && n < num_samples) {
      xr = sre[static_cast<size_t>(a) * num_samples + n];
      xi = sim[static_cast<size_t>(a) * num_samples + n];
    }
    if (BF16) {
      xr = round_bf16(xr);
      xi = round_bf16(xi);
    }
    s_re[i] = xr;
    s_im[i] = xi;
  }

  // Phase 1: Z planes. The tile lies inside one phase tile of the host's base.
  const int pt = u0 / phase_tile;
  const int j0 = u0 - pt * phase_tile;
  const float2 b = base[pt];
  const float n0 = static_cast<float>(pt * phase_tile);  // exact below 2^24
  const float lc = static_cast<float>(code_length);
  for (int g = 0; g < kGroup; ++g) {
    // A padded group repeats the last channel; its units are skipped below.
    const int k = min(k0 + g, num_k - 1);
    const float4 p = params[k];
    const float ph_car = __fadd_rn(__fadd_rn(p.y, b.x),
                                   __fmul_rn(__fsub_rn(p.x, fcar_nom_cyc), n0));
    float pc = __fadd_rn(__fadd_rn(p.w, b.y),
                         __fmul_rn(__fsub_rn(p.z, rho_nom), n0));
    pc = __fsub_rn(pc, __fmul_rn(lc, floorf(__fdiv_rn(pc, lc))));
    const float pc_whole = floorf(pc);
    const float pc_frac = __fsub_rn(pc, pc_whole);
    const int chip0 = static_cast<int>(pc_whole);
    const float* col = code_tiles + static_cast<size_t>(k) * code_length;
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const float j = static_cast<float>(j0 + i);
      float cyc = __fadd_rn(__fmul_rn(j, p.x), ph_car);
      cyc = __fsub_rn(cyc, floorf(cyc));
      float sn, cs;
      sincospif(__fmul_rn(2.0f, cyc), &sn, &cs);
      const float x = __fadd_rn(__fmul_rn(j, p.z), pc_frac);
      int ci = static_cast<int>(floorf(x)) + chip0;
      if (ci < 0) ci += code_length;
      if (ci >= code_length) ci %= code_length;
      const float c = __ldg(col + ci);
      float zr = cs * c;   // exact: c is +/-1
      float zi = sn * c;
      if (BF16) {
        zr = round_bf16(zr);
        zi = round_bf16(zi);
      }
      zc[g * kTile + i] = zr;
      zs[g * kTile + i] = zi;
    }
  }
  __syncthreads();

  // Phase 2: one (channel, antenna) unit per warp at a time.
  int dl[L];
#pragma unroll
  for (int l = 0; l < L; ++l) dl[l] = deltas[l];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int unit = warp; unit < kGroup * A; unit += kWarps) {
    const int g = unit / A;
    const int a = unit - g * A;
    const int k = k0 + g;
    if (k >= num_k) continue;                         // warp-uniform
    const float* zcg = zc + g * kTile;
    const float* zsg = zs + g * kTile;
    const float* sr = s_re + a * width + span;        // sr[i] = s[a][u0 + i]
    const float* si = s_im + a * width + span;
    float acc[L][4];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[l][q] = 0.0f;
    for (int i = lane; i < kTile; i += 32) {
      const float c = zcg[i];
      const float s = zsg[i];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float xr = sr[i - dl[l]];
        const float xi = si[i - dl[l]];
        acc[l][0] += c * xr;   // zc . S_re
        acc[l][1] += s * xi;   // zs . S_im
        acc[l][2] += c * xi;   // zc . S_im
        acc[l][3] += s * xr;   // zs . S_re
      }
    }
    float* out = partial + ((static_cast<size_t>(k) * num_tiles + t) * A + a) * L * 4;
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = acc[l][q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) out[l * 4 + q] = v;
      }
  }
}

// Sum the per-tile partials in tile order, recombine
// m = (zc.S_re + zs.S_im) + i (zc.S_im - zs.S_re), and rotate by
// e^{+2 pi i f_k delta_l}: out[k, a, l] (re and im planes).
__global__ void bank_comp_finish(const float* __restrict__ partial,
                                 const float4* __restrict__ params,
                                 const int* __restrict__ deltas,
                                 float* __restrict__ out_re,
                                 float* __restrict__ out_im,
                                 int num_k, int num_tiles, int num_ants, int num_taps) {
  const int al = num_ants * num_taps;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_k * al) return;
  const int k = idx / al;
  const int r = idx - k * al;
  const int l = r % num_taps;
  const float* p = partial + static_cast<size_t>(k) * num_tiles * al * 4 + r * 4;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int t = 0; t < num_tiles; ++t) {
    const float* q = p + static_cast<size_t>(t) * al * 4;
    s0 += q[0];
    s1 += q[1];
    s2 += q[2];
    s3 += q[3];
  }
  const float m_re = __fadd_rn(s0, s1);
  const float m_im = __fsub_rn(s2, s3);
  const float omega = __fmul_rn(__fmul_rn(kTwoPi, params[k].x),
                                static_cast<float>(deltas[l]));
  float sw, cw;
  sincosf(omega, &sw, &cw);
  out_re[idx] = __fsub_rn(__fmul_rn(cw, m_re), __fmul_rn(sw, m_im));
  out_im[idx] = __fadd_rn(__fmul_rn(cw, m_im), __fmul_rn(sw, m_re));
}

template <int A, int L, bool BF16>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const float* sre,
                   const float* sim, const float* code_tiles, const float* params,
                   const float* base, const int* deltas, float* partial,
                   int num_samples, int num_k, int code_length, int phase_tile,
                   int span, float rho_nom, float fcar_nom_cyc) {
  // Above 48 KB, dynamic shared memory needs the kernel's opt-in.
  cudaError_t err = cudaFuncSetAttribute(bank_comp_kernel<A, L, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bank_comp_kernel<A, L, BF16><<<grid, kThreads, smem, stream>>>(
      sre, sim, code_tiles, reinterpret_cast<const float4*>(params),
      reinterpret_cast<const float2*>(base), deltas, partial, num_samples,
      num_k, code_length, phase_tile, span, rho_nom, fcar_nom_cyc);
  return cudaGetLastError();
}

}  // namespace

// Launch the bank on `stream`. Returns the first CUDA error of the two launches
// (cudaErrorInvalidValue for an antenna/tap count with no instantiation, or a
// phase tile that kTile does not divide).
extern "C" int bank_comp_launch(const float* sre, const float* sim,
                                const float* code_tiles, const float* params,
                                const float* base, const int* deltas,
                                float* partial, float* out_re, float* out_im,
                                int num_ants, int num_taps, int num_samples,
                                int num_k, int code_length, int phase_tile,
                                int span, int bf16, float rho_nom,
                                float fcar_nom_cyc, void* stream) {
  if (phase_tile % kTile != 0 || span < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int num_tiles = (num_samples + span + kTile - 1) / kTile;
  const dim3 grid(num_tiles, (num_k + kGroup - 1) / kGroup);
  const size_t smem = (2 * static_cast<size_t>(kGroup) * kTile +
                       2 * static_cast<size_t>(num_ants) * (kTile + span)) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define BANK_COMP_CASE(A_, L_)                                                      \
  if (num_ants == A_ && num_taps == L_) {                                           \
    err = bf16 ? launch<A_, L_, true>(grid, smem, s, sre, sim, code_tiles, params,  \
                                      base, deltas, partial, num_samples, num_k,    \
                                      code_length, phase_tile, span, rho_nom,       \
                                      fcar_nom_cyc)                                 \
               : launch<A_, L_, false>(grid, smem, s, sre, sim, code_tiles, params, \
                                       base, deltas, partial, num_samples, num_k,   \
                                       code_length, phase_tile, span, rho_nom,      \
                                       fcar_nom_cyc);                               \
  }
  BANK_COMP_CASE(1, 3) BANK_COMP_CASE(1, 5) BANK_COMP_CASE(1, 7)
  BANK_COMP_CASE(2, 3) BANK_COMP_CASE(2, 5) BANK_COMP_CASE(2, 7)
  BANK_COMP_CASE(3, 3) BANK_COMP_CASE(3, 5) BANK_COMP_CASE(3, 7)
  BANK_COMP_CASE(4, 3) BANK_COMP_CASE(4, 5) BANK_COMP_CASE(4, 7)
#undef BANK_COMP_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = num_k * num_ants * num_taps;
  bank_comp_finish<<<(total + 255) / 256, 256, 0, s>>>(
      partial, reinterpret_cast<const float4*>(params), deltas, out_re, out_im,
      num_k, num_tiles, num_ants, num_taps);
  return static_cast<int>(cudaGetLastError());
}
