// K-channel Early/Prompt/Late bank correlator for Hopper (sm_90a).
//
// Replaces: gpuacceleratedtracking_tpu/ops/pallas_epl.py::_bank_rows_kernel
// (wrapper correlate_pallas_bank_rows); it also serves the routes of
// _bank_transition_kernel (pallas_bank) and _bank_kernel (pallas_bank_onehot),
// which compute the same contract: one shared f32 SoA block [A, N] against K
// channels, f32 accumulators [K, A, L]:
//
//   acc[k,a,l] = sum_n s[a,n] * conj(carrier_k[n])
//                      * code_k[floor((n + delta_l) * rho_k + phi_k) mod Lc]
//
// with delta_l = d_l - d_min >= 0 and phi_k = code_phase_k + rho_k * d_min.
//
// What bounds it on the H100: instruction issue. Per sample and channel the
// work is (6 + 4L) A flops of derotation and tap MACs (0.6 GFLOP at K=1024,
// A=1, L=3, N=32768: 9 us at the f32 peak); device memory carries only the
// 0.26 MB signal block, the packed code columns and the per-chunk partials.
// With the rows built from the chip boundaries, the MAC with its carrier
// and the staging is most of what a tile issues (~25 warp-instructions per
// 32 sample-channels at A=1 L=3: the carrier's 6, 5 shared loads, 4 of
// derotation, 6 tap FMAs and the loop), at about half the issue rate: the
// kernel with no row at all takes ~48 of the ~62 us at K=1024 N=32768.
//
// What the design does about it (bank.cuh holds the shared arithmetic):
// - A CTA takes 8 channels, one per warp (2AL sums in each lane's
//   registers), and a chunk of up to 4 consecutive 1024-sample tiles of one
//   phase tile (fewer where the grid would hold under ~1024 CTAs, as for 128
//   GPS L5 channels). Per tile the signal is staged in shared memory once
//   and read by all 8 channels; a channel's phases, lane phasors and sums
//   carry over the chunk's tiles. Lanes run over samples.
// - Each sample's chip is computed once, into the warp's replica row
//   rep[m] = +/-1 for m in [0, 1024 + span) of the tile: tap l reads
//   rep[i + delta_l]. (j + delta_l) is an exact small integer, so this
//   rounds bit for bit like the per-tap formula. The CTA's packed code
//   columns sit in shared memory. Where a channel's chips over the tile stay
//   in [0, 2 Lc) (always inside the routes' chip-rate envelopes, checked per
//   channel and tile), the row is built one of two ways, bit for bit alike:
//   * from the chip boundaries (replica_row_runs), where the launch's
//     min_run asks for it (ops/epl_kernels.rows_min_run: a chip lasts
//     MIN_CHIP_RUN = 16 samples or more at the nominal rate) and the
//     channel's own chips last that long (its rho). A lane
//     per group of 32 positions evaluates the chip formula at the group's
//     two ends, finds where each chip starting inside it starts (an
//     estimate from 1 / rho, corrected by the formula itself, which never
//     decreases with the position), and keeps the group's sign mask in the
//     warp's table, carried to the next tile of the chunk; then each lane
//     writes four positions from one mask with a 16-byte store. At 32
//     samples a chip that is ~7.5 warp-instructions per 32 positions, half
//     masks and half fill, against the formula's ~15. The crossover, on the
//     H100 at K=1024 A=1 L=3 (bank_kernel_ab.py's rows_builds against the
//     per-position kernel): even at 12 samples a chip, 2.8 % faster at 16,
//     8.6 % at 32, 13 % at 256. The build has a kernel of its own whose
//     launch bounds keep each instantiation's CTAs an SM (min_ctas): with
//     its temporaries at 80 registers, 3 CTAs an SM, it was slower than the
//     per-position kernel;
//   * else by that formula at every position (replica_row: one unsigned min
//     for the wrap, one rotate and one logic op for the +/-1; the general
//     wrap outside chips_near, bank.cuh), in a kernel compiled as it was
//     before the boundary build (PositionRows).
// - The carrier is the row x lane phasor product: a lane's samples
//   i = 32 q + lane sit at four fixed in-row positions, so its four lane
//   phasors are computed once per channel and the row phasor (8 per tile)
//   arrives by shuffle. No sincos per sample.
// - The block and the channels come as a bank::Source: in the captured
//   block loop the block is read at the loop's device-side index and each
//   warp derives its channel's parameters from the tracking state (one
//   float4's worth of loads per warp and CTA, as the table's read was), so
//   no torch op runs between the carry and the launch.
// - A time shard of a mesh reads its piece of the block in place
//   (bank::Source's sample offset and antenna-row stride) and nothing
//   outside it: the tap lookahead past the piece's end comes from the
//   replica row, as in the JAX shard, never from the neighbour's samples.
//   The row stride reaches the kernel as an int argument of its own: read
//   from the Source struct in the staging loop it made the K=1024 A=1 launch
//   5 % slower (bank_kernel_ab.py against that variant, on the H100).
// The CTA's sums go to per-chunk partials, which a second kernel sums over
// chunks in a fixed order: no atomics, deterministic. With a mesh's time
// shards, the shards' launches only write partials, and one finish per
// channel shard sums each shard's chunks and then adds the shards' sums in
// shard order (ops/epl_kernels.sum_in_order's order).

#include <cuda_runtime.h>

#include "bank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;      // channels per CTA: one per warp
constexpr int kTile = 1024;                // samples per tile (ROWS_TILE); divides the phase tile
constexpr int kRows = kTile / bank::kRow;  // carrier rows per tile
constexpr int kMaxChunk = 4;               // tiles per CTA at most
constexpr int kMinCtas = 1024;             // chunks shorten until the grid holds this many CTAs

// One channel's replica row rep[m] = chip of phase-tile position j0 + m,
// m in [0, width), one lane per position. kNear: bank::chips_near holds, and
// the wrap is one unsigned min (the routes' envelopes); else the general
// wrap. The position steps exactly in f32.
template <bool kNear>
__device__ __forceinline__ void replica_row(float* rep, const unsigned* col,
                                            const bank::Phases& ch, int j0, int width,
                                            int code_length, int lane) {
  float mf = static_cast<float>(j0 + lane);
#pragma unroll 4
  for (int m = lane; m < width; m += 32, mf += 32.0f) {
    const int ci = kNear ? bank::chip_index_near(ch, mf, code_length)
                         : bank::chip_index(ch, mf, code_length);
    rep[m] = bank::chip_value(col, ci);
  }
}

// The unwrapped chip of row position m: bank::chip_unwrapped at j0 + m.
__device__ __forceinline__ int row_chip(const bank::Phases& ch, int j0, int m) {
  return bank::chip_unwrapped(ch, static_cast<float>(j0 + m));
}

// All ones where chip c (unwrapped, in [0, 2 Lc): chips_near) is -1, else 0.
__device__ __forceinline__ unsigned chip_sign(const unsigned* col, int c, int code_length) {
  const int ci = static_cast<int>(
      min(static_cast<unsigned>(c), static_cast<unsigned>(c - code_length)));
  return static_cast<unsigned>(static_cast<int>(bank::chip_rotated(col, ci)) >> 31);
}

// +1.0f, or -1.0f where bit 31 of w is set.
__device__ __forceinline__ float sign_value(unsigned w) {
  unsigned v;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(v) : "r"(w), "r"(0x80000000u), "r"(0x3f800000u));
  return __uint_as_float(v);
}

// The first row position in [lo, hi] whose chip reaches c, given that
// position lo - 1's chip is below c and position hi's is not: an estimate
// from the rate, then corrected by the formula itself, which never
// decreases with the position (rho >= 0), so the result is exact.
__device__ __forceinline__ int chip_start(const bank::Phases& ch, float inv_rho, int j0, int c,
                                          int lo, int hi) {
  const float x = __fmul_rn(__fsub_rn(static_cast<float>(c - ch.chip0), ch.frac), inv_rho);
  int b = static_cast<int>(fminf(fmaxf(ceilf(x - static_cast<float>(j0)),
                                       static_cast<float>(lo)), static_cast<float>(hi)));
  // Both neighbours at once (position lo - 1's chip is below c): the
  // estimate is off by one at most but at rates far from the nominal one.
  const int below = row_chip(ch, j0, b - 1);
  const int at = row_chip(ch, j0, b);
  if (below >= c) {
    do --b; while (b > lo && row_chip(ch, j0, b - 1) >= c);
  } else if (at < c) {
    do ++b; while (row_chip(ch, j0, b) < c);
  }
  return b;
}

// The replica row from its chip boundaries, where chips_near holds. Lane j
// takes the groups of 32 positions j, j + 32, ...: from the chips at the
// group's ends and the first position of each chip that starts inside it
// (chip_start), the group's sign mask (bit i: position 32 g + i is -1),
// into the warp's table `masks`. With `carry` (the last tile of the chunk
// took this build for this channel) the last tile's whole groups from 32 on
// are this tile's first ones, the same positions of the phase tile, so that
// a tile of span <= 1024 computes 32 groups, one a lane. Each position's
// +/-1 is then one bit of its group's mask: four positions a lane and one
// 16-byte store where the row's width allows, else one. The chips are those
// of the per-position formula, bit for bit.
__device__ __forceinline__ void replica_row_runs(float* rep, unsigned* masks, const unsigned* col,
                                                 const bank::Phases& ch, float inv_rho, int j0,
                                                 int width, int code_length, int lane,
                                                 bool carry) {
  int g_first = 0;
  if (carry && width >= 32 * 33) {
    g_first = width / 32 - 32;
    for (int g = lane; g < g_first; g += 32) masks[g] = masks[g + 32];
    __syncwarp();
  }
  for (int p0 = 32 * (g_first + lane); p0 < width; p0 += 32 * 32) {
    const int last = min(p0 + 31, width - 1);
    const int c_lo = row_chip(ch, j0, p0);
    const int c_hi = row_chip(ch, j0, last);
    unsigned mask = chip_sign(col, c_lo, code_length);
    for (int c = c_lo + 1; c <= c_hi; ++c) {
      const unsigned above = ~0u << (chip_start(ch, inv_rho, j0, c, p0 + 1, last) - p0);
      mask = (mask & ~above) | (chip_sign(col, c, code_length) & above);
    }
    masks[p0 >> 5] = mask;
  }
  __syncwarp();
  if ((width & 3) == 0) {
    const int sh = 28 - 4 * (lane & 7);     // moves bit 4 (lane & 7) + i to bit 28 + i
#pragma unroll 2
    for (int m = 4 * lane; m < width; m += 128) {
      const unsigned w = masks[m >> 5] << sh;
      *reinterpret_cast<float4*>(rep + m) =
          make_float4(sign_value(w << 3), sign_value(w << 2), sign_value(w << 1), sign_value(w));
    }
  } else {
    const unsigned rot = ~static_cast<unsigned>(lane);  // moves bit `lane` to bit 31
#pragma unroll 4
    for (int m = lane; m < width; m += 32) {
      const unsigned w = masks[m >> 5];
      rep[m] = sign_value(__funnelshift_l(w, w, rot));
    }
  }
}

// A CTA takes a chunk of `chunk` consecutive tiles, all in one phase tile,
// and kWarps channels, one per warp. A channel's phases, lane phasors and
// sums carry across the chunk's tiles; the signal tile is restaged per tile.
// kRuns: the launch asks for the boundary build (min_run > 0); without it
// the kernel is the per-position build alone.
template <int A, int L, bool kRuns>
__device__ __forceinline__ void bank_rows_body(
    const float* __restrict__ sre,          // [A, N], or the chunk (src)
    const float* __restrict__ sim,          // [A, N], or the chunk (src)
    const unsigned* __restrict__ code,      // [K, words] packed columns
    const bank::Source src,                 // the block's row, the channels
    const float2* __restrict__ base,        // [phase tiles]: carrier cyc, code chips
    const int* __restrict__ deltas,         // [L]
    float* __restrict__ partial,            // [K, chunks, A, L, 2]
    int num_samples, int plane, int num_k, int code_length, int words, int phase_tile,
    int span, int chunk, float rho_nom, float fcar_nom_cyc, int min_run) {
  extern __shared__ __align__(16) float smem[];
  const int width = kTile + span;            // replica row: positions [0, kTile + span)
  const int groups = (width + 31) / 32;      // its groups of 32 positions
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* s_re = smem;                        // [A][kTile]
  float* s_im = s_re + A * kTile;            // [A][kTile]
  float* rep = s_im + A * kTile + warp * width;
  unsigned* code_s =                         // [kWarps][words]
      reinterpret_cast<unsigned*>(s_im + A * kTile + kWarps * width);
  unsigned* masks = code_s + kWarps * words + warp * groups;  // [kWarps][groups], min_run > 0
  const size_t block = bank::block_offset(src);
  sre += block;
  sim += block;

  const int num_tiles = (num_samples + kTile - 1) / kTile;
  const int t0 = blockIdx.x * chunk;
  const int t_end = min(t0 + chunk, num_tiles);
  const int k0 = blockIdx.y * kWarps;
  const int group_words = min(num_k - k0, kWarps) * words;
  for (int i = threadIdx.x; i < group_words; i += kThreads) {
    code_s[i] = code[static_cast<size_t>(k0) * words + i];
  }

  int dl[L];
#pragma unroll
  for (int l = 0; l < L; ++l) dl[l] = deltas[l];
  const int pt = t0 * kTile / phase_tile;
  const float2 b = base[pt];
  const float n0 = static_cast<float>(pt * phase_tile);   // exact below 2^24
  const int k = k0 + warp;
  const bool active = k < num_k;                          // warp-uniform
  const unsigned* col = code_s + warp * words;
  const bank::Phases ch = bank::tile_phases(bank::channel_params(src, min(k, num_k - 1)), b,
                                            n0, static_cast<float>(code_length), rho_nom,
                                            fcar_nom_cyc);
  const float inv_rho = __frcp_rn(ch.rho);
  // The boundary build where this channel's chips last min_run samples.
  const bool runs = kRuns && ch.rho * static_cast<float>(min_run) <= 1.0f;
  float2 lp[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) lp[q] = bank::lane_phasor(ch, static_cast<float>(32 * q + lane));

  bool built = false;                                     // masks hold the last tile's groups
  float acc_re[A][L];
  float acc_im[A][L];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int l = 0; l < L; ++l) acc_re[a][l] = acc_im[a][l] = 0.0f;

  for (int t = t0; t < t_end; ++t) {
    const int n_begin = t * kTile;
    const int j0 = n_begin - pt * phase_tile;             // tile start in its phase tile
    __syncthreads();                                      // the last tile's reads are done
    for (int i = threadIdx.x; i < A * kTile; i += kThreads) {
      const int a = i / kTile;
      const int n = n_begin + (i - a * kTile);
      const bool in = n < num_samples;
      s_re[i] = in ? sre[static_cast<size_t>(a) * plane + n] : 0.0f;
      s_im[i] = in ? sim[static_cast<size_t>(a) * plane + n] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    if (bank::chips_near(ch, static_cast<float>(j0 + width - 1), code_length)) {
      if (runs) {
        replica_row_runs(rep, masks, col, ch, inv_rho, j0, width, code_length, lane, built);
        built = true;
      } else {
        replica_row<true>(rep, col, ch, j0, width, code_length, lane);
        built = false;
      }
    } else {
      replica_row<false>(rep, col, ch, j0, width, code_length, lane);
      built = false;
    }
    // Lane r < kRows holds row r's phasor; the others compute a copy.
    const float2 rp = bank::row_phasor(ch, static_cast<float>(j0 + bank::kRow * (lane % kRows)));
    __syncwarp();

#pragma unroll 1
    for (int r = 0; r < kRows; ++r) {
      const float2 row = make_float2(__shfl_sync(0xffffffffu, rp.x, r),
                                     __shfl_sync(0xffffffffu, rp.y, r));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = r * bank::kRow + 32 * q + lane;
        const float2 c = bank::carrier(row, lp[q]);
        float chip[L];
#pragma unroll
        for (int l = 0; l < L; ++l) chip[l] = rep[i + dl[l]];
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float xr = s_re[a * kTile + i];
          const float xi = s_im[a * kTile + i];
          const float dr = xr * c.x + xi * c.y;
          const float di = xi * c.x - xr * c.y;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            acc_re[a][l] += dr * chip[l];
            acc_im[a][l] += di * chip[l];
          }
        }
      }
    }
  }
  if (!active) return;

  float* out = partial + (static_cast<size_t>(k) * gridDim.x + blockIdx.x) * (2 * A * L);
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
        out[(a * L + l) * 2] = vr;
        out[(a * L + l) * 2 + 1] = vi;
      }
    }
}

// The kernel's parameters (bank_rows_body's), and a last one that says its
// row build: a tag of its own for each, so that the two kernels share the
// name bank_rows_kernel<A, L> and each has its own launch bounds.
#define BANK_ROWS_PARAMS                                                                   \
  const float* __restrict__ sre, const float* __restrict__ sim,                            \
      const unsigned* __restrict__ code, const bank::Source src,                           \
      const float2* __restrict__ base, const int* __restrict__ deltas,                     \
      float* __restrict__ partial, int num_samples, int plane, int num_k, int code_length, \
      int words, int phase_tile, int span, int chunk, float rho_nom, float fcar_nom_cyc,   \
      int min_run
#define BANK_ROWS_ARGS                                                                     \
  sre, sim, code, src, base, deltas, partial, num_samples, plane, num_k, code_length,      \
      words, phase_tile, span, chunk, rho_nom, fcar_nom_cyc, min_run

struct PositionRows {};  // the per-position build alone
struct BoundaryRows {};  // the boundary build where it holds

// CTAs per SM that the boundary build's kernel keeps: the per-position
// kernel's registers (64 at A L <= 6, 80 to 12, up to 128 above), so that
// the build's temporaries take no occupancy from the MAC.
constexpr int min_ctas(int a, int l) { return a * l <= 6 ? 4 : a * l <= 12 ? 3 : 2; }

template <int A, int L>
__global__ void __launch_bounds__(kThreads) bank_rows_kernel(BANK_ROWS_PARAMS, PositionRows) {
  bank_rows_body<A, L, false>(BANK_ROWS_ARGS);
}

template <int A, int L>
__global__ void __launch_bounds__(kThreads, min_ctas(A, L))
    bank_rows_kernel(BANK_ROWS_PARAMS, BoundaryRows) {
  bank_rows_body<A, L, true>(BANK_ROWS_ARGS);
}

// Sum the per-chunk partials in chunk order: out[k, a, l] (re and im
// planes). With num_shards > 1 time shards, shard s's partials start
// s * shard_stride floats in; each shard's chunks are summed as one call's,
// then the shards' sums are added left to right, (r_0 + r_1) + r_2 ...
__global__ void bank_rows_finish(const float* __restrict__ partial,
                                 float* __restrict__ out_re,
                                 float* __restrict__ out_im,
                                 int num_k, int num_chunks, int al,
                                 long long shard_stride, int num_shards) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_k * al) return;
  const int k = idx / al;
  const int r = idx - k * al;
  float tr = 0.0f, ti = 0.0f;
  for (int sh = 0; sh < num_shards; ++sh) {
    const float* p = partial + static_cast<size_t>(sh) * static_cast<size_t>(shard_stride) +
                     static_cast<size_t>(k) * num_chunks * al * 2 + r * 2;
    float sr = 0.0f, si = 0.0f;
    for (int c = 0; c < num_chunks; ++c) {
      sr += p[static_cast<size_t>(c) * al * 2];
      si += p[static_cast<size_t>(c) * al * 2 + 1];
    }
    tr = sh == 0 ? sr : __fadd_rn(tr, sr);
    ti = sh == 0 ? si : __fadd_rn(ti, si);
  }
  out_re[idx] = tr;
  out_im[idx] = ti;
}

// Each channel's (f_cyc, phi_cyc, rho, phi_code) as the bank kernels derive
// it from `src` (the time shard's advance included): a check of the
// derivation against its torch expressions, on no path of its own.
__global__ void bank_params_kernel(const bank::Source src, float4* __restrict__ out, int num_k) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < num_k) out[k] = bank::channel_params(src, k);
}

// Tiles per CTA: 4, 2 or 1. They must divide the phase tile, and a grid
// under kMinCtas CTAs leaves SMs idle in its last wave.
int chunk_tiles(int num_k, int num_samples, int phase_tile) {
  const int num_tiles = (num_samples + kTile - 1) / kTile;
  const int groups = (num_k + kWarps - 1) / kWarps;
  const int tiles_per_phase = phase_tile / kTile;
  int chunk = kMaxChunk;
  while (chunk > 1 && (tiles_per_phase % chunk != 0 ||
                       (num_tiles + chunk - 1) / chunk * groups < kMinCtas)) {
    chunk /= 2;
  }
  return chunk;
}

cudaError_t finish(const float* partial, float* out_re, float* out_im, int num_ants,
                   int num_taps, int num_samples, int num_k, int phase_tile,
                   long long shard_stride, int num_shards, cudaStream_t stream) {
  const int num_tiles = (num_samples + kTile - 1) / kTile;
  const int chunk = chunk_tiles(num_k, num_samples, phase_tile);
  const int num_chunks = (num_tiles + chunk - 1) / chunk;
  const int al = num_ants * num_taps;
  const int total = num_k * al;
  bank_rows_finish<<<(total + 255) / 256, 256, 0, stream>>>(partial, out_re, out_im, num_k,
                                                            num_chunks, al, shard_stride,
                                                            num_shards);
  return cudaGetLastError();
}

template <int A, int L, class Rows>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const float* sre,
                   const float* sim, const unsigned* code, const bank::Source& src,
                   const float* base, const int* deltas, float* partial, int num_samples,
                   int num_k, int code_length, int words, int phase_tile, int span,
                   int chunk, float rho_nom, float fcar_nom_cyc, int min_run) {
  void (*kernel)(BANK_ROWS_PARAMS, Rows) = bank_rows_kernel<A, L>;
  // Above 48 KB, dynamic shared memory needs the kernel's opt-in.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      sre, sim, code, src, reinterpret_cast<const float2*>(base), deltas, partial,
      num_samples, static_cast<int>(src.plane_stride), num_k, code_length, words, phase_tile,
      span, chunk, rho_nom, fcar_nom_cyc, min_run, Rows{});
  return cudaGetLastError();
}

}  // namespace

// Launch the bank on `stream`; `source` (host memory) says where the block
// and the channels' parameters are read. Returns the first CUDA error of the
// two launches (cudaErrorInvalidValue for an antenna/tap count with no
// instantiation, or a phase tile that kTile does not divide). With out_re
// null, only the bank kernel runs: its partials wait for
// bank_rows_finish_launch (a time shard's). min_run > 0 builds the rows
// from the chip boundaries where a channel's chips last min_run samples or
// more (and its mask table takes shared memory); 0 keeps the per-position
// build.
extern "C" int bank_rows_launch(const float* sre, const float* sim, const int* code,
                                const bank::Source* source, const float* base, const int* deltas,
                                float* partial, float* out_re, float* out_im,
                                int num_ants, int num_taps, int num_samples, int num_k,
                                int code_length, int phase_tile, int span,
                                float rho_nom, float fcar_nom_cyc, int min_run,
                                void* stream) {
  if (phase_tile % kTile != 0 || span < 0 || min_run < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bank::Source src = *source;
  const int num_tiles = (num_samples + kTile - 1) / kTile;
  const int words = (code_length + 31) / 32;
  const int groups = (num_k + kWarps - 1) / kWarps;
  const int chunk = chunk_tiles(num_k, num_samples, phase_tile);
  const int num_chunks = (num_tiles + chunk - 1) / chunk;
  const dim3 grid(num_chunks, groups);
  const size_t mask_words = min_run > 0 ? static_cast<size_t>(kWarps) * ((kTile + span + 31) / 32)
                                         : 0;
  const size_t smem = (2 * static_cast<size_t>(num_ants) * kTile +
                       static_cast<size_t>(kWarps) * (kTile + span) +
                       static_cast<size_t>(kWarps) * words + mask_words) * sizeof(float);
  const unsigned* words_ptr = reinterpret_cast<const unsigned*>(code);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define BANK_ROWS_CASE(A_, L_)                                                         \
  if (num_ants == A_ && num_taps == L_) {                                              \
    err = (min_run > 0 ? launch<A_, L_, BoundaryRows> : launch<A_, L_, PositionRows>)( \
        grid, smem, s, sre, sim, words_ptr, src, base, deltas, partial, num_samples,   \
        num_k, code_length, words, phase_tile, span, chunk, rho_nom, fcar_nom_cyc,     \
        min_run);                                                                      \
  }
  BANK_ROWS_CASE(1, 3) BANK_ROWS_CASE(1, 5) BANK_ROWS_CASE(1, 7)
  BANK_ROWS_CASE(2, 3) BANK_ROWS_CASE(2, 5) BANK_ROWS_CASE(2, 7)
  BANK_ROWS_CASE(3, 3) BANK_ROWS_CASE(3, 5) BANK_ROWS_CASE(3, 7)
  BANK_ROWS_CASE(4, 3) BANK_ROWS_CASE(4, 5) BANK_ROWS_CASE(4, 7)
#undef BANK_ROWS_CASE
  if (err != cudaSuccess || out_re == nullptr) return static_cast<int>(err);
  return static_cast<int>(finish(partial, out_re, out_im, num_ants, num_taps, num_samples,
                                 num_k, phase_tile, 0, 1, s));
}

// One finish for the `num_shards` time shards of a channel shard: shard s's
// partials (bank_rows_launch with out_re null, at the same ants, taps,
// samples, K and phase tile) start s * shard_stride floats after
// `partial`. out[k, a, l] is the shards' sums added in shard order.
extern "C" int bank_rows_finish_launch(const float* partial, long long shard_stride,
                                       int num_shards, float* out_re, float* out_im,
                                       int num_ants, int num_taps, int num_samples, int num_k,
                                       int phase_tile, void* stream) {
  if (num_shards < 1 || phase_tile % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(finish(partial, out_re, out_im, num_ants, num_taps, num_samples,
                                 num_k, phase_tile, shard_stride, num_shards,
                                 static_cast<cudaStream_t>(stream)));
}

// bank_params_kernel over `num_k` channels into out[num_k] float4.
extern "C" int bank_params_launch(const bank::Source* source, float* out, int num_k,
                                  void* stream) {
  bank_params_kernel<<<(num_k + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      *source, reinterpret_cast<float4*>(out), num_k);
  return static_cast<int>(cudaGetLastError());
}
