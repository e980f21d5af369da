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
// The sum is the product [2K, U] x [U, 2AL] of the planes zc = cos * code,
// zs = sin * code against S_re and S_im, as the TPU kernel's MXU
// contraction (pallas_epl.py:2086-2090); the recombination
// m = (zc.S_re + zs.S_im) + i (zc.S_im - zs.S_re) and the rotation run in a
// second kernel.
//
// What bounds it on the H100: at K=1024, A=4, L=7, N=32768 the product is
// 7.5 GFLOP: 7.6 us of bf16 tensor-core peak, 46 us as three TF32 passes.
// Around it, Z costs a carrier (row x lane phasors, bank.cuh), a chip and
// its sign per (channel, sample), ~35 M of them per block, and each k-step
// loads (and in f32 splits) its B fragments. `mma.sync` issues well below
// the `wgmma` peak, so the f32 mode's 11.4 M TF32 mma are a large share of
// a block and the bf16 mode's 1.9 M a small one; the rest is Z and B and
// their latency at 8 (f32) or 16 (bf16) warps per SM. `wgmma` would need Z
// staged through shared memory in its 64-row layout; it is left for later.
// (Laying the signal tile out so that B loads hit 32 distinct banks, not 8,
// was measured no faster.)
//
// Design:
// - A CTA takes kTile = 1024 composite samples and kGroup = 64 channels;
//   4 warps, each two m16 tiles of 8 channels (rows 0-7: zc, rows 8-15: zs
//   of the same channels). Every B fragment (the shifted signal, shared by
//   all channels) is loaded once per k-step and used by 16 channels.
// - B comes from the haloed signal tile staged in shared memory once per
//   CTA: S_{a,l}[u] = tile[a][u - u0 + span - delta_l], zero outside [0, N),
//   so no halo correction is needed. The 2AL planes are padded to n8 tiles
//   (56 stays 56, 42 -> 48); padding columns read as zero.
// - Z goes straight into the A fragments in registers: each lane builds its
//   own fragment elements (one channel, 2 or 4 samples per k-step). The
//   k-steps walk a row-block of 8 (tf32) or 16 (bf16) in-row positions
//   through the tile's 8 rows, so a lane's lane phasors are fixed for 8
//   k-steps; row phasors sit in shared memory (64 channels x 8 rows).
//   Inside the chip-rate envelope (bank::chips_near for all of a warp's
//   channels over the tile) a Z element's chip wraps with one unsigned min;
//   else the general wrap runs. A chip flips the carrier's sign bits with
//   one logic op each.
// - bf16 mode: m16n8k16 bf16 x bf16 -> f32. Z and S are rounded to bf16 as
//   in the plain version; their products are exact in f32, so this is the
//   same function summed in another order.
// - f32 mode: m16n8k8 TF32 with the 3xTF32 split, x = big + small with big
//   the top 10 mantissa bits of x and small = x - big (bank::tf32_split):
//   acc += a_s b_b + a_b b_s + a_b b_b, f32-class accuracy (plain TF32 would
//   keep ~3 digits).
// - f32 mode: each row-block (8 k-steps of three products) accumulates into
//   fresh registers, added to the tile's sums after it, so the tensor
//   cores' accumulation rounding acts on short partial sums. Accumulating
//   straight into the tile's sums read a golden prompt of 32767.32 for
//   32768 on the H100 (2.1e-5 off), the row-blocks 32767.96. bf16 mode
//   accumulates straight into the tile's sums (bf16's own rounding is far
//   larger), which frees the second set of sums: 128 registers a thread
//   instead of ~190 at A=4, L=7, and 4 CTAs per SM instead of 2.
// - f32 mode unrolls its rows by four, so that a warp has the next k-steps'
//   Z and B to issue while a k-step's three dependent products run
//   (~220 registers; bf16 gains nothing from it).
// - Per-tile partials, summed over tiles in a fixed order by the second
//   kernel: no atomics, deterministic.
// - The block and the channels come as a bank::Source (bank.cuh): in the
//   captured block loop the block is read at the loop's device-side index,
//   and the CTA derives its channels' parameters from the tracking state
//   where it read the [K] table (the finish kernel derives f_cyc for the
//   rotation alike).
// - A time shard of a mesh reads its piece of the block in place
//   (bank::Source's sample offset and antenna-row stride): its haloed tile
//   is zero outside the piece, [0, num_samples) of the piece, as a JAX
//   shard sees only its own samples; never the neighbour's. The shards'
//   launches only write partials, and one finish per channel shard finishes
//   each shard's (its tiles' sums, recombination and rotation) and adds the
//   shards' results in shard order (ops/epl_kernels.sum_in_order's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "bank.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;                       // m16 tiles (8 channels each) per warp
constexpr int kGroup = kWarps * kMTiles * 8;     // channels per CTA
constexpr int kTile = 1024;                      // composite samples per CTA (COMP_TILE)
constexpr int kRows = kTile / bank::kRow;        // carrier rows per tile

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int A, int L, bool BF16>
__global__ void __launch_bounds__(kThreads)
bank_comp_kernel(const float* __restrict__ sre,          // [A, N], or the chunk (src)
                 const float* __restrict__ sim,          // [A, N], or the chunk (src)
                 const unsigned* __restrict__ code,      // [K, words] packed columns
                 const bank::Source src,                 // the block's row, the channels
                 const float2* __restrict__ base,        // [phase tiles]: carrier cyc, code chips
                 const int* __restrict__ deltas,         // [L]
                 float* __restrict__ partial,            // [K, tiles, A, L, 4]
                 int num_samples, int plane,            // the piece's samples, the rows' stride
                 int num_k, int code_length, int words, int phase_tile,
                 int span, float rho_nom, float fcar_nom_cyc) {
  constexpr int AL = A * L;
  constexpr int NT = (2 * AL + 7) / 8;           // n8 tiles over the 2AL planes
  constexpr int KS = BF16 ? 16 : 8;              // samples per k-step
  constexpr int NC = BF16 ? 4 : 2;               // Z samples per lane per k-step
  constexpr int NB = bank::kRow / KS;            // row-blocks per row
  constexpr bool kFlush = !BF16;                 // f32: row-block sums in fresh registers
  constexpr int kMT = kMTiles;

  extern __shared__ float smem[];
  const int width = kTile + span;
  // f32: the tile's re and im values; bf16: words (bf16(s[i]), bf16(s[i + 1])).
  float* s_re = smem;                                          // [A][width]
  float* s_im = s_re + A * width;                              // [A][width]
  float2* row_ph = reinterpret_cast<float2*>(s_im + A * width);  // [kGroup][kRows]
  unsigned* code_s = reinterpret_cast<unsigned*>(row_ph + kGroup * kRows);  // [kGroup][words]

  const int t = blockIdx.x;
  const int num_tiles = gridDim.x;
  const int k0 = blockIdx.y * kGroup;
  const int u0 = t * kTile;
  const int pt = u0 / phase_tile;
  const int j0 = u0 - pt * phase_tile;                         // tile start in its phase tile
  const float2 b = base[pt];
  const float n0 = static_cast<float>(pt * phase_tile);        // exact below 2^24
  const float lcf = static_cast<float>(code_length);
  const size_t block = bank::block_offset(src);
  sre += block;
  sim += block;

  // The signal tile and its halo: tile[a][i] = s[a][u0 - span + i], zero
  // outside the block (a time shard's piece).
  for (int i = threadIdx.x; i < A * width; i += kThreads) {
    const int a = i / width;
    const int p = i - a * width;
    const int n = u0 - span + p;
    const size_t row = static_cast<size_t>(a) * plane;
    const bool in0 = n >= 0 && n < num_samples;
    const float xr = in0 ? sre[row + n] : 0.0f;
    const float xi = in0 ? sim[row + n] : 0.0f;
    if (BF16) {
      const bool in1 = p + 1 < width && n + 1 >= 0 && n + 1 < num_samples;
      reinterpret_cast<unsigned*>(s_re)[i] = pack_bf16(xr, in1 ? sre[row + n + 1] : 0.0f);
      reinterpret_cast<unsigned*>(s_im)[i] = pack_bf16(xi, in1 ? sim[row + n + 1] : 0.0f);
    } else {
      s_re[i] = xr;
      s_im[i] = xi;
    }
  }
  // The group's code columns, and row phasors (a padded group repeats the
  // last channel).
  const int group_words = min(num_k - k0, kGroup) * words;
  for (int i = threadIdx.x; i < group_words; i += kThreads) {
    code_s[i] = code[static_cast<size_t>(k0) * words + i];
  }
  for (int i = threadIdx.x; i < kGroup * kRows; i += kThreads) {
    const int g = i / kRows;
    const int r = i - g * kRows;
    const float4 p = bank::channel_params(src, min(k0 + g, num_k - 1));
    const bank::Phases ch = bank::tile_phases(p, b, n0, lcf, rho_nom, fcar_nom_cyc);
    row_ph[i] = bank::row_phasor(ch, static_cast<float>(j0 + bank::kRow * r));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (k0 + warp * kMT * 8 >= num_k) return;                   // a warp of padding channels
  const int gq = lane >> 2;                                    // fragment row (channel) in the tile
  const int tq = lane & 3;

  int gl[kMT];                                             // channel in the group
  bank::Phases ch[kMT];
  const unsigned* col[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    gl[mt] = (warp * kMT + mt) * 8 + gq;
    const int g = min(gl[mt], num_k - 1 - k0);
    ch[mt] = bank::tile_phases(bank::channel_params(src, k0 + g), b, n0, lcf, rho_nom,
                               fcar_nom_cyc);
    col[mt] = code_s + g * words;
  }
  // This lane's B column in each n8 tile: plane p = 8 nt + gq (S_re planes,
  // then S_im, each (antenna, tap)-major), its offset in the signal tile at
  // u = u0 (negative: a padding column, read as zero).
  int boff[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int p = 8 * nt + gq;
    boff[nt] = -1;
    if (p < 2 * AL) {
      const int al = p % AL;
      boff[nt] = (p < AL ? 0 : A * width) + (al / L) * width + span - deltas[al % L];
    }
  }
  // In-row positions of this lane's Z samples in a row-block (fragment columns).
  int cpos[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) cpos[c] = BF16 ? 2 * tq + (c & 1) + 8 * (c >> 1) : tq + 4 * c;

  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // The tile's sums. kNear: every chip of the warp's channels in this tile
  // lies in [0, 2 Lc) (bank::chips_near; always so inside the route's
  // chip-rate envelope), and its wrap is one unsigned min.
  auto tile_sums = [&](auto near) {
    constexpr bool kNear = decltype(near)::value;
#pragma unroll 1
    for (int rb = 0; rb < NB; ++rb) {
      float2 lp[kMT][NC];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          lp[mt][c] = bank::lane_phasor(ch[mt], static_cast<float>(rb * KS + cpos[c]));
      float blk_[kMT][NT][4];
      float (&blk)[kMT][NT][4] = kFlush ? blk_ : acc;
      if (kFlush) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) blk[mt][nt][e] = 0.0f;
      }

      // f32: four rows per iteration let a warp overlap the three dependent
      // products of one k-step with the next k-steps' Z and B; bf16 gains
      // nothing and would lose a CTA per SM to the registers.
      constexpr int kRowUnroll = BF16 ? 1 : 4;
#pragma unroll 1
      for (int r0 = 0; r0 < kRows; r0 += kRowUnroll) {
#pragma unroll
      for (int rr = 0; rr < kRowUnroll; ++rr) {
        const int r = r0 + rr;
        const int ur = r * bank::kRow + rb * KS;                 // k-step's first sample - u0
        // A fragments: Z of this lane's channel at its NC samples.
        unsigned a_big[kMT][4], a_small[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float2 row = row_ph[gl[mt] * kRows + r];
          float zc[NC], zs[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float2 cr = bank::carrier(row, lp[mt][c]);
            const float u = static_cast<float>(j0 + ur + cpos[c]);
            const int ci = kNear ? bank::chip_index_near(ch[mt], u, code_length)
                                 : bank::chip_index(ch[mt], u, code_length);
            const unsigned rot = bank::chip_rotated(col[mt], ci);
            zc[c] = bank::times_chip_rotated(cr.x, rot);
            zs[c] = bank::times_chip_rotated(cr.y, rot);
          }
          if (BF16) {
            a_big[mt][0] = pack_bf16(zc[0], zc[1]);
            a_big[mt][1] = pack_bf16(zs[0], zs[1]);
            a_big[mt][2] = pack_bf16(zc[2 % NC], zc[3 % NC]);
            a_big[mt][3] = pack_bf16(zs[2 % NC], zs[3 % NC]);
          } else {
            bank::tf32_split(zc[0], &a_big[mt][0], &a_small[mt][0]);
            bank::tf32_split(zs[0], &a_big[mt][1], &a_small[mt][1]);
            bank::tf32_split(zc[1], &a_big[mt][2], &a_small[mt][2]);
            bank::tf32_split(zs[1], &a_big[mt][3], &a_small[mt][3]);
          }
        }
        // B fragments (the shifted signal, shared by both m tiles), then the
        // products, one pass over all (m, n) tiles at a time so that
        // consecutive mma are independent.
        unsigned b_big[NT][2], b_small[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bool on = boff[nt] >= 0;
          const int at = boff[nt] + ur;
          if (BF16) {
            const unsigned* w = reinterpret_cast<const unsigned*>(smem);
            b_big[nt][0] = on ? w[at + 2 * tq] : 0u;
            b_big[nt][1] = on ? w[at + 2 * tq + 8] : 0u;
          } else {
            bank::tf32_split(on ? smem[at + tq] : 0.0f, &b_big[nt][0], &b_small[nt][0]);
            bank::tf32_split(on ? smem[at + tq + 4] : 0.0f, &b_big[nt][1], &b_small[nt][1]);
          }
        }
        if (BF16) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma_bf16(blk[mt][nt], a_big[mt], b_big[nt][0], b_big[nt][1]);
        } else {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma_tf32(blk[mt][nt], a_small[mt], b_big[nt][0], b_big[nt][1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma_tf32(blk[mt][nt], a_big[mt], b_small[nt][0], b_small[nt][1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              mma_tf32(blk[mt][nt], a_big[mt], b_big[nt][0], b_big[nt][1]);
        }
      }
      }
      if (kFlush) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += blk_[mt][nt][e];
      }
    }
  };
  bool in_envelope = true;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
    in_envelope = in_envelope &&
                  bank::chips_near(ch[mt], static_cast<float>(j0 + kTile - 1), code_length);
  if (__all_sync(0xffffffffu, in_envelope)) {
    tile_sums(std::true_type{});
  } else {
    tile_sums(std::false_type{});
  }

  // D fragment: e = 0, 1 -> zc row, planes 8 nt + 2 tq + e; e = 2, 3 -> zs row.
  // partial[k, t, al, q]: q = 0 zc.S_re, 1 zs.S_im, 2 zc.S_im, 3 zs.S_re.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int k = k0 + gl[mt];
    if (k >= num_k) continue;
    float* out = partial + (static_cast<size_t>(k) * num_tiles + t) * AL * 4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 8 * nt + 2 * tq + (e & 1);
        if (p >= 2 * AL) continue;
        const bool zs_row = e >= 2;
        const int q = p < AL ? (zs_row ? 3 : 0) : (zs_row ? 1 : 2);
        out[(p % AL) * 4 + q] = acc[mt][nt][e];
      }
  }
}

// Sum the per-tile partials in tile order, recombine
// m = (zc.S_re + zs.S_im) + i (zc.S_im - zs.S_re), and rotate by
// e^{+2 pi i f_k delta_l}: out[k, a, l] (re and im planes). With
// num_shards > 1 time shards, shard s's partials start s * shard_stride
// floats in; each shard is finished as one call is, then the shards'
// results are added left to right, (r_0 + r_1) + r_2 ... (f_cyc, and so
// the rotation, is the same for every shard).
__global__ void bank_comp_finish(const float* __restrict__ partial,
                                 const bank::Source src,
                                 const int* __restrict__ deltas,
                                 float* __restrict__ out_re,
                                 float* __restrict__ out_im,
                                 int num_k, int num_tiles, int num_ants, int num_taps,
                                 long long shard_stride, int num_shards) {
  const int al = num_ants * num_taps;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_k * al) return;
  const int k = idx / al;
  const int r = idx - k * al;
  const int l = r % num_taps;
  const float omega = __fmul_rn(__fmul_rn(bank::kTwoPi, bank::channel_params(src, k).x),
                                static_cast<float>(deltas[l]));
  float sw, cw;
  sincosf(omega, &sw, &cw);
  float tr = 0.0f, ti = 0.0f;
  for (int sh = 0; sh < num_shards; ++sh) {
    const float* p = partial + static_cast<size_t>(sh) * static_cast<size_t>(shard_stride) +
                     static_cast<size_t>(k) * num_tiles * al * 4 + r * 4;
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
    const float re = __fsub_rn(__fmul_rn(cw, m_re), __fmul_rn(sw, m_im));
    const float im = __fadd_rn(__fmul_rn(cw, m_im), __fmul_rn(sw, m_re));
    tr = sh == 0 ? re : __fadd_rn(tr, re);
    ti = sh == 0 ? im : __fadd_rn(ti, im);
  }
  out_re[idx] = tr;
  out_im[idx] = ti;
}

cudaError_t finish(const float* partial, const bank::Source& src, const int* deltas,
                   float* out_re, float* out_im, int num_ants, int num_taps, int num_samples,
                   int num_k, int span, long long shard_stride, int num_shards,
                   cudaStream_t stream) {
  const int num_tiles = (num_samples + span + kTile - 1) / kTile;
  const int total = num_k * num_ants * num_taps;
  bank_comp_finish<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, src, deltas, out_re, out_im, num_k, num_tiles, num_ants, num_taps, shard_stride,
      num_shards);
  return cudaGetLastError();
}

template <int A, int L, bool BF16>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const float* sre,
                   const float* sim, const unsigned* code, const bank::Source& src,
                   const float* base, const int* deltas, float* partial, int num_samples,
                   int num_k, int code_length, int words, int phase_tile, int span,
                   float rho_nom, float fcar_nom_cyc) {
  // Above 48 KB, dynamic shared memory needs the kernel's opt-in.
  cudaError_t err = cudaFuncSetAttribute(bank_comp_kernel<A, L, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bank_comp_kernel<A, L, BF16><<<grid, kThreads, smem, stream>>>(
      sre, sim, code, src, reinterpret_cast<const float2*>(base), deltas, partial,
      num_samples, static_cast<int>(src.plane_stride), num_k, code_length, words, phase_tile,
      span, rho_nom, fcar_nom_cyc);
  return cudaGetLastError();
}

}  // namespace

// Launch the bank on `stream`; `source` (host memory) says where the block and
// the channels' parameters are read. Returns the first CUDA error of the two
// launches (cudaErrorInvalidValue for an antenna/tap count with no
// instantiation, or a phase tile that kTile does not divide). With out_re
// null, only the bank kernel runs: its partials wait for
// bank_comp_finish_launch (a time shard's).
extern "C" int bank_comp_launch(const float* sre, const float* sim, const int* code,
                                const bank::Source* source, const float* base, const int* deltas,
                                float* partial, float* out_re, float* out_im,
                                int num_ants, int num_taps, int num_samples, int num_k,
                                int code_length, int phase_tile, int span, int bf16,
                                float rho_nom, float fcar_nom_cyc, void* stream) {
  if (phase_tile % kTile != 0 || span < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bank::Source src = *source;
  const int num_tiles = (num_samples + span + kTile - 1) / kTile;
  const int words = (code_length + 31) / 32;
  const dim3 grid(num_tiles, (num_k + kGroup - 1) / kGroup);
  const size_t smem = 2 * static_cast<size_t>(num_ants) * (kTile + span) * sizeof(float) +
                      static_cast<size_t>(kGroup) * kRows * sizeof(float2) +
                      static_cast<size_t>(kGroup) * words * sizeof(unsigned);
  const unsigned* words_ptr = reinterpret_cast<const unsigned*>(code);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define BANK_COMP_CASE(A_, L_)                                                          \
  if (num_ants == A_ && num_taps == L_) {                                               \
    err = bf16 ? launch<A_, L_, true>(grid, smem, s, sre, sim, words_ptr, src, base,    \
                                      deltas, partial, num_samples, num_k, code_length, \
                                      words, phase_tile, span, rho_nom, fcar_nom_cyc)   \
               : launch<A_, L_, false>(grid, smem, s, sre, sim, words_ptr, src,         \
                                       base, deltas, partial, num_samples, num_k,       \
                                       code_length, words, phase_tile, span, rho_nom,   \
                                       fcar_nom_cyc);                                   \
  }
  BANK_COMP_CASE(1, 3) BANK_COMP_CASE(1, 5) BANK_COMP_CASE(1, 7)
  BANK_COMP_CASE(2, 3) BANK_COMP_CASE(2, 5) BANK_COMP_CASE(2, 7)
  BANK_COMP_CASE(3, 3) BANK_COMP_CASE(3, 5) BANK_COMP_CASE(3, 7)
  BANK_COMP_CASE(4, 3) BANK_COMP_CASE(4, 5) BANK_COMP_CASE(4, 7)
#undef BANK_COMP_CASE
  if (err != cudaSuccess || out_re == nullptr) return static_cast<int>(err);
  return static_cast<int>(finish(partial, src, deltas, out_re, out_im, num_ants, num_taps,
                                 num_samples, num_k, span, 0, 1, s));
}

// One finish for the `num_shards` time shards of a channel shard: shard s's
// partials (bank_comp_launch with out_re null, at the same ants, taps,
// samples, K and span) start s * shard_stride floats after `partial`;
// `source` is one shard's (the rotation reads its f_cyc). out[k, a, l] is
// the shards' finished sums added in shard order.
extern "C" int bank_comp_finish_launch(const float* partial, long long shard_stride,
                                       int num_shards, const bank::Source* source,
                                       const int* deltas, float* out_re, float* out_im,
                                       int num_ants, int num_taps, int num_samples, int num_k,
                                       int span, void* stream) {
  if (num_shards < 1 || span < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(finish(partial, *source, deltas, out_re, out_im, num_ants, num_taps,
                                 num_samples, num_k, span, shard_stride, num_shards,
                                 static_cast<cudaStream_t>(stream)));
}
