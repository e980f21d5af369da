// Shared pieces of the bank correlator kernels (bank_rows.cu, bank_comp.cu).
//
// Phase arithmetic (ops/epl_kernels.py computes the same values with the same
// roundings in `_tile_phases`, `_row_lane_carrier` and `_replica_chips`): per
// phase tile of `phase_tile` samples the host gives an exact f64 nominal
// base, and each channel adds an f32 residual. Each product and sum is
// rounded on its own (__fmul_rn/__fadd_rn): nvcc cannot contract them into
// FMAs, so a chip boundary lands on the same sample as in the plain version.
// Build without --use_fast_math.
//
// The carrier is the JAX kernels' row x lane product
// (pallas_epl.py::_group_row_phasors, _group_lane_phasors): at phase-tile
// sample j = 128 r + i it is e^{2 pi i frac(128 r f + ph_car)} times
// e^{2 pi i frac(f i)}, one precise sincosf per row and per lane instead of
// one per sample, and four multiplies and two adds per sample.
//
// Chips: the code columns are packed one bit per chip (bit set = -1,
// epl_kernels.prepare_bank_code_tiles_rows, csrc/code_tiles.cu on the card)
// and staged in shared memory. A chip flips the sign bit of the value it
// multiplies, which is exact. The chip index wraps by one unsigned min where
// chips_near holds (the routes' chip-rate envelopes), else by the general
// modulo; both give the same index.
//
// Where a launch reads its block and its channels (`Source`): the block is
// the signal planes the wrapper passed, or row *block_index of a
// [chunk, A, N] buffer of them, the index read on the device (the captured
// block loop's, tracking/graphs.py). The channels' (f_cyc, phi_cyc, rho,
// phi_code) come from a [K] table, or each warp derives its channel's from
// the tracking state's f32 leaves (channel k reads entry k mod `modulus`,
// so the dual bank's data and pilot channels share one state) with the
// roundings torch gives on the card to the plain expressions
// (epl_kernels._channel_params of `intermediate_frequency + carrier_doppler`
// and `code_frequency + code_doppler`): an f32 add of the f32 nominal rate;
// `rate` as f32(f64(x) * (1 / fs)), torch's division of an f64 tensor by a
// Python float on CUDA; the phase over f32(2 pi) as a product with the
// double reciprocal rounded to f32 (the same rule as
// ops/loop_kernel._recip); rho * d_min, then the add.
//
// A time shard of a mesh (parallel/bank.py): the launch reads the piece
// [offset, offset + num_samples) of each antenna's row of the block
// (`sample_offset`, `plane_stride` the row's full length) and treats it as
// its block, reading nothing outside it; and each channel's phases are
// first advanced to the piece's first sample as
// parallel/correlate.advance_phases computes them in torch ops (the nominal
// advance from the f64 table entry, the f32 Doppler residual
// (f - f_nom) * f32(1 / fs) * n0, the cycles' fraction, the wraps by
// torch.remainder), each op rounded on its own.

#pragma once

#include <cuda_runtime.h>

namespace bank {

constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr int kRow = 128;                        // samples per carrier row

// Layout shared with ops/epl_kernels.py::_Source (ctypes); passed by value.
struct Source {
  const float4* params;            // [K] (f_cyc, phi_cyc, rho, phi_code), or null: derive
  const float* carrier_doppler;    // [modulus] state leaves, where params is null
  const float* carrier_phase;
  const float* code_doppler;
  const float* code_phase;
  const long long* block_index;    // the block's row in the chunk, or null
  long long block_stride;          // elements per row of the chunk
  long long sample_offset;         // the piece's first sample in an antenna's row
  long long plane_stride;          // elements from one antenna's row to the next
  double inv_fs;                   // 1 / fs
  float intermediate_frequency;    // f32 nominal rates added to the Dopplers
  float code_frequency;
  float inv_two_pi;                // f32(1 / f32(2 pi)), from the double reciprocal
  float d_min;                     // the earliest tap's shift
  int modulus;                     // state entries: channel k reads k mod modulus
  int shard;                       // nonzero: advance the state's phases to the shard
  float shard_n0;                  // f32(t * samples per shard)
  float shard_carrier;             // the f32 nominal carrier advance, cycles mod 1
  float shard_code;                // the f32 nominal code advance, chips mod Lc
  float shard_inv_fs;              // f32(1 / fs)
  float shard_code_length;         // f32(Lc)
};

// The offset of the launch's piece of its block from the signal pointers it
// was given.
__device__ __forceinline__ size_t block_offset(const Source& src) {
  const size_t piece = static_cast<size_t>(src.sample_offset);
  return src.block_index == nullptr
             ? piece
             : static_cast<size_t>(*src.block_index) * static_cast<size_t>(src.block_stride) +
                   piece;
}

// torch.remainder on f32 (ATen's float remainder, CPU and CUDA): fmod,
// exact, then + b where the result is nonzero and its sign differs from b's.
__device__ __forceinline__ float remainder(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod = __fadd_rn(mod, b);
  return mod;
}

// parallel/correlate.advance_phases: the carrier phase (rad) and code phase
// (chips) at the shard's first sample, from the block start's, at carrier
// and code frequencies f_car and f_code (Hz, f32).
__device__ __forceinline__ void advance_to_shard(const Source& src, float f_car, float f_code,
                                                 float* carrier_phase, float* code_phase) {
  const float dcar = __fmul_rn(
      __fmul_rn(__fsub_rn(f_car, src.intermediate_frequency), src.shard_inv_fs), src.shard_n0);
  float cyc = __fadd_rn(src.shard_carrier, dcar);
  cyc = __fsub_rn(cyc, floorf(cyc));
  *carrier_phase = remainder(__fadd_rn(*carrier_phase, __fmul_rn(kTwoPi, cyc)), kTwoPi);
  const float dcode = __fmul_rn(
      __fmul_rn(__fsub_rn(f_code, src.code_frequency), src.shard_inv_fs), src.shard_n0);
  *code_phase = remainder(__fadd_rn(__fadd_rn(*code_phase, src.shard_code), dcode),
                          src.shard_code_length);
}

// f32(f64(x) * inv_fs): torch's `(x.double() / fs).float()` on the card.
__device__ __forceinline__ float rate(float x, double inv_fs) {
  return __double2float_rn(__dmul_rn(static_cast<double>(x), inv_fs));
}

// Channel k's (f_cyc, phi_cyc, rho, phi_code).
__device__ __forceinline__ float4 channel_params(const Source& src, int k) {
  if (src.params != nullptr) return src.params[k];
  const int s = k % src.modulus;
  const float f_car = __fadd_rn(src.carrier_doppler[s], src.intermediate_frequency);
  const float f_code = __fadd_rn(src.code_doppler[s], src.code_frequency);
  float carrier_phase = src.carrier_phase[s];
  float code_phase = src.code_phase[s];
  if (src.shard) advance_to_shard(src, f_car, f_code, &carrier_phase, &code_phase);
  const float rho = rate(f_code, src.inv_fs);
  return make_float4(rate(f_car, src.inv_fs), __fmul_rn(carrier_phase, src.inv_two_pi), rho,
                     __fadd_rn(code_phase, __fmul_rn(rho, src.d_min)));
}

// One channel's phases at a phase-tile start.
struct Phases {
  float f;       // carrier cycles per sample
  float ph_car;  // carrier cycles at the tile start (not wrapped)
  float rho;     // chips per sample
  float frac;    // fraction of the code phase at the tile start
  int chip0;     // its whole chips, in [0, Lc]
};

// params = (f_cyc, phi_cyc, rho, phi_code); b = the tile's nominal base
// (carrier cycles, code chips); n0 = the tile start, exact in f32.
__device__ __forceinline__ Phases tile_phases(float4 p, float2 b, float n0, float lc,
                                              float rho_nom, float fcar_nom_cyc) {
  Phases ch;
  ch.f = p.x;
  ch.rho = p.z;
  ch.ph_car = __fadd_rn(__fadd_rn(p.y, b.x), __fmul_rn(__fsub_rn(p.x, fcar_nom_cyc), n0));
  float pc = __fadd_rn(__fadd_rn(p.w, b.y), __fmul_rn(__fsub_rn(p.z, rho_nom), n0));
  pc = __fsub_rn(pc, __fmul_rn(lc, floorf(__fdiv_rn(pc, lc))));
  // Whole chips and fraction apart: a position's sum carries only the
  // fraction, and keeps f32 resolution however large the chip index.
  const float whole = floorf(pc);
  ch.frac = __fsub_rn(pc, whole);
  ch.chip0 = static_cast<int>(whole);
  return ch;
}

// (cos, sin) of 2 pi frac(cyc): the wrapped cycles times f32(2 pi).
__device__ __forceinline__ float2 phasor(float cyc) {
  const float theta = __fmul_rn(__fsub_rn(cyc, floorf(cyc)), kTwoPi);
  float s, c;
  sincosf(theta, &s, &c);
  return make_float2(c, s);
}

// Row phasor of the row that starts at phase-tile sample n_row.
__device__ __forceinline__ float2 row_phasor(const Phases& ch, float n_row) {
  return phasor(__fadd_rn(__fmul_rn(n_row, ch.f), ch.ph_car));
}

// Lane phasor of in-row sample i (0..127).
__device__ __forceinline__ float2 lane_phasor(const Phases& ch, float i) {
  return phasor(__fmul_rn(ch.f, i));
}

// The carrier at one sample: row phasor x lane phasor.
__device__ __forceinline__ float2 carrier(float2 row, float2 lane) {
  return make_float2(__fsub_rn(__fmul_rn(row.x, lane.x), __fmul_rn(row.y, lane.y)),
                     __fadd_rn(__fmul_rn(row.y, lane.x), __fmul_rn(row.x, lane.y)));
}

// floor(m rho + frac) + chip0 at phase-tile position m, before the wrap.
__device__ __forceinline__ int chip_unwrapped(const Phases& ch, float m) {
  return __float2int_rd(__fadd_rn(__fmul_rn(m, ch.rho), ch.frac)) + ch.chip0;
}

// Chip index of phase-tile position m: (floor(m rho + frac) + chip0) mod Lc.
// Inside the rows, transition and composite routes' chip-rate envelopes,
// floor(m rho + frac) stays below Lc for every m of a tile, so one
// conditional subtraction wraps it; the integer modulo runs only outside an
// envelope (the one-hot route, which has none, at high chip rates).
__device__ __forceinline__ int chip_index(const Phases& ch, float m, int lc) {
  int ci = chip_unwrapped(ch, m);
  if (ci >= lc) ci -= lc;
  if (static_cast<unsigned>(ci) >= static_cast<unsigned>(lc)) {  // ci < 0 or ci >= lc
    ci %= lc;
    if (ci < 0) ci += lc;
  }
  return ci;
}

// True when every position m <= m_last has its unwrapped chip in [0, 2 Lc),
// so that chip_index_near gives chip_index: for rho >= 0 the unwrapped chip
// never decreases with m (each rounding is monotonic), and a NaN phase
// converts to chip 0.
__device__ __forceinline__ bool chips_near(const Phases& ch, float m_last, int lc) {
  return ch.rho >= 0.0f && ch.chip0 >= 0 &&
         static_cast<unsigned>(chip_unwrapped(ch, m_last)) < 2u * static_cast<unsigned>(lc);
}

// chip_index where chips_near holds: one wrap, as an unsigned min.
__device__ __forceinline__ int chip_index_near(const Phases& ch, float m, int lc) {
  const int ci = chip_unwrapped(ch, m);
  return static_cast<int>(min(static_cast<unsigned>(ci), static_cast<unsigned>(ci - lc)));
}

// The packed word of chip ci, rotated so that the chip's bit (set for -1) is
// bit 31: a left rotation by 31 - (ci & 31) = ~ci & 31 (shf.l.wrap takes the
// amount mod 32) moves bit ci & 31 there.
__device__ __forceinline__ unsigned chip_rotated(const unsigned* col, int ci) {
  const unsigned word = col[ci >> 5];
  return __funnelshift_l(word, word, static_cast<unsigned>(~ci));
}

// x times the chip whose rotated word (chip_rotated) is `rot`: the chip's
// sign bit flips x's, exactly, in one three-input logic op,
// (rot & 0x80000000) ^ x.
__device__ __forceinline__ float times_chip_rotated(float x, unsigned rot) {
  unsigned v;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;"
      : "=r"(v)
      : "r"(rot), "r"(0x80000000u), "r"(__float_as_uint(x)));
  return __uint_as_float(v);
}

// Chip ci as +1.0f or -1.0f: its sign bit over the bits of 1.0f, in one
// three-input logic op, (rot & 0x80000000) | 0x3f800000.
__device__ __forceinline__ float chip_value(const unsigned* col, int ci) {
  unsigned v;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
      : "=r"(v)
      : "r"(chip_rotated(col, ci)), "r"(0x80000000u), "r"(0x3f800000u));
  return __uint_as_float(v);
}

// Truncated TF32 split of x for 3xTF32 products: x = big + small exactly,
// big keeps the top 10 mantissa bits (the tensor cores read the top 10 bits
// of small too: |x - big - tf32(small)| <= 2^-20 |x|).
__device__ __forceinline__ void tf32_split(float x, unsigned* big, unsigned* small) {
  *big = __float_as_uint(x) & 0xffffe000u;
  *small = __float_as_uint(__fsub_rn(x, __uint_as_float(*big)));
}

}  // namespace bank
