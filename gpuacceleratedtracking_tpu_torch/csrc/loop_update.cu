// The loop closure of one tracking block, every channel in one launch, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion of
// gpuacceleratedtracking_tpu/tracking/track.py::loop_update (:77-240) inside
// the JAX package's jit + lax.scan, where XLA fuses the closure's elementwise
// maths over [K], the scan's stacked outputs and its carry into a few loops
// per block; in dual mode also of the GPS L5 dual body around it
// (gpuacceleratedtracking_tpu/tracking/dual.py:123-148). The port's plain
// versions, tracking/track.py::loop_update_plain (~120 torch ops) and
// tracking/dual.py::dual_update_plain, are what this kernel computes, per
// channel k of the flattened leading axes:
//
//   overlay sign from ms_elapsed (Python remainder on int32) -> wiped
//   accumulators (dual: the pilot's, rotated by -90 deg, (p_im, -p_re), and
//   the data prompt, summed over antennas) -> steered or plain antenna sum ->
//   coherent-window sums and the boundary select (coherent_blocks > 1) ->
//   Costas or atan2 PLL, EMLE DLL, atan or atan2 FLL gated by ms_elapsed >=
//   k_coh -> 1st/2nd/3rd-order filters, FLL assist on or off -> carrier
//   aiding -> both NCO phase wraps -> the C/N0 ring-buffer write and the M2M4
//   estimate.
//
// Where the results go. Fresh: every leaf into buffers of its own. Under a
// sink (a scan's [chunk, ...] stacked outputs and the int64 row index, read
// here on the card): every output leaf into row `row` of its stack, and the
// new state over the old state's own buffers (the carry, in place). A
// sink's rows may hold more channels than the call (`row_channels`): the
// call's K channels are then columns [first, first + K) of each row (a
// channel shard of a sharded bank writing its part of the whole bank's
// outputs). A
// channel's state is read and written by its own CTA only, and every value
// is read before it is overwritten (the ring slot and the window sums by the
// lane that writes them, the scalars by the lane that writes them, the
// scalars phase 1 reads before the barrier).
//
// Rounding: written against the plain version op by op on the card. Every
// torch op is one explicitly rounded operation (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), so nothing is contracted into an FMA.
// Python-float constants arrive folded on the host as torch rounds them
// (double -> f32), and a torch division by a Python scalar is a multiply by
// its reciprocal, taken in double and rounded to f32 (torch's CUDA div_true
// does so), which arrives as such.
// Transcendentals are the CUDA functions torch's CUDA kernels call (atanf,
// atan2f, log10f). remainder is torch's: fmodf, then + b where the signs
// differ. The reductions keep the order of torch's CUDA reduction kernel at
// these shapes: the beamforming antenna sum (A values per output, strided,
// not the fastest axis: four accumulators a mod 4, combined in order, so
// left to right for A <= 4); the dual data prompt's antenna sum (a strided
// [K, A] view whose reduced axis is its fastest: width = last_pow2(A) lanes,
// lane j over a = j, j + width, ... into four accumulators taken in turn,
// then shuffles down by width/2 .. 1); and the C/N0 window means (W
// contiguous values per output: a warp's lane sums, then its shuffle tree;
// warp_tree). Where a torch version orders them otherwise, cn0_dbhz (which
// feeds no state) and the fields downstream of an antenna sum differ in
// their last bits.
//
// What bounds it on the H100: the launch and the chain of dependent scalar
// ops per channel (three transcendentals, four divisions, ~100 roundings).
// At K=1024, A=1, L=3 and a 20-slot C/N0 window it moves ~0.5 MB (the ring
// buffers most of it), ~0.15 us at 3.35 TB/s. The design cuts the work
// around the chain and runs it once per channel: a CTA takes kTile
// channels, a warp each. Phase 1 (every warp): the wipe, the antenna sum and
// the window sums of its channel, a lane per tap; the ring-slot write and
// the C/N0 window moments, a lane per slot, in warp_tree's order; into
// shared memory. Phase 2: warp 0 runs the loop chain, a lane per channel
// (its scalars loaded before phase 1, so their latency overlaps it), while
// warp 1 runs the C/N0 tail (square root, division, log10) beside it; each
// writes the CTA's kTile channels of a [K] leaf in one store instruction.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// Channels per CTA, a warp each in phase 1. Measured on the H100 at K=1024
// A=1 L=3 (device time per launch in a CUDA graph, fresh / sink): 8 channels
// 3.8 / 4.2 us, 16 channels 4.1 / 4.3 us, 32 channels 4.5 / 4.9 us.
constexpr int kTile = 8;
constexpr int kThreads = kTile * kLanes;

// Pointers the kernel reads only, in the order of ops/loop_kernel.py::_INPUTS.
struct Inputs {
  const float* acc_re;          // [K, A, L]; dual: [2K, A, L], the data channels first
  const float* acc_im;
  const float* w_re;            // [K or 1, A] steering weights, or null
  const float* w_im;
  const float* overlay;         // [S] overlay signs (dual: the pilot's), or null
  const float* data_overlay;    // [Sd] dual: the data component's overlay signs, else null
  const long long* row;         // the sink's row, an int64 on the card, or null (row 0)
};

// The TrackState leaves but prn, in the order of ops/loop_kernel.py::_STATE:
// the old state (read) and the new one (written; the same buffers in place).
struct State {
  float* carrier_doppler;       // [K]
  float* carrier_phase;
  float* code_doppler;
  float* code_phase;
  float* pll_x1;
  float* pll_x2;
  float* dll_x1;
  float* dll_x2;
  float* cn0_re;                // [K, W] the C/N0 ring buffers
  float* cn0_im;
  int* cn0_index;               // [K]
  int* ms_elapsed;
  float* prev_re;
  float* prev_im;
  float* coh_re;                // [K, L] the coherent-window sums
  float* coh_im;
};

// The output leaves, TrackOutput's then DualTrackOutput's data prompts, in
// the order of ops/loop_kernel.py::_OUTPUTS; under a sink each points at its
// [chunk, ...] stack and the kernel writes row `row`. Null: not written.
struct Outputs {
  float* accum_re;              // [K, A, L]
  float* accum_im;
  float* prompt_re;             // [K]
  float* prompt_im;
  float* carrier_doppler;
  float* code_doppler;
  float* carrier_phase;
  float* code_phase;
  float* pll_error;
  float* dll_error;
  float* cn0_dbhz;
  float* data_re;
  float* data_im;
};

// The f32 constants, in the order of ops/loop_kernel.py::_CONSTANTS.
struct Filter {
  float g_out;   // order 1: 4 Bn; order 2: sqrt(2) w0; order 3: 2.4 w0
  float g_x1;    // order 2: w0^2; order 3: 1.1 w0^2
  float g_x2;    // order 3: w0^3
  float f_x1;    // FLL into x1: order 2: 4 Bf; order 3: sqrt(2) wf
  float f_x2;    // FLL into x2: order 3: wf^2
};

struct Constants {
  float intermediate_frequency;
  float code_frequency;
  float eps;            // 1e-12
  float inv_two_pi;     // 1 / f32(2 pi): the PLL discriminators' scalar division
  float two_minus_d;    // 2 - spacing_chips
  float inv_two;        // 1 / f32(2.0): the DLL's scalar division
  float inv_fll;        // 1 / f32(2 pi t_coh): the FLL discriminators' scalar division
  float t_coh;          // the filters' integration time
  float aid_scale;      // code_frequency (carrier aiding's product)
  float inv_center;     // 1 / f32(center_frequency): carrier aiding's division
  float two_pi;         // f32(2 pi): carrier NCO and its wrap
  float t;              // the block's integration time
  float code_length;
  float cn0_floor;      // 1e-20, the C/N0 clamps
  float mean;           // torch's mean factor, f32(1 / W)
  float ten;            // 10
  Filter pll;
  Filter dll;
};

// The integer parameters, in the order of ops/loop_kernel.py::_INTS.
struct Ints {
  int num_k;
  int num_ants;
  int num_taps;
  int w_stride;         // 0 (shared [A] weights) or A (per channel)
  int window;           // C/N0 ring-buffer slots
  int overlay_len;      // 0: no overlay
  int k_coh;
  int prompt;           // prompt tap index
  int pll_order;
  int dll_order;
  int pll_fll;          // 1: FLL-assisted PLL
  int atan2_disc;       // 1: atan2 PLL and FLL, 0: Costas PLL and atan FLL
  int steered;          // 1: weights given (with an antenna axis)
  int antenna_axis;     // 1: the accumulators have an antenna axis
  int dual;             // 1: GPS L5 dual mode
  int data_overlay_len;
  int chunk;            // rows of the sink's stacks (0: no sink)
  int row_channels;     // channels per row of the sink's stacks (num_k without a sink)
  int first;            // the call's first channel in a row (0 without a sink)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float divide(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.remainder on f32: fmod, then + b where the result and b differ in sign.
__device__ __forceinline__ float remainder(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod = add(mod, b);
  return mod;
}

// torch.remainder on int32 (Python's sign convention).
__device__ __forceinline__ int remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// int32 + 1 with torch's two's-complement wrap.
__device__ __forceinline__ int plus_one(int a) {
  return static_cast<int>(static_cast<unsigned>(a) + 1u);
}

// The last steps of torch's CUDA row reduction (a sum of W contiguous values
// per output, as its kernel takes it at these shapes; checked on the card
// for W = 10, 20, 40 and 1..1024 outputs): a warp per output, lane l has
// summed the values l, l + 32, l + 64, ... into four accumulators taken in
// turn and combined them in order; the lane sums combine by shuffles down by
// 16, 8, 4, 2, 1. Every lane gets lane 0's total.
__device__ __forceinline__ float warp_tree(float sum) {
  for (int offset = kLanes / 2; offset > 0; offset >>= 1) {
    sum = add(sum, __shfl_down_sync(kFull, sum, offset));
  }
  return __shfl_sync(kFull, sum, 0);
}

// An overlay sign, the table's entry at ms mod S, for a warp. A table of up
// to 32 signs is read a lane per sign, a load that does not wait for ms, and
// a shuffle picks the sign; a longer one is read at its index.
__device__ __forceinline__ float overlay_sign(const float* table, int len, int ms, int lane) {
  if (len <= kLanes) {
    const float mine = lane < len ? table[lane] : 0.0f;
    return __shfl_sync(kFull, mine, remainder(ms, len));
  }
  return table[remainder(ms, len)];
}

__device__ __forceinline__ float combine4(const float* acc) {
  return add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
}

// loop_filter.step for one channel: returns the control output, updates x1, x2.
__device__ __forceinline__ float filter_step(const Filter& f, int order, bool fll_on, float err,
                                             float fll, float t, float* x1, float* x2) {
  const float x1o = *x1, x2o = *x2;
  if (order == 1) return mul(err, f.g_out);
  if (order == 2) {
    float dx1 = mul(mul(err, f.g_x1), t);
    if (fll_on) dx1 = add(dx1, mul(mul(fll, f.f_x1), t));
    const float n1 = add(x1o, dx1);
    *x1 = n1;
    return add(mul(add(x1o, n1), 0.5f), mul(err, f.g_out));
  }
  float n2 = add(x2o, mul(mul(err, f.g_x2), t));
  float dx1 = mul(add(mul(add(x2o, n2), 0.5f), mul(err, f.g_x1)), t);
  if (fll_on) {
    n2 = add(n2, mul(mul(fll, f.f_x2), t));
    dx1 = add(dx1, mul(mul(fll, f.f_x1), t));
  }
  const float n1 = add(x1o, dx1);
  *x1 = n1;
  *x2 = n2;
  return add(mul(add(x1o, n1), 0.5f), mul(err, f.g_out));
}

// Phase 1 for channel k, by its warp: the wipe, the antenna sum and the
// window sums (lane l: tap l), the data prompt (dual), the ring-slot write
// and the window moments (lane w: slots w, w + 32, ...). Writes the window
// sums, the ring slot and the accumulators it outputs; hands the windowed
// prompt, early and late, the moments and the data prompt to phase 2 through
// shared memory (column col).
__device__ __forceinline__ void channel_sums(const Inputs& in, const State& old, const State& neu,
                                             const Outputs& out, const Constants& c,
                                             const Ints& n, int k, int col, int lane,
                                             long long acc_row, float (*win)[kTile],
                                             float (*mom)[kTile], float (*data)[kTile]) {
  const int K = n.num_k, A = n.num_ants, L = n.num_taps, W = n.window, AL = A * L;
  const int ms = old.ms_elapsed[k];
  const int index = old.cn0_index[k];
  const bool wipe = n.overlay_len > 0;
  const float sign = wipe ? overlay_sign(in.overlay, n.overlay_len, ms, lane) : 1.0f;
  const bool windowed = n.k_coh > 1;
  const bool boundary = windowed && remainder(plus_one(ms), n.k_coh) == 0;
  // The loop's accumulators: the channel's, or (dual) its pilot's.
  const long long base = static_cast<long long>(n.dual ? K + k : k) * AL;
  const long long own = static_cast<long long>(k) * AL;

  float b_re = 0.0f, b_im = 0.0f, v_re = 0.0f, v_im = 0.0f;
  if (lane < L) {
    const int l = lane;
    const float* wre = n.steered ? in.w_re + static_cast<long long>(k) * n.w_stride : nullptr;
    const float* wim = n.steered ? in.w_im + static_cast<long long>(k) * n.w_stride : nullptr;
    // torch's sum over the antenna axis: four accumulators (a mod 4) from 0,
    // combined in order (the loop unrolled by four keeps them in registers).
    float sr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, si[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int a0 = 0; a0 < A; a0 += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = a0 + j;
        if (a >= A) break;
        float xr = in.acc_re[base + a * L + l], xi = in.acc_im[base + a * L + l];
        if (wipe) {
          xr = mul(xr, sign);
          xi = mul(xi, sign);
        }
        if (n.dual) {        // the pilot in quadrature: rotate by -90 deg
          const float r = xr;
          xr = xi;
          xi = -r;
        }
        if (out.accum_re != nullptr) {
          out.accum_re[acc_row + own + a * L + l] = xr;
          out.accum_im[acc_row + own + a * L + l] = xi;
        }
        if (A == 1 && !n.steered) {
          b_re = xr;
          b_im = xi;
          continue;
        }
        float yr = xr, yi = xi;
        if (n.steered) {
          yr = add(mul(wre[a], xr), mul(wim[a], xi));
          yi = sub(mul(wre[a], xi), mul(wim[a], xr));
        }
        sr[j] = add(sr[j], yr);
        si[j] = add(si[j], yi);
      }
    }
    if (A > 1 || n.steered) {
      b_re = combine4(sr);
      b_im = combine4(si);
    }
    v_re = b_re;
    v_im = b_im;
    const long long at = static_cast<long long>(k) * L + l;
    if (windowed) {
      v_re = add(old.coh_re[at], b_re);
      v_im = add(old.coh_im[at], b_im);
    }
    neu.coh_re[at] = (windowed && !boundary) ? v_re : 0.0f;
    neu.coh_im[at] = (windowed && !boundary) ? v_im : 0.0f;
  }
  // The per-block beamformed prompt (C/N0), the windowed prompt, early (the
  // last tap) and late (the first).
  const float bp_re = __shfl_sync(kFull, b_re, n.prompt);
  const float bp_im = __shfl_sync(kFull, b_im, n.prompt);
  const float p_re = __shfl_sync(kFull, v_re, n.prompt);
  const float p_im = __shfl_sync(kFull, v_im, n.prompt);
  const float e_re = __shfl_sync(kFull, v_re, L - 1);
  const float e_im = __shfl_sync(kFull, v_im, L - 1);
  const float l_re = __shfl_sync(kFull, v_re, 0);
  const float l_im = __shfl_sync(kFull, v_im, 0);

  if (n.dual) {
    // The data prompt, overlay-wiped; over an antenna axis, torch's sum of
    // the strided [K, A] prompt view (its reduced axis the fastest).
    const float sd = overlay_sign(in.data_overlay, n.data_overlay_len, ms, lane);
    const long long at = own + n.prompt;
    float d_re, d_im;
    if (!n.antenna_axis) {
      d_re = mul(in.acc_re[at], sd);
      d_im = mul(in.acc_im[at], sd);
    } else {
      int width = 1;
      while (width * 2 <= A && width < kLanes) width *= 2;
      float dr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, di[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (lane < width) {
        for (int a0 = lane; a0 < A; a0 += 4 * width) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int a = a0 + j * width;
            if (a >= A) break;
            dr[j] = add(dr[j], mul(in.acc_re[at + a * L], sd));
            di[j] = add(di[j], mul(in.acc_im[at + a * L], sd));
          }
        }
      }
      d_re = combine4(dr);
      d_im = combine4(di);
      for (int offset = width / 2; offset > 0; offset >>= 1) {
        d_re = add(d_re, __shfl_down_sync(kFull, d_re, offset));
        d_im = add(d_im, __shfl_down_sync(kFull, d_im, offset));
      }
    }
    if (lane == 0) {
      data[0][col] = d_re;
      data[1][col] = d_im;
    }
  }

  // C/N0: the per-block prompt into its ring-buffer slot (in place: only the
  // slot changes), then M2M4 over the window, the lanes over its slots as
  // torch's row reduction takes them (warp_tree): the j-th slot of a lane
  // into accumulator j mod 4.
  const int slot = remainder(index, W);
  const bool ring_in_place = neu.cn0_re == old.cn0_re;
  const long long row0 = static_cast<long long>(k) * W;
  float acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int w0 = lane; w0 < W; w0 += 4 * kLanes) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + j * kLanes;
      if (w >= W) break;
      // Every slot is read (the load need not wait for the index), the
      // prompt's slot replaced.
      const float cr = old.cn0_re[row0 + w], ci = old.cn0_im[row0 + w];
      const bool here = w == slot;
      const float vr = here ? bp_re : cr;
      const float vi = here ? bp_im : ci;
      if (here || !ring_in_place) {
        neu.cn0_re[row0 + w] = vr;
        neu.cn0_im[row0 + w] = vi;
      }
      const float p2 = add(mul(vr, vr), mul(vi, vi));
      acc2[j] = add(acc2[j], p2);
      acc4[j] = add(acc4[j], mul(p2, p2));
    }
  }
  const float m2 = mul(warp_tree(combine4(acc2)), c.mean);
  const float m4 = mul(warp_tree(combine4(acc4)), c.mean);
  if (lane == 0) {
    win[0][col] = p_re;
    win[1][col] = p_im;
    win[2][col] = e_re;
    win[3][col] = e_im;
    win[4][col] = l_re;
    win[5][col] = l_im;
    mom[0][col] = m2;
    mom[1][col] = m4;
  }
}

__global__ void __launch_bounds__(kThreads)
loop_update_kernel(const Inputs in, const State old, const State neu, const Outputs out,
                   const Constants c, const Ints n) {
  __shared__ float win[6][kTile];   // windowed prompt, early, late (re, im)
  __shared__ float mom[2][kTile];   // the C/N0 window moments M2, M4
  __shared__ float data[2][kTile];  // dual: the data prompt

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int K = n.num_k;
  const int k0 = blockIdx.x * kTile;
  long long row = 0;
  if (in.row != nullptr) {
    row = *in.row;
    if (row < 0 || row >= n.chunk) __trap();
  }
  // [chunk, row_channels] and [chunk, row_channels, A, L] stacks, the call's
  // channel k at column first + k.
  const long long leaf_row = row * n.row_channels + n.first;
  const long long acc_row = leaf_row * n.num_ants * n.num_taps;

  // Warp 0 runs channel k0 + lane's chain in phase 2: its scalars are read
  // now, so the loads overlap phase 1.
  const int kc = k0 + lane;
  const bool chain = warp == 0 && lane < kTile && kc < K;
  float cd = 0.0f, cp = 0.0f, kd = 0.0f, kp = 0.0f, px1 = 0.0f, px2 = 0.0f, dx1 = 0.0f,
        dx2 = 0.0f, q_re = 0.0f, q_im = 0.0f;
  int ms = 0, index = 0;
  if (chain) {
    cd = old.carrier_doppler[kc];
    cp = old.carrier_phase[kc];
    kd = old.code_doppler[kc];
    kp = old.code_phase[kc];
    px1 = old.pll_x1[kc];
    px2 = old.pll_x2[kc];
    dx1 = old.dll_x1[kc];
    dx2 = old.dll_x2[kc];
    q_re = old.prev_re[kc];
    q_im = old.prev_im[kc];
    ms = old.ms_elapsed[kc];
    index = old.cn0_index[kc];
  }

  // Phase 1: a warp per channel.
  if (k0 + warp < K) {
    channel_sums(in, old, neu, out, c, n, k0 + warp, warp, lane, acc_row, win, mom,
                        data);
  }
  __syncthreads();

  if (chain) {
    // Phase 2, warp 0: the loop chain, a lane per channel.
    const int col = lane;
    const float p_re = win[0][col], p_im = win[1][col];
    const float e_re = win[2][col], e_im = win[3][col];
    const float l_re = win[4][col], l_im = win[5][col];
    const int k_coh = n.k_coh;
    const bool windowed = k_coh > 1;
    const bool boundary = windowed && remainder(plus_one(ms), k_coh) == 0;

    float pll_err;
    if (n.atan2_disc) {
      pll_err = mul(atan2f(p_im, p_re), c.inv_two_pi);
    } else {
      const float safe = p_re == 0.0f ? c.eps : p_re;
      pll_err = mul(atanf(divide(p_im, safe)), c.inv_two_pi);
    }
    const float e_env = __fsqrt_rn(add(mul(e_re, e_re), mul(e_im, e_im)));
    const float l_env = __fsqrt_rn(add(mul(l_re, l_re), mul(l_im, l_im)));
    float dll_err = mul(mul(divide(sub(e_env, l_env), clamp_min(add(e_env, l_env), c.eps)),
                            c.two_minus_d), c.inv_two);
    float fll_err = 0.0f;
    if (n.pll_fll) {
      const float cross = sub(mul(q_re, p_im), mul(q_im, p_re));
      const float dot = add(mul(q_re, p_re), mul(q_im, p_im));
      if (n.atan2_disc) {
        fll_err = mul(atan2f(cross, dot), c.inv_fll);
      } else {
        const float safe = fabsf(dot) < c.eps ? c.eps : dot;
        fll_err = mul(atanf(divide(cross, safe)), c.inv_fll);
      }
      if (!(ms >= k_coh)) fll_err = 0.0f;
    }

    // Filters and carrier aiding; inside a coherent window the old state holds.
    float n_px1 = px1, n_px2 = px2, n_dx1 = dx1, n_dx2 = dx2;
    const float doppler_cmd = filter_step(c.pll, n.pll_order, n.pll_fll != 0, pll_err, fll_err,
                                          c.t_coh, &n_px1, &n_px2);
    const float code_cmd = filter_step(c.dll, n.dll_order, false, dll_err, 0.0f, c.t_coh,
                                       &n_dx1, &n_dx2);
    float carrier_doppler = doppler_cmd;
    float code_doppler = add(code_cmd, mul(mul(doppler_cmd, c.aid_scale), c.inv_center));
    float prev_re = p_re, prev_im = p_im;
    if (windowed && !boundary) {
      n_px1 = px1;
      n_px2 = px2;
      n_dx1 = dx1;
      n_dx2 = dx2;
      carrier_doppler = cd;
      code_doppler = kd;
      prev_re = q_re;
      prev_im = q_im;
      pll_err = 0.0f;
      dll_err = 0.0f;
    }

    // NCO phases over the block just consumed, from the old Dopplers.
    const float carrier_freq = add(cd, c.intermediate_frequency);
    const float code_freq = add(kd, c.code_frequency);
    const float carrier_phase = remainder(add(cp, mul(mul(carrier_freq, c.two_pi), c.t)),
                                          c.two_pi);
    const float code_phase = remainder(add(kp, mul(code_freq, c.t)), c.code_length);

    neu.carrier_doppler[kc] = carrier_doppler;
    neu.carrier_phase[kc] = carrier_phase;
    neu.code_doppler[kc] = code_doppler;
    neu.code_phase[kc] = code_phase;
    neu.pll_x1[kc] = n_px1;
    neu.pll_x2[kc] = n_px2;
    neu.dll_x1[kc] = n_dx1;
    neu.dll_x2[kc] = n_dx2;
    neu.prev_re[kc] = prev_re;
    neu.prev_im[kc] = prev_im;
    neu.cn0_index[kc] = plus_one(index);
    neu.ms_elapsed[kc] = plus_one(ms);
    const long long at = leaf_row + kc;
    out.prompt_re[at] = p_re;
    out.prompt_im[at] = p_im;
    out.pll_error[at] = pll_err;
    out.dll_error[at] = dll_err;
    if (out.carrier_doppler != nullptr) {
      out.carrier_doppler[at] = carrier_doppler;
      out.code_doppler[at] = code_doppler;
      out.carrier_phase[at] = carrier_phase;
      out.code_phase[at] = code_phase;
    }
  } else if (warp == 1 && lane < kTile && kc < K) {
    // Phase 2, warp 1, beside the chain: the C/N0 tail and the data prompt.
    const int col = lane;
    const float m2 = mom[0][col], m4 = mom[1][col];
    const float pd = __fsqrt_rn(clamp_min(sub(mul(mul(m2, m2), 2.0f), m4), c.cn0_floor));
    const float pn = clamp_min(sub(m2, pd), c.cn0_floor);
    const float cn0 = divide(pd, mul(pn, c.t));
    const long long at = leaf_row + kc;
    out.cn0_dbhz[at] = mul(log10f(clamp_min(cn0, c.cn0_floor)), c.ten);
    if (n.dual) {
      out.data_re[at] = data[0][col];
      out.data_im[at] = data[1][col];
    }
  }
}

}  // namespace

// Launch the loop closure on `stream`. `pointers`: a host array of the
// Inputs, the old State, the new State and the Outputs pointers, in order;
// `constants` and `ints`: host arrays of the Constants and Ints fields in
// order. All are copied into the launch's parameters. Returns the CUDA error
// of the launch, or cudaErrorInvalidValue where a count does not match its
// structs or a parameter is outside what the kernel takes.
extern "C" int loop_update_launch(const void* const* pointers, int num_pointers,
                                  const float* constants, int num_constants, const int* ints,
                                  int num_ints, void* stream) {
  constexpr size_t kPointerBytes = sizeof(Inputs) + 2 * sizeof(State) + sizeof(Outputs);
  if (num_pointers * sizeof(void*) != kPointerBytes ||
      num_constants * sizeof(float) != sizeof(Constants) ||
      num_ints * sizeof(int) != sizeof(Ints)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in;
  State old, neu;
  Outputs out;
  Constants c;
  Ints n;
  const char* at = reinterpret_cast<const char*>(pointers);
  std::memcpy(&in, at, sizeof(Inputs));
  std::memcpy(&old, at + sizeof(Inputs), sizeof(State));
  std::memcpy(&neu, at + sizeof(Inputs) + sizeof(State), sizeof(State));
  std::memcpy(&out, at + sizeof(Inputs) + 2 * sizeof(State), sizeof(Outputs));
  std::memcpy(&c, constants, sizeof(Constants));
  std::memcpy(&n, ints, sizeof(Ints));
  if (n.num_k <= 0 || n.num_ants <= 0 || n.num_taps <= 0 || n.num_taps > kLanes ||
      n.window <= 0 || n.k_coh <= 0 || n.prompt < 0 || n.prompt >= n.num_taps ||
      (n.dual && n.data_overlay_len <= 0) || (in.row != nullptr && n.chunk <= 0) ||
      n.first < 0 || n.first + n.num_k > n.row_channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n.num_k + kTile - 1) / kTile;
  loop_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, old, neu,
                                                                                  out, c, n);
  return static_cast<int>(cudaGetLastError());
}
