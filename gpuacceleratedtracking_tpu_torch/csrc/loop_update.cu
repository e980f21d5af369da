// The loop closure of one tracking block, every channel in one launch, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of the XLA fusion of
// gpuacceleratedtracking_tpu/tracking/track.py::loop_update (:77-240) inside
// the JAX package's jit + lax.scan, where XLA fuses the closure's elementwise
// maths over [K] into a few loops per block. The port's plain version,
// tracking/track.py::loop_update_plain, is ~120 separate torch ops; this
// kernel computes what they compute, per channel k of the flattened leading
// axes:
//
//   overlay sign from ms_elapsed (Python remainder on int32) -> wiped
//   accumulators -> steered or plain antenna sum -> coherent-window sums and
//   the boundary select (coherent_blocks > 1) -> Costas or atan2 PLL, EMLE
//   DLL, atan or atan2 FLL gated by ms_elapsed >= k_coh -> 1st/2nd/3rd-order
//   filters, FLL assist on or off -> carrier aiding -> both NCO phase wraps
//   -> the C/N0 ring-buffer write and the M2M4 estimate.
//
// Rounding: written against the plain version op by op on the card. Every
// torch op is one explicitly rounded operation (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), so nothing is contracted into an FMA.
// Python-float constants arrive folded on the host as torch rounds them
// (double -> f32), and a torch division by a Python scalar is a multiply by
// the f32 reciprocal (torch's CUDA div_true does so), which arrives as such.
// Transcendentals are the CUDA functions torch's CUDA kernels call (atanf,
// atan2f, log10f). remainder is torch's: fmodf, then + b where the signs
// differ. The two reductions keep the order of torch's CUDA reduction
// kernel at these shapes: the antenna sum (A values per output, strided:
// four accumulators a mod 4, combined in order, so left to right for A <= 4)
// and the C/N0 window means (W contiguous values per output: a warp's lane
// sums, then its shuffle tree; warp_tree). Where a torch version orders them
// otherwise, cn0_dbhz (which feeds no state) and, for A > 1, the fields
// downstream of the antenna sum differ in their last bits.
//
// What bounds it on the H100: the launch and the closure's chain of
// dependent scalar ops (three transcendentals, four divisions, ~100 roundings
// per channel). At K=1024, A=1, L=3 and a 20-slot C/N0 window it moves
// 0.52 MB (state and outputs, the ring buffers most of it), 0.16 us at
// 3.35 TB/s, and does ~3 * 10^5 flops. A warp per channel, four per CTA:
// the lanes take the ring buffer's slots (coalesced, and the window means in
// torch's own order), every lane runs the scalar chain (no divergence) and
// lane 0 writes the per-channel leaves.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 32;                       // a warp per channel
constexpr int kChannels = kThreads / kLanes;     // channels per CTA

// Pointers, in the order of ops/loop_kernel.py::_INPUTS.
struct Inputs {
  const float* acc_re;          // [K, A, L]
  const float* acc_im;
  const float* w_re;            // [K or 1, A] steering weights, or null
  const float* w_im;
  const float* overlay;         // [S] overlay signs, or null
  const float* carrier_doppler; // [K]
  const float* carrier_phase;
  const float* code_doppler;
  const float* code_phase;
  const float* pll_x1;
  const float* pll_x2;
  const float* dll_x1;
  const float* dll_x2;
  const float* cn0_re;          // [K, W]
  const float* cn0_im;
  const int* cn0_index;         // [K]
  const int* ms_elapsed;        // [K]
  const float* prev_re;         // [K]
  const float* prev_im;
  const float* coh_re;          // [K, L]
  const float* coh_im;
};

// The output buffers, in the order of ops/loop_kernel.py::_OUTPUTS.
struct Outputs {
  float* channel;               // [15, K]: the per-channel leaves (ops/loop_kernel.py::_PER_CHANNEL)
  float* coh;                   // [2, K, L]: the window sums, re and im
  float* cn0;                   // [2, K, W]: the C/N0 ring buffers, re and im
  float* acc;                   // [2, K, A, L]: the wiped accumulators, or null (no overlay)
  int* ints;                    // [2, K]: the C/N0 prompt count and ms_elapsed
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
    sum = add(sum, __shfl_down_sync(0xffffffffu, sum, offset));
  }
  return __shfl_sync(0xffffffffu, sum, 0);
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

__global__ void __launch_bounds__(kThreads)
loop_update_kernel(const Inputs in, const Outputs out, const Constants c, const Ints n) {
  const int lane = threadIdx.x % kLanes;
  const int k = blockIdx.x * kChannels + threadIdx.x / kLanes;
  const int K = n.num_k;
  if (k >= K) return;   // the whole warp: k is the warp's
  const int A = n.num_ants, L = n.num_taps, W = n.window, AL = A * L;

  float* o_carrier_doppler = out.channel;
  float* o_carrier_phase = out.channel + K;
  float* o_code_doppler = out.channel + 2 * K;
  float* o_code_phase = out.channel + 3 * K;
  float* o_pll_x1 = out.channel + 4 * K;
  float* o_pll_x2 = out.channel + 5 * K;
  float* o_dll_x1 = out.channel + 6 * K;
  float* o_dll_x2 = out.channel + 7 * K;
  float* o_prev_re = out.channel + 8 * K;
  float* o_prev_im = out.channel + 9 * K;
  float* o_prompt_re = out.channel + 10 * K;
  float* o_prompt_im = out.channel + 11 * K;
  float* o_pll_error = out.channel + 12 * K;
  float* o_dll_error = out.channel + 13 * K;
  float* o_cn0_dbhz = out.channel + 14 * K;
  float* o_coh_re = out.coh;
  float* o_coh_im = out.coh + K * L;
  float* o_cn0_re = out.cn0;
  float* o_cn0_im = out.cn0 + K * W;
  float* o_acc_re = out.acc;
  float* o_acc_im = out.acc + K * AL;
  int* o_cn0_index = out.ints;
  int* o_ms_elapsed = out.ints + K;

  const int ms = in.ms_elapsed[k];
  const float* are = in.acc_re + static_cast<size_t>(k) * AL;
  const float* aim = in.acc_im + static_cast<size_t>(k) * AL;
  const float* wre = n.steered ? in.w_re + static_cast<size_t>(k) * n.w_stride : nullptr;
  const float* wim = n.steered ? in.w_im + static_cast<size_t>(k) * n.w_stride : nullptr;
  const bool wipe = n.overlay_len > 0;
  const float sign = wipe ? in.overlay[remainder(ms, n.overlay_len)] : 1.0f;

  const int k_coh = n.k_coh;
  const bool windowed = k_coh > 1;
  const bool boundary = windowed && remainder(plus_one(ms), k_coh) == 0;

  // Per tap: wipe, antenna sum, coherent window. Keep the prompt (per block
  // and windowed) and the windowed early (last tap) and late (first tap).
  float bp_re = 0.0f, bp_im = 0.0f;      // per-block beamformed prompt (C/N0)
  float p_re = 0.0f, p_im = 0.0f;        // windowed prompt
  float e_re = 0.0f, e_im = 0.0f, l_re = 0.0f, l_im = 0.0f;
  for (int l = 0; l < L; ++l) {
    // torch's sum over the antenna axis: four accumulators (a mod 4) from 0,
    // combined in order.
    float sr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, si[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float b_re = 0.0f, b_im = 0.0f;
    for (int a = 0; a < A; ++a) {
      float xr = are[a * L + l], xi = aim[a * L + l];
      if (wipe) {
        xr = mul(xr, sign);
        xi = mul(xi, sign);
        if ((a * L + l) % kLanes == lane) {
          o_acc_re[static_cast<size_t>(k) * AL + a * L + l] = xr;
          o_acc_im[static_cast<size_t>(k) * AL + a * L + l] = xi;
        }
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
      sr[a & 3] = add(sr[a & 3], yr);
      si[a & 3] = add(si[a & 3], yi);
    }
    if (A > 1 || n.steered) {
      b_re = add(add(add(sr[0], sr[1]), sr[2]), sr[3]);
      b_im = add(add(add(si[0], si[1]), si[2]), si[3]);
    }
    float v_re = b_re, v_im = b_im;
    if (windowed) {
      v_re = add(in.coh_re[static_cast<size_t>(k) * L + l], b_re);
      v_im = add(in.coh_im[static_cast<size_t>(k) * L + l], b_im);
    }
    if (l % kLanes == lane) {
      o_coh_re[static_cast<size_t>(k) * L + l] = (windowed && !boundary) ? v_re : 0.0f;
      o_coh_im[static_cast<size_t>(k) * L + l] = (windowed && !boundary) ? v_im : 0.0f;
    }
    if (l == n.prompt) {
      bp_re = b_re;
      bp_im = b_im;
      p_re = v_re;
      p_im = v_im;
    }
    if (l == 0) {
      l_re = v_re;
      l_im = v_im;
    }
    if (l == L - 1) {
      e_re = v_re;
      e_im = v_im;
    }
  }

  // Discriminators.
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
    const float q_re = in.prev_re[k], q_im = in.prev_im[k];
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

  // Filters and carrier aiding.
  float px1 = in.pll_x1[k], px2 = in.pll_x2[k];
  float dx1 = in.dll_x1[k], dx2 = in.dll_x2[k];
  const float doppler_cmd = filter_step(c.pll, n.pll_order, n.pll_fll != 0, pll_err, fll_err,
                                        c.t_coh, &px1, &px2);
  const float code_cmd = filter_step(c.dll, n.dll_order, false, dll_err, 0.0f, c.t_coh,
                                     &dx1, &dx2);
  float carrier_doppler = doppler_cmd;
  float code_doppler = add(code_cmd, mul(mul(doppler_cmd, c.aid_scale), c.inv_center));
  float prev_re = p_re, prev_im = p_im;
  if (windowed && !boundary) {
    px1 = in.pll_x1[k];
    px2 = in.pll_x2[k];
    dx1 = in.dll_x1[k];
    dx2 = in.dll_x2[k];
    carrier_doppler = in.carrier_doppler[k];
    code_doppler = in.code_doppler[k];
    prev_re = in.prev_re[k];
    prev_im = in.prev_im[k];
    pll_err = 0.0f;
    dll_err = 0.0f;
  }

  // NCO phases over the block just consumed, from the old Dopplers.
  const float carrier_freq = add(in.carrier_doppler[k], c.intermediate_frequency);
  const float code_freq = add(in.code_doppler[k], c.code_frequency);
  const float carrier_phase = remainder(
      add(in.carrier_phase[k], mul(mul(carrier_freq, c.two_pi), c.t)), c.two_pi);
  const float code_phase = remainder(
      add(in.code_phase[k], mul(code_freq, c.t)), c.code_length);

  // C/N0: the per-block prompt into its ring-buffer slot, then M2M4 over the
  // window, the warp's lanes over its slots as torch's row reduction takes
  // them (warp_tree): the j-th slot of a lane into accumulator j mod 4.
  const int index = in.cn0_index[k];
  const int slot = remainder(index, W);
  const float* cre = in.cn0_re + static_cast<size_t>(k) * W;
  const float* cim = in.cn0_im + static_cast<size_t>(k) * W;
  float* ore = o_cn0_re + static_cast<size_t>(k) * W;
  float* oim = o_cn0_im + static_cast<size_t>(k) * W;
  float acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int w = lane, j = 0; w < W; w += kLanes, j = (j + 1) & 3) {
    const float vr = w == slot ? bp_re : cre[w];
    const float vi = w == slot ? bp_im : cim[w];
    ore[w] = vr;
    oim[w] = vi;
    const float p2 = add(mul(vr, vr), mul(vi, vi));
    acc2[j] = add(acc2[j], p2);
    acc4[j] = add(acc4[j], mul(p2, p2));
  }
  const float m2 = mul(warp_tree(combine4(acc2)), c.mean);
  const float m4 = mul(warp_tree(combine4(acc4)), c.mean);
  const float pd = __fsqrt_rn(clamp_min(sub(mul(mul(m2, m2), 2.0f), m4), c.cn0_floor));
  const float pn = clamp_min(sub(m2, pd), c.cn0_floor);
  const float cn0 = divide(pd, mul(pn, c.t));
  const float cn0_dbhz = mul(log10f(clamp_min(cn0, c.cn0_floor)), c.ten);

  if (lane != 0) return;
  o_carrier_doppler[k] = carrier_doppler;
  o_carrier_phase[k] = carrier_phase;
  o_code_doppler[k] = code_doppler;
  o_code_phase[k] = code_phase;
  o_pll_x1[k] = px1;
  o_pll_x2[k] = px2;
  o_dll_x1[k] = dx1;
  o_dll_x2[k] = dx2;
  o_prev_re[k] = prev_re;
  o_prev_im[k] = prev_im;
  o_prompt_re[k] = p_re;
  o_prompt_im[k] = p_im;
  o_pll_error[k] = pll_err;
  o_dll_error[k] = dll_err;
  o_cn0_dbhz[k] = cn0_dbhz;
  o_cn0_index[k] = plus_one(index);
  o_ms_elapsed[k] = plus_one(ms);
}

}  // namespace

// Launch the loop closure on `stream`. `inputs` and `outputs`: host arrays
// of the Inputs and Outputs pointers in order; `constants` and `ints`: host
// arrays of the Constants and Ints fields in order. All four are copied into
// the launch's parameters. Returns the CUDA error of the launch, or
// cudaErrorInvalidValue where an array's count does not match its struct.
extern "C" int loop_update_launch(const void* const* inputs, int num_inputs,
                                  const void* const* outputs, int num_outputs,
                                  const float* constants, int num_constants, const int* ints,
                                  int num_ints, void* stream) {
  if (num_inputs * sizeof(void*) != sizeof(Inputs) ||
      num_outputs * sizeof(void*) != sizeof(Outputs) ||
      num_constants * sizeof(float) != sizeof(Constants) ||
      num_ints * sizeof(int) != sizeof(Ints)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in;
  Outputs out;
  Constants c;
  Ints n;
  std::memcpy(&in, inputs, sizeof(Inputs));
  std::memcpy(&out, outputs, sizeof(Outputs));
  std::memcpy(&c, constants, sizeof(Constants));
  std::memcpy(&n, ints, sizeof(Ints));
  if (n.num_k <= 0 || n.num_ants <= 0 || n.num_taps <= 0 || n.window <= 0 || n.k_coh <= 0 ||
      n.prompt < 0 || n.prompt >= n.num_taps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n.num_k + kChannels - 1) / kChannels;
  loop_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, c, n);
  return static_cast<int>(cudaGetLastError());
}
