// The bank kernels' packed code columns, in one launch, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX track_bank derives its channels' code
// tiles inside its jitted call (tracking/track.py:339-344 calls
// pallas_epl.py::prepare_bank_code_tiles_rows, :1258), where XLA fuses the
// gather and the packing into the compiled program. The port's plain
// version, ops/epl_kernels.py::prepare_bank_code_tiles_rows, is ~14 small
// torch ops; this kernel is its counterpart on the card, bit for bit:
//
//   out[k, w] bit b = (column of channel k)[32 w + b] < 0,   b < 32
//
// for K channels of one [Lc, P] table, or, for the GPS L5 dual bank, 2 K0
// channels of two tables (data channels first, then pilot, channel k of
// table k / K0 reading PRN prn[k mod K0]): the words of
// prepare_bank_code_tiles_rows on the joined table and PRNs, without the
// join. A chip other than +/-1 fails a device-side assert, as the plain
// version's _check_chips does on the card (inside a captured program too),
// and so does a PRN outside [0, P).
//
// What bounds it on the H100: the launch and the latency of its loads, not
// bytes or operations. It reads the table (130 KB for 32 GPS L1 PRNs) and
// writes K x ceil(Lc / 32) words (128 KB at K=1024): ~0.08 us at 3.35 TB/s,
// against ~4.6 us of device time at K=1024 (chip_smoke.py phase 3e, H100
// 80GB HBM3 at 700 W), once per tracking call.
//
// Design: one thread per output word, channels fastest, so the lanes of a
// warp read one chip row of the table (P consecutive floats) per load: each
// of a thread's 32 loads is a few sectors for the warp, all from L2 after
// the first touch, and all 32 are in flight at once (the launch is ~32 K
// threads at K=1024, a quarter of the card's: latency, not bandwidth, is
// what a thread waits on).

#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
code_tiles_kernel(const float* __restrict__ table0,   // [Lc, P0]
                  const float* __restrict__ table1,   // [Lc, P1] (channels K0..2 K0), or table0
                  const void* __restrict__ prn,       // [K0] int32 or int64
                  unsigned* __restrict__ out,         // [K, words]
                  int prn_is64, int num_k0, int num_k, int code_length, int num_prns0,
                  int num_prns1, int words) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(num_k) * words) return;
  const int w = static_cast<int>(i / num_k);
  const int k = static_cast<int>(i - static_cast<long long>(w) * num_k);
  const int t = k / num_k0;
  const int s = k - t * num_k0;
  const long long p = prn_is64 ? static_cast<const long long*>(prn)[s]
                               : static_cast<const int*>(prn)[s];
  const int num_prns = t ? num_prns1 : num_prns0;
  assert(p >= 0 && p < num_prns && "a PRN outside the code table");
  const float* col = (t ? table1 : table0) + p;
  // All 32 loads issued before any is used: one memory round trip a thread.
  const int c0 = 32 * w;
  float chips[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    chips[b] = c0 + b < code_length ? col[static_cast<size_t>(c0 + b) * num_prns] : 1.0f;
  }
  unsigned word = 0;
  bool ok = true;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    ok = ok && (chips[b] == 1.0f || chips[b] == -1.0f);
    word |= static_cast<unsigned>(chips[b] < 0.0f) << b;
  }
  assert(ok && "bank code tables hold +/-1 chips only");
  out[static_cast<size_t>(k) * words + w] = word;
}

}  // namespace

// Pack the code columns of `num_k` channels (`num_k0` PRNs; num_k is num_k0
// for one table, 2 num_k0 with a pilot table) on `stream`. Returns the
// launch's CUDA error.
extern "C" int code_tiles_launch(const float* table0, const float* table1, const void* prn,
                                 int* out, int prn_is64, int num_k0, int num_k,
                                 int code_length, int num_prns0, int num_prns1, void* stream) {
  if (num_k0 < 1 || num_k < 1 || num_k % num_k0 != 0 || num_k / num_k0 > 2 ||
      code_length < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (code_length + 31) / 32;
  const long long total = static_cast<long long>(num_k) * words;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  code_tiles_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table0, table1 == nullptr ? table0 : table1, prn, reinterpret_cast<unsigned*>(out),
      prn_is64, num_k0, num_k, code_length, num_prns0, num_prns1, words);
  return static_cast<int>(cudaGetLastError());
}
