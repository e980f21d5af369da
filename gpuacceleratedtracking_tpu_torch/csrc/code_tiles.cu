// The bank kernels' packed code columns, in one launch, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX track_bank derives its channels' code
// tiles inside its jitted call (tracking/track.py:339-344 calls
// pallas_epl.py::prepare_bank_code_tiles_rows, :1258), where XLA fuses the
// gather and the packing into the compiled program. The port's plain
// version, ops/epl_kernels.py::prepare_bank_code_tiles_rows, packs the P
// columns of the table once and gathers each channel's words by its PRN;
// this kernel is its counterpart on the card, bit for bit:
//
//   out[k, w] bit b = (column of channel k)[32 w + b] < 0,   b < 32
//
// for K channels of one [Lc, P] table, or, for the GPS L5 dual bank, 2 K0
// channels of two tables (data channels first, then pilot, channel k of
// table k / K0 reading PRN prn[k mod K0]): the words of
// prepare_bank_code_tiles_rows on the joined table and PRNs, without the
// join. A chip other than +/-1 in a column that a channel reads fails a
// device-side assert, as the plain version's _check_chips does on the card
// (inside a captured program too), and so does a PRN outside [0, P); a bad
// chip in a column no channel reads does not. With an `index` (a tracking
// call's block index, an int64 on the card), thread 0 of CTA 0 sets it to
// 0, so that a call's captured prologue is this one launch.
//
// What bounds it on the H100: the launch and the latency of one round trip
// of loads, not bytes or operations. It reads the used columns of the table
// (130 KB for 32 GPS L1 PRNs) and writes K x ceil(Lc / 32) words (128 KB at
// K=1024): ~0.08 us at 3.35 TB/s, against ~2.9-3.2 us of its own run at
// K=1024 GPS L1 (torch.profiler), of which ~1.1 us is what a one-element
// add takes (PERF.md).
//
// Design (the work split is ops/epl_kernels.py::tiles_split's, passed in):
// CTA (x, y, z) takes `chunk` words of every column of table z, the x-th
// chunk, and `channels` channels of that table, the y-th.
// - Pack once per column, not per channel: the chunk's 32 chunk rows of the
//   table are contiguous, so thread 0 stages them into shared memory with
//   one bulk copy (the TMA, completing on an mbarrier; a tail short of 16
//   bytes, or a table that is not 16-byte aligned, by plain loads), while
//   the other threads load their channels' PRNs. Then one (word, column)
//   pair a thread packs its 32 chips from shared memory, columns fastest.
//   A CTA reads 1 / (words / chunk) of the table (18.9 KB for GPS L1), and
//   no load's address waits on another load.
// - Coalesced stores: a thread copies one 16-byte vector of its channel's
//   chunk (one word where the rows are not 16-byte aligned) out of shared
//   memory, words fastest: each store is 16 contiguous bytes of a row (at
//   GLONASS, 4 lanes write a whole 64-byte row).
// - A CTA copies as many channels as it has threads for one store each (256
//   at GPS L1): 8 x 4 CTAs at K=1024. Each channel chunk stages its rows
//   anew, from L2; more, smaller channel chunks measured no faster.
// - The chip check rides on the copy: the packing marks a (word, column)
//   pair with a chip other than +/-1, and a thread asserts on the marks of
//   the words it copies, so only columns that a channel reads are checked.

#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShared = 48 << 10;   // bytes of shared memory a CTA takes without an opt-in

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
code_tiles_kernel(const float* __restrict__ table0,   // [Lc, P0]
                  const float* __restrict__ table1,   // [Lc, P1] (channels K0..2 K0), or table0
                  const void* __restrict__ prn,       // [K0] int32 or int64
                  unsigned* __restrict__ out,         // [tables * K0, words]
                  long long* __restrict__ index,      // set to 0, or null
                  int prn_is64, int num_k0, int code_length, int num_prns0, int num_prns1,
                  int words, int chunk, int channels) {
  extern __shared__ uint4 shared[];
  __shared__ unsigned long long staged;   // the mbarrier of the bulk copy
  const int table_id = blockIdx.z;
  const int num_prns = table_id ? num_prns1 : num_prns0;
  const int w0 = blockIdx.x * chunk;
  const int rows = min(32 * chunk, code_length - 32 * w0);
  const int n = rows * num_prns;
  const float* src = (table_id ? table1 : table0) + static_cast<size_t>(32 * w0) * num_prns;
  // [rows, num_prns] chips, then [num_prns, chunk] packed words, then as
  // many bytes: 1 where a chip of that word is not +/-1.
  float* stage = reinterpret_cast<float*>(shared);
  unsigned* packed = reinterpret_cast<unsigned*>(stage + (32 * chunk * num_prns + 3) / 4 * 4);
  unsigned char* bad = reinterpret_cast<unsigned char*>(packed + num_prns * chunk);
  // The chunk's rows into shared memory: one bulk copy of their 16-byte
  // multiple from a 16-byte aligned table, the rest by plain loads.
  const int bulk = (reinterpret_cast<size_t>(src) & 15) == 0 ? n & ~3 : 0;
  if (threadIdx.x == 0) {
    if (index != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) *index = 0;
    if (bulk > 0) {
      const unsigned bar = shared_address(&staged);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(bulk * 4) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                   "[%0], [%1], %2, [%3];\n"
                   ::"r"(shared_address(stage)), "l"(src), "r"(bulk * 4), "r"(bar) : "memory");
    }
  }
  // The copy's channel s and vector v of this thread; its PRN.
  const int vecs = chunk / kVec;
  const int s = blockIdx.y * channels + threadIdx.x / vecs;
  const int v = threadIdx.x - (threadIdx.x / vecs) * vecs;
  const bool copies = threadIdx.x < channels * vecs && s < num_k0 && w0 + v * kVec < words;
  long long p = 0;
  if (copies) {
    p = prn_is64 ? static_cast<const long long*>(prn)[s] : static_cast<const int*>(prn)[s];
  }
  for (int i = bulk + threadIdx.x; i < n; i += kThreads) stage[i] = src[i];
  __syncthreads();   // the mbarrier's init and the plain loads, seen by every thread
  if (bulk > 0) {
    const unsigned bar = shared_address(&staged);
    unsigned done = 0;
    while (!done) {
      asm volatile("{\n .reg .pred p;\n"
                   " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   " selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(bar) : "memory");
    }
  }
  // Pack: one (word, column) pair a thread, columns fastest (conflict-free
  // reads of a chip row), chips past the code +1 (bit 0).
  for (int i = threadIdx.x; i < num_prns * chunk; i += kThreads) {
    const int w = i / num_prns;
    const int q = i - w * num_prns;
    unsigned word = 0;
    bool ok = true;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const float chip = 32 * w + b < rows ? stage[(32 * w + b) * num_prns + q] : 1.0f;
      ok &= (chip == 1.0f) | (chip == -1.0f);
      word |= static_cast<unsigned>(chip < 0.0f) << b;
    }
    packed[q * chunk + w] = word;
    bad[q * chunk + w] = !ok;
  }
  __syncthreads();
  if (!copies) return;
  assert(p >= 0 && p < num_prns && "a PRN outside the code table");
  const int at = static_cast<int>(p) * chunk + v * kVec;
  unsigned* dst = out + (static_cast<size_t>(table_id) * num_k0 + s) * words + w0 + v * kVec;
  if constexpr (kVec == 4) {
    assert(*reinterpret_cast<const unsigned*>(bad + at) == 0 &&
           "bank code tables hold +/-1 chips only");
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed + at);
  } else {
    assert(bad[at] == 0 && "bank code tables hold +/-1 chips only");
    *dst = packed[at];
  }
}

}  // namespace

// Pack the code columns of `num_tables` x `num_k0` channels (`num_k0`
// PRNs; a second table for the dual bank's pilot channels) into `out`
// ([num_tables * num_k0, ceil(code_length / 32)] words), and set `index`
// (if not null) to 0, on `stream`, under the work split (`vec` 4: 16-byte
// stores, `out` 16-byte aligned and the words per row a multiple of 4; else
// 1; `chunk` words and `channels` channels per CTA). Returns the launch's
// CUDA error.
extern "C" int code_tiles_launch(const float* table0, const float* table1, const void* prn,
                                 int* out, long long* index, int prn_is64, int num_k0,
                                 int num_tables, int code_length, int num_prns0, int num_prns1,
                                 int vec, int chunk, int channels, void* stream) {
  const int words = (code_length + 31) / 32;
  const int num_prns = num_prns0 > num_prns1 ? num_prns0 : num_prns1;
  if (num_k0 < 1 || num_tables < 1 || num_tables > 2 || code_length < 1 || num_prns0 < 1 ||
      num_prns1 < 1 || (vec != 1 && vec != 4) || chunk < vec || chunk % vec != 0 ||
      channels < 1 || static_cast<long long>(channels) * (chunk / vec) > kThreads ||
      (vec == 4 && (words % 4 != 0 || reinterpret_cast<size_t>(out) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long shared = 4LL * ((32LL * chunk * num_prns + 3) / 4 * 4) + 5LL * num_prns * chunk;
  const long long chunks_y = (num_k0 + channels - 1) / channels;
  if (shared > kMaxShared || chunks_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((words + chunk - 1) / chunk, static_cast<unsigned>(chunks_y), num_tables);
  const size_t bytes = (static_cast<size_t>(shared) + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t1 = table1 == nullptr ? table0 : table1;
  unsigned* o = reinterpret_cast<unsigned*>(out);
  if (vec == 4) {
    code_tiles_kernel<4><<<grid, kThreads, bytes, s>>>(table0, t1, prn, o, index, prn_is64,
                                                       num_k0, code_length, num_prns0,
                                                       num_prns1, words, chunk, channels);
  } else {
    code_tiles_kernel<1><<<grid, kThreads, bytes, s>>>(table0, t1, prn, o, index, prn_is64,
                                                       num_k0, code_length, num_prns0,
                                                       num_prns1, words, chunk, channels);
  }
  return static_cast<int>(cudaGetLastError());
}
