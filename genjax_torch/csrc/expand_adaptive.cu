// Systematic-resampling expansion, for Hopper:
//
//   out[j] = leaf[i(j)],  i(j) = the first i with counts_cum[i] > j,
//
// for j < n: repeat(leaf, diff(counts_cum)) with the total fixed at n, bit
// for bit, for one 1-D leaf of 4-byte elements (n_src == n).
//
// Replaces genjax_tpu/ops/expand_adaptive.py::expand_adaptive (body
// _kernel). The TPU kernel compacts the source rows, gives each 128-dest
// block a data-dependent while over 2-row windows, and contracts the
// values with an integer suffix-difference telescope: all of that serves
// the VPU's cost model and none of it is ported.
//
// Here the expansion is a merge path (a load-balanced search). Merge the n
// source ends A = counts_cum[0..n) with the n destinations B = 0..n-1, a
// source before a destination on ties (counts_cum[i] <= j): when
// destination j comes up, the sources already passed are exactly those
// with counts_cum[i] <= j, so their number is i(j). The merged sequence
// of 2n items is cut into equal tiles of kTile items, one a block:
//   1. two warps find where the tile's first and last diagonals cross the
//      merge, each by a 32-way search in global memory (every lane probes
//      the end of one of 32 equal parts of the range and the ballot's
//      count narrows it 32-fold: 4 dependent rounds at n = 2^20 and 5 at
//      2^24, where a binary search takes 21 and 25);
//   2. the block stages its window of counts_cum into shared memory with
//      coalesced loads;
//   3. each thread binary-searches its own diagonal in shared memory and
//      merges kItems items serially, without branches, copying leaf[i]
//      from global memory (a thread's sources are consecutive, so a warp's
//      reads share lines; a tile's last destinations may belong to the
//      source after its window) to a staged output as a 4-byte integer
//      (so that -0.0 and NaN payloads survive);
//   4. the block writes its destinations, a contiguous run, coalesced.
// A tile holds kTile items whatever the counts, so no block does more than
// its share: a source with n offspring, or 2^20 - 1 sources with none, cost
// no block more than its tile. Any n: the last tile is ragged. counts_cum
// must be nondecreasing with counts_cum[n-1] == n, so that every i(j) < n;
// the leaf index is clamped to n - 1 all the same.
//
// What bounds it on the card: bytes. It must read the n int32 counts and
// the n leaf words once and write n words, 12 bytes a destination: 12.6 MB
// at n = 2^20, 3.8 us at 3.35 TB/s. The kernel reads each of them once
// (plus the search's few probes a block) and keeps the merge in shared
// memory, where the one-thread-a-destination search it replaces made ~20
// dependent L2 round trips a thread. What remains is latency: each block
// runs its search, its staging, its merge and its stores in turn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

// The number of sources among the first `diag` merged items: the first a
// in [max(0, diag - n), min(diag, n)] whose source does not come before
// destination diag - 1 - a. Called by a whole warp.
__device__ long long warp_split(const int32_t* __restrict__ cc, long long n,
                                long long diag) {
  const int lane = threadIdx.x & 31;
  long long lo = diag > n ? diag - n : 0;
  long long hi = diag < n ? diag : n;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + (lane + 1) * step - 1;
    const bool src_first = q < hi && (long long)cc[q] <= diag - 1 - q;
    const long long k = __popc(__ballot_sync(kFull, src_first));
    const long long top = lo + (k + 1) * step - 1;
    lo = lo + k * step < hi ? lo + k * step : hi;
    hi = top < hi ? top : hi;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand(const int32_t* __restrict__ leaf, const int32_t* __restrict__ cc,
       long long n, int32_t* __restrict__ out) {
  __shared__ int32_t s_cc[kTile + 1];
  __shared__ int32_t s_out[kTile];
  __shared__ long long s_split[2];
  const long long d0 = (long long)blockIdx.x * kTile;
  const long long d1 = d0 + kTile < 2 * n ? d0 + kTile : 2 * n;

  // 1. The splits of the tile's two diagonals.
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long a = warp_split(cc, n, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) s_split[warp] = a;
  }
  __syncthreads();
  const long long a0 = s_split[0];
  const int na = (int)(s_split[1] - a0);
  const int nb = (int)(d1 - d0) - na;
  const int b0 = (int)(d0 - a0);  // < n < 2^31

  // 2. The window counts_cum[a0, a1), with a sentinel above every
  // destination at na.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = j * kThreads + threadIdx.x;
    if (k < na) s_cc[k] = cc[a0 + k];
  }
  if (threadIdx.x == 0) s_cc[na] = INT32_MAX;
  __syncthreads();

  // 3. This thread's diagonal of the tile's merge, then kItems steps of it.
  const int total = na + nb;
  const int dg = (int)threadIdx.x * kItems < total ? (int)threadIdx.x * kItems
                                                   : total;
  int a_lo = dg > nb ? dg - nb : 0;
  int a_hi = dg < na ? dg : na;
  while (a_lo < a_hi) {
    const int mid = (a_lo + a_hi) >> 1;
    if (s_cc[mid] <= b0 + (dg - 1 - mid)) a_lo = mid + 1;
    else a_hi = mid;
  }
  int a = a_lo, b = dg - a_lo;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (dg + k < total) {
      // A source comes first while its end is <= the next destination;
      // the sentinel stops the sources at na, and b < nb on every
      // destination step because the tile holds exactly nb of them.
      const bool take_src = b >= nb || s_cc[a] <= b0 + b;
      if (!take_src) s_out[b] = leaf[a0 + a < n ? a0 + a : n - 1];
      a += take_src;
      b += !take_src;
    }
  }
  __syncthreads();

  // 4. The tile's destinations [b0, b0 + nb), coalesced.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = j * kThreads + threadIdx.x;
    if (k < nb) out[b0 + k] = s_out[k];
  }
}

}  // namespace

extern "C" {

// leaf: 4-byte words[n]; counts_cum: int32[n], nondecreasing, last == n;
// out: 4-byte words[n]. All on the device. Launches on `stream` and
// returns cudaGetLastError().
int expand_adaptive_launch(const int32_t* leaf, const int32_t* counts_cum,
                           int32_t* out, long long n, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (2 * n + kTile - 1) / kTile;
  expand<<<(unsigned)blocks, kThreads, 0, s>>>(leaf, counts_cum, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
