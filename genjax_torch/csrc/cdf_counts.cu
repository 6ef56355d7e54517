// Systematic-resampling CDF -> cumulative offspring counts, for Hopper.
//
// Replaces genjax_tpu/ops/cdf_counts.py::systematic_cumulative_pallas
// (body _cdf_counts_kernel). For log-weights lw[0..n), m = max(lw),
// scale = n_dest / sum(exp(lw - m)) and u0 = uniform(key, ()), it writes
//
//   cum[i]  = prefix max over j <= i of (prefix sum of exp(lw - m))[j]
//   out[i]  = clamp(ceil(cum[i] * scale - u0), 0, n_dest)   (int32)
//   out[n-1] = n_dest
//
// (n_dest, the number of destinations, is n when the ensemble keeps its
// size.) m comes from the caller as a device scalar; the normalizer is the
// total of pass 2, and u0 is drawn here from the key's two words exactly
// as jax.random.uniform(key, ()) draws it (threefry2x32 of counter (0, 0),
// the xor of the two words, the top 23 bits as a mantissa in [1, 2),
// minus one), so that no host-side key arithmetic precedes the launch.
//
// The TPU kernel carries a running (sum, max) pair across a sequential
// grid. CUDA blocks run in no order, so both halves of that carry become
// passes of their own (no atomics: every sum is taken in one fixed order,
// so the result does not change from run to run):
//   1. block_sums     each block sums exp(lw - m) over its tile;
//   2. scan_blocks    one block turns the block sums into exclusive offsets
//                     and the total;
//   3. block_max      each block scans its tile plus its offset and keeps
//                     the largest prefix value;
//   4. scan_blocks    one block turns the block maxima into exclusive
//                     prefix maxima;
//   5. emit           each block recomputes the same prefix sums, lifts them
//                     by its prefix maximum (the exact monotone repair: the
//                     offset add can round below the previous block's last
//                     value) and writes the clamped counts.
// The prefix maximum is exact in floating point, so the counts are
// nondecreasing, end at n_dest and sum to n_dest in every weight regime.
// Any n: the ragged last tile is masked.
//
// What bounds it on the card: bytes. At n = 2^20 passes 1, 3 and 5 each
// read the 4 MB of log-weights and pass 5 writes 4 MB of counts, about
// 16 MB in all against 3.35 TB/s (some 5 us); the rest is five launches.
// Each block takes a 4096-element tile (1024 threads x 4), staged through
// shared memory so that every global load and store is coalesced.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

struct Sum {
  __device__ static float id() { return 0.0f; }
  __device__ static float op(float a, float b) { return a + b; }
};

struct Max {
  __device__ static float id() { return 0.0f; }  // every prefix sum is >= 0
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// jax.random.uniform(key, ()) for float32, from the key's two words.
__device__ float uniform_from_key(const int64_t* key) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = ks[0], x1 = ks[1];  // counter (0, 0) plus the key
  for (int g = 0; g < 5; ++g) {
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

// Exclusive scan of one value per thread over the whole block, in a fixed
// order. `total` receives the block's inclusive total.
template <class Op>
__device__ float block_exclusive_scan(float v, float* warp_buf, float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    float t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = Op::op(t, incl);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = Op::id();
  if (lane == 31) warp_buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = warp_buf[lane];
    float wincl = w;
    for (int o = 1; o < 32; o <<= 1) {
      float t = __shfl_up_sync(kFull, wincl, o);
      if (lane >= o) wincl = Op::op(t, wincl);
    }
    float wexcl = __shfl_up_sync(kFull, wincl, 1);
    if (lane == 0) wexcl = Op::id();
    warp_buf[lane] = wexcl;
    if (lane == 31) warp_buf[32] = wincl;
  }
  __syncthreads();
  float out = warp == 0 ? excl : Op::op(warp_buf[warp], excl);
  *total = warp_buf[32];
  __syncthreads();
  return out;
}

// Load this block's tile of exp(lw - m) so that thread t holds elements
// 4t .. 4t+3 of the tile; lanes past n hold 0.
__device__ void load_tile(const float* lw, float m, int64_t n, float* smem,
                          float x[kItems]) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    smem[j * kThreads + threadIdx.x] = i < n ? expf(lw[i] - m) : 0.0f;
  }
  __syncthreads();
  for (int j = 0; j < kItems; ++j) x[j] = smem[threadIdx.x * kItems + j];
  __syncthreads();
}

// The tile's prefix sums plus `offset`, each lifted to the running
// maximum inside the tile. Passes 3 and 5 both call this, so they see
// the same numbers bit for bit.
__device__ void tile_cum(const float* lw, float m, int64_t n, float offset,
                         float* smem, float* warp_buf, float cum[kItems],
                         float* tile_max) {
  float x[kItems];
  load_tile(lw, m, n, smem, x);
  float tsum = x[0];
  for (int j = 1; j < kItems; ++j) tsum += x[j];
  float total;
  float run = offset + block_exclusive_scan<Sum>(tsum, warp_buf, &total);
  float tmax = 0.0f;
  for (int j = 0; j < kItems; ++j) {
    run += x[j];
    tmax = fmaxf(tmax, run);
    cum[j] = tmax;
  }
  float before = block_exclusive_scan<Max>(tmax, warp_buf, tile_max);
  for (int j = 0; j < kItems; ++j) cum[j] = fmaxf(cum[j], before);
}

__global__ void __launch_bounds__(kThreads)
block_sums(const float* lw, const float* m, int64_t n, float* sums) {
  __shared__ float smem[kTile];
  __shared__ float warp_buf[33];
  float x[kItems];
  load_tile(lw, *m, n, smem, x);
  float tsum = x[0];
  for (int j = 1; j < kItems; ++j) tsum += x[j];
  float total;
  block_exclusive_scan<Sum>(tsum, warp_buf, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: exclusive scan of `in[0..nb)` into `out`, each thread taking
// a contiguous run of entries; the total goes to `*total`.
template <class Op>
__global__ void __launch_bounds__(kThreads)
scan_blocks(const float* in, float* out, int64_t nb, float* total) {
  __shared__ float warp_buf[33];
  const int64_t per = (nb + kThreads - 1) / kThreads;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < nb ? lo + per : nb;
  float acc = Op::id();
  for (int64_t i = lo; i < hi; ++i) acc = Op::op(acc, in[i]);
  float all;
  float run = block_exclusive_scan<Op>(acc, warp_buf, &all);
  if (threadIdx.x == 0) *total = all;
  for (int64_t i = lo; i < hi; ++i) {
    out[i] = run;
    run = Op::op(run, in[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
block_max(const float* lw, const float* m, int64_t n, const float* offsets,
          float* maxima) {
  __shared__ float smem[kTile];
  __shared__ float warp_buf[33];
  float cum[kItems];
  float tile_max;
  tile_cum(lw, *m, n, offsets[blockIdx.x], smem, warp_buf, cum, &tile_max);
  if (threadIdx.x == 0) maxima[blockIdx.x] = tile_max;
}

__global__ void __launch_bounds__(kThreads)
emit(const float* lw, const float* m, const int64_t* key, const float* total,
     int64_t n, int64_t n_dest, const float* offsets, const float* prior_max,
     int32_t* out) {
  __shared__ float smem[kTile];
  __shared__ float warp_buf[33];
  float cum[kItems];
  float tile_max;
  tile_cum(lw, *m, n, offsets[blockIdx.x], smem, warp_buf, cum, &tile_max);
  const float lift = prior_max[blockIdx.x];
  const float nf = (float)n_dest;
  const float scale = nf / *total;
  const float u0 = uniform_from_key(key);
  int32_t* sout = reinterpret_cast<int32_t*>(smem);
  for (int j = 0; j < kItems; ++j) {
    const float c = fmaxf(cum[j], lift);
    const float v = fminf(fmaxf(ceilf(c * scale - u0), 0.0f), nf);
    sout[threadIdx.x * kItems + j] = (int32_t)v;
  }
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n) {
      int32_t v = sout[j * kThreads + threadIdx.x];
      if (v > n_dest) v = (int32_t)n_dest;
      out[i] = i == n - 1 ? (int32_t)n_dest : v;
    }
  }
}

}  // namespace

extern "C" {

// Number of floats of scratch the launch needs for n elements.
long long cdf_counts_scratch_floats(long long n) {
  const long long nb = (n + kTile - 1) / kTile;
  return 4 * nb + 2;
}

// lw: f32[n] (n source particles); m: f32[1] = max(lw); key: int64[2], the
// words of the resampling key; out: int32[n], the cumulative counts of
// n_dest destinations; scratch: f32[cdf_counts_scratch_floats(n)]. All on
// the device. Launches on `stream` and returns cudaGetLastError().
int cdf_counts_launch(const float* lw, const float* m, const int64_t* key,
                      int32_t* out, float* scratch, long long n,
                      long long n_dest, void* stream) {
  if (n <= 0 || n_dest < 0 || n_dest > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + kTile - 1) / kTile;
  float* sums = scratch;
  float* offsets = scratch + nb;
  float* maxima = scratch + 2 * nb;
  float* prior_max = scratch + 3 * nb;
  float* total = scratch + 4 * nb;
  float* max_total = scratch + 4 * nb + 1;
  block_sums<<<(unsigned)nb, kThreads, 0, s>>>(lw, m, n, sums);
  scan_blocks<Sum><<<1, kThreads, 0, s>>>(sums, offsets, nb, total);
  block_max<<<(unsigned)nb, kThreads, 0, s>>>(lw, m, n, offsets, maxima);
  scan_blocks<Max><<<1, kThreads, 0, s>>>(maxima, prior_max, nb, max_total);
  emit<<<(unsigned)nb, kThreads, 0, s>>>(lw, m, key, total, n, n_dest,
                                         offsets, prior_max, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
