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
// size.) u0 is drawn here from the key's two words exactly as
// jax.random.uniform(key, ()) draws it (threefry2x32 of counter (0, 0),
// the xor of the two words, the top 23 bits as a mantissa in [1, 2),
// minus one), so that no host-side key arithmetic precedes the launch.
//
// The TPU kernel carries a running (sum, max) pair across a sequential
// grid. CUDA blocks run in no order; here the carry takes two launches,
// and the maximum m is found inside them (no reduction before the call):
//   1. tile_partials  each block takes a tile of 4096 and writes its
//                     maximum m_t and s_t = sum exp(lw - m_t) over it. It
//                     also clears the look-back flags and the tile ticket
//                     that launch 2 uses.
//   2. emit           each block takes a tile by ticket (an atomic
//                     counter, so that tiles are claimed in the order the
//                     blocks start and none waits on a tile that is not
//                     running). From the partials, a few KB in L2, it gets
//                     m = max m_t, the total sum_t s_t exp(m_t - m) and its
//                     tile's exclusive offset, every block in the same
//                     fixed order and in double. It recomputes its tile's
//                     prefix sums of exp(lw - m) plus the offset, lifts
//                     them to their running maximum, and takes the running
//                     maximum of all earlier tiles by a decoupled
//                     look-back: each tile publishes its own maximum, then
//                     the maximum of everything up to it, and the block
//                     reads back up to 1024 predecessors at once until it
//                     meets a published prefix. (The lift is the exact
//                     monotone repair: an offset can round below the
//                     previous tile's last value.) Then it writes the
//                     clamped counts.
// No float atomics: every sum is taken in one fixed order, so the result
// does not change from run to run, and the maximum is exact in floating
// point, so the counts are nondecreasing, end at n_dest and sum to n_dest
// in every weight regime. Any n: the ragged last tile is masked. Offsets
// in double keep every tile within an f32 rounding of the exact prefix
// sum at any n.
//
// What bounds it on the card: bytes. Launch 1 reads the 4 MB of
// log-weights at n = 2^20, launch 2 reads them again and writes 4 MB of
// counts: 12 MB against 3.35 TB/s, about 3.6 us. Every block of launch 2
// also reads the 8-byte partials of every tile from L2 (2 KB at 2^20).
// At that size the time goes to launch 2's chain of dependent steps (the
// ticket, the partials, the tile's scans, the look-back), each a round
// trip to L2 or a barrier of 1024 threads, more than to its bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
// Look-back flag states, in the high word beside the value's bits.
constexpr unsigned long long kOwn = 1ull << 32;     // the tile's own max
constexpr unsigned long long kPrefix = 2ull << 32;  // max of tiles 0..t

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

// max(a, b) that keeps a NaN of either operand, as jnp.max does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct Sum {
  __device__ static float id() { return 0.0f; }
  template <class T>
  __device__ static T op(T a, T b) { return a + b; }
};

struct Max {
  __device__ static float id() { return 0.0f; }  // every prefix sum is >= 0
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};

struct NanMax {
  __device__ static float id() { return -INFINITY; }
  __device__ static float op(float a, float b) { return nan_max(a, b); }
};

// Exclusive scan of one value per thread over the whole block, in a fixed
// order. `total` receives the block's inclusive total.
template <class Op, class T>
__device__ T block_exclusive_scan(T v, T* warp_buf, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    T t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = Op::op(t, incl);
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = Op::id();
  if (lane == 31) warp_buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = warp_buf[lane];
    T wincl = w;
    for (int o = 1; o < 32; o <<= 1) {
      T t = __shfl_up_sync(kFull, wincl, o);
      if (lane >= o) wincl = Op::op(t, wincl);
    }
    T wexcl = __shfl_up_sync(kFull, wincl, 1);
    if (lane == 0) wexcl = Op::id();
    warp_buf[lane] = wexcl;
    if (lane == 31) warp_buf[32] = wincl;
  }
  __syncthreads();
  T out = warp == 0 ? excl : Op::op(warp_buf[warp], excl);
  *total = warp_buf[32];
  __syncthreads();
  return out;
}

// The block's reduction of one value per thread, in a fixed order.
template <class Op>
__device__ float block_reduce(float v, float* warp_buf) {
  float total;
  block_exclusive_scan<Op>(v, warp_buf, &total);
  return total;
}

__global__ void __launch_bounds__(kThreads)
tile_partials(const float* __restrict__ lw, int64_t n, float2* part,
              unsigned long long* flags, unsigned* ticket) {
  __shared__ float warp_buf[33];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  float x[kItems];
  float m = -INFINITY;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    x[j] = i < n ? lw[i] : -INFINITY;
    m = nan_max(m, x[j]);
  }
  const float mt = block_reduce<NanMax>(m, warp_buf);
  float s = 0.0f;
  if (mt != -INFINITY)  // a tile of -inf adds nothing (and no NaN)
    for (int j = 0; j < kItems; ++j) s += expf(x[j] - mt);
  const float st = block_reduce<Sum>(s, warp_buf);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = make_float2(mt, st);
    flags[blockIdx.x] = 0;
    if (blockIdx.x == 0) *ticket = 0;
  }
}

__device__ __forceinline__ void publish(unsigned long long* flag,
                                        unsigned long long state, float v) {
  const unsigned long long word = state | __float_as_uint(v);
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(flag), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* flag) {
  unsigned long long word;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];"
               : "=l"(word)
               : "l"(flag)
               : "memory");
  return word;
}

// The maximum over tiles 0..t-1 of their cumulative values, read back
// through the flags by the whole block, a window of kThreads tiles at a
// time (one window while t <= kThreads): thread k waits for tile
// end - kThreads + k to publish, and the window's values from its last
// published prefix on (all of them if it has none) are combined.
__device__ float look_back(const unsigned long long* flags, int64_t t,
                           float* warp_buf) {
  float prior = 0.0f;
  for (int64_t end = t; end > 0; end -= kThreads) {
    const int64_t i = end - kThreads + threadIdx.x;
    unsigned long long word = 0;
    if (i >= 0) {
      do {
        word = peek(&flags[i]);
      } while ((word >> 32) == 0);
    }
    // 1 + the thread of the window's last prefix, or 0 without one.
    const float last = block_reduce<Max>(
        i >= 0 && word >= kPrefix ? (float)(threadIdx.x + 1) : 0.0f,
        warp_buf);
    const bool take = i >= 0 && (float)(threadIdx.x + 1) >= last;
    prior = fmaxf(prior, block_reduce<Max>(
                             take ? __uint_as_float((unsigned)word) : 0.0f,
                             warp_buf));
    if (last > 0.0f) break;
  }
  return prior;
}

// Two blocks an SM (32 registers a thread), so that a grid of 256 tiles
// (n = 2^20) runs in one wave.
__global__ void __launch_bounds__(kThreads, 2)
emit(const float* __restrict__ lw, const int64_t* __restrict__ key,
     int64_t n, int64_t n_dest, const float2* __restrict__ part,
     unsigned long long* flags, unsigned* ticket, int32_t* __restrict__ out) {
  __shared__ float smem[kTile];
  __shared__ float warp_buf[33];
  __shared__ double dwarp_buf[33];
  __shared__ float sh_m;
  __shared__ double sh_offset;
  __shared__ int64_t sh_tile;
  if (threadIdx.x == 0) sh_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t t = sh_tile;
  const int64_t nb = (n + kTile - 1) / kTile;
  // This tile's log-weights, loaded first so that their latency hides
  // behind the work on the partials.
  const int64_t base = t * kTile;
  float raw[kItems];
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    raw[j] = i < n ? lw[i] : -INFINITY;
  }

  // The global maximum and this tile's offset from the partials, each
  // thread taking a contiguous run of tiles. Offsets and the total are
  // summed in double, so that at any n a tile's values sit within an f32
  // rounding of the exact prefix sum (an f32 sum over thousands of tiles
  // drifts by several ulps, a destination each at n = 2^24).
  const int64_t per = (nb + kThreads - 1) / kThreads;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < nb ? lo + per : nb;
  float m = -INFINITY;
  for (int64_t i = lo; i < hi; ++i) m = nan_max(m, part[i].x);
  m = block_reduce<NanMax>(m, warp_buf);
  double acc = 0.0;
  for (int64_t i = lo; i < hi; ++i) {
    const float2 p = part[i];
    if (p.x != -INFINITY) acc += (double)p.y * exp((double)p.x - m);
  }
  double total;
  double run = block_exclusive_scan<Sum>(acc, dwarp_buf, &total);
  for (int64_t i = lo; i < hi; ++i) {
    if (i == t) sh_offset = run;
    const float2 p = part[i];
    if (p.x != -INFINITY) run += (double)p.y * exp((double)p.x - m);
  }
  if (threadIdx.x == 0) sh_m = m;
  __syncthreads();
  m = sh_m;
  const double offset = sh_offset;

  // This tile's prefix sums plus the offset, each lifted to the running
  // maximum inside the tile. Thread k holds elements 4k .. 4k+3.
  for (int j = 0; j < kItems; ++j)
    smem[j * kThreads + threadIdx.x] = expf(raw[j] - m);
  __syncthreads();
  float x[kItems];
  for (int j = 0; j < kItems; ++j) x[j] = smem[threadIdx.x * kItems + j];
  float tsum = x[0];
  for (int j = 1; j < kItems; ++j) tsum += x[j];
  float tile_total;
  run = offset + block_exclusive_scan<Sum>(tsum, warp_buf, &tile_total);
  float cum[kItems];
  float tmax = 0.0f;
  for (int j = 0; j < kItems; ++j) {
    run += x[j];
    tmax = fmaxf(tmax, (float)run);
    cum[j] = tmax;
  }
  float tile_max;
  const float before = block_exclusive_scan<Max>(tmax, warp_buf, &tile_max);

  // The running maximum of all earlier tiles.
  if (threadIdx.x == 0) publish(&flags[t], t == 0 ? kPrefix : kOwn, tile_max);
  const float prior = look_back(flags, t, warp_buf);
  if (threadIdx.x == 0 && t > 0)
    publish(&flags[t], kPrefix, fmaxf(prior, tile_max));
  const float lift = fmaxf(prior, before);

  const float nf = (float)n_dest;
  const float scale = nf / (float)total;
  const float u0 = uniform_from_key(key);
  int32_t* sout = reinterpret_cast<int32_t*>(smem);
  for (int j = 0; j < kItems; ++j) {
    const float c = fmaxf(cum[j], lift);
    const float v = fminf(fmaxf(ceilf(c * scale - u0), 0.0f), nf);
    sout[threadIdx.x * kItems + j] = (int32_t)v;
  }
  __syncthreads();
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

// Bytes of scratch the launch needs for n elements: per tile a float2
// partial and a u64 flag, then the ticket.
long long cdf_counts_scratch_bytes(long long n) {
  const long long nb = (n + kTile - 1) / kTile;
  return 16 * nb + 8;
}

// lw: f32[n] (n source particles); key: int64[2], the words of the
// resampling key; out: int32[n], the cumulative counts of n_dest
// destinations; scratch: cdf_counts_scratch_bytes(n) bytes, 8-byte
// aligned. All on the device. Launches on `stream` and returns
// cudaGetLastError().
int cdf_counts_launch(const float* lw, const int64_t* key, int32_t* out,
                      void* scratch, long long n, long long n_dest,
                      void* stream) {
  if (n <= 0 || n_dest < 0 || n_dest > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long nb = (n + kTile - 1) / kTile;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part = static_cast<float2*>(scratch);
  unsigned long long* flags = reinterpret_cast<unsigned long long*>(part + nb);
  unsigned* ticket = reinterpret_cast<unsigned*>(flags + nb);
  tile_partials<<<(unsigned)nb, kThreads, 0, s>>>(lw, n, part, flags, ticket);
  emit<<<(unsigned)nb, kThreads, 0, s>>>(lw, key, n, n_dest, part, flags,
                                         ticket, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
