// One particle-filter step in one launch, for Hopper:
//
//   eps[i]    = Box-Muller(threefry2x32(key, (i, 0)))       (i the flat index)
//   x_new[i]  = propagate(x[i], eps[i])                    (stored in the
//                                                           state's dtype)
//   lw_new[i] = lw[i] + loglik(x_new[i], obs)
//   lse = logsumexp(lw_new),  ess = exp(2 lse - logsumexp(2 lw_new)).
//
// Replaces genjax_tpu/ops/fused_step.py::make_fused_step (body
// _fused_kernel, with threefry2x32 and normal_from_counter at :53-93). The
// TPU kernel carries the (max, sumexp) pairs of lw and 2 lw across a
// sequential grid. Here blocks run in no order: each block writes one
// partial (max c, sum exp(lw - c), sum exp(2 (lw - c))), and the last
// block to finish, found by an atomic ticket (an acquire-release increment
// after its partial), folds every partial into lse and ess in a fixed
// order and resets the ticket to 0 for the next launch on the same
// scratch. Every sum is taken in an order that does not depend on timing,
// so the results repeat bit for bit, and there are no float atomics.
//
// The model comes in at compile time: nvcc pre-includes one header
// (-include), which defines fused_model::propagate, loglik and kParams,
// the number of float constants it reads. The header is a hand-written
// one of csrc/models/ or one that genjax_torch/ops/fused_model.py
// generated from the model's torch form. One library is built per header.
// The constants, any number of them, come in an f32 buffer on the device
// that the launch points to: every thread reads a constant at the same
// address, so each read is one broadcast load from the read-only path,
// which L1 serves after a block's first. The compiler loads a constant
// once for a thread's four elements and keeps it in a register; with a
// thousand constants those registers overflow and ptxas spills them to
// local memory, which such a model pays for.
//
// The key's two words and the observation are read from device memory, so
// a step needs no host sync. Counters are the flat index in uint32 (any
// n < 2^32); uniforms are the top 24 bits of each word, exact in f32; the
// logarithm, square root and cosine are the precise libdevice functions,
// as torch's, so that the kernel and its plain version agree to an ulp
// before the model amplifies it.
//
// What bounds it on the card: bytes and the integer pipe, about equally.
// At n = 2^20 with f32 state it must read x and lw and write x_new and
// lw_new, 16 bytes an element, 16.8 MB: 5.0 us at 3.35 TB/s. Threefry's 20
// rounds are about 70 integer instructions an element (add, funnel-shift
// rotate, xor), and Hopper issues 64 integer lanes a clock per SM, half
// its f32 rate: about 4.6 us at 2^20 on 132 SMs. So each thread moves 16
// bytes at a time (four f32 elements, as one vector load or store where
// the pointers allow), everything between the loads and the stores stays
// in registers (32 a thread, so that the 1024 blocks of 2^20 run in one
// wave), and the statistics cost one 16-byte store a block. Beyond the
// bounds, a launch pays the precise logarithm, square root and cosine
// (about 100 more instructions an element) and, after its last block's
// elements, the chain of the block reductions, the ticket and the fold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// threefry2x32, 20 rounds (Random123), of the counter words (ctr, 0).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t ctr, uint32_t& b0,
                                             uint32_t& b1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = ctr + k0, x1 = k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[g & 1][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  b0 = x0;
  b1 = x1;
}

// The top 24 bits as a uniform in [0, 1), exactly.
__device__ __forceinline__ float unit24(uint32_t b) {
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}

// Box-Muller's cosine branch; 1 - u1 lies in (0, 1], so log1p(-u1) is
// finite.
__device__ __forceinline__ float normal_from_counter(uint32_t k0, uint32_t k1,
                                                     uint32_t ctr) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, ctr, b0, b1);
  const float r = sqrtf(-2.0f * log1pf(-unit24(b0)));
  return r * cosf(6.283185307179586f * unit24(b1));
}

// max(a, b) that keeps a NaN of either operand, as torch.max does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as torch's .to()
}

// Four elements as one 16-byte (f32) or 8-byte (bf16) access.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// The block's maximum, in every thread.
__device__ float block_max(float v, float* buf) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = buf[0];
  for (int w = 1; w < kWarps; ++w) m = nan_max(m, buf[w]);
  __syncthreads();
  return m;
}

// The block's sums of one pair a thread, in every thread, in a fixed
// order: a shuffle-down tree inside each warp, then the warps in order.
__device__ float2 block_sum(float2 v, float2* buf) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(kFull, v.x, o);
    v.y += __shfl_down_sync(kFull, v.y, o);
  }
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 s = buf[0];
  for (int w = 1; w < kWarps; ++w) s.x += buf[w].x, s.y += buf[w].y;
  __syncthreads();
  return s;
}

// Takes the ticket for a block whose partial is written: the release
// orders the partial before the increment, and the acquire, with the
// barrier after it, lets every thread of the last block read every
// partial.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// The last block: every partial (c, sum exp(lw - c), sum exp(2 (lw - c))),
// each thread a contiguous run of them, into lse and ess; then the ticket
// back to 0.
__device__ void fold(const float4* parts, unsigned nb, float* stats,
                     unsigned* ticket, float* mbuf, float2* sbuf) {
  const unsigned per = (nb + kThreads - 1) / kThreads;
  const unsigned lo = threadIdx.x * per;
  const unsigned hi = lo + per < nb ? lo + per : nb;
  float m = -INFINITY;
  for (unsigned i = lo; i < hi; ++i) m = nan_max(m, __ldcg(&parts[i]).x);
  m = block_max(m, mbuf);
  float2 s = make_float2(0.0f, 0.0f);
  for (unsigned i = lo; i < hi; ++i) {
    const float4 q = __ldcg(&parts[i]);
    if (q.x != -INFINITY) {  // a block of -inf adds nothing (and no NaN)
      const float e = expf(q.x - m);
      s.x += q.y * e;
      s.y += q.z * (e * e);
    }
  }
  s = block_sum(s, sbuf);
  if (threadIdx.x == 0) {
    const float lse = m + logf(s.x);
    const float lse2 = 2.0f * m + logf(s.y);
    stats[0] = lse;
    stats[1] = expf(2.0f * lse - lse2);
    *ticket = 0;
  }
}

template <class State>
__global__ void __launch_bounds__(kThreads)
step(const int64_t* __restrict__ key, const float* __restrict__ obs,
     const State* __restrict__ xs, const float* __restrict__ lw,
     State* __restrict__ xs_out, float* __restrict__ lw_out, float4* parts,
     float* stats, unsigned* ticket, long long n,
     const float* __restrict__ p, bool vec) {
  __shared__ float mbuf[kWarps];
  __shared__ float2 sbuf[kWarps];
  __shared__ bool last;
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const float y = *obs;
  const long long i0 = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  const bool full = vec && i0 + kItems <= n;
  float x[kItems], w[kItems];
  if (full) {
    load4(xs + i0, x);
    load4(lw + i0, w);
  } else {
    for (int j = 0; j < kItems; ++j) {
      const bool live = i0 + j < n;
      x[j] = live ? to_f32(xs[i0 + j]) : 0.0f;
      w[j] = live ? lw[i0 + j] : 0.0f;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const float eps = normal_from_counter(k0, k1, (uint32_t)(i0 + j));
    x[j] = fused_model::propagate(x[j], eps, p);
    w[j] = w[j] + fused_model::loglik(x[j], y, p);
    if (i0 + j < n) m = nan_max(m, w[j]);
  }
  if (full) {
    store4(xs_out + i0, x);
    store4(lw_out + i0, w);
  } else {
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < n) {
        store1(xs_out + i0 + j, x[j]);
        lw_out[i0 + j] = w[j];
      }
    }
  }

  // This block's partial: its maximum c, then the sums of exp(lw - c) and
  // its square, each thread's elements in order, then block_sum's order.
  const float c = block_max(m, mbuf);
  float2 t = make_float2(0.0f, 0.0f);
  if (c != -INFINITY) {
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < n) {
        const float e = __expf(w[j] - c);
        t.x += e;
        t.y += e * e;
      }
    }
  }
  t = block_sum(t, sbuf);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = make_float4(c, t.x, t.y, 0.0f);
    last = take_ticket(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) fold(parts, gridDim.x, stats, ticket, mbuf, sbuf);
}

// The two threefry words of counters 0..n-1, from the same threefry2x32
// as the step, for a bitwise check against core.random.
__global__ void threefry_bits(const int64_t* __restrict__ key,
                              uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t b0, b1;
  threefry2x32((uint32_t)key[0], (uint32_t)key[1], (uint32_t)i, b0, b1);
  out[2 * i] = b0;
  out[2 * i + 1] = b1;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// Floats of the partials that a launch for n elements writes (one float4
// a block of kTile elements), 16-byte aligned.
long long fused_step_partial_floats(long long n) {
  return 4 * ((n + kTile - 1) / kTile);
}

// key: int64[2], the step key's words; obs: f32[1]; xs / xs_out: n states,
// f32 (bf16 == 0) or bf16 (bf16 == 1); lw / lw_out: f32[n]; parts:
// fused_step_partial_floats(n) floats, 16-byte aligned; stats: f32[2],
// receives (lse, ess); ticket: one unsigned, 0 before the launch and 0
// again after it (launches that share it must run one after another, as
// on one stream); params: n_params floats, the model's constants (null
// where there are none). All on the device. Launches on `stream` and
// returns cudaGetLastError().
int fused_step_launch(const int64_t* key, const float* obs, const void* xs,
                      const float* lw, void* xs_out, float* lw_out,
                      float* parts, float* stats, unsigned* ticket,
                      long long n, int bf16, const float* params,
                      int n_params, void* stream) {
  if (n <= 0 || n > 0xffffffffLL || n_params != fused_model::kParams ||
      (n_params > 0 && params == nullptr) || !aligned(parts, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  float4* part4 = reinterpret_cast<float4*>(parts);
  const bool lw_vec = aligned(lw, 16) && aligned(lw_out, 16);
  if (bf16) {
    const auto* x = static_cast<const __nv_bfloat16*>(xs);
    auto* xo = static_cast<__nv_bfloat16*>(xs_out);
    const bool vec = lw_vec && aligned(x, 8) && aligned(xo, 8);
    step<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        key, obs, x, lw, xo, lw_out, part4, stats, ticket, n, params, vec);
  } else {
    const auto* x = static_cast<const float*>(xs);
    auto* xo = static_cast<float*>(xs_out);
    const bool vec = lw_vec && aligned(x, 16) && aligned(xo, 16);
    step<float><<<blocks, kThreads, 0, s>>>(
        key, obs, x, lw, xo, lw_out, part4, stats, ticket, n, params, vec);
  }
  return (int)cudaGetLastError();
}

// out: uint32[2 n], the words (b0, b1) of each counter. On the device;
// launches on `stream` and returns cudaGetLastError().
int fused_step_threefry_bits(const int64_t* key, uint32_t* out, long long n,
                             void* stream) {
  if (n <= 0 || n > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  threefry_bits<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(key, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
