// Log-space matrix product on Hopper's tensor cores, at full f32 accuracy:
//
//   C[b,i,j] = log sum_k exp(X[b,i,k] + Y[b,k,j])
//            = log(max(P[b,i,j], FLT_MIN)) + rx[b,i] + cy[b,j],
//   P[b]     = exp(X[b] - rx[b]) @ exp(Y[b] - cy[b]),
//   rx[b,i]  = max_k X[b,i,k],   cy[b,j] = max_k Y[b,k,j].
//
// Replaces genjax_tpu/ops/logmatmul.py::log_matmul_pallas (body _kernel),
// the combine of the parallel-prefix HMM filter. The TPU kernel holds one
// whole (S, S) block of X, Y and C in VMEM per grid step, so it needs
// S % 128 == 0 and S <= 1024. Here the product is tiled, and any M, K, N
// and any batch B >= 1 are taken: TMA zero-fills the ragged edges.
//
// Numerics: split TF32 (3xTF32). TF32 keeps 11 significant bits, about
// 5e-4 relative per product, and every term of P is positive, so that
// error would pass straight into log P. Each operand e is split into
// hi = cvt.rna.tf32(e) and lo = cvt.rna.tf32(e - hi), and the tensor
// cores accumulate lo*hi + hi*lo + hi*hi in f32, small terms first: about
// 22 significant bits, as close to the plain f32 product as the tolerance
// 1e-5 + 1e-5 |C| needs. No TF32 product is taken without its
// compensation terms. Both exponentials are scaled by 2^32 (exact) and P
// by 2^-64 (exact above FLT_MIN), so that no tensor-core operand is
// subnormal: a flush of subnormal inputs could otherwise drop terms that
// sum to more than FLT_MIN where every term is below it.
//
// Three launches:
//   1. prologue_rows  one warp per row of X writes rx and the hi and lo
//                     planes of exp(X - rx) 2^32 (K-major, as wgmma takes
//                     a TF32 operand); eight warps per 32 columns of Y
//                     write cy. A maximum keeps a NaN, as jnp.max does.
//   2. prologue_cols  64 x 64 tiles of Y through shared memory write the
//                     hi and lo planes of exp(Y - cy) 2^32 transposed
//                     (K-major), coalesced on both sides.
//   3. product        one block per (128 x 256 tile of C, b): one
//                     producer thread keeps a ring of two stages in shared
//                     memory filled by TMA (cp.async.bulk.tensor, 128-byte
//                     swizzle, completion on mbarriers); two consumer
//                     warpgroups of 64 rows each run wgmma.mma_async
//                     m64n256k8 TF32 on the staged planes, three per k8
//                     slice, into one f32 accumulator set (128 registers a
//                     thread, after setmaxnreg moves the producer's spare
//                     registers to them), then release the stage. The
//                     epilogue takes log(max(P, FLT_MIN)) + rx + cy; a NaN
//                     P stays NaN, and a row or column whose shift is
//                     infinite is NaN, as exp(x - rx) makes it in JAX.
// exp runs once per element per call (in the prologue), not once per tile
// that reads it. The planes live in scratch with K rounded up to 4 (rows
// 16-byte aligned, as TMA needs); the tensor maps end at K, so the pad
// is never read. Strided operands (the scan's elems[1::2], odd[:-1]) are
// read in place through their batch stride: rows must be contiguous
// (inner strides (K, 1) and (N, 1)). C is written contiguous. The tensor
// maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPointByVersion, so the library needs no -lcuda.
//
// What bounds it on the card: operations. 3 x 2 B M K N flops of TF32 on
// the tensor cores, 495 TFLOP/s dense, against 2 B M K N at 67 TFLOP/s
// for the f32 FFMA kernel this replaces. The prologue reads
// B M K + 2 B K N floats and writes 2 (B M K + B K N) at the memory's
// 3.35 TB/s. Writing the lo planes costs bytes, but keeps the product a
// plain TMA-to-wgmma loop: splitting the staged f32 tiles inside it
// instead (half the planes) measured slower on the card, as the split's
// shared-memory traffic and the barrier it needs idle the tensor cores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kShiftThreads = 256;  // 8 warps: 8 rows, or 32 columns
constexpr int kT = 64;              // transpose tile edge
constexpr long long kMaxGrid = 65535;
constexpr float kScale = 4294967296.0f;           // 2^32, each operand
constexpr float kUnscale = 5.42101086242752217e-20f;  // 2^-64, the product

constexpr int kBM = 128;                 // C rows per block
constexpr int kBN = 256;                 // C columns per block
constexpr int kBK = 32;                  // k per stage: one 128-byte row
constexpr int kRow = kBK * 4;            // bytes of a staged row
constexpr int kThreads = 384;            // producer + 2 consumer groups

// max(a, b) that keeps a NaN of either operand, as jnp.max does (fmaxf
// drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// e -> (hi, lo): hi = e rounded to TF32 (nearest, ties away), lo = the
// rest rounded likewise.
__device__ __forceinline__ void split_tf32(float e, float* hi, float* lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(e));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(e - __uint_as_float(h)));
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

__global__ void __launch_bounds__(kShiftThreads)
prologue_rows(const float* __restrict__ X, long long sx,
              const float* __restrict__ Y, long long sy,
              float* __restrict__ rx, float* __restrict__ cy,
              float* __restrict__ A, long long B, int M, int K, int N,
              int Kp) {
  const int row_blocks = (M + 7) / 8;
  const int lane = threadIdx.x & 31;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    if ((int)blockIdx.x < row_blocks) {
      const int i = blockIdx.x * 8 + (threadIdx.x >> 5);
      if (i < M) {  // the same for the whole warp
        const float* row = X + b * sx + (long long)i * K;
        float m = -INFINITY;
        for (int k = lane; k < K; k += 32) m = nan_max(row[k], m);
        for (int o = 16; o > 0; o >>= 1)
          m = nan_max(m, __shfl_xor_sync(kFull, m, o));
        if (lane == 0) rx[b * M + i] = m;
        float* hi = A + (2 * b * M + i) * (long long)Kp;
        float* lo = hi + (long long)M * Kp;
        for (int k = lane; k < K; k += 32) {
          float h, l;
          split_tf32(expf(row[k] - m) * kScale, &h, &l);
          hi[k] = h;
          lo[k] = l;
        }
      }
    } else {
      // Warp g takes rows g, g + 8, ... of 32 columns (coalesced), and
      // the eight partial maxima of a column meet in shared memory: eight
      // loads in flight per column keep a small batch from waiting on a
      // thread's walk down a whole column.
      __shared__ float part[8][32];
      const int g = threadIdx.x >> 5;
      const int j = (blockIdx.x - row_blocks) * 32 + lane;
      float m = -INFINITY;
      if (j < N) {
        const float* col = Y + b * sy + j;
        for (int k = g; k < K; k += 8) m = nan_max(col[(long long)k * N], m);
      }
      part[g][lane] = m;
      __syncthreads();
      if (g == 0 && j < N) {
        for (int r = 1; r < 8; ++r) m = nan_max(m, part[r][lane]);
        cy[b * N + j] = m;
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kT * 4)
prologue_cols(const float* __restrict__ Y, long long sy,
              const float* __restrict__ cy, float* __restrict__ Bt,
              long long B, int K, int N, int Kp) {
  __shared__ float hs[kT][kT + 1];  // [k][j]
  __shared__ float ls[kT][kT + 1];
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  const int j0 = blockIdx.x * kT, k0 = blockIdx.y * kT;
  for (long long b = blockIdx.z; b < B; b += gridDim.z) {
    const float* Yb = Y + b * sy;
    const int j = j0 + tx;
    const float c = j < N ? cy[b * N + j] : 0.0f;
    for (int r = ty; r < kT; r += 4) {
      const int k = k0 + r;
      if (j < N && k < K)
        split_tf32(expf(Yb[(long long)k * N + j] - c) * kScale, &hs[r][tx],
                   &ls[r][tx]);
    }
    __syncthreads();
    float* hi = Bt + 2 * b * N * (long long)Kp;
    float* lo = hi + (long long)N * Kp;
    for (int r = ty; r < kT; r += 4) {
      const int jj = j0 + r, k = k0 + tx;
      if (jj < N && k < K) {
        hi[(long long)jj * Kp + k] = hs[tx][r];
        lo[(long long)jj * Kp + k] = ls[tx][r];
      }
    }
    __syncthreads();
  }
}

// -- TMA, mbarriers and wgmma ----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (k, row, plane) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k),
      "r"(row), "r"(plane)
      : "memory");
}

// A shared-memory matrix descriptor for wgmma: K-major rows of 128 bytes,
// 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wgmma fences.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void mma_n256(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// A stage: the hi and lo planes of a 128 x 32 slice of A, then of a
// 256 x 32 slice of B, each 1024-byte aligned; two stages fill the
// block's shared memory.
constexpr int kStage = (2 * kBM + 2 * kBN) * kRow;
constexpr int kStages = 2;
constexpr int kSmem = kStages * kStage + 1024 + 2 * kStages * 8;

__global__ void __launch_bounds__(kThreads, 1)
product(const __grid_constant__ CUtensorMap mapA,
        const __grid_constant__ CUtensorMap mapB,
        const float* __restrict__ rx, const float* __restrict__ cy,
        float* __restrict__ C, long long B, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nk = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int group = threadIdx.x / 128;

  if (group == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int it = 0;
      for (long long b = blockIdx.z; b < B; b += gridDim.z) {
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % kStages;
          bar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = smem + s * kStage;
          bar_expect(&full[s], kStage);
          const int k = ks * kBK, p = (int)(2 * b);
          tma_load(st, &mapA, &full[s], k, m0, p);
          tma_load(st + kBM * kRow, &mapA, &full[s], k, m0, p + 1);
          tma_load(st + 2 * kBM * kRow, &mapB, &full[s], k, n0, p);
          tma_load(st + (2 * kBM + kBN) * kRow, &mapB, &full[s], k, n0,
                   p + 1);
        }
      }
    }
  } else {
    // Consumers: warpgroup c takes rows m0 + 64 c .. + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = group - 1;
    const int t = threadIdx.x % 128;
    int it = 0;
    for (long long b = blockIdx.z; b < B; b += gridDim.z) {
      float acc[kBN / 2];
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) acc[r] = 0.0f;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % kStages;
        bar_wait(&full[s], (it / kStages) & 1);
        const uint32_t a_hi = smem_addr(smem + s * kStage) + c * 64 * kRow;
        const uint32_t a_lo = a_hi + kBM * kRow;
        const uint32_t b_hi = smem_addr(smem + s * kStage) + 2 * kBM * kRow;
        const uint32_t b_lo = b_hi + kBN * kRow;
#pragma unroll
        for (int r = 0; r < kBN / 2; ++r) pin(acc[r]);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint32_t o = kk * 32;  // 8 TF32 values along k
          mma_n256(acc, desc(a_lo + o), desc(b_hi + o));
          mma_n256(acc, desc(a_hi + o), desc(b_lo + o));
          mma_n256(acc, desc(a_hi + o), desc(b_hi + o));
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
        for (int r = 0; r < kBN / 2; ++r) pin(acc[r]);
        if (t == 0) bar_arrive(&empty[s]);
      }
      // Epilogue. Accumulator r of thread t holds row 16 (t / 32) +
      // (t % 32) / 4 + 8 ((r / 2) % 2) and column 8 (r / 4) + 2 (t % 4) +
      // r % 2 of this warpgroup's 64 x kBN tile.
      const float* rxb = rx + b * M;
      const float* cyb = cy + b * N;
      float* Cb = C + b * (long long)M * N;
      const int i0 = m0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h;
        if (i < M) {
          const float ri = rxb[i];
#pragma unroll
          for (int q = 0; q < kBN / 8; ++q) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = n0 + q * 8 + 2 * (t % 4) + e;
              if (j < N) {
                const float cj = cyb[j];
                float out;
                if (isinf(ri) || isinf(cj)) {
                  out = __int_as_float(0x7fffffff);
                } else {
                  const float p = acc[q * 4 + h * 2 + e] * kUnscale;
                  out = logf(p != p ? p : fmaxf(p, FLT_MIN)) + ri + cj;
                }
                Cb[(long long)i * N + j] = out;
              }
            }
          }
        }
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The planes (2 B, rows, Kp) as a tensor map of boxes (32, box_rows, 1)
// that ends at K, 128-byte swizzled.
bool plane_map(CUtensorMap* map, EncodeTiled encode, float* base,
               long long planes, long long rows, long long K, long long Kp,
               int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)(Kp * 4),
                                 (cuuint64_t)(rows * Kp * 4)};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long round4(long long k) { return (k + 3) / 4 * 4; }

}  // namespace

extern "C" {

// Floats of scratch the launch needs: the four planes, then the shifts.
long long log_matmul_scratch_floats(long long B, long long M, long long K,
                                    long long N) {
  return 2 * B * (M + N) * round4(K) + B * (M + N);
}

// X: f32, element (b, i, k) at X[b*sx + i*K + k]; Y: f32, element (b, k, j)
// at Y[b*sy + k*N + j]; C: f32[B, M, N], contiguous; scratch:
// f32[log_matmul_scratch_floats(B, M, K, N)], 16-byte aligned. All on the
// device. Launches on `stream` and returns cudaGetLastError(), or -1 if the
// CUDA driver's tensor-map encoder is missing or refuses the planes.
int log_matmul_launch(const float* X, long long sx, const float* Y,
                      long long sy, float* C, float* scratch, long long B,
                      long long M, long long K, long long N, void* stream) {
  if (B <= 0 || M <= 0 || K <= 0 || N <= 0 || M > 0x7fffffffLL ||
      K > 0x7fffffffLL || N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long Kp = round4(K);
  float* A = scratch;                    // (B, 2, M, Kp)
  float* Bt = A + 2 * B * M * Kp;        // (B, 2, N, Kp)
  float* rx = Bt + 2 * B * N * Kp;       // (B, M)
  float* cy = rx + B * M;                // (B, N)
  EncodeTiled encode = encode_tiled();
  CUtensorMap ma, mb;
  if (encode == nullptr ||
      !plane_map(&ma, encode, A, 2 * B, M, K, Kp, kBM) ||
      !plane_map(&mb, encode, Bt, 2 * B, N, K, Kp, kBN))
    return -1;
  const unsigned gb = (unsigned)(B < kMaxGrid ? B : kMaxGrid);
  const long long row_blocks =
      (M + 7) / 8 + (N + 31) / 32;
  const long long col_tiles = (K + kT - 1) / kT;
  const long long tiles_m = (M + kBM - 1) / kBM;
  const long long tiles_n = (N + kBN - 1) / kBN;
  if (row_blocks > 0x7fffffffLL || col_tiles > kMaxGrid ||
      tiles_m > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      product, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  prologue_rows<<<dim3((unsigned)row_blocks, gb), kShiftThreads, 0, s>>>(
      X, sx, Y, sy, rx, cy, A, B, (int)M, (int)K, (int)N, (int)Kp);
  prologue_cols<<<dim3((unsigned)((N + kT - 1) / kT), (unsigned)col_tiles,
                       gb),
                  kT * 4, 0, s>>>(Y, sy, cy, Bt, B, (int)K, (int)N, (int)Kp);
  product<<<dim3((unsigned)tiles_n, (unsigned)tiles_m, gb), kThreads, kSmem,
            s>>>(ma, mb, rx, cy, C, B, (int)M, (int)K, (int)N);
  return (int)cudaGetLastError();
}

}  // extern "C"
