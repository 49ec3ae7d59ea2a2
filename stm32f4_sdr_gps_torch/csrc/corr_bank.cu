// Correlator-bank probe for Hopper (sm_90a): the E/P/L correlator bank of
// C = 32 channels over SP = 2048 samples, written two ways, with T steps
// inside one launch.
//
// Replaces the JAX package's Pallas TPU probe P5,
// tools/mxu_corr_probe.py::make_fn.kernel, which asks whether the bank is
// cheaper as six vector multiply-reduce sums or as two block-diagonal
// matrix products.  Step t perturbs yr by t * 1e-9 so that no step repeats
// another, and the probe returns the per-channel sum over the T steps of
// the step's total:
//
//   fma: tot[c] = sum_k yr_t*r0 + sum_k yi*r0 + sum_k yr_t*r1 + ...
//        (the six sums of the E/P/L bank against rep (3, C, SP));
//   mma: tot[c] = sum_n (bf16(yr_t) @ repT)[c, n] * mask[c, n]
//              + sum_n (bf16(yi) @ repT)[c, n] * mask[c, n]
//        (two (C, SP) x (SP, N = 128) bf16 products on the tensor cores,
//        float32 accumulators, then a masked row sum).
//
// The TPU probe's sequential grid of T steps is not part of that function:
// its output is the sum over the steps, so the steps are added in any
// order and none waits for the one before.  No work is skipped: every step
// forms all six fma products, or both mma products on the tensor cores,
// and rounds its own yr + t * 1e-9 to bf16.
//
// Design.
// * fma: each channel's 2048 samples are split over FMA_SPLIT = 8 blocks
//   of 128 threads (256 blocks at C = 32: two warps on each scheduler of
//   128 SMs).  A thread keeps its 2 samples of yr and yi and of the three
//   replica rows in registers and carries six running sums over all T
//   steps, each step's 12 products as explicit fmaf (the build's
//   -fmad=false, there for the tracking scan's XLA parity, would split
//   a * b + c in two).  At the end the block reduces its six sums once
//   (block_sum6) and writes one partial; a second small kernel adds each
//   channel's 8 partials in order.
// * mma: one wgmma.m64n128k16 a step does both products: the 32 channels'
//   yr_t rows stacked over their 32 yi rows are its 64 rows of A.  K =
//   2048 is split over 128 CTAs (K = 16 per CTA) of WGS = 2 warpgroups,
//   which take alternate steps with accumulators of their own, so the
//   SM's tensor cores always have the other's wgmmas to run.  A CTA loads
//   its 16 x 128 bf16 slice of repT into shared memory once, in the
//   no-swizzle K-major core-matrix layout wgmma reads, and each warpgroup
//   builds A in registers: each thread holds its 8 float32 elements of the
//   slice;
//   the warps of the yr rows add the step's perturbation and round to bf16
//   every step into one of NSETS register sets, in turn (the others may
//   still be read by the previous steps' wgmmas, up to NSETS - 1 of which
//   stay in flight: wgmma.wait_group NSETS - 1 retires the one that read a
//   set before the set is written again); the yi rows' bf16 values never
//   change and are rounded once.  The float32 accumulators carry over the steps; every
//   FLUSH steps they are added into a register sum and the next wgmma
//   starts them afresh (scale-d = 0), so no accumulator grows past FLUSH
//   steps' worth.  At the end each thread takes its rows' masked sums,
//   the four threads of a row add theirs, the CTA adds its warpgroups'
//   and writes one partial per row; a second small kernel adds the 128
//   CTAs' partials of each channel's two rows in CTA order.  NSETS = 8
//   and WGS = 2 are the fastest of 2-8 and 1-2 on the H100 (PERF.md):
//   a step's wgmma takes several times its ~64 tensor-core cycles from
//   issue to completion, so one warpgroup with 2 sets kept the tensor
//   cores idle most of the time.
//
// Bound.  fma: 1600 x 32 x 2048 samples x 13 float32 operations over
// 67 TFLOP/s, ~20 us; the kernel issues ~17 instructions a step in each
// of its 1024 warps at C = 32, ~34 cycles a step on each of the 128 SMs'
// four schedulers.  mma: 1600 x 2 x 2 x 32 x 2048 x 128 bf16 operations
// over 989 TFLOP/s, ~54 us; one m64n128k16 a step takes ~64 cycles of an
// SM's tensor cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "track_epoch.cuh"

namespace {

constexpr int SP = 2048;                // samples per row
constexpr int N = 128;                  // replica-matrix columns
constexpr int FMA_THREADS = 128;
constexpr int FMA_WARPS = FMA_THREADS / 32;
constexpr int FMA_PER = 2;              // samples per thread (fma)
constexpr int FMA_SPLIT = SP / (FMA_THREADS * FMA_PER);   // blocks a channel
constexpr int MMA_C = 32;               // channels of the mma kernel
constexpr int MMA_ROWS = 2 * MMA_C;     // A: yr_t rows over yi rows
constexpr int MMA_K = 16;               // K slice of one CTA
constexpr int MMA_CTAS = SP / MMA_K;    // 128
constexpr int WG = 128;                 // one warpgroup
constexpr int WGS = 2;                  // warpgroups a CTA
constexpr int MMA_THREADS = WG * WGS;
constexpr int NSETS = 8;                // A register sets, steps in flight
constexpr int FLUSH = 256;              // steps per accumulator flush
static_assert((FLUSH & (FLUSH - 1)) == 0 && FLUSH % NSETS == 0, "FLUSH");
constexpr int SUM_THREADS = 1024;       // the mma partials' sum kernel
static_assert(FMA_SPLIT * FMA_THREADS * FMA_PER == SP, "fma split");
static_assert(MMA_CTAS * MMA_ROWS % SUM_THREADS == 0, "mma partials");

__device__ inline float perturb(int t) { return (float)t * 1e-9f; }

__global__ void __launch_bounds__(FMA_THREADS)
fma_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
           const float* __restrict__ rep, float* __restrict__ partial, int C,
           int T) {
    __shared__ float s_part[FMA_WARPS][6];
    const int s = blockIdx.x;
    const int c = blockIdx.y;
    float a[FMA_PER], b[FMA_PER], r0[FMA_PER], r1[FMA_PER], r2[FMA_PER];
#pragma unroll
    for (int i = 0; i < FMA_PER; ++i) {
        const int k = s * FMA_THREADS * FMA_PER + threadIdx.x
                      + i * FMA_THREADS;
        a[i] = yr[(size_t)c * SP + k];
        b[i] = yi[(size_t)c * SP + k];
        r0[i] = rep[((size_t)0 * C + c) * SP + k];
        r1[i] = rep[((size_t)1 * C + c) * SP + k];
        r2[i] = rep[((size_t)2 * C + c) * SP + k];
    }
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float tf = 0.f;            // t, exact in float32 below 2^24 steps
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
        const float eps = tf * 1e-9f;                 // perturb(t)
        tf += 1.0f;
#pragma unroll
        for (int i = 0; i < FMA_PER; ++i) {
            const float y = a[i] + eps;
            acc[0] = fmaf(y, r0[i], acc[0]);
            acc[1] = fmaf(b[i], r0[i], acc[1]);
            acc[2] = fmaf(y, r1[i], acc[2]);
            acc[3] = fmaf(b[i], r1[i], acc[3]);
            acc[4] = fmaf(y, r2[i], acc[4]);
            acc[5] = fmaf(b[i], r2[i], acc[5]);
        }
    }
    track::block_sum6<FMA_WARPS>(acc, s_part);
    if (threadIdx.x == 0)
        partial[(size_t)c * FMA_SPLIT + s] =
            acc[0] + acc[1] + acc[2] + acc[3] + acc[4] + acc[5];
}

// out[c] = channel c's FMA_SPLIT partials, added in order.
__global__ void fma_sum_kernel(const float* __restrict__ partial,
                               float* __restrict__ out, int C) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    float v = partial[(size_t)c * FMA_SPLIT];
#pragma unroll
    for (int s = 1; s < FMA_SPLIT; ++s) v += partial[(size_t)c * FMA_SPLIT + s];
    out[c] = v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two float32 values rounded to bf16 (to nearest even), lo in the low
// half: one .b32 register of a wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// The wgmma descriptor of a K-major operand without swizzle: 8 x 16-byte
// core matrices, the two along K (LBO) 128 bytes apart, successive groups
// of 8 rows (SBO) 256 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
           | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// Keep the compiler from moving accesses of an accumulator register across
// the wgmma fences and waits around it.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(PENDING)
                 : "memory");
}

// d (+)= A @ B for the warpgroup's 64 x 128 tile: A (64 x 16 bf16) from
// registers, B (16 x 128 bf16) from shared memory through desc; scale_d 0
// starts the accumulators afresh.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}

// One step t of the mma kernel on register set a of A.  A step that
// starts a chunk of FLUSH (fresh) first adds the last chunk's accumulators
// into sum (none before the first) and then starts them afresh; the yr
// rows' A is rounded from this step's yr + t * 1e-9 and the wgmma issued.
// On return at most NSETS - 1 of the warpgroup's wgmmas are in flight, so
// the one that last read the set of its next step is done.
__device__ __forceinline__ void mma_step(float (&d)[64], float (&sum)[64],
                                         uint32_t (&a)[4],
                                         const float2 (&f)[4], bool is_yr,
                                         int t, bool fresh, bool first,
                                         uint64_t desc) {
    if (fresh && !first) {
        wgmma_wait<0>();
        fence_operands(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += d[i];
    }
    if (is_yr) {
        const float eps = perturb(t);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            a[i] = pack_bf16(f[i].x + eps, f[i].y + eps);
    }
    wgmma_fence();
    fence_operands(d);
    wgmma_m64n128k16(d, a, desc, fresh ? 0 : 1);
    fence_operands(d);
    wgmma_commit();
    wgmma_wait<NSETS - 1>();
}

__global__ void __launch_bounds__(MMA_THREADS, 1)
mma_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
           const __nv_bfloat16* __restrict__ repT,
           const float* __restrict__ mask, float* __restrict__ partial,
           int T) {
    // B: rows k0 .. k0 + 15 of repT, element (k, n) at byte
    // (n / 8) * 256 + (k / 8) * 128 + (n % 8) * 16 + (k % 8) * 2
    __shared__ __align__(128) __nv_bfloat16 s_b[MMA_K * N];
    // each warpgroup's masked row sums
    __shared__ float s_rows[WGS][MMA_ROWS];
    const int wg = threadIdx.x / WG;
    const int tid = threadIdx.x % WG;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;          // row within the 8-row group
    const int q = tid & 3;                  // column pair
    const int k0 = blockIdx.x * MMA_K;
    for (int e = threadIdx.x; e < MMA_K * N; e += MMA_THREADS) {
        const int k = e / N, n = e % N;
        s_b[(n >> 3) * 128 + (k >> 3) * 64 + (n & 7) * 8 + (k & 7)] =
            repT[(size_t)(k0 + k) * N + n];
    }
    // the generic-proxy stores above, before the tensor cores read them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const uint64_t desc = kmajor_desc(s_b);

    // A fragment of warp w: rows 16 w .. 16 w + 15 of the stacked 64 (w < 2
    // yr, else yi); register i holds row r0 (i even) or r0 + 8 (i odd),
    // columns 2q, 2q + 1 (i < 2) or 2q + 8, 2q + 9 (i >= 2) of the slice
    const bool is_yr = warp < 2;
    const float* src = is_yr ? yr : yi;
    const int r0 = 16 * (warp & 1) + g;
    float2 f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        f[i] = *reinterpret_cast<const float2*>(
            src + (size_t)(r0 + 8 * (i & 1)) * SP + k0 + 2 * q + 8 * (i >> 1));
    uint32_t a[NSETS][4];
#pragma unroll
    for (int s = 0; s < NSETS; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[s][i] = pack_bf16(f[i].x, f[i].y);
    float d[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        d[i] = 0.f;
        sum[i] = 0.f;
    }
    // the warpgroup's steps t = wg + WGS u, u < steps; its u-th on set u %
    // NSETS, the sets unrolled so each stays in registers
    const int steps = T > wg ? (T - wg + WGS - 1) / WGS : 0;
    int u = 0;
    for (; u + NSETS <= steps; u += NSETS) {
#pragma unroll
        for (int s = 0; s < NSETS; ++s)
            mma_step(d, sum, a[s], f, is_yr, wg + WGS * (u + s),
                     ((u + s) & (FLUSH - 1)) == 0, u + s == 0, desc);
    }
#pragma unroll
    for (int s = 0; s < NSETS - 1; ++s)
        if (u + s < steps)
            mma_step(d, sum, a[s], f, is_yr, wg + WGS * (u + s),
                     ((u + s) & (FLUSH - 1)) == 0, u + s == 0, desc);
    wgmma_wait<0>();
    fence_operands(d);
    if (steps > 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += d[i];
    }

    // masked row sums: d[4j + {0, 1}] is row r (16 w + g), d[4j + {2, 3}]
    // row r + 8, at columns 8j + 2q + {0, 1}
    const int row = 16 * warp + g;
    const float* m_lo = mask + (size_t)(row & (MMA_C - 1)) * N;
    const float* m_hi = mask + (size_t)((row + 8) & (MMA_C - 1)) * N;
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * q;
        lo += sum[4 * j] * m_lo[col] + sum[4 * j + 1] * m_lo[col + 1];
        hi += sum[4 * j + 2] * m_hi[col] + sum[4 * j + 3] * m_hi[col + 1];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        lo += __shfl_xor_sync(0xffffffffu, lo, off);
        hi += __shfl_xor_sync(0xffffffffu, hi, off);
    }
    if (q == 0) {
        s_rows[wg][row] = lo;
        s_rows[wg][row + 8] = hi;
    }
    __syncthreads();
    if (threadIdx.x < MMA_ROWS) {
        float v = s_rows[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < WGS; ++w) v += s_rows[w][threadIdx.x];
        partial[(size_t)blockIdx.x * MMA_ROWS + threadIdx.x] = v;
    }
}

// out[c] = the CTAs' partials of rows c (yr) and 32 + c (yi), added in CTA
// order; the partials are staged in shared memory by one coalesced pass.
__global__ void __launch_bounds__(SUM_THREADS)
mma_sum_kernel(const float* __restrict__ partial, float* __restrict__ out) {
    __shared__ float s_p[MMA_CTAS * MMA_ROWS];
    for (int i = threadIdx.x; i < MMA_CTAS * MMA_ROWS; i += SUM_THREADS)
        s_p[i] = partial[i];
    __syncthreads();
    const int c = threadIdx.x;
    if (c >= MMA_C) return;
    float v = 0.f;
    for (int b = 0; b < MMA_CTAS; ++b)
        v += s_p[b * MMA_ROWS + c] + s_p[b * MMA_ROWS + MMA_C + c];
    out[c] = v;
}

}  // namespace

// yr, yi: (C, 2048) f32; rep: (3, C, 2048) f32; out: (C, 1) f32;
// partial: (C, 8) f32 scratch (channel x block).  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int corr_bank_fma_launch(const void* yr, const void* yi,
                                    const void* rep, void* out, void* partial,
                                    int C, int T, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    fma_kernel<<<dim3(FMA_SPLIT, C), FMA_THREADS, 0, s>>>(
        static_cast<const float*>(yr), static_cast<const float*>(yi),
        static_cast<const float*>(rep), static_cast<float*>(partial), C, T);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fma_sum_kernel<<<(C + 127) / 128, 128, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), C);
    return static_cast<int>(cudaGetLastError());
}

// yr, yi: (32, 2048) f32; repT: (2048, 128) bf16; mask: (32, 128) f32;
// out: (32, 1) f32; partial: (128, 64) f32 scratch (CTA x row of the
// stacked yr_t / yi rows).  C must be 32.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int corr_bank_mma_launch(const void* yr, const void* yi,
                                    const void* repT, const void* mask,
                                    void* out, void* partial, int C, int T,
                                    void* stream) {
    if (C != MMA_C) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    mma_kernel<<<MMA_CTAS, MMA_THREADS, 0, s>>>(
        static_cast<const float*>(yr), static_cast<const float*>(yi),
        static_cast<const __nv_bfloat16*>(repT),
        static_cast<const float*>(mask), static_cast<float*>(partial), T);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mma_sum_kernel<<<1, SUM_THREADS, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
