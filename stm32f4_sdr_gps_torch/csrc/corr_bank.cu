// Correlator-bank probe for Hopper (sm_90a): the E/P/L correlator bank of
// C = 32 channels over SP = 2048 samples, written two ways, with T steps
// inside one launch.
//
// Replaces the JAX package's Pallas TPU probe P5,
// tools/mxu_corr_probe.py::make_fn.kernel, which asks whether the bank is
// cheaper as six vector multiply-reduce sums or as two block-diagonal
// matrix products.  Its sequential grid of T steps becomes a loop inside
// the launch.  Step t perturbs yr by t * 1e-9 so that no step repeats
// another, and adds a per-channel total into a (C, 1) float32 sum:
//
//   fma: tot[c] = sum_k yr_t*r0 + sum_k yi*r0 + sum_k yr_t*r1 + ...
//        (the six sums of the E/P/L bank against rep (3, C, SP));
//   mma: tot[c] = sum_n (bf16(yr_t) @ repT)[c, n] * mask[c, n]
//              + sum_n (bf16(yi) @ repT)[c, n] * mask[c, n]
//        (two (C, SP) x (SP, N = 128) bf16 products on the tensor cores,
//        float32 accumulators, then a masked row sum).
//
// Design.
// * fma: one block of 256 threads per channel.  Each thread keeps its 8
//   samples of yr, yi and the three replica rows in registers for all T
//   steps; per step it forms its six partial sums and the block reduces
//   them (block_sum6 of track_epoch.cuh, shared scratch alternating
//   between two buffers so one barrier per step suffices); thread 0 adds
//   the six totals and carries the channel's sum.
// * mma: the K = SP axis is cut into 32 slices of 64, one block each.  A
//   block's 8 warps own one 16-column tile of N each; per step the block
//   rounds its (32, 64) slices of yr_t and yi to bf16 into shared memory,
//   each warp runs 4 k-steps x 2 row tiles x 2 products of wmma 16x16x16
//   bf16 with float32 accumulators (its replica fragments stay in
//   registers for all T steps), stores them to shared memory, and 8
//   threads per channel row take the masked row sums.  Each block carries
//   its channels' partial totals over the T steps; a second small kernel
//   adds the 32 slices' totals in order.
//
// Bound.  Both are latency-bound at this size: per step the fma kernel
// does 12 flops on each of 32 x 2048 samples and one block barrier, the
// mma kernel 33.5 Mflop on the tensor cores across 32 blocks and two
// barriers.  Which is cheaper per step at 32 channels is the question the
// probe answers (PERF.md); making either fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "track_epoch.cuh"

namespace {

using namespace nvcuda;

constexpr int SP = 2048;                // samples per row
constexpr int N = 128;                  // replica-matrix columns
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = SP / THREADS;       // samples per thread (fma)
constexpr int MMA_C = 32;               // channels of the mma kernel
constexpr int KB = 64;                  // K slice of one mma block
constexpr int NBLK = SP / KB;           // 32 mma blocks
constexpr int KSTEPS = KB / 16;
constexpr int MTILES = MMA_C / 16;
constexpr int A_PER = MMA_C * KB / THREADS;   // slice elements per thread
constexpr int NPART = N / 16;           // threads per channel row (sums)
// Row strides of the shared tiles, padded against bank conflicts: a row
// of LA bf16 starts 4 banks after the one above it (the fragment loads
// read 8 rows of 16 bytes at once), a row of LM floats 8 banks after (the
// row sums read 4 rows x 8 columns at once).  Unpadded, the conflicts
// cost more than half of each step.
constexpr int LA = KB + 8;
constexpr int LM = N + 8;

__device__ inline float perturb(int t) { return (float)t * 1e-9f; }

__global__ void __launch_bounds__(THREADS)
fma_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
           const float* __restrict__ rep, float* __restrict__ out, int C,
           int T) {
    __shared__ float s_part[2][WARPS][6];
    const int c = blockIdx.x;
    float a[PER], b[PER], r0[PER], r1[PER], r2[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int k = threadIdx.x + i * THREADS;
        a[i] = yr[(size_t)c * SP + k];
        b[i] = yi[(size_t)c * SP + k];
        r0[i] = rep[((size_t)0 * C + c) * SP + k];
        r1[i] = rep[((size_t)1 * C + c) * SP + k];
        r2[i] = rep[((size_t)2 * C + c) * SP + k];
    }
    float total = 0.0f;
    for (int t = 0; t < T; ++t) {
        const float eps = perturb(t);
        float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const float y = a[i] + eps;
            acc[0] += y * r0[i];
            acc[1] += b[i] * r0[i];
            acc[2] += y * r1[i];
            acc[3] += b[i] * r1[i];
            acc[4] += y * r2[i];
            acc[5] += b[i] * r2[i];
        }
        track::block_sum6<WARPS>(acc, s_part[t & 1]);
        if (threadIdx.x == 0)
            total += acc[0] + acc[1] + acc[2] + acc[3] + acc[4] + acc[5];
    }
    if (threadIdx.x == 0) out[c] = total;
}

__global__ void __launch_bounds__(THREADS)
mma_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
           const __nv_bfloat16* __restrict__ repT,
           const float* __restrict__ mask, float* __restrict__ partial,
           int T) {
    // bf16 slices of yr_t (0) and yi (1), (MMA_C, KB) in rows of LA
    __shared__ __align__(32) __nv_bfloat16 s_a[2][MMA_C * LA];
    // the two products' (MMA_C, N) float32 results for this K slice, in
    // rows of LM
    __shared__ __align__(32) float s_m[2][MMA_C * LM];
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int k0 = blockIdx.x * KB;

    // this thread's elements of the slice, kept in registers
    float ar[A_PER], ai[A_PER];
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
        const int e = tid + i * THREADS;
        const size_t g = (size_t)(e / KB) * SP + k0 + e % KB;
        ar[i] = yr[g];
        ai[i] = yi[g];
    }
    // this warp's replica fragments: rows k0.., columns warp*16..
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> bf[KSTEPS];
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k)
        wmma::load_matrix_sync(bf[k], repT + (size_t)(k0 + k * 16) * N
                                          + warp * 16, N);
    // masked row sums: thread (row, part) takes columns part + 8 j
    const int row = tid / NPART;
    const int part = tid % NPART;
    float mk[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) mk[j] = mask[row * N + part + NPART * j];

    float total = 0.0f;
    for (int t = 0; t < T; ++t) {
        const float eps = perturb(t);
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            const int e = tid + i * THREADS;
            const int a = (e / KB) * LA + e % KB;
            s_a[0][a] = __float2bfloat16(ar[i] + eps);
            s_a[1][a] = __float2bfloat16(ai[i]);
        }
        __syncthreads();
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][MTILES];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int m = 0; m < MTILES; ++m) wmma::fill_fragment(acc[p][m], 0.f);
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
#pragma unroll
                for (int m = 0; m < MTILES; ++m) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                   wmma::row_major> af;
                    wmma::load_matrix_sync(af, s_a[p] + m * 16 * LA + k * 16,
                                           LA);
                    wmma::mma_sync(acc[p][m], af, bf[k], acc[p][m]);
                }
            }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int m = 0; m < MTILES; ++m)
                wmma::store_matrix_sync(s_m[p] + m * 16 * LM + warp * 16,
                                        acc[p][m], LM, wmma::mem_row_major);
        __syncthreads();
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            s1 += s_m[0][row * LM + part + NPART * j] * mk[j];
            s2 += s_m[1][row * LM + part + NPART * j] * mk[j];
        }
#pragma unroll
        for (int off = NPART / 2; off > 0; off >>= 1) {
            s1 += __shfl_down_sync(0xffffffffu, s1, off, NPART);
            s2 += __shfl_down_sync(0xffffffffu, s2, off, NPART);
        }
        if (part == 0) total += s1 + s2;
    }
    if (part == 0) partial[(size_t)blockIdx.x * MMA_C + row] = total;
}

// out[c] = the NBLK slices' totals of channel c, added in slice order.
__global__ void sum_slices_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out) {
    const int c = threadIdx.x;
    float v = partial[c];
    for (int b = 1; b < NBLK; ++b) v += partial[(size_t)b * MMA_C + c];
    out[c] = v;
}

}  // namespace

// yr, yi: (C, 2048) f32; rep: (3, C, 2048) f32; out: (C, 1) f32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int corr_bank_fma_launch(const void* yr, const void* yi,
                                    const void* rep, void* out, int C, int T,
                                    void* stream) {
    fma_kernel<<<C, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(yr), static_cast<const float*>(yi),
        static_cast<const float*>(rep), static_cast<float*>(out), C, T);
    return static_cast<int>(cudaGetLastError());
}

// yr, yi: (32, 2048) f32; repT: (2048, 128) bf16; mask: (32, 128) f32;
// out: (32, 1) f32; partial: (32, 32) f32 scratch (slice x channel).  C
// must be 32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int corr_bank_mma_launch(const void* yr, const void* yi,
                                    const void* repT, const void* mask,
                                    void* out, void* partial, int C, int T,
                                    void* stream) {
    if (C != MMA_C) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    mma_kernel<<<NBLK, THREADS, 0, s>>>(
        static_cast<const float*>(yr), static_cast<const float*>(yi),
        static_cast<const __nv_bfloat16*>(repT),
        static_cast<const float*>(mask), static_cast<float*>(partial), T);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_slices_kernel<<<1, MMA_C, 0, s>>>(static_cast<const float*>(partial),
                                          static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
