// Row rolls and K1's replica barrel for Hopper (sm_90a): the JAX package's
// roll probes, whose Pallas TPU kernels they replace:
//
//   P1  tools/tpu_roll_wide_probe.py::_roll_stage.kernel (:78): a dynamic
//       roll of each row of an (8, W) f32 plane by +-shift[r], W = 4352
//       (U2P) and 2176 (WIN);
//   P2  tools/tpu_roll_wide_probe.py::stage_statwin.kernel2 (:115): row 0
//       of an (8, 2176) plane rolled by eight static amounts, one per
//       output row;
//   P3  tools/tpu_roll_wide_probe.py::stage_barrel.kernel (:157): K1's
//       replica compose: each u2 row rebuilt by a roll of a folded
//       non-negative amount from mc and cut to WIN, the masked 4-stage
//       barrel (1, 2, 4, 8) within WIN, then P and L as further rolls;
//   P4  tools/tpu_mosaic_bisect.py::stage_roll.kernel (:76): P1 at W = 256.
//
// P1, P2 and P4 are one kernel, roll_rows_kernel:
// out[r, j] = x[src, (j - amt[r]) mod W], with src = r, or one fixed row
// for P2.  P3 is barrel_kernel.  The row count is a parameter: 8 in the
// tools, C = 32 and 128 rows at K1's channel counts.
//
// The TPU's hazard does not arise here.  On the TPU, tpu.dynamic_rotate
// with a negative amount at a width that is not a power of two returned
// garbage (the r5 divergence of K1), so K1 folds its amounts into [0, W)
// before it rotates.  Here a roll is an indexed read and the kernel folds
// every amount itself (roll_ops.cuh), whatever its sign or size.
//
// Bound.  A roll computes nothing and moves 16-350 KB at the probes'
// sizes: 5-105 ns at 3.35 TB/s, far below the few microseconds of a
// launch, so a launch bounds each of these kernels.  roll_rows_kernel
// gives one thread to each output lane (a block of 256 lanes of one row),
// so neighbouring threads read neighbouring lanes of the source row.
// barrel_kernel gives one block of 256 threads to each row: the rebuilt
// window (8.5 KB) lives in shared memory, each barrel stage reads it
// shifted into registers and writes it back between two block barriers,
// as P8's roll_row does (csrc/forest.cu), and a stage whose bit of es is
// clear is skipped by the whole block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cuda_runtime.h>

#include "roll_ops.cuh"

namespace {

using namespace roll;

constexpr int ROLL_THREADS = 256;
constexpr int BARREL_THREADS = 256;
constexpr int BARREL_PER = (WIN + BARREL_THREADS - 1) / BARREL_THREADS;

__global__ void __launch_bounds__(ROLL_THREADS)
roll_rows_kernel(const float* __restrict__ x, const int* __restrict__ amt,
                 float* __restrict__ out, int W, int src_row) {
    const int r = blockIdx.y;
    const int j = blockIdx.x * ROLL_THREADS + threadIdx.x;
    if (j >= W) return;
    const int src = src_row < 0 ? r : src_row;
    out[(size_t)r * W + j] = x[(size_t)src * W + roll_src(j, amt[r], W)];
}

__global__ void __launch_bounds__(BARREL_THREADS)
barrel_kernel(const float* __restrict__ u2, const int* __restrict__ mc,
              const int* __restrict__ es, float* __restrict__ e,
              float* __restrict__ p, float* __restrict__ l) {
    __shared__ float s_w[WIN];
    const int r = blockIdx.x;
    const int tid = threadIdx.x;
    // rebuild: the window of u2's row at the folded rebuild amount
    const float* row = u2 + (size_t)r * U2P;
    const int amt = rebuild_amount(mc[r]);
    for (int j = tid; j < WIN; j += BARREL_THREADS)
        s_w[j] = row[roll_src(j, amt, U2P)];
    __syncthreads();
    // the masked barrel: stage s left-rolls the window by 1 << s where bit
    // s of the row's es is set (one value per row, so per block)
    const int bits = es[r];
    float v[BARREL_PER];
    for (int s = 0; s < NSTAGE; ++s) {
        const int sh = barrel_shift(s);
        if ((bits & sh) == 0) continue;
#pragma unroll
        for (int i = 0; i < BARREL_PER; ++i) {
            const int j = tid + i * BARREL_THREADS;
            if (j < WIN) v[i] = s_w[roll_src(j, WIN - sh, WIN)];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < BARREL_PER; ++i) {
            const int j = tid + i * BARREL_THREADS;
            if (j < WIN) s_w[j] = v[i];
        }
        __syncthreads();
    }
    // E, then P and L as left rolls by 1 and 2: every lane, wrap lanes too
    const size_t base = (size_t)r * WIN;
    for (int j = tid; j < WIN; j += BARREL_THREADS) {
        const int j1 = roll_src(j, WIN - 1, WIN);
        e[base + j] = s_w[j];
        p[base + j] = s_w[j1];
        l[base + j] = s_w[roll_src(j1, WIN - 1, WIN)];
    }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// x: (R, W) f32 (P2: at least src_row + 1 rows); amt: (R,) i32, any sign
// and size; out: (R, W) f32.  src_row < 0 rolls row r into row r, else
// row src_row into every row.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int roll_rows_launch(const void* x, const void* amt, void* out,
                                int R, int W, int src_row, void* stream) {
    if (R < 1 || R > 65535 || W < 1 || src_row < -1) return invalid();
    const dim3 grid((W + ROLL_THREADS - 1) / ROLL_THREADS, R);
    roll_rows_kernel<<<grid, ROLL_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int*>(amt),
        static_cast<float*>(out), W, src_row);
    return static_cast<int>(cudaGetLastError());
}

// u2: (R, 4352) f32; mc, es: (R,) i32; e, p, l: (R, 2176) f32.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int barrel_launch(const void* u2, const void* mc, const void* es,
                             void* e, void* p, void* l, int R, void* stream) {
    if (R < 1) return invalid();
    barrel_kernel<<<R, BARREL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u2), static_cast<const int*>(mc),
        static_cast<const int*>(es), static_cast<float*>(e),
        static_cast<float*>(p), static_cast<float*>(l));
    return static_cast<int>(cudaGetLastError());
}
