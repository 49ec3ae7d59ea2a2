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
// Bound.  A roll computes nothing: the bytes it moves (each input lane
// read once, each output lane written once) over 3.35 TB/s, 5 ns to
// 1.33 us from 8 rows of 256 lanes to 128 of 4352, under the ~1.7 us of a
// queued empty launch (NVIDIA H100 80GB HBM3, 700 W) until 128 rows.  So
// each kernel does the least an output lane needs and fills the card at
// 128 rows:
// * a 2-D grid (lane chunks x rows) of ROLL_THREADS-thread blocks; each
//   thread writes VEC = 4 consecutive lanes of a row (roll_lanes,
//   barrel_lanes in roll_ops.cuh) with one 16-byte store an output.  On
//   that card 128 threads a block and one chunk a thread measured best
//   (probes/roll_parts.py): at 128 rows each further block of the grid
//   costs about half a nanosecond (32 and 64 threads a block lose up to
//   1.8 and 0.5 us), and two or four chunks a thread put fewer loads in
//   flight at 8 and 32 rows;
// * a row's amounts are read and folded once a thread, the same values in
//   every thread of the block, so a lane's source is an add and a
//   conditional subtract, not a %;
// * no shared memory and no block barrier.  The barrel's stages compose
//   into one left roll by s = es & 15 and P, L into one more by 1 and 2,
//   so E, P and L are one gather from the u2 row at the composed index
//   (barrel_src), each thread reading the VEC + 2 u2 lanes it needs once
//   for all three outputs.  On the TPU, Mosaic's rotate forced the
//   barrel stage by stage; the card does not need it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cuda_runtime.h>

#include "roll_ops.cuh"

namespace {

using namespace roll;

constexpr int ROLL_THREADS = 128;
constexpr int CHUNKS = 1;                      // 4-lane chunks a thread
constexpr int STRIDE = ROLL_THREADS * VEC;     // from chunk to chunk
constexpr int LANES = STRIDE * CHUNKS;         // output lanes a block

__global__ void __launch_bounds__(ROLL_THREADS)
roll_rows_kernel(const float* __restrict__ x, const int* __restrict__ amt,
                 float* __restrict__ out, int W, int src_row) {
    const int r = blockIdx.y;
    const int j0 = blockIdx.x * LANES + threadIdx.x * VEC;
    if (j0 >= W) return;
    const int a = fold(amt[r], W);
    const float* src = x + (size_t)(src_row < 0 ? r : src_row) * W;
    float* dst = out + (size_t)r * W;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        const int j = j0 + c * STRIDE;
        if (j < W) roll_lanes(src, dst, j, a, W);
    }
}

__global__ void __launch_bounds__(ROLL_THREADS)
barrel_kernel(const float* __restrict__ u2, const int* __restrict__ mc,
              const int* __restrict__ es, float* __restrict__ e,
              float* __restrict__ p, float* __restrict__ l) {
    const int r = blockIdx.y;
    const int j0 = blockIdx.x * LANES + threadIdx.x * VEC;
    if (j0 >= WIN) return;
    const int a = rebuild_amount(mc[r]);
    const int s = barrel_shift(es[r]);
    const float* row = u2 + (size_t)r * U2P;
    const size_t o = (size_t)r * WIN;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        const int j = j0 + c * STRIDE;
        if (j < WIN) barrel_lanes(row, e + o, p + o, l + o, j, a, s);
    }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// x: (R, W) f32 (P2: at least src_row + 1 rows); amt: (R,) i32, any sign
// and size; out: (R, W) f32, 16-byte aligned where W % 4 == 0.
// src_row < 0 rolls row r into row r, else row src_row into every row.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int roll_rows_launch(const void* x, const void* amt, void* out,
                                int R, int W, int src_row, void* stream) {
    if (R < 1 || R > 65535 || W < 1 || src_row < -1) return invalid();
    if (W % VEC == 0 && !aligned16(out)) return invalid();
    const dim3 grid((W + LANES - 1) / LANES, R);
    roll_rows_kernel<<<grid, ROLL_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int*>(amt),
        static_cast<float*>(out), W, src_row);
    return static_cast<int>(cudaGetLastError());
}

// u2: (R, 4352) f32; mc, es: (R,) i32; e, p, l: (R, 2176) f32, 16-byte
// aligned.  Launches on `stream` and returns cudaGetLastError().
extern "C" int barrel_launch(const void* u2, const void* mc, const void* es,
                             void* e, void* p, void* l, int R, void* stream) {
    if (R < 1 || R > 65535) return invalid();
    if (!(aligned16(e) && aligned16(p) && aligned16(l))) return invalid();
    const dim3 grid((WIN + LANES - 1) / LANES, R);
    barrel_kernel<<<grid, ROLL_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u2), static_cast<const int*>(mc),
        static_cast<const int*>(es), static_cast<float*>(e),
        static_cast<float*>(p), static_cast<float*>(l));
    return static_cast<int>(cudaGetLastError());
}
