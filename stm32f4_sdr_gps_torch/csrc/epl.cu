// Per-epoch E/P/L correlator for Hopper (sm_90a): carrier wipe-off and the
// three half-chip replica lags of one 1 ms epoch, for C channels.
//
// Replaces the JAX package's Pallas TPU kernel K2,
// stm32f4_sdr_gps_tpu/ops/pallas_epl.py::_epl_kernel_real (launched by
// epl_correlate_pallas).  The per-epoch tracking loop (track/scan.py,
// TrackConfig.use_pallas with the whole-block scan off) launches it once
// per epoch through ops/epl.py:epl_correlate.
//
// Design.  One block of K1_THREADS (128) threads per channel, which adds
// the epoch's E/P/L in the tracking scan's order (track_scan.cu), so with
// the same (m, ph, dopfs) the two kernels give the same sums bit for bit:
// thread tid takes the samples k = tid + j * 128, j < 16, the two past the
// 2046 being exact zeros in registers (the kernel reads x straight from its
// (2046,) tensor and never past it); the six sums go through the
// transposed warp butterfly (warp_sum6), one block barrier and the
// pairwise tree over the four warps (tree_sum), all from track_epoch.cuh.
// The trip count is a compile-time constant, so each thread issues all of
// its loads (16 samples of x, the 16 x 3 replica values u2[m - 1 + k],
// u2[m + k], u2[m + 1 + k]) before its arithmetic and pays their latency
// once.  The carrier is rotated off exactly per sample (epl_terms).
// Threads 0-5 write the channel's six sums, its row of the (C, 3)
// complex64 output.  The TPU kernel's lane rolls of the code row, its
// zero-padded epoch and its clamp of a negative shift are gone: the shift
// m is asserted to lie in [1, 2046], which keeps every replica read,
// u2[m - 1 + 2049] at most, inside the 4352-wide row.
//
// Bound.  Per epoch each block reads the 16 KB epoch (all C blocks share
// it through the 50 MB L2) and a 16 KB window of its 17 KB code row, and
// does one sincospif, the rotation and six multiply-adds per sample: well
// under a microsecond of work that at the receiver's few channels fills a
// handful of the 132 SMs, so one launch costs about its launch latency
// (chip_smoke.py times an empty kernel beside it).  The per-epoch path
// around it (about 210 small torch launches per epoch) costs far more; the
// whole-block scan (track_scan.cu) is the fast path.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <assert.h>
#include <cuda_runtime.h>

#include "track_epoch.cuh"

namespace {

using track::K1_THREADS;
using track::K1_WARPS;

constexpr int NJ = track::SP / K1_THREADS;   // samples per thread
constexpr int PART = 8;                      // floats per warp partial

__global__ void __launch_bounds__(K1_THREADS)
epl_kernel(const float2* __restrict__ x, const float* __restrict__ u2,
           const float* __restrict__ cp, const float* __restrict__ dop,
           const float* __restrict__ ph, float* __restrict__ out,
           float fs) {
    __shared__ float s_part[K1_WARPS * PART];
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const int m = track::halfchip_shift(cp[c]);
    // the precondition that keeps every replica read inside the row
    assert(m >= 1 && m <= track::S);
    const float* rep = u2 + (size_t)c * track::U2P + (m - 1);
    const float phase = ph[c];
    const float dopfs = dop[c] / fs;
    float2 v[NJ];
    float e[NJ], p[NJ], l[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int k = tid + j * K1_THREADS;
        v[j] = k < track::S ? x[k] : make_float2(0.f, 0.f);
        e[j] = rep[k];
        p[j] = rep[k + 1];
        l[j] = rep[k + 2];
    }
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
        track::epl_terms(acc, v[j].x, v[j].y, tid + j * K1_THREADS, phase,
                         dopfs, e[j], p[j], l[j]);
    const float total = track::warp_sum6(acc);
    const int lane = tid % 32;
    if (lane % 4 == 0 && lane < 24)                  // lane 4j: sum j
        s_part[(tid / 32) * PART + lane / 4] = total;
    __syncthreads();
    if (tid < 6) {
        float w[K1_WARPS];
#pragma unroll
        for (int i = 0; i < K1_WARPS; ++i) w[i] = s_part[i * PART + tid];
        out[(size_t)c * 6 + tid] = track::tree_sum<K1_WARPS>(w);
    }
}

}  // namespace

// x: (2046,) complex64 as interleaved float pairs; u2: (C, 4352) f32;
// cp, dop, ph: (C,) f32 code phase (chips), Doppler (Hz), carrier phase
// (cycles); out: (C, 3) complex64 as (C, 6) f32 (ie, qe, ip, qp, il, ql).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int epl_launch(const void* x, const void* u2, const void* cp,
                          const void* dop, const void* ph, void* out, int C,
                          float fs, void* stream) {
    const float2* xp = static_cast<const float2*>(x);
    const float* up = static_cast<const float*>(u2);
    const float* cpp = static_cast<const float*>(cp);
    const float* dp = static_cast<const float*>(dop);
    const float* pp = static_cast<const float*>(ph);
    float* op = static_cast<float*>(out);
    epl_kernel<<<C, K1_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        xp, up, cpp, dp, pp, op, fs);
    return static_cast<int>(cudaGetLastError());
}
