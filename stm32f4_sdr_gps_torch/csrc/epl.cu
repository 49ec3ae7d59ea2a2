// Per-epoch E/P/L correlator for Hopper (sm_90a): carrier wipe-off and the
// three half-chip replica lags of one 1 ms epoch, for C channels.
//
// Replaces the JAX package's Pallas TPU kernel K2,
// stm32f4_sdr_gps_tpu/ops/pallas_epl.py::_epl_kernel_real (launched by
// epl_correlate_pallas).  The per-epoch tracking loop (track/scan.py,
// TrackConfig.use_pallas with the whole-block scan off) launches it once
// per epoch through ops/epl.py:epl_correlate.
//
// Design.  One block of 256 threads per channel.  Every thread reads the
// channel's code phase, Doppler and carrier phase, and takes the samples
// k = tid, tid + 256, ... of the 2046 (no padding lanes): the carrier is
// rotated off exactly per sample and the replica is read from the
// channel's doubled upsampled code row in global memory at u2[m - 1 + k],
// u2[m + k], u2[m + 1 + k], with m the integer half-chip shift.  The
// per-sample work (epl_sample) and the shift (halfchip_shift) are the
// tracking-scan kernel's own, from track_epoch.cuh, and so is the block
// reduction of the six sums (block_sum6); thread 0 writes the channel's
// row of the (C, 3) complex64 output.  The TPU kernel's lane rolls of the
// code row, its zero-padded epoch and its clamp of a negative shift are
// gone: the shift is asserted to lie in [1, 2046] instead.
//
// Bound.  Per epoch each block reads the 16 KB epoch (all C blocks share
// it through the 50 MB L2) and a 16 KB window of its 17 KB code row, and
// does one sincospif and six multiply-adds per sample: a few microseconds
// of work that at the receiver's few channels fills a handful of the 132
// SMs, so one launch costs about its launch latency.  The per-epoch path
// around it (about 120 small torch launches per epoch) costs far more;
// the whole-block scan (track_scan.cu) is the fast path.  Making this
// kernel faster is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <assert.h>
#include <cuda_runtime.h>

#include "track_epoch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
epl_kernel(const float2* __restrict__ x, const float* __restrict__ u2,
           const float* __restrict__ cp, const float* __restrict__ dop,
           const float* __restrict__ ph, float* __restrict__ out,
           float fs) {
    __shared__ float s_part[WARPS][6];
    const int c = blockIdx.x;
    const int m = track::halfchip_shift(cp[c]);
    // the precondition that keeps every replica read inside the row
    assert(m >= 1 && m <= track::S);
    const float* rep = u2 + (size_t)c * track::U2P + (m - 1);
    const float phase = ph[c];
    const float dopfs = dop[c] / fs;
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = threadIdx.x; k < track::S; k += THREADS) {
        const float2 v = x[k];
        track::epl_sample(acc, v.x, v.y, k, phase, dopfs, rep);
    }
    track::block_sum6<WARPS>(acc, s_part);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int j = 0; j < 6; ++j) out[(size_t)c * 6 + j] = acc[j];
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
    epl_kernel<<<C, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        xp, up, cpp, dp, pp, op, fs);
    return static_cast<int>(cudaGetLastError());
}
