// Per-sample and per-epoch arithmetic of the handoff search kernels
// (pretrack.cu): the squared-prompt Doppler search's prompts and the
// half-chip code search's correlations, both over E epochs of C channels.
//
// Everything here is __host__ __device__: nvcc builds it into the Hopper
// kernels, and g++ builds the same source (with -D__host__= -D__device__=)
// into the host library (pretrack_host.cpp) that the CPU tests hold against
// the plain torch loops, acquire/engine.py:squared_prompts_plain and
// track/pretrack.py:_pretrack_power.
//
// Floating point: both builds run without fused multiply-add contraction
// (nvcc -fmad=false, g++ -ffp-contract=off), so every float operation is
// one IEEE single-precision rounding in source order, apart from the
// explicit fused multiply-adds (fma_rn: __fmaf_rn on the card), which stand
// exactly where the plain loops call ops/wipeoff.fma: the carrier phase's
// epoch step and the replica's sample position.  The epoch recurrences and
// the chip index are therefore the plain loops' bit for bit; the wiped
// samples differ from them only in sincospif against torch's cos/sin of
// -2 pi x, and the sums in their order.
#pragma once

#include "track_epoch.cuh"

namespace pretrack {

constexpr int THREADS = 256;            // threads a block, one block an
constexpr int WARPS = THREADS / 32;     // (epoch, channel)
constexpr int NJ = 8;                   // samples a thread holds
constexpr int MAX_S = THREADS * NJ;     // samples an epoch at most
constexpr int MAX_K = 64;               // half-chip offsets at most
constexpr int CODE_LENGTH = track::CODE_LENGTH;

// a * b + c with one rounding: __fmaf_rn on the card, fmaf on the host.
__host__ __device__ inline float fma_rn(float a, float b, float c) {
#ifdef __CUDA_ARCH__
    return __fmaf_rn(a, b, c);
#else
    return fmaf(a, b, c);
#endif
}

// The code phase one epoch on: torch.remainder(cp + chips_per_epoch, 1023).
__host__ __device__ inline float next_code_phase(float cp, float cpe) {
    return track::code_phase_mod(cp + cpe);
}

// The carrier phase one epoch on, as ops/wipeoff.carrier_wipeoff carries
// it: frac(fma(f, n / fs, phase)).
__host__ __device__ inline float next_carrier_phase(float ph, float f,
                                                    float s_over_fs) {
    const float end = fma_rn(f, s_over_fs, ph);
    return end - floorf(end);
}

// The carrier phase at the start of epoch e, from 0 at epoch 0.
__host__ __device__ inline float carrier_phase_at(int e, float f,
                                                  float s_over_fs) {
    float ph = 0.0f;
    for (int t = 0; t < e; ++t) ph = next_carrier_phase(ph, f, s_over_fs);
    return ph;
}

// The code phase at the start of epoch e, from cp0 at epoch 0.
__host__ __device__ inline float code_phase_at(int e, float cp0, float cpe) {
    float cp = cp0;
    for (int t = 0; t < e; ++t) cp = next_code_phase(cp, cpe);
    return cp;
}

// The chip that sample k of a replica reads, as ops/replica.
// sample_replicas computes it: floor(fma(rate, k, base)) mod 1023, where
// base is the code phase plus the lag, rounded once.
__host__ __device__ inline int chip_index(float rate, int k, float base) {
    const float v = fma_rn(rate, (float)k, base);
    return track::floor_mod((int)floorf(v), CODE_LENGTH);
}

// Half-chip offset o of K, centred: (o - (K - 1) / 2) / 2 chips.
__host__ __device__ inline float offset_chips(int o, int K) {
    return ((float)o - 0.5f * (float)(K - 1)) * 0.5f;
}

// Sample k of an epoch with the carrier rotated off:
// y = x * exp(-j 2 pi frac(ph + f * (k / fs))).
__host__ __device__ inline void wipe(float xr, float xi, int k, float ph,
                                     float f, float fs, float* yr,
                                     float* yi) {
    const float t = (float)k / fs;
    float a = ph + f * t;
    a = a - floorf(a);
    float sn, cs;
    sincospif(2.0f * a, &sn, &cs);
    *yr = xr * cs + xi * sn;
    *yi = xi * cs - xr * sn;
}

}  // namespace pretrack
