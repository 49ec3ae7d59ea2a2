// Per-frame arithmetic of the real-IF ingest kernel (if_resample.cu): int8
// real samples at L / M of the way down to 2.046 MHz (38.192 MHz: L = 3,
// M = 56), mixed by the exact quarter-rate sequence and resampled by a
// polyphase low-pass FIR.
//
// A frame is M input samples and the L outputs they complete: output
// m = L a + b of frame a reads the staged samples up to
// top = M a + off_max, the highest sample any output of the frame reads.
// Its taps are laid out "shifted" (signal/capture.py:if_resample_plan):
// H[b * D + d] multiplies the staged sample top - d, and is zero where d
// falls outside output b's own P taps, so every output of a frame walks
// the same D samples (D even) in the same order, two at a time.
//
// Everything here is __host__ __device__: nvcc builds it into the Hopper
// kernel and g++ builds the same source (with -D__host__= -D__device__=)
// into the host library (if_resample_host.cpp) that the CPU tests hold
// against the plain torch version.  Both builds add with one rounding a
// fused multiply-add (fma_rn), in the same order, so the host build is the
// kernel's output bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

namespace ifr {

constexpr int THREADS = 128;   // threads a block, one frame each
constexpr int MAX_L = 4;       // outputs a frame the kernel is built for

// a * b + c with one rounding: __fmaf_rn on the card, fmaf on the host.
__host__ __device__ inline float fma_rn(float a, float b, float c) {
#ifdef __CUDA_ARCH__
    return __fmaf_rn(a, b, c);
#else
    return fmaf(a, b, c);
#endif
}

// The exact quarter-rate mix e^{-j pi i / 2} = (-j)^i = 1, -j, -1, j: an
// even sample goes to the real part with sign +1, -1 and an odd one to the
// imaginary part with sign -1, +1.
__host__ __device__ inline float mix_sign(long long i) {
    const int q = (int)(i & 3);
    return (q == 0 || q == 3) ? 1.0f : -1.0f;
}

// Sample i as the kernel stages it: signed by the mix, zero before the
// window (the filter's history) and past its end.
__host__ __device__ inline float staged(const int8_t* x, long long i,
                                        long long n) {
    return (i >= 0 && i < n) ? (float)x[i] * mix_sign(i) : 0.0f;
}

// Two taps of one output, at d and d + 1: read as one 8-byte word.
struct alignas(8) TapPair {
    float even, odd;
};

// Adds the staged samples at d = 2 i (v0) and d + 1 (v1) into every
// output of a frame: acc[b][0] sums the even d, acc[b][1] the odd d.  H
// holds output b's taps as D / 2 pairs from H[b * D / 2].
template <int L>
__host__ __device__ inline void accumulate(float (&acc)[L][2],
                                           const TapPair* H, int half_d,
                                           int i, float v0, float v1) {
#pragma unroll
    for (int b = 0; b < L; ++b) {
        const TapPair h = H[b * half_d + i];
        acc[b][0] = fma_rn(h.even, v0, acc[b][0]);
        acc[b][1] = fma_rn(h.odd, v1, acc[b][1]);
    }
}

// Writes the frame's L complex outputs as (re, im) pairs: a sample's
// parity says its part, and the samples at even d have the parity of top.
template <int L>
__host__ __device__ inline void finish(const float (&acc)[L][2], long long top,
                                       float* out) {
    const bool odd = top & 1;
#pragma unroll
    for (int b = 0; b < L; ++b) {
        out[2 * b] = odd ? acc[b][1] : acc[b][0];
        out[2 * b + 1] = odd ? acc[b][0] : acc[b][1];
    }
}

}  // namespace ifr
