// The real-IF ingest for Hopper (sm_90a): int8 real samples at a rational
// multiple M / L of 2.046 MHz with the IF at a quarter of the sample rate,
// to complex64 baseband at 2.046 MHz, in one launch a window
// (signal/capture.py:if_to_baseband_device; the SoftGNSS front end, 38.192
// MHz: L = 3, M = 56).
//
// Replaces no Pallas kernel: the JAX package has no such ingest.  Its plain
// version is signal/capture.py:if_to_baseband_plain (torch ops) and its
// float64 reference signal/if_reference.py.
//
// Design.  One thread a frame (M input samples, L outputs), 128 frames a
// block.  A block first stages its frames' samples, and the D - 1 before
// them that its first frame's taps reach, in shared memory: each int8 read
// from global memory once (the halo, 3 % at M = 56, again from L2), 16 to
// a load, turned into float and signed by the quarter-rate mix
// [1, -j, -1, j] as it is stored.  A frame's samples lie M + 1 words after
// the previous frame's (M even, so M + 1 is odd), so the 32 threads of a
// warp, which walk their frames in step, read 32 different banks.  Each
// thread then walks its D samples from the top down, two at a time and a
// run of contiguous words at a time, and adds each, with one fused
// multiply-add an output, into the L outputs of its frame; the taps
// (shifted per output, signal/capture.py:if_resample_plan), two to an
// 8-byte load, are read by every thread of the block at the same address,
// a broadcast.  Each output is written once.
//
// Bound.  The window's int8 samples read once and its complex64 outputs
// written once: at 266 ms of 38.192 MHz, 10,159,072 + 4,353,888 bytes, 4.33
// us at 3.35 TB/s; the operations, L D fused multiply-adds a frame (498 at D
// = 166, 384 of them on non-zero taps), 0.18 GFLOP, 2.7 us at 67 TFLOP/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cuda_runtime.h>

#include "if_resample.cuh"

namespace {

using ifr::THREADS;

template <int L>
__global__ void __launch_bounds__(THREADS)
if_resample_kernel(const int8_t* __restrict__ x,
                   const float* __restrict__ taps, float* __restrict__ out,
                   long long n, int frames, int M, int D, int off_max) {
    extern __shared__ float smem[];
    float* H = smem;                       // L * D shifted taps
    float* tile = smem + L * D;            // the block's staged samples
    const int tid = threadIdx.x;
    const long long a0 = (long long)blockIdx.x * THREADS;
    const long long base = a0 * M + off_max - (D - 1);
    const int last = (int)min((long long)THREADS, frames - a0) - 1;
    const int count = M * last + D;        // samples the block reads
    for (int i = tid; i < L * D; i += THREADS) H[i] = taps[i];
    // The block's samples in 16-byte chunks from the one at or below
    // base: one 16-byte load a chunk inside the window (x starts on a
    // 16-byte boundary), the bytes one by one at its edges.  Sample r of
    // the block sits at r + floor(r / M): one word of padding after each M.
    const long long g0 = base - (((base % 16) + 16) % 16);
    const int chunks = (int)((base + count - g0 + 15) / 16);
    for (int c = tid; c < chunks; c += THREADS) {
        const long long g = g0 + 16LL * c;
        int w[4];
        if (g >= 0 && g + 16 <= n) {
            const int4 v = *reinterpret_cast<const int4*>(x + g);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                w[k] = 0;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const long long i = g + 4 * k + b;
                    if (i >= 0 && i < n)
                        w[k] |= (int)(uint8_t)x[i] << (8 * b);
                }
            }
        }
        const int r0 = (int)(g - base);       // -15 .. count - 1
        int q = r0 >= 0 ? r0 / M : -1;
        int rem = r0 - q * M;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int r = r0 + j;
            if (r >= 0 && r < count) {
                // g is a multiple of 4: sample g + j's mix sign is j's
                const float v = (float)(int8_t)(w[j >> 2] >> (8 * (j & 3)));
                tile[r + q] = v * ifr::mix_sign(j);
            }
            if (++rem == M) { rem = 0; ++q; }
        }
    }
    __syncthreads();
    if (tid > last) return;
    // the frame's top sample, M t + D - 1 samples into the block's; the
    // walk down from it runs through whole frames of M contiguous words
    // after a first run of rem_top + 1 (even: M and D are even)
    const int rel = M * tid + D - 1;
    int pos = rel + rel / M;
    int run = rel % M + 1;
    const ifr::TapPair* H2 = reinterpret_cast<const ifr::TapPair*>(H);
    const int half_d = D / 2;
    float acc[L][2];
#pragma unroll
    for (int b = 0; b < L; ++b) acc[b][0] = acc[b][1] = 0.0f;
    for (int i = 0; i < half_d;) {
        const int end = min(half_d, i + run / 2);
        for (; i < end; ++i, pos -= 2)
            ifr::accumulate<L>(acc, H2, half_d, i, tile[pos], tile[pos - 1]);
        pos -= 1;                          // the padding word
        run = M;
    }
    const long long a = a0 + tid;
    ifr::finish<L>(acc, a * M + off_max, out + a * 2 * L);
}

template <int L>
int launch(const void* x, const void* taps, void* out, long long n,
           int frames, int M, int D, int off_max, cudaStream_t stream) {
    const int count = M * (THREADS - 1) + D;
    const size_t smem = sizeof(float)
        * ((size_t)L * D + count + (size_t)(count / M + 1));
    const int blocks = (frames + THREADS - 1) / THREADS;
    if_resample_kernel<L><<<blocks, THREADS, smem, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const float*>(taps),
        static_cast<float*>(out), n, frames, M, D, off_max);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n,) int8 real samples, n = M * frames, on a 16-byte boundary; taps:
// (L, D) f32 shifted taps; out: (L * frames,) complex64.  M and D even, L
// 1 or 3, the shared memory under 48 KB (the wrapper checks).  Launches
// on `stream` and returns cudaGetLastError(), or -1 for an L it is not
// built for.
extern "C" int if_resample_launch(const void* x, const void* taps,
                                  void* out, long long n, int frames,
                                  int L, int M, int D, int off_max,
                                  void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (L) {
        case 1: return launch<1>(x, taps, out, n, frames, M, D, off_max, st);
        case 3: return launch<3>(x, taps, out, n, frames, M, D, off_max, st);
        default: return -1;
    }
}
