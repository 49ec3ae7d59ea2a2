// The handoff search for Hopper (sm_90a): the squared-prompt Doppler
// search's prompts and the half-chip code search's power, every epoch of
// every channel in one launch each.
//
// Replaces no Pallas kernel.  In the JAX package both searches are lax.scan
// programs under jax.jit: stm32f4_sdr_gps_tpu/acquire/engine.py
// refine_doppler_device (its scan at :520; refine_doppler's one-channel
// scan at :468), the squared-prompt scan over 32 epochs (256 under
// coherent_pll, up to 512 in the aided sync), and stm32f4_sdr_gps_tpu/
// track/pretrack.py:_pretrack_power, the half-chip scan over 20 epochs
// (100 under coherent_pll) at 31 offsets.  The port ran them as eager
// Python loops of ~37 and ~27 small launches an epoch
// (acquire/engine.py:squared_prompts_plain, track/pretrack.py:
// _pretrack_power, kept as the plain versions); these kernels take their
// place on the card (acquire/engine.py:squared_prompts_cuda,
// track/pretrack.py:pretrack_power_cuda).
//
// Design.  One block of 256 threads for each (epoch, channel), so the
// epochs run side by side and no loop crosses the host.  A block first
// replays, from epoch 0, the float32 recurrences the plain loop carries
// from epoch to epoch: the code phase (remainder(cp + chips_per_epoch,
// 1023)) and the carrier phase (frac(fma(f, n / fs, phase))).  Blocks run
// in no order and share nothing, so each recomputes its own, bit for bit
// the plain loop's state: one thread runs the e dependent scalar steps
// while the others stage the channel's code row in shared memory, under a
// microsecond at the cold start's 32 epochs.  (Replayed by all 256 threads
// the steps took the SMs' issue slots: 0.67 ms at E = 512 x C = 32.)  Each
// thread wipes off its 8 samples k = tid + 256 j once and reads the
// replica chip floor(fma(rate, k, cp + lag)) mod 1023 from the row.  Sums
// go through the warp butterfly and then the 8 warps as a pairwise tree, a
// fixed order (pretrack_host.cpp reproduces it).
//   sq_prompt_kernel: the prompt at the carrier-aided code phase, written
//     as the (E, C) complex prompts; the squaring, FFT and argmax stay in
//     torch (acquire/engine.py:_squared_prompt_bins).
//   pretrack_corr_kernel: each wiped sample multiplied into all K (31)
//     half-chip offsets' replicas; the (E, C, K) complex correlations go to
//     scratch, and pretrack_sum_kernel adds |corr|^2 over the epochs in
//     epoch order into (C, K): deterministic, with no atomics.
//
// Bound.  At the cold start's sizes (C = 4; E = 32 for the prompts, E = 20
// and K = 31 for the power) the work is 0.3-0.5 MB and 5-33 MFLOP, under
// half a microsecond of the card, so each launch costs its launch latency
// and the replay's.  At E = 512 x C = 32 (the aided sync) the float32
// operations bound the prompts, 0.64 GFLOP, 9.5 us at 67 TFLOP/s, ahead of
// the bytes (the 512 epochs once, 8.4 MB, 2.5 us at 3.35 TB/s; the C
// blocks of an epoch read it through the 50 MB L2).  The operations count
// is probes/pretrack_kernels.py's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cuda_runtime.h>

#include "pretrack.cuh"

namespace {

using pretrack::CODE_LENGTH;
using pretrack::NJ;
using pretrack::THREADS;
using pretrack::WARPS;

__device__ inline float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ inline void stage_code(float* code, const float* table, int c) {
    for (int i = threadIdx.x; i < CODE_LENGTH; i += THREADS)
        code[i] = table[(size_t)c * CODE_LENGTH + i];
}

__global__ void __launch_bounds__(THREADS)
sq_prompt_kernel(const float2* __restrict__ x,
                 const float* __restrict__ table,
                 const float* __restrict__ cp0,
                 const float* __restrict__ rate,
                 const float* __restrict__ dop, float* __restrict__ out,
                 int S, int C, float s_over_fs, float fs) {
    __shared__ float code[CODE_LENGTH];
    __shared__ float part[2][WARPS];
    __shared__ float state[2];
    const int e = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
    stage_code(code, table, c);
    const float r = rate[c], f = dop[c];
    if (tid == 0) {             // one thread replays, the block waits
        state[0] = pretrack::code_phase_at(e, cp0[c], r * (float)S);
        state[1] = pretrack::carrier_phase_at(e, f, s_over_fs);
    }
    __syncthreads();
    const float cp = state[0], ph = state[1];
    const float2* xe = x + (size_t)e * S;
    float ar = 0.0f, ai = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int k = tid + j * THREADS;
        if (k < S) {
            const float2 v = xe[k];
            float yr, yi;
            pretrack::wipe(v.x, v.y, k, ph, f, fs, &yr, &yi);
            const float rep = code[pretrack::chip_index(r, k, cp)];
            ar += yr * rep;
            ai += yi * rep;
        }
    }
    ar = warp_sum(ar);
    ai = warp_sum(ai);
    if ((tid & 31) == 0) {
        part[0][tid >> 5] = ar;
        part[1][tid >> 5] = ai;
    }
    __syncthreads();
    if (tid < 2) {
        float w[WARPS];
#pragma unroll
        for (int i = 0; i < WARPS; ++i) w[i] = part[tid][i];
        out[((size_t)e * C + c) * 2 + tid] = track::tree_sum<WARPS>(w);
    }
}

__global__ void __launch_bounds__(THREADS)
pretrack_corr_kernel(const float2* __restrict__ x,
                     const float* __restrict__ table,
                     const float* __restrict__ cp,
                     const float* __restrict__ dop,
                     float* __restrict__ corr, int S, int C, int K,
                     float cps, float s_over_fs, float fs) {
    __shared__ float code[CODE_LENGTH];
    __shared__ float part[pretrack::MAX_K][2][WARPS];
    __shared__ float state;
    const int e = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
    stage_code(code, table, c);
    const float f = dop[c], cpc = cp[c];
    if (tid == 0) state = pretrack::carrier_phase_at(e, f, s_over_fs);
    __syncthreads();
    const float ph = state;
    const float2* xe = x + (size_t)e * S;
    float yr[NJ], yi[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int k = tid + j * THREADS;
        yr[j] = yi[j] = 0.0f;
        if (k < S) {
            const float2 v = xe[k];
            pretrack::wipe(v.x, v.y, k, ph, f, fs, &yr[j], &yi[j]);
        }
    }
    for (int o = 0; o < K; ++o) {
        const float base = cpc + pretrack::offset_chips(o, K);
        float ar = 0.0f, ai = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int k = tid + j * THREADS;
            if (k < S) {
                const float rep = code[pretrack::chip_index(cps, k, base)];
                ar += yr[j] * rep;
                ai += yi[j] * rep;
            }
        }
        ar = warp_sum(ar);
        ai = warp_sum(ai);
        if ((tid & 31) == 0) {
            part[o][0][tid >> 5] = ar;
            part[o][1][tid >> 5] = ai;
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * K; i += THREADS) {
        float w[WARPS];
#pragma unroll
        for (int q = 0; q < WARPS; ++q) w[q] = part[i >> 1][i & 1][q];
        corr[((size_t)e * C + c) * 2 * K + i] = track::tree_sum<WARPS>(w);
    }
}

__global__ void __launch_bounds__(THREADS)
pretrack_sum_kernel(const float2* __restrict__ corr,
                    float* __restrict__ power, int E, int CK) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= CK) return;
    float acc = 0.0f;
    for (int e = 0; e < E; ++e) {
        const float2 v = corr[(size_t)e * CK + i];
        acc = acc + (v.x * v.x + v.y * v.y);
    }
    power[i] = acc;
}

}  // namespace

// x: (E, S) complex64 epochs; table: (C, 1023) f32 bipolar codes; cp0,
// rate, dop: (C,) f32 code phase at epoch 0 (chips), code rate (chips a
// sample) and Doppler (Hz); out: (E, C) complex64 prompts.  S at most
// 2048.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sq_prompts_launch(const void* x, const void* table,
                                 const void* cp0, const void* rate,
                                 const void* dop, void* out, int E, int C,
                                 int S, float s_over_fs, float fs,
                                 void* stream) {
    sq_prompt_kernel<<<dim3(E, C), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<const float*>(table),
        static_cast<const float*>(cp0), static_cast<const float*>(rate),
        static_cast<const float*>(dop), static_cast<float*>(out), S, C,
        s_over_fs, fs);
    return static_cast<int>(cudaGetLastError());
}

// x, table as above; cp, dop: (C,) f32 code phase (chips, fixed over the
// epochs) and Doppler; corr: (E, C, K) complex64 scratch; power: (C, K)
// f32, the sum over epochs of |corr|^2.  K at most 64, S at most 2048.
// Two launches on `stream`; returns the first non-zero cudaGetLastError().
extern "C" int pretrack_power_launch(const void* x, const void* table,
                                     const void* cp, const void* dop,
                                     void* corr, void* power, int E, int C,
                                     int S, int K, float cps,
                                     float s_over_fs, float fs,
                                     void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    pretrack_corr_kernel<<<dim3(E, C), THREADS, 0, st>>>(
        static_cast<const float2*>(x), static_cast<const float*>(table),
        static_cast<const float*>(cp), static_cast<const float*>(dop),
        static_cast<float*>(corr), S, C, K, cps, s_over_fs, fs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ck = C * K;
    pretrack_sum_kernel<<<(ck + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        static_cast<const float2*>(corr), static_cast<float*>(power), E, ck);
    return static_cast<int>(cudaGetLastError());
}
