// Tracking-scan kernel for Hopper (sm_90a): the whole T-epoch x C-channel
// tracking loop in one launch.
//
// Replaces the JAX package's Pallas TPU kernel K1,
// stm32f4_sdr_gps_tpu/ops/pallas_track_scan.py::_kernel (launched by
// pallas_track_scan).  It computes what K1 computes, in all of K1's
// tracking modes (the default loop, coherent_bit_vote, coherent_pll with
// pll_ext_bits, emit_correlators: one instantiation of the kernel per
// track::Mode, chosen per launch), not how: the TPU's sequential grid,
// epoch padding, replica barrel and carrier-ramp cache are gone.
//
// Design.  A loop over the T epochs runs inside each block, so time stays
// sequential with a 1 ms loop closure while channels run in parallel.  A
// block holds G channels (k1_channels_per_block: 1 while the channels fit
// on the SMs, more past that) of K1_THREADS threads each (the sweep in
// PERF.md), their code rows in shared memory, and a double buffer of
// epochs that all G channels share: one thread stages epoch t + 2 into the
// buffer epoch t has just left with one TMA bulk copy (cp.async.bulk,
// 16,368 bytes, completion on an mbarrier), so each epoch's samples are in
// shared memory before the epoch starts and the sample loop reads nothing
// from device memory.  The staged epoch is zero-padded to SP = 2048
// samples, so every thread takes exactly SP / K1_THREADS samples k = tid +
// j * K1_THREADS (a compile-time trip count; the padding adds exact
// zeros): the carrier is rotated off exactly per sample (sincospif) and
// the replica read at the integer half-chip shift m (E/P/L at m - 1, m,
// m + 1; m - 1 + 2049 < 4352 keeps the padded reads in the row).  The six
// sums go through a transposed warp butterfly (warp_sum6: 9 shuffles)
// into shared memory.  After the epoch's one block barrier, one warp of
// the channel adds the warps' partials as a pairwise tree, runs the loop
// update (epoch_update in track_epoch.cuh) with the channel state in
// registers (0 bytes of stack frame, ptxas -v), and publishes the next
// epoch's (ph, dopfs, m) through shared memory and a named barrier of the
// channel's threads, which the other warps wait on; then lane j stores
// output slot j.  The partials and the published values are written again
// only after the next block barrier, which every reader has passed by
// then.  A channel's arithmetic is the same whatever C and G are
// (kernels_host.cpp reproduces its order).
//
// Bound.  Per channel and epoch: 2046 samples x (one sincospif, the
// rotation and six multiply-adds), ~25 float32 operations each, and the
// samples' 16 KB, read once per block from device memory by the TMA.  At
// the receiver's few channels the card is idle but for a handful of SMs,
// and each epoch is three parts in a row on one SM: the sample loop
// (~57 instructions a sample on the SM's four schedulers), the reductions
// with the block barrier, and the loop update (~500 mostly dependent
// scalar instructions in one warp); PERF.md times each with the probe
// probes/scan_parts.py.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <assert.h>
#include <cuda_runtime.h>

#include "track_epoch.cuh"

namespace {

using track::K1_THREADS;
using track::K1_WARPS;
using track::SP;

constexpr unsigned EPOCH_BYTES = track::S * sizeof(float2);  // 1023 x 16
constexpr int NJ = SP / K1_THREADS;    // samples per thread and epoch
constexpr int PART = 8;                // floats per warp partial (6 used)
constexpr int HEAD = 128;              // shared bytes before the epochs
constexpr int STAGER = 32;    // the thread that stages epochs: lane 0 of
                              // warp 1, never a channel's update warp

// shared memory of a block of G channels: the two mbarriers, two staged
// epochs, the warp partials and the published (ph, dopfs, m) of each
// channel, G code rows
size_t smem_bytes(int G) {
    return HEAD + 2 * SP * sizeof(float2) +
           (G * K1_WARPS * PART + 4 * G + G * track::U2P) * sizeof(float);
}

// Named barrier `id` (1 + the channel's slot; 0 is __syncthreads) of the
// channel's K1_THREADS threads: the update warp arrives, the others wait.
__device__ __forceinline__ void publish_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(K1_THREADS)
                 : "memory");
}
__device__ __forceinline__ void publish_wait(int id) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(K1_THREADS) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage one epoch into shared memory: arm the buffer's mbarrier with the
// bytes to come, then one bulk copy that completes on it.  Called after a
// block barrier that follows every read of the buffer, whose values have
// all reached registers by then.
__device__ __forceinline__ void stage_epoch(float2* dst, const float2* src,
                                            uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(EPOCH_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(EPOCH_BYTES),
           "r"(smem_addr(bar))
        : "memory");
}

// Wait until the buffer's mbarrier has completed the phase of the given
// parity (its copy has landed).
__device__ __forceinline__ void wait_epoch(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n"
        :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

template <class M>
__global__ void __launch_bounds__(track::K1_BLOCK_MAX, 1)
track_scan_kernel(const float2* __restrict__ x, const float* __restrict__ u2,
                  float* __restrict__ f32s, int* __restrict__ i32s,
                  int* __restrict__ wins, float* __restrict__ out, int T,
                  int C, int G, track::Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);              // [2]
    float2* s_x = reinterpret_cast<float2*>(smem + HEAD);          // [2][SP]
    float* s_part = reinterpret_cast<float*>(s_x + 2 * SP);     // [G][W][8]
    float4* s_pub = reinterpret_cast<float4*>(s_part + G * K1_WARPS * PART);
    float* s_u2 = reinterpret_cast<float*>(s_pub + G);           // [G][U2P]

    const int g = threadIdx.x / K1_THREADS;
    const int tid = threadIdx.x % K1_THREADS;
    const int warp = tid / 32;
    const int lane = threadIdx.x % 32;
    const int c = blockIdx.x * G + g;
    // the last block's spare channel slots only keep the block barriers
    const bool live = c < C;
    // the warp that also runs the channel's update: a different one in
    // each slot, so the G update warps of a block fall on different
    // schedulers
    const bool updater = warp == g % K1_WARPS;
    float* part = s_part + g * K1_WARPS * PART;

    if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(smem_addr(&s_bar[b])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the padding, never copied
    for (int j = threadIdx.x; j < 2 * (SP - track::S); j += blockDim.x)
        s_x[(j % 2) * SP + track::S + j / 2] = make_float2(0.f, 0.f);
    float* row = s_u2 + g * track::U2P;
    if (live) {
        const float4* src =
            reinterpret_cast<const float4*>(u2 + (size_t)c * track::U2P);
        for (int j = tid; j < track::U2P / 4; j += K1_THREADS)
            reinterpret_cast<float4*>(row)[j] = src[j];
    }
    __syncthreads();
    if (threadIdx.x == STAGER) {
        stage_epoch(s_x, x, &s_bar[0]);
        if (T > 1) stage_epoch(s_x + SP, x + track::S, &s_bar[1]);
    }

    track::ChanState st;
    int m = 1;
    float ph = 0.f, dopfs = 0.f;
    if (live) {
        track::load_state(st, f32s, i32s, wins, c, C, p);
        m = track::halfchip_shift(st.f[track::CP]);
        ph = st.f[track::PH];
        dopfs = st.f[track::DOP] / p.fs;
    }
    for (int t = 0; t < T; ++t) {
        const int b = t & 1;
        if (live) {
            // the precondition that keeps every replica read inside the row
            assert(m >= 1 && m <= track::S);
            const float* rep = row + (m - 1);
            const float2* xe = s_x + b * SP;
            wait_epoch(&s_bar[b], (t >> 1) & 1);
            float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int k = tid + j * K1_THREADS;
                const float2 v = xe[k];
                track::epl_sample(acc, v.x, v.y, k, ph, dopfs, rep);
            }
            const float total = track::warp_sum6(acc);
            if (lane % 4 == 0 && lane < 24)         // lane 4j: sum j
                part[warp * PART + lane / 4] = total;
        }
        // the epoch's one block barrier: every partial of the epoch is
        // written and every read of its staged samples done
        __syncthreads();
        if (threadIdx.x == STAGER && t + 2 < T)
            stage_epoch(s_x + b * SP, x + (size_t)(t + 2) * track::S,
                        &s_bar[b]);
        if (live && !updater) {
            // the update warp's (ph, dopfs, m) for the next epoch; it
            // writes them again only after the next block barrier
            publish_wait(1 + g);
            const float4 pub = s_pub[g];
            ph = pub.x;
            dopfs = pub.y;
            m = __float_as_int(pub.z);
        } else if (live) {
            // the partials are written again only after the other warps
            // have passed the named barrier, so after these reads
            float v[6][K1_WARPS];
#pragma unroll
            for (int w = 0; w < K1_WARPS; ++w) {
                const float4 a =
                    *reinterpret_cast<const float4*>(part + w * PART);
                const float2 e =
                    *reinterpret_cast<const float2*>(part + w * PART + 4);
                v[0][w] = a.x;
                v[1][w] = a.y;
                v[2][w] = a.z;
                v[3][w] = a.w;
                v[4][w] = e.x;
                v[5][w] = e.y;
            }
            float sums[6];
#pragma unroll
            for (int j = 0; j < 6; ++j)
                sums[j] = track::tree_sum<K1_WARPS>(v[j]);
            float o[M::nout];
            track::epoch_update<M>(st, sums, p, c, o);
            m = track::halfchip_shift(st.f[track::CP]);
            ph = st.f[track::PH];
            dopfs = st.f[track::DOP] / p.fs;
            if (lane == 0)
                s_pub[g] = make_float4(ph, dopfs, __int_as_float(m), 0.f);
            publish_arrive(1 + g);
            // the output slots leave while the other warps start the next
            // epoch: lane j stores slot j
            float slot = o[0];
#pragma unroll
            for (int j = 1; j < M::nout; ++j)
                if (lane == j) slot = o[j];
            if (lane < M::nout)
                out[((size_t)t * M::nout + lane) * C + c] = slot;
        }
    }
    if (live && updater && lane == 0)
        track::store_state(st, f32s, i32s, wins, c, C, p);
}

int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

}  // namespace

// G, the channels per block that track_scan_launch takes for C channels on
// the current device (k1_channels_per_block).
extern "C" int track_scan_channels_per_block(int C) {
    return track::k1_channels_per_block(C, sm_count());
}

// x: (T, 2046) complex64 as interleaved float pairs, 16-byte aligned;
// u2: (C, 4352) f32, 16-byte aligned; f32s (16, C), i32s (14, C), wins
// (W, C) (entries -1, 0, +1) are updated in place; out: (T, nout, C) f32,
// nout = ip[9] (11, or 15 with the E/L slots).  fp/ip are the host
// parameter arrays (NFP floats, NIP ints).  Launches on `stream` and
// returns the first CUDA error of the launch, or 0.
extern "C" int track_scan_launch(const void* x, const void* u2, void* f32s,
                                 void* i32s, void* wins, void* out, int T,
                                 int C, const void* fp, const void* ip,
                                 void* stream) {
    track::Params p = track::params_from_arrays(
        static_cast<const float*>(fp), static_cast<const int*>(ip));
    const float2* xp = static_cast<const float2*>(x);
    const float* up = static_cast<const float*>(u2);
    float* fs = static_cast<float*>(f32s);
    int* is = static_cast<int*>(i32s);
    int* ws = static_cast<int*>(wins);
    float* op = static_cast<float*>(out);
    const int G = track::k1_channels_per_block(C, sm_count());
    const int blocks = (C + G - 1) / G;
    const size_t smem = smem_bytes(G);
    return track::dispatch_mode(static_cast<const int*>(ip), [&](auto mode) {
        using M = decltype(mode);
        cudaError_t rc = cudaFuncSetAttribute(
            track_scan_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (rc != cudaSuccess) return static_cast<int>(rc);
        track_scan_kernel<M><<<blocks, G * K1_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
            xp, up, fs, is, ws, op, T, C, G, p);
        return static_cast<int>(cudaGetLastError());
    });
}
