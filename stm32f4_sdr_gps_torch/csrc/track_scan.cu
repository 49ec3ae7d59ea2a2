// Tracking-scan kernel for Hopper (sm_90a): the whole T-epoch x C-channel
// tracking loop in one launch.
//
// Replaces the JAX package's Pallas TPU kernel K1,
// stm32f4_sdr_gps_tpu/ops/pallas_track_scan.py::_kernel (launched by
// pallas_track_scan).  It computes what K1 computes on the default
// (non-coherent) path, not how: the TPU's sequential grid, epoch padding,
// replica barrel and carrier-ramp cache are gone.
//
// Design.  One thread block of 256 threads per channel; a loop over the T
// epochs runs inside the block, so time stays sequential with a 1 ms loop
// closure while channels run in parallel on separate SMs.  Per epoch each
// thread takes up to 8 of the 2046 samples: the carrier is rotated off
// exactly per sample (angle ph + (dop/fs)*k in cycles, sincospif) and the
// replica is read from a shared-memory copy of the channel's doubled
// upsampled code row at the integer half-chip shift m (E/P/L at m-1, m,
// m+1).  The six partial sums are reduced with warp shuffles and shared
// memory; thread 0 then runs the per-channel loop update (epoch_update in
// track_epoch.cuh), writes the 11 output slots and publishes the next
// epoch's shift, phase and Doppler to shared memory.
//
// Bound.  Per channel the kernel reads T x 2046 x 8 bytes of samples,
// which the C blocks of one launch share through the 50 MB L2, and does
// one sincospif and 6 multiply-adds per sample; at the receiver's few
// channels the card is mostly idle and the epoch loop is latency-bound
// (two block barriers and the serial thread-0 update per epoch).  A later
// step packs several channels into one block that share one shared-memory
// copy of each epoch (ROADMAP, "Hopper mapping").
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
track_scan_kernel(const float2* __restrict__ x, const float* __restrict__ u2,
                  float* __restrict__ f32s, int* __restrict__ i32s,
                  int* __restrict__ wins, float* __restrict__ out, int T,
                  int C, track::Params p) {
    __shared__ float s_u2[track::U2P];
    __shared__ float s_part[WARPS][6];
    __shared__ float s_ph, s_dopfs;
    __shared__ int s_m;

    const int c = blockIdx.x;
    const int tid = threadIdx.x;

    for (int j = tid; j < track::U2P; j += THREADS)
        s_u2[j] = u2[(size_t)c * track::U2P + j];

    track::ChanState st;
    if (tid == 0) {
        track::load_state(st, f32s, i32s, wins, c, C, p);
        s_m = track::halfchip_shift(st.f[track::CP]);
        s_ph = st.f[track::PH];
        s_dopfs = st.f[track::DOP] / p.fs;
    }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        const float2* xe = x + (size_t)t * track::S;
        const int m = s_m;
        // the precondition that keeps every replica read inside the row
        assert(m >= 1 && m <= track::S);
        const float* rep = s_u2 + (m - 1);
        const float ph = s_ph, dopfs = s_dopfs;
        float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int k = tid; k < track::S; k += THREADS) {
            const float2 v = xe[k];
            track::epl_sample(acc, v.x, v.y, k, ph, dopfs, rep);
        }
        track::block_sum6<WARPS>(acc, s_part);
        if (tid == 0) {
            float o[track::NOUT];
            track::epoch_update(st, acc, p, c, o);
            float* orow = out + (size_t)t * track::NOUT * C + c;
            for (int j = 0; j < track::NOUT; ++j) orow[(size_t)j * C] = o[j];
            s_m = track::halfchip_shift(st.f[track::CP]);
            s_ph = st.f[track::PH];
            s_dopfs = st.f[track::DOP] / p.fs;
        }
        __syncthreads();
    }
    if (tid == 0) track::store_state(st, f32s, i32s, wins, c, C, p);
}

}  // namespace

// x: (T, 2046) complex64 as interleaved float pairs; u2: (C, 4352) f32;
// f32s (16, C), i32s (14, C), wins (W, C) are updated in place; out:
// (T, 11, C) f32.  fp/ip are the host parameter arrays (NFP floats, NIP
// ints).  Launches on `stream` and returns cudaGetLastError().
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
    void* args[] = {&xp, &up, &fs, &is, &ws, &op, &T, &C, &p};
    cudaLaunchKernel(reinterpret_cast<const void*>(&track_scan_kernel),
                     dim3(C), dim3(THREADS), args, 0,
                     static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
}
