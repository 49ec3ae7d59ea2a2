// Lane arithmetic of the row-roll kernels (roll.cu), shared with their host
// build (roll_host.cpp, compiled with g++ -D__host__= -D__device__=) that
// the CPU tests hold against the plain torch versions in
// probes/roll_wide.py and probes/mosaic_bisect.py.
//
// A roll is an indexed read: out[j] = row[(j - amt) mod w].  Each amount
// is folded into [0, w) once a row (fold, the only % here), whatever its
// sign or size; a lane's source is then an add and a conditional
// subtract.  One thread's work is four consecutive output lanes
// (roll_lanes, barrel_lanes), written with one 16-byte store each where
// the rows are 16-byte aligned.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace roll {

constexpr int U2P = 4352;      // doubled upsampled code row (K1's u2)
constexpr int WIN = 2176;      // K1's replica window: 2048 lanes + 128
constexpr int SPAN = 15;       // K1's barrel span (_BARREL_SPAN)
constexpr int VEC = 4;         // output lanes a thread: one 16-byte store

#ifdef __CUDACC__
using vec4 = float4;
#else
struct alignas(16) vec4 {
    float x, y, z, w;
};
#endif

// a mod w in [0, w), for any int a and w > 0
__host__ __device__ inline int fold(int a, int w) {
    const int r = a % w;
    return r < 0 ? r + w : r;
}

// The lane that lands on lane j (0 <= j < w) when a row of width w is
// rolled right by a folded amount a (0 <= a < w), as np.roll and
// pltpu.roll in interpret mode roll: (j - a) mod w.
__host__ __device__ inline int wrap_src(int j, int a, int w) {
    const int s = j - a;
    return s < 0 ? s + w : s;
}

// Where a pointer may take 16-byte stores.
__host__ __device__ inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__host__ __device__ inline void store4(float* p, vec4 v) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float4*>(p) = v;
#else
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
#endif
}

// Output lanes j .. j + 3 (j % 4 == 0, j < w) of a row of width w rolled
// right by the folded amount a.  Where w % 4 == 0 (every width the probes
// use: 4352, 2176, 256) the four lanes are read by four scalar loads and
// written by one 16-byte store (dst 16-byte aligned).  On the NVIDIA
// H100 80GB HBM3 at 700 W two aligned 16-byte loads and a funnel by
// (-a) mod 4 took the same time within 0.1 us a launch
// (probes/roll_parts.py, its funnel_loads build), and scalar loads need
// neither the funnel nor an aligned source.  Any other width takes four
// scalar copies, the lanes past w left out.
__host__ __device__ inline void roll_lanes(const float* src, float* dst,
                                           int j, int a, int w) {
    if ((w & 3) == 0) {
        store4(dst + j, vec4{src[wrap_src(j, a, w)],
                             src[wrap_src(j + 1, a, w)],
                             src[wrap_src(j + 2, a, w)],
                             src[wrap_src(j + 3, a, w)]});
        return;
    }
    for (int k = 0; k < VEC && j + k < w; ++k)
        dst[j + k] = src[wrap_src(j + k, a, w)];
}

// K1's base-window rebuild (pallas_track_scan.py:339-350): the
// non-negative right roll that left-rolls u2's row by mc - 1 - SPAN / 2,
// folded into [0, U2P) for an mc outside [1, 2046] too.
__host__ __device__ inline int rebuild_amount(int mc) {
    const int shift = mc - 1 - SPAN / 2;
    return fold(shift > 0 ? U2P - shift : -shift, U2P);
}

// The barrel's left roll of the window: its stages left-roll by 1, 2, 4
// and 8 where the bits of es are set, by s = es & 15 in all (rolls
// compose; bitwise, as the plain version tests es & (1 << stage), so a
// negative es takes the stages of its low four bits).
__host__ __device__ inline int barrel_shift(int es) { return es & 15; }

// The u2 lane of K1's replica output k (0 = E, 1 = P, 2 = L) at lane j of
// the window: the rebuilt window is u2's row rolled right by a and cut to
// WIN, the barrel left-rolls it by s, P by 1 more and L by 2, so lane j
// reads window lane (j + s + k) mod WIN, which reads u2 lane
// (m - a) mod U2P.  For 0 <= j + s + k < 2 WIN, 0 <= a < U2P: two
// conditional subtracts.
__host__ __device__ inline int barrel_src(int j, int a, int s, int k) {
    int m = j + s + k;
    m -= m >= WIN ? WIN : 0;
    return wrap_src(m, a, U2P);
}

// Output lanes j .. j + 3 (j % 4 == 0, j < WIN) of E, P and L of one row:
// the six window lanes j + s .. j + s + 5 read once from the u2 row, E
// takes the first four, P the four from the second, L from the third;
// one 16-byte store each (e, p, l 16-byte aligned).
__host__ __device__ inline void barrel_lanes(const float* row, float* e,
                                             float* p, float* l, int j,
                                             int a, int s) {
    float v[VEC + 2];
#pragma unroll
    for (int i = 0; i < VEC + 2; ++i) v[i] = row[barrel_src(j, a, s, i)];
    store4(e + j, vec4{v[0], v[1], v[2], v[3]});
    store4(p + j, vec4{v[1], v[2], v[3], v[4]});
    store4(l + j, vec4{v[2], v[3], v[4], v[5]});
}

}  // namespace roll
