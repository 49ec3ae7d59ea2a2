// Lane arithmetic of the row-roll kernels (roll.cu), shared with their host
// build (roll_host.cpp, compiled with g++ -D__host__= -D__device__=) that
// the CPU tests hold against the plain torch versions in
// probes/roll_wide.py and probes/mosaic_bisect.py.
//
// A roll is an indexed read: out[j] = row[roll_src(j, amt, w)].  Every
// amount is folded into [0, w) here, whatever its sign or size, so the
// kernels never depend on how a negative amount is treated.
#pragma once

namespace roll {

constexpr int U2P = 4352;      // doubled upsampled code row (K1's u2)
constexpr int WIN = 2176;      // K1's replica window: 2048 lanes + 128
constexpr int SPAN = 15;       // K1's barrel span (_BARREL_SPAN)
constexpr int NSTAGE = 4;      // barrel stages: left rolls by 1, 2, 4, 8

// a mod w in [0, w), for any int a and w > 0
__host__ __device__ inline int fold(int a, int w) {
    const int r = a % w;
    return r < 0 ? r + w : r;
}

// The lane that lands on lane j when a row of width w is rolled right by
// amt (np.roll, and pltpu.roll in interpret mode): (j - amt) mod w.  The
// amount is folded first, so j - fold(amt) stays in (-w, w).
__host__ __device__ inline int roll_src(int j, int amt, int w) {
    return fold(j - fold(amt, w), w);
}

// K1's base-window rebuild (pallas_track_scan.py:339-350): the
// non-negative right roll that left-rolls u2's row by mc - 1 - SPAN / 2.
__host__ __device__ inline int rebuild_amount(int mc) {
    const int shift = mc - 1 - SPAN / 2;
    return shift > 0 ? U2P - shift : -shift;
}

// Barrel stage s left-rolls by 1 << s, spelled as K1 spells it: a right
// roll by WIN - (1 << s).
__host__ __device__ inline int barrel_shift(int s) { return 1 << s; }

}  // namespace roll
