// Host build of the row-roll kernels' lanes (roll.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off into the host
// library beside kernels_host.cpp (ops/kernel_lib.py host_lib), so
// roll_ops.cuh compiles as plain C++.  Each function takes the launcher's
// arguments minus the stream, runs the kernel's threads one after another
// (each thread's four lanes through the same roll_lanes / barrel_lanes),
// and returns 1 on arguments the launcher refuses.  The CPU tests hold
// them against the plain torch versions (probes/roll_wide.py,
// probes/mosaic_bisect.py).

#include <stddef.h>

#include "roll_ops.cuh"

using namespace roll;

extern "C" int roll_rows_host(const void* x, const void* amt, void* out,
                              int R, int W, int src_row) {
    if (R < 1 || R > 65535 || W < 1 || src_row < -1) return 1;
    if (W % VEC == 0 && !aligned16(out)) return 1;
    const float* xf = static_cast<const float*>(x);
    const int* am = static_cast<const int*>(amt);
    float* of = static_cast<float*>(out);
    for (int r = 0; r < R; ++r) {
        const int a = fold(am[r], W);
        const float* src = xf + (size_t)(src_row < 0 ? r : src_row) * W;
        for (int j = 0; j < W; j += VEC)
            roll_lanes(src, of + (size_t)r * W, j, a, W);
    }
    return 0;
}

extern "C" int barrel_host(const void* u2, const void* mc, const void* es,
                           void* e, void* p, void* l, int R) {
    if (R < 1 || R > 65535) return 1;
    if (!(aligned16(e) && aligned16(p) && aligned16(l))) return 1;
    const float* uf = static_cast<const float*>(u2);
    const int* m = static_cast<const int*>(mc);
    const int* bits = static_cast<const int*>(es);
    for (int r = 0; r < R; ++r) {
        const int a = rebuild_amount(m[r]);
        const int s = barrel_shift(bits[r]);
        const size_t o = (size_t)r * WIN;
        for (int j = 0; j < WIN; j += VEC)
            barrel_lanes(uf + (size_t)r * U2P, static_cast<float*>(e) + o,
                         static_cast<float*>(p) + o,
                         static_cast<float*>(l) + o, j, a, s);
    }
    return 0;
}
