// Host build of the row-roll kernels' lane arithmetic (roll.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off into the host
// library beside kernels_host.cpp (ops/kernel_lib.py host_lib), so
// roll_ops.cuh compiles as plain C++.  Each function takes the launcher's
// arguments minus the stream, runs serially on host arrays, and returns 1
// on arguments the launcher refuses.  The CPU tests hold them against the
// plain torch versions (probes/roll_wide.py, probes/mosaic_bisect.py).

#include <stddef.h>

#include "roll_ops.cuh"

using namespace roll;

extern "C" int roll_rows_host(const void* x, const void* amt, void* out,
                              int R, int W, int src_row) {
    if (R < 1 || R > 65535 || W < 1 || src_row < -1) return 1;
    const float* xf = static_cast<const float*>(x);
    const int* a = static_cast<const int*>(amt);
    float* of = static_cast<float*>(out);
    for (int r = 0; r < R; ++r) {
        const int src = src_row < 0 ? r : src_row;
        for (int j = 0; j < W; ++j)
            of[(size_t)r * W + j] = xf[(size_t)src * W + roll_src(j, a[r], W)];
    }
    return 0;
}

extern "C" int barrel_host(const void* u2, const void* mc, const void* es,
                           void* e, void* p, void* l, int R) {
    if (R < 1) return 1;
    const float* uf = static_cast<const float*>(u2);
    const int* m = static_cast<const int*>(mc);
    const int* bits = static_cast<const int*>(es);
    float w[WIN], t[WIN];
    for (int r = 0; r < R; ++r) {
        const int amt = rebuild_amount(m[r]);
        for (int j = 0; j < WIN; ++j)
            w[j] = uf[(size_t)r * U2P + roll_src(j, amt, U2P)];
        for (int s = 0; s < NSTAGE; ++s) {
            const int sh = barrel_shift(s);
            if ((bits[r] & sh) == 0) continue;
            for (int j = 0; j < WIN; ++j) t[j] = w[roll_src(j, WIN - sh, WIN)];
            for (int j = 0; j < WIN; ++j) w[j] = t[j];
        }
        float* er = static_cast<float*>(e) + (size_t)r * WIN;
        float* pr = static_cast<float*>(p) + (size_t)r * WIN;
        float* lr = static_cast<float*>(l) + (size_t)r * WIN;
        for (int j = 0; j < WIN; ++j) {
            const int j1 = roll_src(j, WIN - 1, WIN);
            er[j] = w[j];
            pr[j] = w[j1];
            lr[j] = w[roll_src(j1, WIN - 1, WIN)];
        }
    }
    return 0;
}
