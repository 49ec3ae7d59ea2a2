// Host build of the real-IF ingest kernel's arithmetic (if_resample.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off, so
// if_resample.cuh compiles as plain C++.  Each frame walks the staged
// samples top, top - 1, ..., top - D + 1 and adds them into its L outputs
// through the same functions as the kernel, in the same order, so the
// result is the kernel's bit for bit.  The CPU tests hold it against the
// plain torch version (signal/capture.py:if_to_baseband_plain) and the
// float64 reference (signal/if_reference.py).

#include "if_resample.cuh"

namespace {

template <int L>
void frames_host(const int8_t* x, const float* H, float* out, long long n,
                 int frames, int M, int D, int off_max) {
    const ifr::TapPair* H2 = reinterpret_cast<const ifr::TapPair*>(H);
    for (long long a = 0; a < frames; ++a) {
        const long long top = a * M + off_max;
        float acc[L][2];
        for (int b = 0; b < L; ++b) acc[b][0] = acc[b][1] = 0.0f;
        for (int i = 0; i < D / 2; ++i)
            ifr::accumulate<L>(acc, H2, D / 2, i,
                               ifr::staged(x, top - 2 * i, n),
                               ifr::staged(x, top - 2 * i - 1, n));
        ifr::finish<L>(acc, top, out + a * 2 * L);
    }
}

}  // namespace

// The arguments of if_resample_launch; returns -1 for an L the kernel is
// not built for, else 0.
extern "C" int if_resample_host(const void* x, const void* taps, void* out,
                                long long n, int frames, int L, int M,
                                int D, int off_max) {
    const int8_t* xi = static_cast<const int8_t*>(x);
    const float* H = static_cast<const float*>(taps);
    float* o = static_cast<float*>(out);
    switch (L) {
        case 1: frames_host<1>(xi, H, o, n, frames, M, D, off_max); break;
        case 3: frames_host<3>(xi, H, o, n, frames, M, D, off_max); break;
        default: return -1;
    }
    return 0;
}
