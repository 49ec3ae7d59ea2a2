// Host build of the tracking-scan kernel's arithmetic (track_scan.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off, so
// track_epoch.cuh compiles as plain C++.  track_scan_host runs the kernel's
// loop serially, one channel at a time, and sums each epoch's E/P/L terms
// in the kernel's order: per thread over samples k = tid, tid + 256, ...,
// then the warp-shuffle tree within each warp, then the 8 warps in order.
// The CPU tests hold it against the plain torch version
// (ops/track_scan.py:track_scan_reference), which checks the CUDA
// source's arithmetic on a machine without a GPU.

#include "track_epoch.cuh"

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
}  // namespace

// Same arguments as track_scan_launch, host pointers and no stream.
extern "C" int track_scan_host(const void* x, const void* u2, void* f32s,
                               void* i32s, void* wins, void* out, int T,
                               int C, const void* fp, const void* ip) {
    const track::Params p = track::params_from_arrays(
        static_cast<const float*>(fp), static_cast<const int*>(ip));
    const float* xf = static_cast<const float*>(x);
    const float* uf = static_cast<const float*>(u2);
    float* of = static_cast<float*>(out);
    float acc[THREADS][6];
    for (int c = 0; c < C; ++c) {
        track::ChanState st;
        track::load_state(st, static_cast<float*>(f32s),
                          static_cast<int*>(i32s), static_cast<int*>(wins),
                          c, C, p);
        const float* row = uf + (size_t)c * track::U2P;
        for (int t = 0; t < T; ++t) {
            const int m = track::halfchip_shift(st.f[track::CP]);
            if (m < 1 || m > track::S) return 1;
            const float* rep = row + (m - 1);
            const float ph = st.f[track::PH];
            const float dopfs = st.f[track::DOP] / p.fs;
            const float* xe = xf + (size_t)t * track::S * 2;
            for (int tid = 0; tid < THREADS; ++tid) {
                for (int j = 0; j < 6; ++j) acc[tid][j] = 0.0f;
                for (int k = tid; k < track::S; k += THREADS)
                    track::epl_sample(acc[tid], xe[2 * k], xe[2 * k + 1], k,
                                      ph, dopfs, rep);
            }
            float sums[6];
            for (int j = 0; j < 6; ++j) {
                float part[WARPS];
                for (int w = 0; w < WARPS; ++w) {
                    float v[32];
                    for (int l = 0; l < 32; ++l) v[l] = acc[w * 32 + l][j];
                    for (int off = 16; off > 0; off >>= 1)
                        for (int l = 0; l < off; ++l) v[l] = v[l] + v[l + off];
                    part[w] = v[0];
                }
                float s = part[0];
                for (int w = 1; w < WARPS; ++w) s += part[w];
                sums[j] = s;
            }
            float o[track::NOUT];
            track::epoch_update(st, sums, p, c, o);
            for (int j = 0; j < track::NOUT; ++j)
                of[((size_t)t * track::NOUT + j) * C + c] = o[j];
        }
        track::store_state(st, static_cast<float*>(f32s),
                           static_cast<int*>(i32s), static_cast<int*>(wins),
                           c, C, p);
    }
    return 0;
}
