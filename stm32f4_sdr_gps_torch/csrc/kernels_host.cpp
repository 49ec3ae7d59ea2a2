// Host build of the kernels' arithmetic (track_scan.cu and epl.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off, so
// track_epoch.cuh compiles as plain C++.  block_sums adds one epoch's E/P/L
// terms in the kernels' order: per thread over samples k = tid, tid + 256,
// ..., then the warp-shuffle tree within each warp, then the 8 warps in
// order (block_sum6).  track_scan_host runs the tracking-scan kernel's
// loop serially, one channel at a time; epl_host runs the per-epoch
// correlator.  The CPU tests hold them against the plain torch versions
// (ops/track_scan.py:track_scan_reference, ops/epl.py:
// epl_correlate_halfchip), which checks the CUDA sources' arithmetic on a
// machine without a GPU.

#include "track_epoch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The six E/P/L sums of one epoch; xe is the epoch as interleaved float
// pairs and rep points at u2[m - 1] of the channel's row.
void block_sums(const float* xe, const float* rep, float ph, float dopfs,
                float sums[6]) {
    float acc[THREADS][6];
    for (int tid = 0; tid < THREADS; ++tid) {
        for (int j = 0; j < 6; ++j) acc[tid][j] = 0.0f;
        for (int k = tid; k < track::S; k += THREADS)
            track::epl_sample(acc[tid], xe[2 * k], xe[2 * k + 1], k, ph,
                              dopfs, rep);
    }
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
}

}  // namespace

// Same arguments as track_scan_launch, host pointers and no stream.
// Returns 1 if a half-chip shift falls outside [1, 2046].
extern "C" int track_scan_host(const void* x, const void* u2, void* f32s,
                               void* i32s, void* wins, void* out, int T,
                               int C, const void* fp, const void* ip) {
    const track::Params p = track::params_from_arrays(
        static_cast<const float*>(fp), static_cast<const int*>(ip));
    const float* xf = static_cast<const float*>(x);
    const float* uf = static_cast<const float*>(u2);
    float* of = static_cast<float*>(out);
    for (int c = 0; c < C; ++c) {
        track::ChanState st;
        track::load_state(st, static_cast<float*>(f32s),
                          static_cast<int*>(i32s), static_cast<int*>(wins),
                          c, C, p);
        const float* row = uf + (size_t)c * track::U2P;
        for (int t = 0; t < T; ++t) {
            const int m = track::halfchip_shift(st.f[track::CP]);
            if (m < 1 || m > track::S) return 1;
            float sums[6];
            block_sums(xf + (size_t)t * track::S * 2, row + (m - 1),
                       st.f[track::PH], st.f[track::DOP] / p.fs, sums);
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

// Same arguments as epl_launch, host pointers and no stream.  Returns 1
// if a half-chip shift falls outside [1, 2046].
extern "C" int epl_host(const void* x, const void* u2, const void* cp,
                        const void* dop, const void* ph, void* out, int C,
                        float fs) {
    const float* xf = static_cast<const float*>(x);
    const float* uf = static_cast<const float*>(u2);
    const float* cpf = static_cast<const float*>(cp);
    const float* df = static_cast<const float*>(dop);
    const float* pf = static_cast<const float*>(ph);
    float* of = static_cast<float*>(out);
    for (int c = 0; c < C; ++c) {
        const int m = track::halfchip_shift(cpf[c]);
        if (m < 1 || m > track::S) return 1;
        block_sums(xf, uf + (size_t)c * track::U2P + (m - 1), pf[c],
                   df[c] / fs, of + (size_t)c * 6);
    }
    return 0;
}
