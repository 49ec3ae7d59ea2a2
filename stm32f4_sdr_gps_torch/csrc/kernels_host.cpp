// Host build of the kernels' arithmetic (track_scan.cu and epl.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off, so
// track_epoch.cuh compiles as plain C++.  k1_sums adds one epoch's E/P/L
// terms in the tracking scan's order: per thread over the staged samples
// k = tid + j * K1_THREADS (the zero padding past 2046 included), then the
// transposed butterfly within each warp (warp_sum6), then the pairwise
// tree over the channel's warps (tree_sum).  epl_sums adds them in the
// per-epoch kernel's order: per thread over k = tid, tid + 256, ..., then the
// shuffle-down tree within each warp and the 8 warps in order
// (block_sum6).  track_scan_host runs the tracking-scan kernel's loop
// serially, one channel at a time; epl_host runs the per-epoch correlator.
// The CPU tests hold them against the plain torch versions
// (ops/track_scan.py:track_scan_reference, ops/epl.py:
// epl_correlate_halfchip), which checks the CUDA sources' arithmetic on a
// machine without a GPU.  k1_channels_per_block, watchdog_host and
// code_phase_mod_host expose the tracking scan's choice of channels per
// block, its watchdog window masks and its code-phase wrap to the same
// tests.

#include <vector>

#include "track_epoch.cuh"

namespace {

constexpr int EPL_THREADS = 256;
constexpr int EPL_WARPS = EPL_THREADS / 32;

// The six E/P/L sums of one epoch in the tracking scan's order; xe is the
// epoch as interleaved float pairs and rep points at u2[m - 1] of the
// channel's row.
void k1_sums(const float* xe, const float* rep, float ph, float dopfs,
             float sums[6]) {
    float part[6][track::K1_WARPS];
    for (int w = 0; w < track::K1_WARPS; ++w) {
        float v[32][8];
        for (int l = 0; l < 32; ++l) {
            float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            for (int k = w * 32 + l; k < track::SP; k += track::K1_THREADS) {
                const bool pad = k >= track::S;
                track::epl_sample(acc, pad ? 0.0f : xe[2 * k],
                                  pad ? 0.0f : xe[2 * k + 1], k, ph, dopfs,
                                  rep);
            }
            for (int j = 0; j < 8; ++j) v[l][j] = j < 6 ? acc[j] : 0.0f;
        }
        // warp_sum6: at each of off = 16, 8, 4 a lane keeps the half of
        // its n values that its bit off selects and adds the partner's
        // same half; then plain butterflies at off = 2, 1
        for (int off = 16, n = 8; off >= 4; off >>= 1, n >>= 1) {
            float next[32][8];
            for (int l = 0; l < 32; ++l) {
                const int half = (l & off) ? n / 2 : 0;
                for (int i = 0; i < n / 2; ++i)
                    next[l][i] = v[l][half + i] + v[l ^ off][half + i];
            }
            for (int l = 0; l < 32; ++l)
                for (int i = 0; i < n / 2; ++i) v[l][i] = next[l][i];
        }
        for (int off = 2; off > 0; off >>= 1) {
            float next[32];
            for (int l = 0; l < 32; ++l) next[l] = v[l][0] + v[l ^ off][0];
            for (int l = 0; l < 32; ++l) v[l][0] = next[l];
        }
        for (int j = 0; j < 6; ++j) part[j][w] = v[4 * j][0];
    }
    for (int j = 0; j < 6; ++j)
        sums[j] = track::tree_sum<track::K1_WARPS>(part[j]);
}

// The same sums in the per-epoch kernel's order (block_sum6).
void epl_sums(const float* xe, const float* rep, float ph, float dopfs,
              float sums[6]) {
    float acc[EPL_THREADS][6];
    for (int tid = 0; tid < EPL_THREADS; ++tid) {
        for (int j = 0; j < 6; ++j) acc[tid][j] = 0.0f;
        for (int k = tid; k < track::S; k += EPL_THREADS)
            track::epl_sample(acc[tid], xe[2 * k], xe[2 * k + 1], k, ph,
                              dopfs, rep);
    }
    for (int j = 0; j < 6; ++j) {
        float part[EPL_WARPS];
        for (int w = 0; w < EPL_WARPS; ++w) {
            float v[32];
            for (int l = 0; l < 32; ++l) v[l] = acc[w * 32 + l][j];
            for (int off = 16; off > 0; off >>= 1)
                for (int l = 0; l < off; ++l) v[l] = v[l] + v[l + off];
            part[w] = v[0];
        }
        float s = part[0];
        for (int w = 1; w < EPL_WARPS; ++w) s += part[w];
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
    return track::dispatch_mode(static_cast<const int*>(ip), [&](auto mode) {
        using M = decltype(mode);
        for (int c = 0; c < C; ++c) {
            track::ChanState st;
            track::load_state(st, static_cast<float*>(f32s),
                              static_cast<int*>(i32s),
                              static_cast<int*>(wins), c, C, p);
            const float* row = uf + (size_t)c * track::U2P;
            for (int t = 0; t < T; ++t) {
                const int m = track::halfchip_shift(st.f[track::CP]);
                if (m < 1 || m > track::S) return 1;
                float sums[6];
                k1_sums(xf + (size_t)t * track::S * 2, row + (m - 1),
                        st.f[track::PH], st.f[track::DOP] / p.fs, sums);
                float o[M::nout];
                track::epoch_update<M>(st, sums, p, c, o);
                for (int j = 0; j < M::nout; ++j)
                    of[((size_t)t * M::nout + j) * C + c] = o[j];
            }
            track::store_state(st, static_cast<float*>(f32s),
                               static_cast<int*>(i32s),
                               static_cast<int*>(wins), c, C, p);
        }
        return 0;
    });
}

// The tracking scan's channels per block for C channels on `sms` SMs.
extern "C" int k1_channels_per_block(int C, int sms) {
    return track::k1_channels_per_block(C, sms);
}

// One watchdog step on n windows of width win, given as the kernel's
// (win, n) int32 plane: packs each through load_state, takes
// watchdog_step with sgn[i] and hold[i], writes the transition count to
// trans[i] and the window back through store_state.  Returns 1 on a width
// outside [2, 32].
extern "C" int watchdog_host(void* wins, const void* sgn, const void* hold,
                             void* trans, int win, int n) {
    if (win < 2 || win > track::MAX_WIN) return 1;
    std::vector<float> f32s((size_t)track::NF32 * n, 0.0f);
    std::vector<int> i32s((size_t)track::NI32 * n, 0);
    track::Params p{};
    p.win = win;
    p.cib = 1;
    const int* s = static_cast<const int*>(sgn);
    const int* h = static_cast<const int*>(hold);
    int* w = static_cast<int*>(wins);
    for (int i = 0; i < n; ++i) {
        track::ChanState st;
        track::load_state(st, f32s.data(), i32s.data(), w, i, n, p);
        static_cast<int*>(trans)[i] =
            track::watchdog_step(st.wpos, st.wneg, s[i], win, h[i] != 0);
        track::store_state(st, f32s.data(), i32s.data(), w, i, n, p);
    }
    return 0;
}

// code_phase_mod and float_mod(., 1023) of a[0 .. n-1], into fast and
// full.
extern "C" int code_phase_mod_host(const void* a, void* fast, void* full,
                                   int n) {
    const float* af = static_cast<const float*>(a);
    for (int i = 0; i < n; ++i) {
        static_cast<float*>(fast)[i] = track::code_phase_mod(af[i]);
        static_cast<float*>(full)[i] =
            track::float_mod(af[i], (float)track::CODE_LENGTH);
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
        epl_sums(xf, uf + (size_t)c * track::U2P + (m - 1), pf[c],
                 df[c] / fs, of + (size_t)c * 6);
    }
    return 0;
}
