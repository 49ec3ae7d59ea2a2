// Host build of the handoff search kernels' arithmetic (pretrack.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off, so
// pretrack.cuh compiles as plain C++.  Each function runs its kernel's
// blocks serially and adds every sum in the kernel's order: per thread over
// its samples k = tid + 256 j, then the warp butterfly (lane l adds lane
// l ^ off at off = 16 .. 1), then the 8 warps as a pairwise tree
// (track::tree_sum).  Each block replays the epoch recurrences from epoch 0
// through the same functions the kernels call.  The CPU tests hold these
// against the plain torch loops (acquire/engine.py:squared_prompts_plain,
// track/pretrack.py:_pretrack_power), which checks the CUDA source's
// arithmetic on a machine without a GPU; pretrack_states_host and
// pretrack_chip_host expose the recurrences and the chip index alone.

#include "pretrack.cuh"

namespace {

using pretrack::CODE_LENGTH;
using pretrack::NJ;
using pretrack::THREADS;
using pretrack::WARPS;

// The kernels' block sum of one partial per thread.
float block_sum(const float* p) {
    float w[WARPS];
    for (int q = 0; q < WARPS; ++q) {
        float v[32];
        for (int l = 0; l < 32; ++l) v[l] = p[q * 32 + l];
        for (int off = 16; off > 0; off >>= 1) {
            float next[32];
            for (int l = 0; l < 32; ++l) next[l] = v[l] + v[l ^ off];
            for (int l = 0; l < 32; ++l) v[l] = next[l];
        }
        w[q] = v[0];
    }
    return track::tree_sum<WARPS>(w);
}

bool shape_ok(int S, int K) {
    return S >= 1 && S <= pretrack::MAX_S && K >= 1 && K <= pretrack::MAX_K;
}

}  // namespace

// The state each block of sq_prompt_kernel starts its epoch from: for
// epoch e of channel c, cp_out[e * C + c] and ph_out[e * C + c], replayed
// from cp0[c] and 0 with chips_per_epoch = rate[c] * S.
extern "C" int pretrack_states_host(const void* cp0, const void* rate,
                                    const void* dop, void* cp_out,
                                    void* ph_out, int E, int C, int S,
                                    float s_over_fs) {
    const float* cpf = static_cast<const float*>(cp0);
    const float* rf = static_cast<const float*>(rate);
    const float* df = static_cast<const float*>(dop);
    for (int e = 0; e < E; ++e)
        for (int c = 0; c < C; ++c) {
            static_cast<float*>(cp_out)[(size_t)e * C + c] =
                pretrack::code_phase_at(e, cpf[c], rf[c] * (float)S);
            static_cast<float*>(ph_out)[(size_t)e * C + c] =
                pretrack::carrier_phase_at(e, df[c], s_over_fs);
        }
    return 0;
}

// chip_index(rate[i], k[i], base[i]) into out[i], for i < n.
extern "C" int pretrack_chip_host(const void* rate, const void* k,
                                  const void* base, void* out, int n) {
    for (int i = 0; i < n; ++i)
        static_cast<int*>(out)[i] = pretrack::chip_index(
            static_cast<const float*>(rate)[i],
            static_cast<const int*>(k)[i],
            static_cast<const float*>(base)[i]);
    return 0;
}

// Same arguments as sq_prompts_launch, host pointers and no stream.
// Returns 1 on an S the kernel does not take.
extern "C" int sq_prompts_host(const void* x, const void* table,
                               const void* cp0, const void* rate,
                               const void* dop, void* out, int E, int C,
                               int S, float s_over_fs, float fs) {
    if (!shape_ok(S, 1)) return 1;
    const float* xf = static_cast<const float*>(x);
    const float* tf = static_cast<const float*>(table);
    float* of = static_cast<float*>(out);
    float pr[THREADS], pi[THREADS];
    for (int e = 0; e < E; ++e)
        for (int c = 0; c < C; ++c) {
            const float r = static_cast<const float*>(rate)[c];
            const float f = static_cast<const float*>(dop)[c];
            const float cp = pretrack::code_phase_at(
                e, static_cast<const float*>(cp0)[c], r * (float)S);
            const float ph = pretrack::carrier_phase_at(e, f, s_over_fs);
            const float* code = tf + (size_t)c * CODE_LENGTH;
            const float* xe = xf + (size_t)e * S * 2;
            for (int tid = 0; tid < THREADS; ++tid) {
                float ar = 0.0f, ai = 0.0f;
                for (int j = 0; j < NJ; ++j) {
                    const int k = tid + j * THREADS;
                    if (k >= S) continue;
                    float yr, yi;
                    pretrack::wipe(xe[2 * k], xe[2 * k + 1], k, ph, f, fs,
                                   &yr, &yi);
                    const float rep = code[pretrack::chip_index(r, k, cp)];
                    ar += yr * rep;
                    ai += yi * rep;
                }
                pr[tid] = ar;
                pi[tid] = ai;
            }
            of[((size_t)e * C + c) * 2] = block_sum(pr);
            of[((size_t)e * C + c) * 2 + 1] = block_sum(pi);
        }
    return 0;
}

// pretrack_power_launch's two kernels, host pointers and no stream: the
// (E, C, K) complex correlations into corr, their power summed over the
// epochs into power.  Returns 1 on an S or K the kernels do not take.
extern "C" int pretrack_power_host(const void* x, const void* table,
                                   const void* cp, const void* dop,
                                   void* corr, void* power, int E, int C,
                                   int S, int K, float cps, float s_over_fs,
                                   float fs) {
    if (!shape_ok(S, K)) return 1;
    const float* xf = static_cast<const float*>(x);
    const float* tf = static_cast<const float*>(table);
    float* cf = static_cast<float*>(corr);
    float yr[THREADS][NJ], yi[THREADS][NJ];
    float pr[THREADS], pi[THREADS];
    for (int e = 0; e < E; ++e)
        for (int c = 0; c < C; ++c) {
            const float f = static_cast<const float*>(dop)[c];
            const float cpc = static_cast<const float*>(cp)[c];
            const float ph = pretrack::carrier_phase_at(e, f, s_over_fs);
            const float* code = tf + (size_t)c * CODE_LENGTH;
            const float* xe = xf + (size_t)e * S * 2;
            for (int tid = 0; tid < THREADS; ++tid)
                for (int j = 0; j < NJ; ++j) {
                    const int k = tid + j * THREADS;
                    yr[tid][j] = yi[tid][j] = 0.0f;
                    if (k < S)
                        pretrack::wipe(xe[2 * k], xe[2 * k + 1], k, ph, f,
                                       fs, &yr[tid][j], &yi[tid][j]);
                }
            for (int o = 0; o < K; ++o) {
                const float base = cpc + pretrack::offset_chips(o, K);
                for (int tid = 0; tid < THREADS; ++tid) {
                    float ar = 0.0f, ai = 0.0f;
                    for (int j = 0; j < NJ; ++j) {
                        const int k = tid + j * THREADS;
                        if (k >= S) continue;
                        const float rep =
                            code[pretrack::chip_index(cps, k, base)];
                        ar += yr[tid][j] * rep;
                        ai += yi[tid][j] * rep;
                    }
                    pr[tid] = ar;
                    pi[tid] = ai;
                }
                float* out = cf + (((size_t)e * C + c) * K + o) * 2;
                out[0] = block_sum(pr);
                out[1] = block_sum(pi);
            }
        }
    const size_t ck = (size_t)C * K;
    for (size_t i = 0; i < ck; ++i) {
        float acc = 0.0f;
        for (int e = 0; e < E; ++e) {
            const float re = cf[(e * ck + i) * 2];
            const float im = cf[(e * ck + i) * 2 + 1];
            acc = acc + (re * re + im * im);
        }
        static_cast<float*>(power)[i] = acc;
    }
    return 0;
}
