// Host build of the epoch-cost probes' arithmetic (forest.cu).
//
// Built with g++ -D__host__= -D__device__= -ffp-contract=off into the host
// library beside kernels_host.cpp (ops/kernel_lib.py host_lib), so
// forest_ops.cuh compiles as plain C++.  Each function runs its probe
// serially over the channels, on host arrays, with the launcher's
// arguments minus the stream, and returns 1 on arguments the launcher
// refuses.  P6 and P7 take the kernels' own per-channel code; P8's sums
// follow the row kernel's order (per thread over samples tid + 256 i, the
// shuffle tree within each warp, the warps in order, then the six sums in
// order); forest_layout_col_host runs the col kernels' own decomposition
// and order.  The CPU tests hold them against the plain torch versions
// (probes/forest_chain.py, forest_constructs.py, forest_layout.py).

#include <string.h>

#include <algorithm>
#include <vector>

#include "forest_ops.cuh"

using namespace forest;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// the sum of t[0..255] as block_sum6 adds one of its six partials
float block_sum(const float* t) {
    float part[WARPS];
    for (int w = 0; w < WARPS; ++w) {
        float v[32];
        for (int l = 0; l < 32; ++l) v[l] = t[w * 32 + l];
        for (int off = 16; off > 0; off >>= 1)
            for (int l = 0; l < off; ++l) v[l] = v[l] + v[l + off];
        part[w] = v[0];
    }
    float s = part[0];
    for (int w = 1; w < WARPS; ++w) s += part[w];
    return s;
}

bool is_col(int variant) {
    return variant == WIDE_COL || variant == RED_COL || variant == ROLL_COL;
}

}  // namespace

extern "C" int forest_chain_host(const void* x, void* out, int variant, int C,
                                 int K, int G) {
    if (variant < 0 || variant >= NCHAIN || C < 1 || K < 0 || G < 0) return 1;
    const ChainVariant v = CHAIN_VARIANTS[variant];
    const ChainLayout l = chain_layout(v, C, K);
    const float* xp = static_cast<const float*>(x);
    float* op = static_cast<float*>(out);
    return dispatch_chain(v, [&](auto opc, auto rows) {
        constexpr int OP = decltype(opc)::value, R = decltype(rows)::value;
        for (int c = 0; c < C; ++c) chain_channel<OP, R>(xp, op, c, G * ITERS, l);
        return 0;
    });
}

// out must hold zeros on entry, as the launcher's caller provides.
extern "C" int forest_constructs_host(const void* x, void* out, void* st,
                                      void* sti, int variant, int C, int G) {
    if (variant < 0 || variant >= NCONSTRUCT || C < 1 || G < 1) return 1;
    const float* xp = static_cast<const float*>(x);
    float* op = static_cast<float*>(out);
    float* S = static_cast<float*>(st);
    int* SI = static_cast<int*>(sti);
    for (int e = 0; e < NP * C; ++e) {
        S[e] = xp[e];
        SI[e] = (int)xp[e];
    }
    std::vector<float> a(C), b(C);
    std::vector<int> ia(C), ib(C);
    return dispatch_construct(variant, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        for (int g = 0; g < G; ++g) {
            for (int e = 0; e < ITERS; ++e) {
                for (int c = 0; c < C; ++c) {
                    a[c] = S[c];
                    b[c] = S[C + c];
                    ia[c] = SI[c];
                    ib[c] = SI[C + c];
                    epoch_pairs(a[c], b[c]);
                }
                if constexpr (V == WHEN_ANY || V == WHEN_ANY4) {
                    for (int j = 0; j < (V == WHEN_ANY ? 1 : 4); ++j) {
                        bool any = false;
                        for (int c = 0; c < C; ++c) any |= any_guard(a[c], b[c], j);
                        if (any)
                            for (int c = 0; c < C; ++c) S[c] = a[c] + 1.0f;
                    }
                } else if constexpr (V == CONCAT16 || V == DYNSTORE) {
                    const int row = V == DYNSTORE ? g : 0;
                    for (int c = 0; c < C; ++c)
                        for (int q = 0; q < NOUT; ++q)
                            op[((size_t)row * C + c) * NOUT + q] =
                                V == CONCAT16 ? a[c] * concat_scale(q) : a[c];
                } else if constexpr (V == STACK13) {
                    for (int p = 0; p < NP; ++p)
                        for (int c = 0; c < C; ++c) S[p * C + c] = a[c] * stack_scale(p);
                } else {
                    for (int c = 0; c < C; ++c)
                        own_construct<V>(a[c], b[c], ia[c], ib[c]);
                }
                for (int c = 0; c < C; ++c) {
                    S[c] = a[c];
                    S[C + c] = b[c];
                    if (V == IMOD4) SI[c] = ia[c];
                }
            }
        }
        for (int c = 0; c < C; ++c)
            for (int q = 0; q < NOUT; ++q) op[(size_t)c * NOUT + q] = S[c];
        return 0;
    });
}

// out[i] = sin(x[i]) (offset 0) or cos(x[i]) (offset 1) as P7's sincos
// computes them on the card (trig_f).
extern "C" int forest_trig_host(const void* x, void* out, int n, int offset) {
    if (n < 0 || offset < 0 || offset > 1) return 1;
    const float* xp = static_cast<const float*>(x);
    float* op = static_cast<float*>(out);
    for (int i = 0; i < n; ++i) op[i] = trig_f(xp[i], offset);
    return 0;
}

// wst receives the final plane for every variant (tr6 and tr2: w as it
// came in).
extern "C" int forest_layout_host(const void* x, const void* w, void* st,
                                  void* wst, int variant, int C, int G) {
    if (variant < 0 || variant >= NLAYOUT || C < 1 || G < 0) return 1;
    const bool col = is_col(variant);
    if (col && (C > 32 || 32 % C != 0)) return 1;
    if ((variant == TR6 && 6 * C > 1024) || (variant == TR2 && 2 * C > 1024))
        return 1;
    float* S = static_cast<float*>(st);
    float* W = static_cast<float*>(wst);
    memcpy(S, x, sizeof(float) * NST * C);
    memcpy(W, w, sizeof(float) * SP * C);
    // element k of channel c's row
    auto at = [&](int c, int k) -> float& {
        return col ? W[(size_t)k * C + c] : W[(size_t)c * SP + k];
    };
    std::vector<float> t(SP);
    for (int it = 0; it < G * ITERS; ++it) {
        if (variant == TR6 || variant == TR2) {
            for (int e = 0; e < (variant == TR6 ? 6 : 2) * C; ++e)
                S[e] = tr_scale(S[e]);
        } else if (variant == WIDE_ROW || variant == WIDE_COL) {
            for (size_t e = 0; e < (size_t)SP * C; ++e) W[e] = wide_passes(W[e]);
        } else if (variant == RED_ROW || variant == RED_COL) {
            for (int c = 0; c < C; ++c) {
                float sums[6];
                for (int j = 0; j < 6; ++j) {
                    for (int tid = 0; tid < THREADS; ++tid) {
                        float acc = 0.0f;
                        for (int k = tid; k < SP; k += THREADS)
                            acc += red_term(at(c, k), j);
                        t[tid] = acc;
                    }
                    sums[j] = block_sum(t.data());
                }
                S[c] = sums[0] + sums[1] + sums[2] + sums[3] + sums[4] + sums[5];
            }
        } else {
            for (int c = 0; c < C; ++c) {
                if (!roll_mask(S[c])) continue;
                for (int s = 0; s < BARREL_STAGES; ++s) {
                    const int sh = barrel_shift(s);
                    for (int k = 0; k < SP; ++k) t[k] = at(c, (k + sh) & (SP - 1));
                    for (int k = 0; k < SP; ++k) at(c, k) = t[k];
                }
            }
        }
        for (int c = 0; c < C; ++c) S[7 * C + c] = st7_step(S[7 * C + c]);
    }
    return 0;
}

// P8's col variants as col_kernel decomposes them, literally: groups of
// col_group(C) channels, each a cluster of COL_RANKS slabs of 256 samples;
// red_col sums as a rank's threads do (element e = tid + 256 i of the slab
// is sample e / CG, channel tid % CG), then across the lanes of a channel
// (lane ^ 16, ..., ^ CG), its warps in order and the ranks in rank order;
// roll_col runs each rank's stages on its slab and the first HALO rows of
// the next rank's (cyclically), over a ghost zone that shrinks to
// col_extent(s) rows at stage s.  Same arguments as forest_layout_host.
extern "C" int forest_layout_col_host(const void* x, const void* w, void* st,
                                      void* wst, int variant, int C, int G) {
    if (!is_col(variant) || C < 1 || C > 32 || 32 % C != 0 || G < 0)
        return 1;
    const int CG = col_group(C);
    float* S = static_cast<float*>(st);
    float* W = static_cast<float*>(wst);
    memcpy(S, x, sizeof(float) * NST * C);
    memcpy(W, w, sizeof(float) * SP * C);
    auto at = [&](int row, int ch) -> float& { return W[(size_t)row * C + ch]; };
    std::vector<float> acc(COL_THREADS * 6), slabs((size_t)SP * CG),
        buf(GHOST * CG), nxt(GHOST * CG);
    float blk[COL_RANKS][COL_GROUP][6];
    for (int g0 = 0; g0 < C; g0 += CG) {
        for (int it = 0; it < G * ITERS; ++it) {
            if (variant == WIDE_COL) {
                for (int row = 0; row < SP; ++row)
                    for (int c = 0; c < CG; ++c)
                        at(row, g0 + c) = wide_passes(at(row, g0 + c));
            } else if (variant == RED_COL) {
                for (int rank = 0; rank < COL_RANKS; ++rank) {
                    for (int tid = 0; tid < COL_THREADS; ++tid) {
                        float* a = &acc[tid * 6];
                        for (int j = 0; j < 6; ++j) a[j] = 0.0f;
                        for (int i = 0; i < CG; ++i) {
                            const int e = tid + i * COL_THREADS;
                            const float wv = at(rank * COL_SAMPLES + e / CG,
                                                g0 + tid % CG);
                            for (int j = 0; j < 6; ++j) a[j] += red_term(wv, j);
                        }
                    }
                    float part[COL_WARPS][COL_GROUP][6];
                    for (int warp = 0; warp < COL_WARPS; ++warp) {
                        float v[32][6], t[32][6];
                        memcpy(v, &acc[warp * 32 * 6], sizeof v);
                        for (int off = 16; off >= CG; off >>= 1) {
                            for (int l = 0; l < 32; ++l)
                                for (int j = 0; j < 6; ++j)
                                    t[l][j] = v[l][j] + v[l ^ off][j];
                            memcpy(v, t, sizeof v);
                        }
                        for (int c = 0; c < CG; ++c)
                            for (int j = 0; j < 6; ++j) part[warp][c][j] = v[c][j];
                    }
                    for (int c = 0; c < CG; ++c)
                        for (int j = 0; j < 6; ++j) {
                            float s = part[0][c][j];
                            for (int q = 1; q < COL_WARPS; ++q) s += part[q][c][j];
                            blk[rank][c][j] = s;
                        }
                }
                for (int c = 0; c < CG; ++c) {
                    float tot = 0.0f;
                    for (int j = 0; j < 6; ++j) {
                        float tj = blk[0][c][j];
                        for (int b = 1; b < COL_RANKS; ++b) tj += blk[b][c][j];
                        tot = j == 0 ? tj : tot + tj;
                    }
                    S[g0 + c] = tot;
                }
            } else {
                for (int rank = 0; rank < COL_RANKS; ++rank) {
                    const int next = (rank + 1) % COL_RANKS;
                    for (int k = 0; k < GHOST; ++k) {
                        const int row = k < COL_SAMPLES
                                            ? rank * COL_SAMPLES + k
                                            : next * COL_SAMPLES + k - COL_SAMPLES;
                        for (int c = 0; c < CG; ++c) buf[k * CG + c] = at(row, g0 + c);
                    }
                    for (int s = 0; s < BARREL_STAGES; ++s) {
                        const int sh = barrel_shift(s);
                        for (int k = 0; k < col_extent(s); ++k)
                            for (int c = 0; c < CG; ++c)
                                nxt[k * CG + c] = roll_mask(S[g0 + c])
                                                      ? buf[(k + sh) * CG + c]
                                                      : buf[k * CG + c];
                        std::copy(nxt.begin(), nxt.begin() + col_extent(s) * CG,
                                  buf.begin());
                    }
                    std::copy(buf.begin(), buf.begin() + COL_SAMPLES * CG,
                              slabs.begin() + (size_t)rank * COL_SAMPLES * CG);
                }
                for (int row = 0; row < SP; ++row)
                    for (int c = 0; c < CG; ++c) at(row, g0 + c) = slabs[row * CG + c];
            }
            for (int c = 0; c < CG; ++c)
                S[7 * C + g0 + c] = st7_step(S[7 * C + g0 + c]);
        }
    }
    return 0;
}
