// Per-element bodies of the epoch-cost probes P6, P7 and P8 (forest.cu).
//
// Everything here is __host__ __device__: nvcc builds it into the Hopper
// kernels of forest.cu, and g++ builds the same source (with -D__host__=
// -D__device__= -ffp-contract=off) into the host library (forest_host.cpp)
// that the CPU tests hold against the plain torch versions
// (probes/forest_chain.py, forest_constructs.py, forest_layout.py).
//
// Floating point: both builds run without multiply-add contraction (nvcc
// -fmad=false), so every float operation rounds once in source order.
// Where the JAX reference computes a*c + b, its XLA lowering fuses it into
// one rounding; those steps are an explicit fmaf here (fma_pair,
// wide_passes, any_guard).  P7's costas and lcg constructs are the
// tracking kernel's own costas_err and lcg_uniform (track_epoch.cuh), and
// imod4 its floor_mod.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "track_epoch.cuh"

namespace forest {

template <int N>
using ic = std::integral_constant<int, N>;

constexpr int ITERS = 8;       // inner iterations per grid step (EPOCHS)
constexpr int NP = 13;         // P7 state planes
constexpr int NOUT = 16;       // P7 output row width
constexpr int SP = 2048;       // P8 samples per channel
constexpr int NST = 8;         // P8 state planes

// int32 arithmetic with two's-complement wrap, as XLA and torch compute it
// (signed overflow is undefined in C++).
__host__ __device__ inline int wrap_add(int a, int b) {
    return (int)((uint32_t)a + (uint32_t)b);
}

__host__ __device__ inline int wrap_sub(int a, int b) {
    return (int)((uint32_t)a - (uint32_t)b);
}

// jnp.maximum / torch.maximum: NaN in the first operand propagates.
__host__ __device__ inline float max_nan(float a, float b) {
    return (a != a || a > b) ? a : b;
}

// ---- P6: dependent pairs of tiny ops (tools/forest_probe.py:76-95) ----

enum ChainOp { FMA = 0, SEL = 1, INT = 2 };

__host__ __device__ inline void fma_pair(float& a, float& b) {
    a = fmaf(a, 1.000001f, b);
    b = fmaf(b, 0.999999f, a);
}

// b's update takes the new a (forest_probe.py:84-87); the products by 0.5
// are exact, so fusing them would change nothing.
__host__ __device__ inline void sel_pair(float& a, float& b) {
    const bool m = a > b;
    const float na = m ? a * 0.5f + b : b - a;
    b = m ? b : b * 0.5f + na;
    a = na;
}

__host__ __device__ inline void int_pair(int& ai, int& bi) {
    const int t = wrap_add(ai, 1);
    ai = (t < 1000 ? t : 1000) ^ bi;
    const int u = wrap_add(bi, -1);
    bi = wrap_add(u > -1000 ? u : -1000, ai);
}

// One inner iteration of a P6 variant on R independent (a, b) chains of
// `pairs` dependent pairs each.  The chains advance in lockstep, so their
// independent ops stand side by side in program order.  The int chains
// convert from and back to float32 once per iteration, as the probe does
// (truncation toward zero, then round to nearest).
template <int OP, int R>
__host__ __device__ inline void chain_iteration(float (&a)[R], float (&b)[R],
                                                int pairs) {
    if constexpr (OP == INT) {
        int ai[R], bi[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            ai[r] = (int)a[r];
            bi[r] = (int)b[r];
        }
        for (int k = 0; k < pairs; ++k) {
#pragma unroll
            for (int r = 0; r < R; ++r) int_pair(ai[r], bi[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            a[r] = (float)ai[r];
            b[r] = (float)bi[r];
        }
    } else {
        for (int k = 0; k < pairs; ++k) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if constexpr (OP == FMA) fma_pair(a[r], b[r]);
                else sel_pair(a[r], b[r]);
            }
        }
    }
}

// The 11 variants in the probe's order (forest_probe.py:144-146): the op,
// the rows each channel carries as independent chains, and whether the
// rows are the ilp variant's 4 chains of K/4 pairs, whose (8, C, 1) state
// interleaves a and b planes.  c1 and lc (and fc's 8 rows against kc's 16)
// differ on the TPU in vreg layout only; per channel they are the same
// chains, so on the card c1 and lc run the same code.
struct ChainVariant {
    int op, rows;
    bool ilp;
};
constexpr int NCHAIN = 11;
constexpr ChainVariant CHAIN_VARIANTS[NCHAIN] = {
    {FMA, 1, false},  {FMA, 1, false}, {FMA, 8, false}, {FMA, 4, true},
    {SEL, 1, false},  {SEL, 1, false}, {INT, 1, false}, {INT, 1, false},
    {FMA, 16, false}, {FMA, 4, false}, {SEL, 16, false}};

// Where chain r of channel c keeps a and b in the flat state: a at
// r * a_stride + c, b at b_base + r * a_stride + c.
struct ChainLayout {
    int pairs, a_stride, b_base;
};

__host__ __device__ inline ChainLayout chain_layout(const ChainVariant& v,
                                                    int C, int K) {
    if (v.ilp) return {K / 4, 2 * C, C};
    return {K, C, v.rows * C};
}

// P6 for channel c: load its chains, run `iters` iterations, store them.
template <int OP, int R>
__host__ __device__ inline void chain_channel(const float* x, float* out,
                                              int c, int iters,
                                              ChainLayout l) {
    float a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        a[r] = x[r * l.a_stride + c];
        b[r] = x[l.b_base + r * l.a_stride + c];
    }
    for (int it = 0; it < iters; ++it) chain_iteration<OP, R>(a, b, l.pairs);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        out[r * l.a_stride + c] = a[r];
        out[l.b_base + r * l.a_stride + c] = b[r];
    }
}

// Calls f(ic<OP>{}, ic<R>{}) for a variant's op and rows and returns what
// f returns.
template <class F>
inline int dispatch_chain(const ChainVariant& v, F&& f) {
    switch (v.op * 100 + v.rows) {
        case FMA * 100 + 1: return f(ic<FMA>{}, ic<1>{});
        case FMA * 100 + 4: return f(ic<FMA>{}, ic<4>{});
        case FMA * 100 + 8: return f(ic<FMA>{}, ic<8>{});
        case FMA * 100 + 16: return f(ic<FMA>{}, ic<16>{});
        case SEL * 100 + 1: return f(ic<SEL>{}, ic<1>{});
        case SEL * 100 + 16: return f(ic<SEL>{}, ic<16>{});
        default: return f(ic<INT>{}, ic<1>{});
    }
}

// ---- P7: the minimal epoch body and its constructs (forest_probe2.py) ----

enum Construct {
    BASE = 0, WHEN_ANY, WHEN_ANY4, CONCAT16, STACK13, IMOD4, FDIV4, DYNSTORE,
    SINCOS, COSTAS, LCG, NCONSTRUCT
};

// the two fma pairs every variant runs (forest_probe2.py:81-83)
__host__ __device__ inline void epoch_pairs(float& a, float& b) {
    fma_pair(a, b);
    fma_pair(a, b);
}

// guard j of when_any / when_any4: a > b * 1e9 + j (fused, as the
// reference rounds it; for j = 0 the same as the product alone)
__host__ __device__ inline bool any_guard(float a, float b, int j) {
    return a > fmaf(b, 1e9f, (float)j);
}

// the per-piece factors of concat16 and stack13, float32(1 + 0.01 j) and
// float32(1 + 0.001 j) as the probe rounds them from double
__host__ __device__ inline float concat_scale(int j) {
    return (float)(1.0 + 0.01 * j);
}

__host__ __device__ inline float stack_scale(int j) {
    return (float)(1.0 + 0.001 * j);
}

// The constructs that touch only their own channel's values: imod4,
// fdiv4, sincos (cosf + sinf, as the probe computes it), costas and lcg.
// The others synchronise the block or store, and live in the kernel.
template <int V>
__host__ __device__ inline void own_construct(float& a, float& b, int& ia,
                                              int ib) {
    if constexpr (V == IMOD4) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            ia = track::floor_mod(wrap_sub(ib, ia), 20 + j);
    } else if constexpr (V == FDIV4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            a = b / max_nan(a, 1e-12f);
            b = a + b;
        }
    } else if constexpr (V == SINCOS) {
        a = cosf(a) + sinf(b);
    } else if constexpr (V == COSTAS) {
        a = track::costas_err(a, b);
    } else if constexpr (V == LCG) {
        a = track::lcg_uniform(ia) > 0.5f ? a : b;
    }
}

// Calls f(ic<V>{}) for construct v and returns what f returns.
template <class F>
inline int dispatch_construct(int v, F&& f) {
    switch (v) {
        case BASE: return f(ic<BASE>{});
        case WHEN_ANY: return f(ic<WHEN_ANY>{});
        case WHEN_ANY4: return f(ic<WHEN_ANY4>{});
        case CONCAT16: return f(ic<CONCAT16>{});
        case STACK13: return f(ic<STACK13>{});
        case IMOD4: return f(ic<IMOD4>{});
        case FDIV4: return f(ic<FDIV4>{});
        case DYNSTORE: return f(ic<DYNSTORE>{});
        case SINCOS: return f(ic<SINCOS>{});
        case COSTAS: return f(ic<COSTAS>{});
        default: return f(ic<LCG>{});
    }
}

// ---- P8: the layout probe's element bodies (forest_probe3.py) ----

enum Layout {
    TR6 = 0, TR2, WIDE_ROW, WIDE_COL, RED_ROW, RED_COL, ROLL_ROW, ROLL_COL,
    NLAYOUT
};

// the 14 wide passes on one element (forest_probe3.py:85-91)
__host__ __device__ inline float wide_passes(float w) {
    float a = w;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        a = fmaf(a, 1.000001f, w);
        a = fmaf(a, 0.999999f, -w);
    }
    return a;
}

// term j of the six multiply-reduce sums (forest_probe3.py:95-97)
__host__ __device__ inline float red_term(float w, int j) {
    return w * (w + (float)j);
}

// the 4-stage barrel: stage s reads the element 2**s samples ahead
// (forest_probe3.py:116-118, the roll amount folded to W - 2**s)
constexpr int BARREL_STAGES = 4;
__host__ __device__ inline int barrel_shift(int stage) { return 1 << stage; }

// the per-channel roll mask st[0] > 0.5 (forest_probe3.py:113-115)
__host__ __device__ inline bool roll_mask(float st0) { return st0 > 0.5f; }

__host__ __device__ inline float tr_scale(float v) { return v * 1.000001f; }

// st[7] advances every iteration in every variant (forest_probe3.py:120)
__host__ __device__ inline float st7_step(float v) { return v * 1.0000001f; }

}  // namespace forest
