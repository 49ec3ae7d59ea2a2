// Epoch-cost probes for Hopper (sm_90a): what one iteration of the
// tracking loop's serial per-channel update costs, by part.
//
// Replaces the JAX package's Pallas TPU probes
//   P6  tools/forest_probe.py::build.kernel   (chains of tiny ops),
//   P7  tools/forest_probe2.py::build.kernel  (the epoch body's constructs),
//   P8  tools/forest_probe3.py::build.kernel  (layouts of the correlator
//                                              reductions and the barrel).
// Each TPU probe runs a sequential grid of G steps of 8 inner iterations;
// here the G x 8 loop runs inside one launch, and its time divided by
// G * 8 is the cost of one iteration.  The element bodies are in
// forest_ops.cuh, shared with the g++ host build.
//
// P6, chain_kernel.  One thread per channel; a variant's rows per channel
// (1 for c1 and lc, 4 for k4, 8 for fc, 16 for kc, the ilp variant's 4
// chains of K/4 pairs) run as independent chains in that thread's
// registers.  So the probe asks on Hopper what it asked on the TPU: the
// latency of one dependent op pair, and whether one thread's independent
// chains overlap.  Bound: the latency of a dependent FP32 / INT op (about
// 5.5 cycles on the H100 at 1.98 GHz) for one to four chains, the issue
// rate of one warp (one instruction per cycle) from eight chains up.
//
// P7, constructs_kernel.  One thread per channel, all C channels in one
// block (C <= 1024).  The 13 + 13 state planes live in shared memory, as
// the TPU kept them in VMEM scratch, and are read and written through
// volatile pointers, so every iteration loads and stores them as the
// probe's base body does.  when_any / when_any4 are __syncthreads_or, a
// block barrier; concat16 and dynstore are 64-byte global stores per
// channel per iteration (__stcg, which nvcc does not drop); stack13
// writes the 13 planes.  Bound: latency of the one serial chain per
// thread, plus whatever the construct adds; this is the per-epoch serial
// work of thread 0 in track_scan.cu.  The IEEE divide and cosf / sinf are
// value-dependent (slow paths for inf, NaN and, in sinf, arguments past
// 1e5), so probes/forest_constructs.py also times P7 on finite values.
//
// P8, three kernels for the two layouts of a channel's 2048 samples.
// * tr_kernel (tr6, tr2): one block; thread c holds channel c's 8 planes
//   in registers, and each iteration moves 6 (or 2) of them through shared
//   memory to one thread per (plane, channel), scales them there and
//   moves them back: two barriers per iteration.
// * row_kernel (wide_row, red_row, roll_row): the (C, 2048) plane is 256
//   KB at C = 32, more than a block may hold, so one block of 256 threads
//   per channel with its 8 KB row in shared memory.  red_row reduces in
//   fixed order (block_sum6: shuffle tree, then the warps in order);
//   roll_row reads the row shifted in shared memory, with a select per
//   channel: two barriers per barrel stage.
// * col_kernel (wide_col, red_col, roll_col): the (2048, C) plane
//   sample-major with lane = channel (C divides 32), split into 8 slices
//   of 256 samples held in the shared memory of the 8 blocks of one
//   thread-block cluster; warps split a slice's samples.  red_col sums
//   per thread, then across the lanes of one channel, the warps in order
//   and the cluster's blocks in rank order (distributed shared memory);
//   roll_col reads the shifted element from whichever block holds it:
//   two cluster barriers per barrel stage.
// Bound: barrier latency per stage, and the 14 fma passes' issue rate for
// wide.  A cluster barrier (cluster.sync) compiles to MEMBAR.ALL.GPU, the
// cluster arrive / wait and an L1 invalidate (CCTL.IVALL), which makes
// the col kernels several times slower than the row kernels, whose block
// barriers cost ~40 ns.  red_* reduce an unchanged plane every iteration:
// they read it from shared memory behind a barrier each time, so nvcc
// cannot hoist the reduction out of the loop (the time per iteration is
// the same at G = 64 and 128).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "forest_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace forest;

constexpr int CHAIN_THREADS = 32;
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int ROW_PER = SP / ROW_THREADS;      // samples per thread
constexpr int CLUSTER = 8;
constexpr int COL_THREADS = 256;
constexpr int COL_WARPS = COL_THREADS / 32;
constexpr int COL_SAMPLES = SP / CLUSTER;      // samples per block
constexpr size_t DEFAULT_SMEM = 48 * 1024;

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// ---------------------------------- P6 ------------------------------------

template <int OP, int R>
__global__ void __launch_bounds__(CHAIN_THREADS)
chain_kernel(const float* __restrict__ x, float* __restrict__ out, int C,
             int iters, ChainLayout l) {
    const int c = blockIdx.x * CHAIN_THREADS + threadIdx.x;
    if (c < C) chain_channel<OP, R>(x, out, c, iters, l);
}

// ---------------------------------- P7 ------------------------------------

template <int V>
__global__ void constructs_kernel(const float* __restrict__ x,
                                  float* __restrict__ out,
                                  float* __restrict__ st_out,
                                  int* __restrict__ sti_out, int C, int G) {
    extern __shared__ float smem[];
    volatile float* S = smem;                                     // (13, C)
    volatile int* SI = reinterpret_cast<volatile int*>(smem + NP * C);
    const int c = threadIdx.x;
    for (int p = 0; p < NP; ++p) {
        const float v = x[p * C + c];
        S[p * C + c] = v;
        SI[p * C + c] = (int)v;
    }
    for (int g = 0; g < G; ++g) {
        for (int e = 0; e < ITERS; ++e) {
            float a = S[c], b = S[C + c];
            int ia = SI[c];
            const int ib = SI[C + c];
            epoch_pairs(a, b);
            if constexpr (V == WHEN_ANY) {
                if (__syncthreads_or(any_guard(a, b, 0))) S[c] = a + 1.0f;
            } else if constexpr (V == WHEN_ANY4) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (__syncthreads_or(any_guard(a, b, j))) S[c] = a + 1.0f;
            } else if constexpr (V == CONCAT16 || V == DYNSTORE) {
                const int row = V == DYNSTORE ? g : 0;
                float4* o = reinterpret_cast<float4*>(
                    out + ((size_t)row * C + c) * NOUT);
#pragma unroll
                for (int q = 0; q < NOUT / 4; ++q) {
                    if constexpr (V == CONCAT16)
                        __stcg(o + q, make_float4(a * concat_scale(4 * q),
                                                  a * concat_scale(4 * q + 1),
                                                  a * concat_scale(4 * q + 2),
                                                  a * concat_scale(4 * q + 3)));
                    else
                        __stcg(o + q, make_float4(a, a, a, a));
                }
            } else if constexpr (V == STACK13) {
#pragma unroll
                for (int p = 0; p < NP; ++p) S[p * C + c] = a * stack_scale(p);
            } else {
                own_construct<V>(a, b, ia, ib);
            }
            S[c] = a;
            S[C + c] = b;
            if constexpr (V == IMOD4) SI[c] = ia;
        }
    }
    // after the last step, row 0 of the output is st[0] (forest_probe2.py:
    // 144-146)
    const float a = S[c];
    float4* o = reinterpret_cast<float4*>(out + (size_t)c * NOUT);
#pragma unroll
    for (int q = 0; q < NOUT / 4; ++q) o[q] = make_float4(a, a, a, a);
    for (int p = 0; p < NP; ++p) {
        st_out[p * C + c] = S[p * C + c];
        sti_out[p * C + c] = SI[p * C + c];
    }
}

// ---------------------------------- P8 ------------------------------------

template <int NPL>
__global__ void tr_kernel(const float* __restrict__ x, float* __restrict__ st,
                          int C, int G) {
    extern __shared__ float s_t[];                   // (NPL, C)
    const int t = threadIdx.x;                       // plane t / C, channel t % C
    const bool owner = t < C;                        // channel t's planes
    float v[NST];
    if (owner) {
#pragma unroll
        for (int p = 0; p < NST; ++p) v[p] = x[p * C + t];
    }
    for (int it = 0; it < G * ITERS; ++it) {
        if (owner) {
#pragma unroll
            for (int p = 0; p < NPL; ++p) s_t[p * C + t] = v[p];
        }
        __syncthreads();
        s_t[t] = tr_scale(s_t[t]);
        __syncthreads();
        if (owner) {
#pragma unroll
            for (int p = 0; p < NPL; ++p) v[p] = s_t[p * C + t];
            v[7] = st7_step(v[7]);
        }
    }
    if (owner) {
#pragma unroll
        for (int p = 0; p < NST; ++p) st[p * C + t] = v[p];
    }
}

template <int V>
__global__ void __launch_bounds__(ROW_THREADS)
row_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ st, float* __restrict__ wst, int C, int G) {
    __shared__ float s_w[SP];
    __shared__ float s_part[2][ROW_WARPS][6];
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    float v[NST];                                    // thread 0: st[:, c]
    if (tid == 0) {
#pragma unroll
        for (int p = 0; p < NST; ++p) v[p] = x[p * C + c];
    }
    const bool m = roll_mask(x[c]);
    float r[ROW_PER];                                // samples tid + 256 i
#pragma unroll
    for (int i = 0; i < ROW_PER; ++i) {
        r[i] = w[(size_t)c * SP + tid + i * ROW_THREADS];
        if constexpr (V != WIDE_ROW) s_w[tid + i * ROW_THREADS] = r[i];
    }
    __syncthreads();
    for (int it = 0; it < G * ITERS; ++it) {
        if constexpr (V == WIDE_ROW) {
#pragma unroll
            for (int i = 0; i < ROW_PER; ++i) r[i] = wide_passes(r[i]);
        } else if constexpr (V == RED_ROW) {
            float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < ROW_PER; ++i) {
                const float wv = s_w[tid + i * ROW_THREADS];
#pragma unroll
                for (int j = 0; j < 6; ++j) acc[j] += red_term(wv, j);
            }
            track::block_sum6<ROW_WARPS>(acc, s_part[it & 1]);
            if (tid == 0)
                v[0] = acc[0] + acc[1] + acc[2] + acc[3] + acc[4] + acc[5];
        } else {
            for (int s = 0; s < BARREL_STAGES; ++s) {
                const int sh = barrel_shift(s);
#pragma unroll
                for (int i = 0; i < ROW_PER; ++i) {
                    const int k = tid + i * ROW_THREADS;
                    r[i] = s_w[m ? (k + sh) & (SP - 1) : k];
                }
                __syncthreads();
#pragma unroll
                for (int i = 0; i < ROW_PER; ++i)
                    s_w[tid + i * ROW_THREADS] = r[i];
                __syncthreads();
            }
        }
        if (tid == 0) v[7] = st7_step(v[7]);
    }
    if (tid == 0) {
#pragma unroll
        for (int p = 0; p < NST; ++p) st[p * C + c] = v[p];
    }
#pragma unroll
    for (int i = 0; i < ROW_PER; ++i)
        wst[(size_t)c * SP + tid + i * ROW_THREADS] = r[i];
}

// CT = C channels; element e = tid + 256 i of a block's (256, CT) slice is
// sample e / CT of the slice, channel e % CT = tid % CT.
template <int V, int CT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(COL_THREADS)
col_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ st, float* __restrict__ wst, int G) {
    __shared__ float s_w[COL_SAMPLES * CT];
    __shared__ float s_part[2][COL_WARPS][6][CT];
    __shared__ float s_blk[2][6][CT];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int c = tid % CT;
    const bool owner = rank == 0 && tid < CT;        // st[:, tid]
    float v[NST];
    if (owner) {
#pragma unroll
        for (int p = 0; p < NST; ++p) v[p] = x[p * CT + tid];
    }
    const bool m = roll_mask(x[c]);
    const size_t base = (size_t)rank * COL_SAMPLES * CT;
    float r[CT];
#pragma unroll
    for (int i = 0; i < CT; ++i) {
        r[i] = w[base + tid + i * COL_THREADS];
        if constexpr (V != WIDE_COL) s_w[tid + i * COL_THREADS] = r[i];
    }
    if constexpr (V != WIDE_COL) cluster.sync();
    for (int it = 0; it < G * ITERS; ++it) {
        if constexpr (V == WIDE_COL) {
#pragma unroll
            for (int i = 0; i < CT; ++i) r[i] = wide_passes(r[i]);
        } else if constexpr (V == RED_COL) {
            const int par = it & 1;
            float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < CT; ++i) {
                const float wv = s_w[tid + i * COL_THREADS];
#pragma unroll
                for (int j = 0; j < 6; ++j) acc[j] += red_term(wv, j);
            }
            // the lanes of one channel are lane ^ 16, ^ 8, ..., ^ CT
#pragma unroll
            for (int off = 16; off >= CT; off >>= 1) {
#pragma unroll
                for (int j = 0; j < 6; ++j)
                    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
            }
            if (lane < CT) {
#pragma unroll
                for (int j = 0; j < 6; ++j) s_part[par][warp][j][lane] = acc[j];
            }
            __syncthreads();
            if (tid < CT) {
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    float s = s_part[par][0][j][tid];
                    for (int q = 1; q < COL_WARPS; ++q) s += s_part[par][q][j][tid];
                    s_blk[par][j][tid] = s;
                }
            }
            cluster.sync();
            if (owner) {
                float tot = 0.0f;
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    float tj = 0.0f;
                    for (int b = 0; b < CLUSTER; ++b)
                        tj += cluster.map_shared_rank(&s_blk[par][j][tid], b)[0];
                    tot = j == 0 ? tj : tot + tj;
                }
                v[0] = tot;
            }
        } else {
            for (int s = 0; s < BARREL_STAGES; ++s) {
                const int sh = barrel_shift(s);
#pragma unroll
                for (int i = 0; i < CT; ++i) {
                    // the rolled element is read whatever the mask, as
                    // the probe's where(m, roll(w), w) computes it
                    const int e = tid + i * COL_THREADS;
                    const int k = ((rank * COL_SAMPLES + e / CT + sh)
                                   & (SP - 1));
                    const float rolled = cluster.map_shared_rank(
                        &s_w[0], k / COL_SAMPLES)[(k % COL_SAMPLES) * CT + c];
                    r[i] = m ? rolled : s_w[e];
                }
                cluster.sync();
#pragma unroll
                for (int i = 0; i < CT; ++i) s_w[tid + i * COL_THREADS] = r[i];
                cluster.sync();
            }
        }
        if (owner) v[7] = st7_step(v[7]);
    }
    if (owner) {
#pragma unroll
        for (int p = 0; p < NST; ++p) st[p * CT + tid] = v[p];
    }
#pragma unroll
    for (int i = 0; i < CT; ++i) wst[base + tid + i * COL_THREADS] = r[i];
    // no block may leave while another still reads its shared memory
    if constexpr (V != WIDE_COL) cluster.sync();
}

template <int V>
int launch_col(const float* x, const float* w, float* st, float* wst, int C,
               int G, cudaStream_t s) {
    switch (C) {
        case 1: col_kernel<V, 1><<<CLUSTER, COL_THREADS, 0, s>>>(x, w, st, wst, G); break;
        case 2: col_kernel<V, 2><<<CLUSTER, COL_THREADS, 0, s>>>(x, w, st, wst, G); break;
        case 4: col_kernel<V, 4><<<CLUSTER, COL_THREADS, 0, s>>>(x, w, st, wst, G); break;
        case 8: col_kernel<V, 8><<<CLUSTER, COL_THREADS, 0, s>>>(x, w, st, wst, G); break;
        case 16: col_kernel<V, 16><<<CLUSTER, COL_THREADS, 0, s>>>(x, w, st, wst, G); break;
        case 32: col_kernel<V, 32><<<CLUSTER, COL_THREADS, 0, s>>>(x, w, st, wst, G); break;
        default: return invalid();
    }
    return static_cast<int>(cudaGetLastError());
}

template <int NPL>
int launch_tr(const float* x, float* st, int C, int G, cudaStream_t s) {
    if (NPL * C > 1024) return invalid();
    tr_kernel<NPL><<<1, NPL * C, NPL * C * sizeof(float), s>>>(x, st, C, G);
    return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_row(const float* x, const float* w, float* st, float* wst, int C,
               int G, cudaStream_t s) {
    row_kernel<V><<<C, ROW_THREADS, 0, s>>>(x, w, st, wst, C, G);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P6.  x, out: the variant's state, C channels (forest_chain.py gives the
// shapes); K dependent pairs per iteration, G steps of 8 iterations.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int forest_chain_launch(const void* x, void* out, int variant,
                                   int C, int K, int G, void* stream) {
    if (variant < 0 || variant >= NCHAIN || C < 1 || K < 0 || G < 0)
        return invalid();
    const ChainVariant v = CHAIN_VARIANTS[variant];
    const ChainLayout l = chain_layout(v, C, K);
    const float* xp = static_cast<const float*>(x);
    float* op = static_cast<float*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_chain(v, [&](auto opc, auto rows) {
        constexpr int OP = decltype(opc)::value, R = decltype(rows)::value;
        chain_kernel<OP, R><<<(C + CHAIN_THREADS - 1) / CHAIN_THREADS,
                              CHAIN_THREADS, 0, s>>>(xp, op, C, G * ITERS, l);
        return static_cast<int>(cudaGetLastError());
    });
}

// P7.  x: (13, C) f32; out: (G, C, 16) f32, zeroed by the caller; st:
// (13, C) f32 and sti: (13, C) i32, the final state planes.  C <= 1024.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int forest_constructs_launch(const void* x, void* out, void* st,
                                        void* sti, int variant, int C, int G,
                                        void* stream) {
    if (variant < 0 || variant >= NCONSTRUCT || C < 1 || C > 1024 || G < 1)
        return invalid();
    const size_t smem = 2 * NP * (size_t)C * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_construct(variant, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        if (smem > DEFAULT_SMEM) {
            const cudaError_t err = cudaFuncSetAttribute(
                constructs_kernel<V>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        constructs_kernel<V><<<1, C, smem, s>>>(
            static_cast<const float*>(x), static_cast<float*>(out),
            static_cast<float*>(st), static_cast<int*>(sti), C, G);
        return static_cast<int>(cudaGetLastError());
    });
}

// P8.  x: (8, C) f32 state; w: (C, 2048) f32 for tr and the row variants,
// (2048, C) for the col variants; st, wst: the final state and plane, of
// the same shapes (tr6 and tr2 leave the plane alone and do not write
// wst).  tr6 takes C <= 170, tr2 C <= 512, the col variants C in {1, 2, 4,
// 8, 16, 32}.  Launches on `stream` and returns cudaGetLastError().
extern "C" int forest_layout_launch(const void* x, const void* w, void* st,
                                    void* wst, int variant, int C, int G,
                                    void* stream) {
    if (variant < 0 || variant >= NLAYOUT || C < 1 || G < 0) return invalid();
    const float* xp = static_cast<const float*>(x);
    const float* wp = static_cast<const float*>(w);
    float* sp = static_cast<float*>(st);
    float* wsp = static_cast<float*>(wst);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (variant) {
        case TR6: return launch_tr<6>(xp, sp, C, G, s);
        case TR2: return launch_tr<2>(xp, sp, C, G, s);
        case WIDE_ROW: return launch_row<WIDE_ROW>(xp, wp, sp, wsp, C, G, s);
        case RED_ROW: return launch_row<RED_ROW>(xp, wp, sp, wsp, C, G, s);
        case ROLL_ROW: return launch_row<ROLL_ROW>(xp, wp, sp, wsp, C, G, s);
        case WIDE_COL: return launch_col<WIDE_COL>(xp, wp, sp, wsp, C, G, s);
        case RED_COL: return launch_col<RED_COL>(xp, wp, sp, wsp, C, G, s);
        default: return launch_col<ROLL_COL>(xp, wp, sp, wsp, C, G, s);
    }
}
