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
// block (C <= 1024).  Bound: the latency of the one serial chain per
// thread, four dependent FFMAs an iteration (~11 ns at P6's dependent
// pair), plus whatever the construct adds; this is the per-epoch serial
// work of the update warp in track_scan.cu.  So the state takes the form
// the tracking kernel gives its ChanState (track_epoch.cuh): the 13 + 13
// planes live in registers, indexed only by compile-time constants,
// loaded once and written to st / sti once.  An empty asm (opaque) hands
// each iteration's a, b, ia, ib to the body as values nvcc cannot see
// through, and takes each dead result (when_any's store, stack13's
// planes) from it, so nvcc neither hoists a construct of an unchanged
// value (lcg of ia) out of the loop nor sinks a plane that the body
// overwrites: every iteration does the probe's work, as the TPU's VMEM
// stores forced it to.  when_any / when_any4 are a warp vote (__any_sync
// over the block's lanes) when the block is one warp (C <= 32), the vote
// a one-warp update uses, and __syncthreads_or, a block barrier, past
// it; concat16 and dynstore are 64-byte global stores per channel per
// iteration (__stcg, which nvcc does not drop).  sincos takes sin and cos
// from trig_f (forest_ops.cuh, within 2 ulp, registers only: CUDA's sinf
// and cosf keep the 2/pi words of their Payne-Hanek path in a local
// array, a 32-byte stack frame).  The IEEE divide and sin / cos are
// value-dependent (slow paths for inf, NaN and arguments past 105615), so
// probes/forest_constructs.py also times P7 on finite values.
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
//   sample-major with lane = channel (C divides 32).  A grid of clusters
//   of COL_RANKS = 8 blocks: cluster g takes the CG = min(C, 8) channels
//   [g CG, g CG + CG), rank r of it their samples [256 r, 256 r + 256),
//   staged into its shared memory by coalesced loads (element e = tid +
//   256 i of the (256, CG) slab is sample e / CG, channel tid % CG).  CG =
//   8 gives a channel 256 threads, as row_kernel does, and C = 32 32
//   blocks, each on an SM of its own (launch_col), as row_kernel's.
//   - wide_col: the 14 passes in registers, no exchange.
//   - red_col: each rank sums its slab per thread, then over the lanes of
//     one channel (lane ^ 16, ^ 8, ..., ^ CG) and its warps in order.
//     Ranks 1-7 push their 6 x CG sums into rank 0's slot for the
//     iteration's parity with st.async.shared::cluster.mbarrier::
//     complete_tx::bytes, which completes on rank 0's mbarrier for that
//     slot; rank 0 arms it with mbarrier.arrive.expect_tx, waits with
//     mbarrier.try_wait.parity, adds the ranks in rank order, and lane b
//     of its first warp frees the slot with a remote
//     mbarrier.arrive.shared::cluster (address by mapa) on rank b's own
//     barrier, which rank b waits on before it writes that slot again,
//     two iterations later.
//   - roll_col: the four stages shift by HALO = 1 + 2 + 4 + 8 = 15 samples
//     in all, so rank r needs only the first 15 rows of rank r + 1's slab
//     (cyclically).  At the end of each iteration rank r pushes its new
//     first 15 rows into rank r - 1's halo slot by the same scheme (parity
//     double buffer; the receiver frees a slot after its first stage has
//     read it), and the stages run locally on slab + halo with a
//     shrinking ghost zone (270, 268, 264, 256 valid rows), each with
//     roll_row's two block barriers.  Every stage computes where(m,
//     roll(w), w) on every element, reading the element the mask selects,
//     as roll_row does.
//   The only cluster barriers are one after the mbarrier init and one
//   before exit (no block may leave while another may still write its
//   shared memory); chip_smoke.py counts them in the SASS.
// Bound: barrier and exchange latency per iteration for red and roll
// (their bytes and operations take ns), the 14 fma passes' issue rate for
// wide.  A block barrier costs ~40 ns.  A cluster barrier (cluster.sync)
// compiles to MEMBAR.ALL.GPU, the cluster arrive / wait and an L1
// invalidate (CCTL.IVALL): with one in every reduction and two in every
// barrel stage, red_col and roll_col took 3.9 and 7.8 us an iteration at
// C = 32 on the H100 80GB HBM3 at 700 W, against red_row's 0.45 and
// roll_row's 0.29.  The point-to-point stores above complete on the
// receiver's mbarrier, with no fence and no cache invalidate: on the same
// card red_col and roll_col take 0.74 and 0.54 us an iteration at C = 32
// (0.69 and 0.39 at C = 4), a halo hop ~0.15 us (probes/col_parts.py
// times them without the exchange).  red_*
// reduce an unchanged plane every iteration: they read it from shared
// memory behind a barrier each time, so nvcc cannot hoist the reduction
// out of the loop (the time per iteration is the same at G = 64 and 128).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (ops/kernel_lib.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace forest;

constexpr int CHAIN_THREADS = 32;
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int ROW_PER = SP / ROW_THREADS;      // samples per thread

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

// v passes through an empty asm: nvcc must have it in a register here and
// cannot see its value on the other side.
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }

// WARP: the block is one warp (C <= 32), and when_any votes over it.
template <int V, bool WARP>
__global__ void __launch_bounds__(1024)
constructs_kernel(const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ st_out, int* __restrict__ sti_out,
                  int C, int G) {
    const int c = threadIdx.x;
    float s[NP];
    int si[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        s[p] = x[p * C + c];
        si[p] = (int)s[p];
    }
    const unsigned lanes = C >= 32 ? 0xffffffffu : (1u << C) - 1u;
    for (int g = 0; g < G; ++g) {
        for (int e = 0; e < ITERS; ++e) {
            float a = s[0], b = s[1];
            int ia = si[0], ib = si[1];
            opaque(a);
            opaque(b);
            opaque(ia);
            opaque(ib);
            epoch_pairs(a, b);
            if constexpr (V == WHEN_ANY || V == WHEN_ANY4) {
#pragma unroll
                for (int j = 0; j < (V == WHEN_ANY ? 1 : 4); ++j) {
                    const bool guard = any_guard(a, b, j);
                    bool any;
                    if constexpr (WARP) any = __any_sync(lanes, guard);
                    else any = __syncthreads_or(guard);
                    if (any) s[0] = a + 1.0f;
                    opaque(s[0]);
                }
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
                for (int p = 0; p < NP; ++p) {
                    s[p] = a * stack_scale(p);
                    opaque(s[p]);
                }
            } else {
                own_construct<V>(a, b, ia, ib);
            }
            s[0] = a;
            s[1] = b;
            if constexpr (V == IMOD4) si[0] = ia;
        }
    }
    // after the last step, row 0 of the output is st[0] (forest_probe2.py:
    // 144-146)
    float4* o = reinterpret_cast<float4*>(out + (size_t)c * NOUT);
#pragma unroll
    for (int q = 0; q < NOUT / 4; ++q) o[q] = make_float4(s[0], s[0], s[0], s[0]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        st_out[p * C + c] = s[p];
        sti_out[p * C + c] = si[p];
    }
}

template <int V, bool WARP>
int launch_constructs(const void* x, void* out, void* st, void* sti, int C,
                      int G, cudaStream_t s) {
    constructs_kernel<V, WARP><<<1, C, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<float*>(st), static_cast<int*>(sti), C, G);
    return static_cast<int>(cudaGetLastError());
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

// The exchange between the blocks of a cluster: mbarriers in shared
// memory, stores into another block's shared memory that complete on its
// mbarrier, and arrivals on another block's mbarrier.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `p` (this block's shared memory) in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t remote_addr(const void* p, int rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
    return r;
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(bar)) : "memory");
}

// this phase's arrival, and the bytes that must land before it completes
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    return done;
}

// Wait until the phase of the given parity has completed.  A wait past
// ~2^33 cycles (seconds; a launch takes ms) means a lost arrival: trap,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    if (bar_try(bar, parity)) return;
    const long long t0 = clock64();
    while (!bar_try(bar, parity))
        if (clock64() - t0 > (1ll << 33)) __trap();
}

// arrive on the mbarrier at shared::cluster address `bar` (another block's)
__device__ __forceinline__ void bar_arrive_remote(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// store into another block's shared memory; the bytes count towards the
// current phase of its mbarrier `bar` (both shared::cluster addresses)
__device__ __forceinline__ void push1(uint32_t dst, float v, uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
        "[%0], %1, [%2];"
        :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void push4(uint32_t dst, float a, float b,
                                      float c, float d, uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];"
        :: "r"(dst), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
           "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void push2(uint32_t dst, float a, float b,
                                      uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
        "[%0], {%1, %2}, [%3];"
        :: "r"(dst), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
           "r"(bar)
        : "memory");
}

// roll_col's elements a thread: every stage computes the first
// ghost_ni() * 256 elements of the ghost zone, >= col_extent(0) * CG, with
// no guard; a row past a stage's extent is never read into a row within
// the next stage's
template <int CG>
__host__ __device__ constexpr int ghost_ni() {
    return (col_extent(0) * CG + COL_THREADS - 1) / COL_THREADS;
}

// shared floats of roll_col's ghost zone: every row a stage may read
template <int CG>
__host__ __device__ constexpr int ghost_floats() {
    return ghost_ni<CG>() * COL_THREADS + (1 << (BARREL_STAGES - 1)) * CG;
}

// the col kernels' mbarriers: FULL[p] completes when slot p has landed,
// FREE[p] when its reader has released it (p: the iteration's parity)
constexpr int FULL = 0, FREE = 2;

// roll_col: rows 0..14 of the slab, elements tid < HALO * CG, go to rank
// `left`'s halo slot for iteration j (parity j & 1), once that rank has
// read the slot's previous use (at once for j = 0, 1)
template <int CG>
__device__ __forceinline__ void push_halo(uint64_t* bars,
                                          float (*halo)[HALO * CG],
                                          int left, int j, float val) {
    const int p = j & 1;
    bar_wait(&bars[FREE + p], ((uint32_t)(j >> 1) & 1u) ^ 1u);
    push1(remote_addr(&halo[p][threadIdx.x], left), val,
          remote_addr(&bars[FULL + p], left));
}

// roll_col's barrel stage S on the ghost zone s_w: element e becomes
// where(m, e + 2^S rows, e), read from the element the mask selects, as
// roll_row does; stage 0 takes rows 256..270 from the halo slot `halo`.
// Two block barriers, as roll_row.  The thread's elements e = tid + 256 i
// end in t (the last stage's first CG are the slab's).
template <int S, int CG>
__device__ __forceinline__ void roll_stage(float* s_w, const float* halo,
                                           bool m, float (&t)[ghost_ni<CG>()]) {
    constexpr int N = ghost_ni<CG>();
    constexpr int SH = (1 << S) * CG;
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int e = tid + i * COL_THREADS;
        const int k = m ? e + SH : e;
        if constexpr (S == 0) {
            const bool in_halo = k >= COL_SAMPLES * CG && k < GHOST * CG;
            t[i] = (in_halo ? halo - COL_SAMPLES * CG : s_w)[k];
        } else {
            t[i] = s_w[k];
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) s_w[tid + i * COL_THREADS] = t[i];
    __syncthreads();
}

// CG channels a cluster (see the note at the top).  Shared slots and
// mbarriers: red_col's (2 parities) x (8 ranks) x (CG channels) x 8 floats
// (6 sums, 32-byte rows for the v4 store) at rank 0, FULL[p] there and
// FREE[p] at ranks 1-7; roll_col's (2 parities) x (HALO x CG) halo and its
// FULL[p] / FREE[p] at every rank.
template <int V, int CG>
__global__ void __cluster_dims__(COL_RANKS, 1, 1) __launch_bounds__(COL_THREADS)
col_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ st, float* __restrict__ wst, int C, int G) {
    constexpr int WF = V == WIDE_COL ? 1
                       : V == RED_COL ? COL_SAMPLES * CG : ghost_floats<CG>();
    __shared__ __align__(16) float s_w[WF];
    __shared__ float s_part[V == RED_COL ? 2 : 1][COL_WARPS][6][CG];
    __shared__ __align__(16) float
        s_slot[V == RED_COL ? 2 : 1][COL_RANKS][CG][8];
    __shared__ float s_halo[V == ROLL_COL ? 2 : 1][HALO * CG];
    __shared__ __align__(8) uint64_t s_bar[4];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int ch0 = blockIdx.x / COL_RANKS * CG;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int c = tid % CG;
    const int iters = G * ITERS;
    const bool owner = rank == 0 && tid < CG;        // st[:, ch0 + tid]
    float v[NST] = {};       // defined in every thread: no undef to spill
    if (owner) {
#pragma unroll
        for (int p = 0; p < NST; ++p) v[p] = x[p * C + ch0 + tid];
    }
    const bool m = roll_mask(x[ch0 + c]);
    // element e = tid + 256 i of the slab: sample e / CG, channel c
    const size_t base = (size_t)rank * COL_SAMPLES * C + ch0 + c;
    float r[CG];
#pragma unroll
    for (int i = 0; i < CG; ++i) {
        r[i] = w[base + (size_t)((tid + i * COL_THREADS) / CG) * C];
        if constexpr (V != WIDE_COL) s_w[tid + i * COL_THREADS] = r[i];
    }
    if constexpr (V != WIDE_COL) {
        if (tid == 0) {
#pragma unroll
            for (int b = 0; b < 4; ++b) bar_init(&s_bar[b]);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        cluster.sync();                      // every rank's mbarriers ready
    }
    if constexpr (V == WIDE_COL) {
        for (int it = 0; it < iters; ++it) {
#pragma unroll
            for (int i = 0; i < CG; ++i) r[i] = wide_passes(r[i]);
            if (owner) v[7] = st7_step(v[7]);
        }
    } else if constexpr (V == RED_COL) {
        constexpr uint32_t BYTES = (COL_RANKS - 1) * CG * 6 * sizeof(float);
        for (int it = 0; it < iters; ++it) {
            const int par = it & 1;
            const uint32_t use = (uint32_t)(it >> 1) & 1u;  // slot use parity
            float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < CG; ++i) {
                const float wv = s_w[tid + i * COL_THREADS];
#pragma unroll
                for (int j = 0; j < 6; ++j) acc[j] += red_term(wv, j);
            }
            // the lanes of one channel are lane ^ 16, ^ 8, ..., ^ CG
#pragma unroll
            for (int off = 16; off >= CG; off >>= 1) {
#pragma unroll
                for (int j = 0; j < 6; ++j)
                    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
            }
            if (lane < CG) {
#pragma unroll
                for (int j = 0; j < 6; ++j) s_part[par][warp][j][lane] = acc[j];
            }
            __syncthreads();
            if (tid < CG) {
                float blk[6];
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    blk[j] = s_part[par][0][j][tid];
#pragma unroll
                    for (int q = 1; q < COL_WARPS; ++q)
                        blk[j] += s_part[par][q][j][tid];
                }
                if (rank != 0) {
                    // the slot is free once rank 0 has read it two
                    // iterations ago (at once for the first two)
                    bar_wait(&s_bar[FREE + par], use ^ 1u);
                    const uint32_t dst = remote_addr(&s_slot[par][rank][tid][0], 0);
                    const uint32_t bar = remote_addr(&s_bar[FULL + par], 0);
                    push4(dst, blk[0], blk[1], blk[2], blk[3], bar);
                    push2(dst + 16, blk[4], blk[5], bar);
                } else {
                    if (tid == 0) bar_expect(&s_bar[FULL + par], BYTES);
                    bar_wait(&s_bar[FULL + par], use);
                    float tot = 0.0f;
#pragma unroll
                    for (int j = 0; j < 6; ++j) {
                        float tj = blk[j];
#pragma unroll
                        for (int b = 1; b < COL_RANKS; ++b)
                            tj += s_slot[par][b][tid][j];
                        tot = j == 0 ? tj : tot + tj;
                    }
                    v[0] = tot;
                }
            }
            // rank 0 has read the slots: lane b of its warp 0 frees rank
            // b's, all seven at once
            if (rank == 0 && warp == 0) {
                __syncwarp();
                if (lane >= 1 && lane < COL_RANKS && it + 2 < iters)
                    bar_arrive_remote(remote_addr(&s_bar[FREE + par], lane));
            }
            if (owner) v[7] = st7_step(v[7]);
        }
    } else {
        constexpr uint32_t BYTES = HALO * CG * sizeof(float);
        const int left = (rank + COL_RANKS - 1) % COL_RANKS;
        const int right = (rank + 1) % COL_RANKS;
        float t[ghost_ni<CG>()];
        if (iters > 0 && tid < HALO * CG)
            push_halo<CG>(s_bar, s_halo, left, 0, r[0]);
        for (int it = 0; it < iters; ++it) {
            const int p = it & 1;
            if (tid == 0) bar_expect(&s_bar[FULL + p], BYTES);
            bar_wait(&s_bar[FULL + p], (uint32_t)(it >> 1) & 1u);
            roll_stage<0, CG>(s_w, s_halo[p], m, t);
            // stage 0 has read the halo slot: the right rank may refill it
            if (tid == 0 && it + 2 < iters)
                bar_arrive_remote(remote_addr(&s_bar[FREE + p], right));
            roll_stage<1, CG>(s_w, s_halo[p], m, t);
            roll_stage<2, CG>(s_w, s_halo[p], m, t);
            roll_stage<3, CG>(s_w, s_halo[p], m, t);
#pragma unroll
            for (int i = 0; i < CG; ++i) r[i] = t[i];
            if (it + 1 < iters && tid < HALO * CG)
                push_halo<CG>(s_bar, s_halo, left, it + 1, r[0]);
            if (owner) v[7] = st7_step(v[7]);
        }
    }
    if (owner) {
#pragma unroll
        for (int p = 0; p < NST; ++p) st[p * C + ch0 + tid] = v[p];
    }
#pragma unroll
    for (int i = 0; i < CG; ++i)
        wst[base + (size_t)((tid + i * COL_THREADS) / CG) * C] = r[i];
    // no block may leave while another may still write its shared memory
    if constexpr (V != WIDE_COL) cluster.sync();
}

// Each block also reserves COL_RESERVE bytes of dynamic shared memory
// that it does not use: two cannot share an SM (228 KB), so the grid's
// blocks take C / CG * 8 SMs, as row_kernel's C blocks take C.
constexpr int COL_RESERVE = 116 << 10;

template <int V, int CG>
int launch_col(const float* x, const float* w, float* st, float* wst, int C,
               int G, cudaStream_t s) {
    const cudaError_t err = cudaFuncSetAttribute(
        col_kernel<V, CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        COL_RESERVE);
    if (err != cudaSuccess) return static_cast<int>(err);
    col_kernel<V, CG><<<C / CG * COL_RANKS, COL_THREADS, COL_RESERVE, s>>>(
        x, w, st, wst, C, G);
    return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_col(const float* x, const float* w, float* st, float* wst, int C,
               int G, cudaStream_t s) {
    switch (col_group(C)) {
        case 1: return launch_col<V, 1>(x, w, st, wst, C, G, s);
        case 2: return launch_col<V, 2>(x, w, st, wst, C, G, s);
        case 4: return launch_col<V, 4>(x, w, st, wst, C, G, s);
        default: return launch_col<V, 8>(x, w, st, wst, C, G, s);
    }
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
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_construct(variant, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        if constexpr (V == WHEN_ANY || V == WHEN_ANY4) {
            if (C <= 32) return launch_constructs<V, true>(x, out, st, sti, C, G, s);
        }
        return launch_constructs<V, false>(x, out, st, sti, C, G, s);
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
    const bool col = variant == WIDE_COL || variant == RED_COL ||
                     variant == ROLL_COL;
    if (col && (C > 32 || 32 % C != 0)) return invalid();
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
