// Per-channel arithmetic of the tracking-scan kernel (track_scan.cu) and
// of the per-epoch E/P/L kernel (epl.cu), which share the correlator
// (halfchip_shift, epl_terms), the reduction of one epoch's six sums
// (warp_sum6, tree_sum) and its thread count (K1_THREADS), so both add an
// epoch's E/P/L in one order.  The probes corr_bank.cu and forest.cu use
// the block reduction block_sum6.  The tracking scan also has its launch
// shape (k1_channels_per_block).
//
// Everything but the warp and block reductions is __host__ __device__:
// nvcc builds it into the Hopper kernels, and g++ builds the same source
// (with -D__host__= -D__device__=) into a host library (kernels_host.cpp)
// that the CPU tests hold against the plain torch versions,
// ops/track_scan.py:track_scan_reference and ops/epl.py:
// epl_correlate_halfchip.
//
// One call of epoch_update is one 1 ms loop closure of one channel: DLL,
// polynomial Costas PLL, FLL, false-lock watchdog with its integer LCG
// kick, SNR window latch, bit sync with majority vote, and the carried
// epoch remainders.  It mirrors the whole loop update of the JAX package's
// Pallas kernel, stm32f4_sdr_gps_tpu/ops/pallas_track_scan.py lines
// 610-836, in each of its modes: the 20 ms coherent PLL (coherent_pll, and
// its K-bit sign-decided accumulator when pll_ext_bits > 1) with the
// watchdog held while synced, the grid-locked coherent bit decision
// (coherent_bit_vote or coherent_pll), and the E/L output slots 11-14
// (emit_correlators).  The mode is a template parameter (Mode), as K1's is
// a trace-time constant: each mode compiles into a kernel of its own, so
// the default loop carries none of the other modes' code (as run-time
// flags they cost the default loop ~7 % per epoch on the H100, PERF.md).
// The Params flags say which instantiation a launch takes
// (dispatch_mode).
//
// The channel state (ChanState) is indexed only by compile-time
// constants, so the tracking scan keeps all of it in registers: the
// watchdog's sign window is two bit masks, not an array indexed by the
// run-time window length.
//
// Floating point: both builds run without fused multiply-add contraction
// (nvcc -fmad=false, g++ -ffp-contract=off), so every float operation is
// one IEEE single-precision rounding in source order on both, apart from
// the two explicit fmaf calls of the NCO updates; the two builds differ
// only in sincospif.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#include <math.h>
// Host stand-in for CUDA's sincospif: sin/cos of pi*x, rounded from double.
static inline void sincospif(float x, float* s, float* c) {
    const double a = 3.14159265358979323846 * (double)x;
    *s = (float)sin(a);
    *c = (float)cos(a);
}
#endif

namespace track {

constexpr int S = 2046;        // samples per 1 ms epoch (2.046 MHz)
constexpr int U2P = 4352;      // doubled upsampled code row width
constexpr int CODE_LENGTH = 1023;
constexpr int NF32 = 16;
constexpr int NI32 = 14;
constexpr int NOUT = 11;       // output slots per epoch and channel
constexpr int NOUT_EL = 15;    // ... with the E/L slots (emit_correlators)
constexpr int MAX_WIN = 32;    // largest watchdog window the kernel takes
constexpr int NFP = 22;        // float parameters (kernel_params order)
constexpr int NIP = 10;        // int parameters

// The tracking scan's launch shape: K1_THREADS threads per channel (each
// takes the staged samples k = tid + j * K1_THREADS, j < SP / K1_THREADS,
// and one warp of them also runs the loop update), G channels per block of
// G * K1_THREADS threads, at most K1_GROUP_MAX.  A compile-time constant,
// so a channel's per-thread samples and summation order never depend on
// the channel count; 128 is the fastest of 64-512 (PERF.md).
constexpr int K1_THREADS = 128;
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr int K1_BLOCK_MAX = 512;
constexpr int K1_GROUP_MAX = K1_BLOCK_MAX / K1_THREADS;
constexpr int SP = 2048;       // the epoch as the tracking scan stages it,
                               // zero-padded to a multiple of K1_THREADS
// whole warps that divide the staged epoch; at least two warps a channel
// (one of them stages epochs while another runs the update), and a named
// barrier for each channel of a block
static_assert(K1_THREADS % 32 == 0 && SP % K1_THREADS == 0 &&
              K1_WARPS >= 2 && K1_GROUP_MAX < 16, "K1_THREADS");

// G for C channels on a card with `sms` SMs: one channel per block while
// the blocks fit on the SMs (the lowest latency per epoch); past that, the
// fewest channels per block that fit, up to K1_GROUP_MAX, so G channels
// share each staged epoch.
__host__ __device__ inline int k1_channels_per_block(int C, int sms) {
    if (C <= sms) return 1;
    const int g = (C + sms - 1) / sms;
    return g < K1_GROUP_MAX ? g : K1_GROUP_MAX;
}

// f32 state rows (ops/track_scan.py _F32_FIELDS)
enum F32Field {
    CP, DOP, PH, DLL_PREV, PLL_PREV, FLL_THETA, FLL_ERR, ACQ_DOP,
    SNR_I, SNR_Q, SNR_LI, SNR_LQ, BIT_IP, BIT_QP, EXT_IP, EXT_QP
};
// i32 state rows (ops/track_scan.py _I32_FIELDS)
enum I32Field {
    FLL_PRIMED, PREV_SIGN, LAST_SWAP, RPC, SYNC, OLD_REM, POS_CNT,
    NEG_CNT, BAD_CNT, MASTER, SNR_CNT, EPOCH, WRAPS, EXT_CNT
};

// Loop constants, all float32 as the torch version rounds them
// (ops/track_scan.py kernel_params builds the two arrays).
struct Params {
    float fs;            // sample rate, Hz
    float cps;           // chips per sample
    float freq_l1;       // L1 carrier, Hz
    float s_over_fs;     // epoch duration, s
    float dll_c1, dll_c2_dt, fine_ratio;
    float pll_wide_c1, pll_wide_c2, pll_narrow_c1, pll_narrow_c2;
    float dt, pll_scale;
    float fll_c1_dt, fll_c2_dt, fll_scale;
    // whole-bit Costas gains: c2 times the bit (cib * dt) or the K-bit
    // span (pll_ext_bits * cib * dt)
    float pll_bit_c1, pll_bit_c2_dt, pll_bit_scale;
    float pll_ext_c1, pll_ext_c2_dt, pll_ext_scale;
    int cib;             // codes in bit
    int win;             // watchdog window (pll_check_window)
    int snr_window;
    int bad_threshold;   // pll_bad_state_threshold
    int sync_up, sync_down;
    int ext_bits;        // pll_ext_bits
};

// The tracking mode, fixed at compile time.  PLL: the Costas loop closes
// every epoch (PLL_EPOCH), once per completed bit (PLL_BIT, coherent_pll)
// or once per ext_bits sign-decided bits (PLL_EXT, coherent_pll with
// pll_ext_bits > 1).  GRID: grid-locked bit sync and the coherent bit
// decision (coherent_bit_vote or coherent_pll).  EMIT: the E/L slots.
enum { PLL_EPOCH = 0, PLL_BIT = 1, PLL_EXT = 2 };

template <int PLL, bool GRID, bool EMIT>
struct Mode {
    static constexpr int pll = PLL;
    static constexpr bool grid_locked = GRID;
    static constexpr bool emit = EMIT;
    static constexpr int nout = EMIT ? NOUT_EL : NOUT;
};

template <bool EMIT, class F>
inline int dispatch_pll(int pll, bool grid, F&& f) {
    if (pll == PLL_EXT) return f(Mode<PLL_EXT, true, EMIT>{});
    if (pll == PLL_BIT) return f(Mode<PLL_BIT, true, EMIT>{});
    if (grid) return f(Mode<PLL_EPOCH, true, EMIT>{});
    return f(Mode<PLL_EPOCH, false, EMIT>{});
}

// Call f(Mode<...>{}) for the mode the int parameter array asks for:
// ip[6] coherent_pll, ip[7] coherent_bit_vote, ip[8] pll_ext_bits, ip[9]
// the output slots (NOUT, or NOUT_EL with the E/L slots).  Host code: the
// launcher and the host build choose the instantiation; the device sees
// the mode only as the template parameter.
template <class F>
inline int dispatch_mode(const int* ip, F&& f) {
    const int pll = !ip[6] ? PLL_EPOCH : (ip[8] > 1 ? PLL_EXT : PLL_BIT);
    const bool grid = ip[6] || ip[7];
    return ip[9] == NOUT_EL ? dispatch_pll<true>(pll, grid, f)
                            : dispatch_pll<false>(pll, grid, f);
}

__host__ __device__ inline Params params_from_arrays(const float* fp,
                                                     const int* ip) {
    Params p;
    p.fs = fp[0];
    p.cps = fp[1];
    p.freq_l1 = fp[2];
    p.s_over_fs = fp[3];
    p.dll_c1 = fp[4];
    p.dll_c2_dt = fp[5];
    p.fine_ratio = fp[6];
    p.pll_wide_c1 = fp[7];
    p.pll_wide_c2 = fp[8];
    p.pll_narrow_c1 = fp[9];
    p.pll_narrow_c2 = fp[10];
    p.dt = fp[11];
    p.pll_scale = fp[12];
    p.fll_c1_dt = fp[13];
    p.fll_c2_dt = fp[14];
    p.fll_scale = fp[15];
    p.pll_bit_c1 = fp[16];
    p.pll_bit_c2_dt = fp[17];
    p.pll_bit_scale = fp[18];
    p.pll_ext_c1 = fp[19];
    p.pll_ext_c2_dt = fp[20];
    p.pll_ext_scale = fp[21];
    p.cib = ip[0];
    p.win = ip[1];
    p.snr_window = ip[2];
    p.bad_threshold = ip[3];
    p.sync_up = ip[4];
    p.sync_down = ip[5];
    p.ext_bits = ip[8];
    return p;
}

// The watchdog's prompt-sign window of p.win entries (-1, +1, or 0 for a
// slot not filled yet, as track/state.py init_state leaves it): bit k of
// wpos / wneg is set where entry k is +1 / -1; bit win-1 is the newest.
struct ChanState {
    float f[NF32];
    int i[NI32];
    uint32_t wpos, wneg;
    int rem;            // (epoch - last_swap) mod cib, carried
    int wcnt;           // epoch mod win, carried
};

__host__ __device__ inline int floor_mod(int a, int b) {
    const int r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Python/torch float remainder: fmod, then shifted into the divisor's sign.
__host__ __device__ inline float float_mod(float a, float b) {
    float r = fmodf(a, b);
    if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
    return r;
}

// float_mod(a, CODE_LENGTH), the code phase's wrap.  For a in [0, 3 *
// 1023) the quotient is 0, 1 or 2 and a - q * 1023 is exact (Sterbenz), so
// the branch gives fmodf's exact result without its loop.
__host__ __device__ inline float code_phase_mod(float a) {
    const float len = (float)CODE_LENGTH;
    if (a >= 0.0f && a < 3.0f * len)
        return a >= 2.0f * len ? a - 2.0f * len : (a >= len ? a - len : a);
    return float_mod(a, len);
}

__host__ __device__ inline float wrap_half(float x) { return x - rintf(x); }

__host__ __device__ inline float sign_f(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Load channel c of the (16, C) / (14, C) / (W, C) state planes; the
// window plane's entries are packed into the two masks.
__host__ __device__ inline void load_state(ChanState& s, const float* f32s,
                                           const int* i32s, const int* wins,
                                           int c, int C, const Params& p) {
#pragma unroll
    for (int k = 0; k < NF32; ++k) s.f[k] = f32s[k * C + c];
#pragma unroll
    for (int k = 0; k < NI32; ++k) s.i[k] = i32s[k * C + c];
    s.wpos = 0u;
    s.wneg = 0u;
    for (int k = 0; k < p.win; ++k) {
        const int v = wins[k * C + c];
        s.wpos |= (v > 0 ? 1u : 0u) << k;
        s.wneg |= (v < 0 ? 1u : 0u) << k;
    }
    s.rem = floor_mod(s.i[EPOCH] - s.i[LAST_SWAP], p.cib);
    s.wcnt = floor_mod(s.i[EPOCH], p.win);
}

__host__ __device__ inline void store_state(const ChanState& s, float* f32s,
                                            int* i32s, int* wins, int c,
                                            int C, const Params& p) {
#pragma unroll
    for (int k = 0; k < NF32; ++k) f32s[k * C + c] = s.f[k];
#pragma unroll
    for (int k = 0; k < NI32; ++k) i32s[k * C + c] = s.i[k];
    for (int k = 0; k < p.win; ++k) {
        const bool pos = (s.wpos >> k) & 1u, neg = (s.wneg >> k) & 1u;
        wins[k * C + c] = pos ? 1 : (neg ? -1 : 0);
    }
}

__host__ __device__ inline int popcount32(uint32_t v) {
#ifdef __CUDA_ARCH__
    return __popc(v);
#else
    return __builtin_popcount(v);
#endif
}

// One epoch of the false-lock watchdog's window (tracking.c:261-327) on
// the masks: returns the sign transitions of the window after sgn (+1 or
// -1) shifts in (sgn against the newest entry, then the pairs (k-1, k) for
// k = 2 .. win-1), and shifts sgn in unless `hold`.  Two entries differ
// where either mask differs, so a 0 (unfilled) entry differs from both
// signs and equals another 0.
__host__ __device__ inline int watchdog_step(uint32_t& wpos, uint32_t& wneg,
                                             int sgn, int win, bool hold) {
    const uint32_t top = 1u << (win - 1);
    const bool newest_same = (sgn > 0 ? wpos : wneg) & top;
    // bit k: entry k differs from entry k + 1
    const uint32_t diff = (wpos ^ (wpos >> 1)) | (wneg ^ (wneg >> 1));
    const uint32_t pairs = (top - 1u) & ~1u;          // bits 1 .. win-2
    const int trans = (newest_same ? 0 : 1) + popcount32(diff & pairs);
    if (!hold) {
        wpos = (wpos >> 1) | (sgn > 0 ? top : 0u);
        wneg = (wneg >> 1) | (sgn > 0 ? 0u : top);
    }
    return trans;
}

// Integer half-chip shift m = floor(2 * code_phase) mod S, 0 folded to S,
// so the early lag reads u2[m - 1 + k] with m - 1 >= 0 and the late lag
// u2[m + 1 + k] <= u2[2S] < u2[U2P] for every k < S.
__host__ __device__ inline int halfchip_shift(float code_phase) {
    int m = floor_mod((int)floorf(2.0f * code_phase), S);
    return m == 0 ? S : m;
}

// One sample's contribution to the six E/P/L sums (ie, qe, ip, qp, il,
// ql), given the replica's early, prompt and late values e, pr, l.  The
// carrier angle is computed exactly per sample in cycles, wrapped to
// [0, 1), and rotated off.
__host__ __device__ inline void epl_terms(float acc[6], float xr, float xi,
                                          int k, float ph, float dopfs,
                                          float e, float pr, float l) {
    float ang = ph + dopfs * (float)k;
    ang = ang - floorf(ang);
    float sn, cs;
    sincospif(2.0f * ang, &sn, &cs);
    const float yr = xr * cs + xi * sn;
    const float yi = xi * cs - xr * sn;
    acc[0] += yr * e;
    acc[1] += yi * e;
    acc[2] += yr * pr;
    acc[3] += yi * pr;
    acc[4] += yr * l;
    acc[5] += yi * l;
}

// epl_terms with the replica read from rep, which points at u2[m - 1] of
// the channel's row.
__host__ __device__ inline void epl_sample(float acc[6], float xr, float xi,
                                           int k, float ph, float dopfs,
                                           const float* rep) {
    epl_terms(acc, xr, xi, k, ph, dopfs, rep[k], rep[k + 1], rep[k + 2]);
}

#ifdef __CUDACC__
// Sum each of the six per-thread partials acc[6] over a block of
// 32 * WARPS threads: the shuffle-down tree within each warp, then the
// warps in order (forest_host.cpp reproduces this order).  The
// totals are left in thread 0's acc only.  The call ends with thread 0
// reading s_part after a block barrier, so the caller must not write the
// same s_part again before every thread has passed one more barrier.
template <int WARPS>
__device__ inline void block_sum6(float acc[6], float (*s_part)[6]) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
    }
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < 6; ++j) s_part[warp][j] = acc[j];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int j = 0; j < 6; ++j) {
            float v = s_part[0][j];
            for (int w = 1; w < WARPS; ++w) v += s_part[w][j];
            acc[j] = v;
        }
    }
}

// The tracking scan's warp step: the six partials summed over the warp
// as a transposed butterfly.  The six, padded with two zeros to eight,
// are halved at each of the levels off = 16, 8, 4: of lanes l and l ^ off
// the one without bit off keeps the lower half of what it carries, the
// other the upper half, and each adds what its partner sends (keep +
// received); two plain butterfly levels (off = 2, 1) follow.  Lane 4j
// (and 4j + 1 .. 4j + 3) ends with the warp's total of sum j: 9 shuffles,
// against 30 for a butterfly over each sum (kernels_host.cpp k1_sums
// reproduces this order).
__device__ inline float warp_sum6(const float acc[6]) {
    const unsigned lane = threadIdx.x & 31u;
    const float v[8] = {acc[0], acc[1], acc[2], acc[3], acc[4], acc[5],
                        0.f, 0.f};
    const bool hi16 = lane & 16u, hi8 = lane & 8u, hi4 = lane & 4u;
    float r4[4], r2[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        r4[i] = (hi16 ? v[4 + i] : v[i]) +
                __shfl_xor_sync(0xffffffffu, hi16 ? v[i] : v[4 + i], 16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
        r2[i] = (hi8 ? r4[2 + i] : r4[i]) +
                __shfl_xor_sync(0xffffffffu, hi8 ? r4[i] : r4[2 + i], 8);
    float r = (hi4 ? r2[1] : r2[0]) +
              __shfl_xor_sync(0xffffffffu, hi4 ? r2[0] : r2[1], 4);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    return r;
}
#endif

// The tracking scan's cross-warp step: the sum of v[0 .. N-1] as a
// pairwise tree, v[w] + v[w + s] for s = 1, 2, 4, ... and w a multiple of
// 2s with w + s < N.
template <int N>
__host__ __device__ inline float tree_sum(float v[N]) {
#pragma unroll
    for (int s = 1; s < N; s *= 2) {
#pragma unroll
        for (int w = 0; w + s < N; w += 2 * s) v[w] = v[w] + v[w + s];
    }
    return v[0];
}

// Costas discriminator atan2(qp*sign(ip), |ip|)/pi in half-cycles, as the
// JAX kernel computes it (pallas_track_scan.py:238-254): octant fold and a
// 9th-order polynomial, ~1e-5 rad from atan2.
__host__ __device__ inline float costas_err(float ip, float qp) {
    const float y = qp * sign_f(ip);
    const float ax = fabsf(ip);
    const float ay = fabsf(y);
    const float mx = ax > ay ? ax : ay;
    const float z = (ax < ay ? ax : ay) / (mx > 1e-30f ? mx : 1e-30f);
    const float z2 = z * z;
    float p = 0.0208351f;
    p = p * z2 - 0.0851330f;
    p = p * z2 + 0.1801410f;
    p = p * z2 - 0.3302995f;
    p = p * z2 + 0.9998660f;
    float a = z * p;
    if (ay > ax) a = 1.57079632679489661923f - a;
    return sign_f(y) * a / 3.14159265358979323846f;
}

// Deterministic uniform in [0, 1) from the kick seed epoch*37 + channel
// (track/scan.py _lcg_uniform): uint32 wrap arithmetic.
__host__ __device__ inline float lcg_uniform(int seed) {
    uint32_t s = (uint32_t)seed * 1664525u + 1013904223u;
    s = s ^ (s >> 16);
    s = s * 2246822519u;
    return (float)(s >> 8) * (1.0f / 16777216.0f);
}

// One epoch of one channel in mode M.  sums = (ie, qe, ip, qp, il, ql)
// with the carrier already rotated off; writes the M::nout output slots of
// the epoch.
template <class M>
__host__ __device__ inline void epoch_update(ChanState& s, const float sums[6],
                                             const Params& p, int chan,
                                             float out[M::nout]) {
    const float ie = sums[0], qe = sums[1], ip = sums[2], qp = sums[3];
    const float il = sums[4], ql = sums[5];
    float* f = s.f;
    int* i = s.i;
    const float cp = f[CP], dop = f[DOP], ph = f[PH];
    const float dll_prev = f[DLL_PREV], pll_prev = f[PLL_PREV];
    const int epoch = i[EPOCH];
    const int rem = s.rem, wcnt = s.wcnt;
    const bool in_sync = i[SYNC] == 1;

    // nav-bit edge-zone freeze
    const bool edge = in_sync && (rem == 0 || rem == p.cib - 1);

    // DLL (tracking.c:333-393)
    const float e2 = ie * ie + qe * qe;
    const float l2 = il * il + ql * ql;
    const float el = e2 + l2;
    const float cerr_raw = -(e2 - l2) / (el > 1e-12f ? el : 1e-12f);
    const float cerr = edge ? dll_prev : cerr_raw;
    const float dd = edge ? 0.0f
                          : p.dll_c1 * (cerr - dll_prev) + p.dll_c2_dt * cerr;
    const float ddelta = dd / p.fine_ratio;
    const float code_freq = p.cps * (1.0f + dop / p.freq_l1);
    // the NCO accumulators advance by one fused multiply-add each (fmaf),
    // as the JAX reference's XLA lowering computes them
    const float unwrapped = fmaf(code_freq, (float)S, cp) + ddelta;
    const float new_cp = code_phase_mod(unwrapped);
    const float nominal = cp + p.cps * (float)S;
    const bool wrapped = fabsf(unwrapped - nominal) > 0.5f * CODE_LENGTH;

    // Costas PLL (tracking.c:175-209)
    const float perr = costas_err(ip, qp);
    const float c1 = in_sync ? p.pll_narrow_c1 : p.pll_wide_c1;
    const float c2 = in_sync ? p.pll_narrow_c2 : p.pll_wide_c2;
    float pll_delta =
        (c1 * wrap_half(perr - pll_prev) + c2 * p.dt * perr) * p.pll_scale;

    // FLL (tracking.c:214-256)
    const float fdiff = wrap_half(perr - f[FLL_THETA]);
    const float odiff = wrap_half(fdiff - f[FLL_ERR]);
    float fll_delta =
        (i[FLL_PRIMED] == 1 && !edge)
            ? (p.fll_c1_dt * odiff + p.fll_c2_dt * fdiff) * p.fll_scale
            : 0.0f;

    // 20 ms coherent PLL: once synced, the Costas loop closes only at each
    // completed bit, on the bit's coherent prompt sums (or, with
    // ext_bits > 1, on the sum of ext_bits sign-decided bit vectors), and
    // the per-epoch PLL and FLL stand still.  The K-bit accumulator planes
    // are read and written only in the PLL_EXT mode; the other modes leave
    // them as they are.
    float phase_err_store = perr;
    if constexpr (M::pll != PLL_EPOCH) {
        const float bip = f[BIT_IP], bqp = f[BIT_QP];
        const bool bit_done = in_sync && rem < i[OLD_REM];
        if constexpr (M::pll == PLL_EXT) {
            const float d = bip >= 0.0f ? 1.0f : -1.0f;
            float ext_ip2 = f[EXT_IP] + (bit_done ? d * bip : 0.0f);
            float ext_qp2 = f[EXT_QP] + (bit_done ? d * bqp : 0.0f);
            int ext_cnt2 = i[EXT_CNT] + (bit_done ? 1 : 0);
            const bool ext_done = bit_done && ext_cnt2 >= p.ext_bits;
            const float perr_ext = costas_err(ext_ip2, ext_qp2);
            const float delta_ext =
                (p.pll_ext_c1 * wrap_half(perr_ext - pll_prev) +
                 p.pll_ext_c2_dt * perr_ext) * p.pll_ext_scale;
            if (in_sync) {
                pll_delta = ext_done ? delta_ext : 0.0f;
                phase_err_store = ext_done ? perr_ext : pll_prev;
            }
            if (ext_done || !in_sync) {
                ext_ip2 = 0.0f;
                ext_qp2 = 0.0f;
                ext_cnt2 = 0;
            }
            f[EXT_IP] = ext_ip2;
            f[EXT_QP] = ext_qp2;
            i[EXT_CNT] = ext_cnt2;
        } else {
            const float perr_bit = costas_err(bip, bqp);
            const float delta_bit =
                (p.pll_bit_c1 * wrap_half(perr_bit - pll_prev) +
                 p.pll_bit_c2_dt * perr_bit) * p.pll_bit_scale;
            if (in_sync) {
                pll_delta = bit_done ? delta_bit : 0.0f;
                phase_err_store = bit_done ? perr_bit : pll_prev;
            }
        }
        if (in_sync) fll_delta = 0.0f;
    }
    float new_dop = dop + pll_delta + fll_delta;
    float new_ph = fmaf(dop, p.s_over_fs, ph);
    new_ph = new_ph - floorf(new_ph);

    // false-lock watchdog (tracking.c:261-327): sign transitions of the
    // window after this epoch's sign shifts in; under coherent_pll the
    // window and its counters stand still while synced
    const int sgn = ip > 0.0f ? 1 : -1;
    const bool hold = M::pll != PLL_EPOCH && in_sync;
    const int trans = watchdog_step(s.wpos, s.wneg, sgn, p.win, hold);
    const bool wend = wcnt == p.win - 1;
    int bad2 = i[BAD_CNT];
    if (wend) bad2 = trans > 1 ? (bad2 + 1 < 10 ? bad2 + 1 : 10)
                               : (bad2 - 1 > 0 ? bad2 - 1 : 0);
    int master2 = i[MASTER];
    if (wend && bad2 > 9) master2 = master2 + 1;
    else if (wend && bad2 == 0) master2 = 0;
    if (hold) {
        bad2 = i[BAD_CNT];
        master2 = i[MASTER];
    }
    if (master2 > p.bad_threshold) {
        const float u = lcg_uniform(epoch * 37 + chan);
        new_dop = f[ACQ_DOP] + (u - 0.5f) * 500.0f;
        bad2 = 0;
        master2 = 0;
    }

    // SNR window (tracking.c:147-169): latch the completed |I|, |Q| sums
    float snr_i2 = f[SNR_I] + fabsf(ip);
    float snr_q2 = f[SNR_Q] + fabsf(qp);
    int cnt2 = i[SNR_CNT] + 1;
    float li2 = f[SNR_LI], lq2 = f[SNR_LQ];
    if (cnt2 >= p.snr_window) {
        li2 = snr_i2;
        lq2 = snr_q2;
        snr_i2 = 0.0f;
        snr_q2 = 0.0f;
        cnt2 = 0;
    }

    // bit sync (nav_data.c:46-138); grid-locked under coherent_bit_vote and
    // coherent_pll: once synced, flips neither rebase the bit boundary nor
    // feed the sync counters, and the bit is the sign of its prompt-I sum
    const bool flip = sgn != i[PREV_SIGN] && !(M::grid_locked && in_sync);
    const bool on_grid = rem <= 1 || rem == p.cib - 1;
    int rpc2 = i[RPC];
    if (flip) rpc2 = on_grid ? (rpc2 + 1 < 10 ? rpc2 + 1 : 10)
                             : (rpc2 - 1 > 0 ? rpc2 - 1 : 0);
    int sync2 = i[SYNC];
    if (flip) sync2 = rpc2 > p.sync_up ? 1 : (rpc2 < p.sync_down ? 0 : sync2);
    const int ls2 = flip ? epoch : i[LAST_SWAP];
    const int rem2 = flip ? 0 : rem;
    const bool boundary = sync2 == 1 && rem2 < i[OLD_REM];
    const int pos = i[POS_CNT], neg = i[NEG_CNT];
    const int votes = pos + neg;
    const int bit_val =
        M::grid_locked ? (f[BIT_IP] > 0.0f ? 1 : 0) : (pos > neg ? 1 : 0);
    const bool bit_ready = boundary && votes > 0;
    const int bit_epoch = epoch - votes;
    int p2 = boundary ? 0 : pos;
    int n2 = boundary ? 0 : neg;
    if (sync2 == 1 && ip > 0.0f) p2 += 1;
    if (sync2 == 1 && ip <= 0.0f) n2 += 1;
    float ip_sum2 = boundary ? 0.0f : f[BIT_IP];
    if (sync2 == 1) ip_sum2 = ip_sum2 + ip;
    float qp_sum2 = boundary ? 0.0f : f[BIT_QP];
    if (sync2 == 1) qp_sum2 = qp_sum2 + qp;

    // carried remainders
    s.rem = rem2 + 1 == p.cib ? 0 : rem2 + 1;
    s.wcnt = wcnt + 1 == p.win ? 0 : wcnt + 1;

    f[CP] = new_cp;
    f[DOP] = new_dop;
    f[PH] = new_ph;
    f[DLL_PREV] = cerr;
    f[PLL_PREV] = phase_err_store;
    f[FLL_THETA] = perr;
    f[FLL_ERR] = fdiff;
    f[SNR_I] = snr_i2;
    f[SNR_Q] = snr_q2;
    f[SNR_LI] = li2;
    f[SNR_LQ] = lq2;
    f[BIT_IP] = ip_sum2;
    f[BIT_QP] = qp_sum2;
    i[FLL_PRIMED] = 1;
    i[PREV_SIGN] = sgn;
    i[LAST_SWAP] = ls2;
    i[RPC] = rpc2;
    i[SYNC] = sync2;
    i[OLD_REM] = rem2;
    i[POS_CNT] = p2;
    i[NEG_CNT] = n2;
    i[BAD_CNT] = bad2;
    i[MASTER] = master2;
    i[SNR_CNT] = cnt2;
    i[EPOCH] = epoch + 1;
    i[WRAPS] = i[WRAPS] + (wrapped ? 1 : 0);

    out[0] = ip;
    out[1] = qp;
    out[2] = cp;
    out[3] = new_dop;
    out[4] = bit_ready ? 1.0f : 0.0f;
    out[5] = (float)bit_val;
    out[6] = (float)bit_epoch;
    out[7] = (float)sync2;
    out[8] = li2;
    out[9] = wrapped ? 1.0f : 0.0f;
    out[10] = lq2;
    if constexpr (M::emit) {
        out[11] = ie;
        out[12] = qe;
        out[13] = il;
        out[14] = ql;
    }
}

}  // namespace track
