// Per-channel arithmetic of the tracking-scan kernel (track_scan.cu) and
// of the per-epoch E/P/L kernel (epl.cu), which share the correlator
// (halfchip_shift, epl_sample) and the block reduction (block_sum6).
//
// Everything but block_sum6 is __host__ __device__: nvcc builds it into
// the Hopper kernels, and g++ builds the same source (with -D__host__=
// -D__device__=) into a host library (kernels_host.cpp) that the CPU tests
// hold against the plain torch versions, ops/track_scan.py:
// track_scan_reference and ops/epl.py:epl_correlate_halfchip.
//
// One call of epoch_update is one 1 ms loop closure of one channel: DLL,
// polynomial Costas PLL, FLL, false-lock watchdog with its integer LCG
// kick, SNR window latch, bit sync with majority vote, and the carried
// epoch remainders.  It mirrors the default (non-coherent) path of the JAX
// package's Pallas kernel, stm32f4_sdr_gps_tpu/ops/pallas_track_scan.py
// lines 624-821.
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
constexpr int NOUT = 11;
constexpr int MAX_WIN = 32;    // largest watchdog window the kernel takes
constexpr int NFP = 16;        // float parameters (kernel_params order)
constexpr int NIP = 6;         // int parameters

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
    int cib;             // codes in bit
    int win;             // watchdog window (pll_check_window)
    int snr_window;
    int bad_threshold;   // pll_bad_state_threshold
    int sync_up, sync_down;
};

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
    p.cib = ip[0];
    p.win = ip[1];
    p.snr_window = ip[2];
    p.bad_threshold = ip[3];
    p.sync_up = ip[4];
    p.sync_down = ip[5];
    return p;
}

struct ChanState {
    float f[NF32];
    int i[NI32];
    int win[MAX_WIN];   // watchdog prompt-sign window, [win-1] newest
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

__host__ __device__ inline float wrap_half(float x) { return x - rintf(x); }

__host__ __device__ inline float sign_f(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Load channel c of the (16, C) / (14, C) / (W, C) state planes.
__host__ __device__ inline void load_state(ChanState& s, const float* f32s,
                                           const int* i32s, const int* wins,
                                           int c, int C, const Params& p) {
    for (int k = 0; k < NF32; ++k) s.f[k] = f32s[k * C + c];
    for (int k = 0; k < NI32; ++k) s.i[k] = i32s[k * C + c];
    for (int k = 0; k < p.win; ++k) s.win[k] = wins[k * C + c];
    s.rem = floor_mod(s.i[EPOCH] - s.i[LAST_SWAP], p.cib);
    s.wcnt = floor_mod(s.i[EPOCH], p.win);
}

__host__ __device__ inline void store_state(const ChanState& s, float* f32s,
                                            int* i32s, int* wins, int c,
                                            int C, const Params& p) {
    for (int k = 0; k < NF32; ++k) f32s[k * C + c] = s.f[k];
    for (int k = 0; k < NI32; ++k) i32s[k * C + c] = s.i[k];
    for (int k = 0; k < p.win; ++k) wins[k * C + c] = s.win[k];
}

// Integer half-chip shift m = floor(2 * code_phase) mod S, 0 folded to S,
// so the early lag reads u2[m - 1 + k] with m - 1 >= 0 and the late lag
// u2[m + 1 + k] <= u2[2S] < u2[U2P] for every k < S.
__host__ __device__ inline int halfchip_shift(float code_phase) {
    int m = floor_mod((int)floorf(2.0f * code_phase), S);
    return m == 0 ? S : m;
}

// One sample's contribution to the six E/P/L sums (ie, qe, ip, qp, il,
// ql).  The carrier angle is computed exactly per sample in cycles,
// wrapped to [0, 1), and rotated off; rep points at u2[m - 1] of the row.
__host__ __device__ inline void epl_sample(float acc[6], float xr, float xi,
                                           int k, float ph, float dopfs,
                                           const float* rep) {
    float ang = ph + dopfs * (float)k;
    ang = ang - floorf(ang);
    float sn, cs;
    sincospif(2.0f * ang, &sn, &cs);
    const float yr = xr * cs + xi * sn;
    const float yi = xi * cs - xr * sn;
    const float e = rep[k], pr = rep[k + 1], l = rep[k + 2];
    acc[0] += yr * e;
    acc[1] += yi * e;
    acc[2] += yr * pr;
    acc[3] += yi * pr;
    acc[4] += yr * l;
    acc[5] += yi * l;
}

#ifdef __CUDACC__
// Sum each of the six per-thread partials acc[6] over a block of
// 32 * WARPS threads: the shuffle-down tree within each warp, then the
// warps in order (kernels_host.cpp block_sums reproduces this order).  The
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
#endif

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

// One epoch of one channel.  sums = (ie, qe, ip, qp, il, ql) with the
// carrier already rotated off; writes the 11 output slots of the epoch.
__host__ __device__ inline void epoch_update(ChanState& s, const float sums[6],
                                             const Params& p, int chan,
                                             float out[NOUT]) {
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
    const float new_cp = float_mod(unwrapped, (float)CODE_LENGTH);
    const float nominal = cp + p.cps * (float)S;
    const bool wrapped = fabsf(unwrapped - nominal) > 0.5f * CODE_LENGTH;

    // Costas PLL (tracking.c:175-209)
    const float perr = costas_err(ip, qp);
    const float c1 = in_sync ? p.pll_narrow_c1 : p.pll_wide_c1;
    const float c2 = in_sync ? p.pll_narrow_c2 : p.pll_wide_c2;
    const float pll_delta =
        (c1 * wrap_half(perr - pll_prev) + c2 * p.dt * perr) * p.pll_scale;

    // FLL (tracking.c:214-256)
    const float fdiff = wrap_half(perr - f[FLL_THETA]);
    const float odiff = wrap_half(fdiff - f[FLL_ERR]);
    const float fll_delta =
        (i[FLL_PRIMED] == 1 && !edge)
            ? (p.fll_c1_dt * odiff + p.fll_c2_dt * fdiff) * p.fll_scale
            : 0.0f;
    float new_dop = dop + pll_delta + fll_delta;
    float new_ph = fmaf(dop, p.s_over_fs, ph);
    new_ph = new_ph - floorf(new_ph);

    // false-lock watchdog (tracking.c:261-327): sign transitions of the
    // window after this epoch's sign shifts in
    const int sgn = ip > 0.0f ? 1 : -1;
    int trans = sgn != s.win[p.win - 1] ? 1 : 0;
    for (int k = 2; k < p.win; ++k) trans += s.win[k] != s.win[k - 1] ? 1 : 0;
    for (int k = 0; k < p.win - 1; ++k) s.win[k] = s.win[k + 1];
    s.win[p.win - 1] = sgn;
    const bool wend = wcnt == p.win - 1;
    int bad2 = i[BAD_CNT];
    if (wend) bad2 = trans > 1 ? (bad2 + 1 < 10 ? bad2 + 1 : 10)
                               : (bad2 - 1 > 0 ? bad2 - 1 : 0);
    int master2 = i[MASTER];
    if (wend && bad2 > 9) master2 = master2 + 1;
    else if (wend && bad2 == 0) master2 = 0;
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

    // bit sync (nav_data.c:46-138)
    const bool flip = sgn != i[PREV_SIGN];
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
    const int bit_val = pos > neg ? 1 : 0;
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
    f[PLL_PREV] = perr;
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
}

}  // namespace track
