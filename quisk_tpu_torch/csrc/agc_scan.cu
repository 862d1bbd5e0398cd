// Per-channel AGC / ALC state machines: the TX ALC, the WDSP AGC and the
// hang AGC.  One kernel template, three modes, one launcher.
//
// Replaces no Pallas kernel: it replaces the per-sample scans of the JAX
// package's quisk_tpu/ops/agc.py, which run as unrolled_scan under jit with
// the channels on the vector lanes: TxALC (:408-452, microphone.c:270-358),
// WcpAGC (:254-323, wdsp/wcpAGC.c:161-342) and HangAGC (:154-171).  In the
// port the only other way is a Python loop of 25-75 tensor ops a sample (the
// plain versions, ops/agc_scan.py), 50 000-150 000 launches a 2048-sample
// block.  What depends on the input alone (delay line, window max, gain
// limit, |x|, the per-mode gain memory, the product with the delayed
// samples) stays as torch ops around the kernel, once a block.
//
// Per channel and sample, with the state carried across the block and
// across calls (A = the ALC's delay, H = the hang length):
//
//   kTxAlc  in: magn.  clip = magn*(g + gc*A) > target; on a clip a ramp
//           lands on clamp(g + (target/magn - g)/A*A) over A samples; when
//           the ring index comes back to the last clip's (block complete)
//           a recovery ramp bounded by the observed headroom and d_limit;
//           else the headroom is observed.  out: g before the step, clip.
//   kWcp    in: the attack window's max rm and the delayed |x| ao.  The
//           back-averages, the 5-state machine on volts (attack, pop fast
//           decay, hang, decay, post-hang decay), then the gain law
//           mult = (out_target - slope*min(log10(volts/max_in), 0))/volts.
//   kHang   in: the log-gain limit.  lg = lim on attack (lim < lg), held
//           while the counter runs, else min(lg + inc, lim).  out: lg.
//
// Rounding is that of the plain version, one float32 operation at a time:
// every product, sum and quotient goes through __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn in the plain version's order (a dividend of
// exactly +-0 over a positive divisor is that zero without the divide,
// div_pos, as the divide would give it), so nvcc contracts
// nothing into an FMA (g + gc*A in the clip test would otherwise flip
// decisions at the threshold, where constant-envelope rows sit); (tm -
// g)/A*A keeps its divide and its multiply; 1 - k of the back-averages is
// rounded once; log10f is the full-precision function (the build has no
// --use_fast_math), as torch's log10 on a CUDA tensor; min, max and clamp
// let a NaN through, as torch's do; the constants are the op's float32
// values, and 1e-9 and 1e10 are float32 of the double, as torch rounds a
// Python float.
//
// What bounds it on an H100: neither bytes nor operations but the serial
// chain of each channel's 2048 steps.  At [1024, 2048] the kernel reads and
// writes 17-25 MB (~0.007 ms at 3.35 TB/s) and does ~0.1 GFLOP, while each
// step waits on the last: through the clip test (TxALC), the compares and
// selects of the state machine (WcpAGC), or a compare, a sum and a min
// (HangAGC), whatever the number of channels.  A channel's time is its
// chain's latency plus whatever else its warp must issue in between, and
// the number of channels only fills more SMs: more warps do not shorten a
// chain.  Two things lengthen it on this card.  A conditional whose arms
// cost something becomes a branch behind a convergence barrier, and lanes
// in different states run each arm one after another.  And every __fdiv_rn
// is a fast path and a check with a branch around the rare slow path, a
// region of code of its own into which nothing else is scheduled, so a
// sample's divides cost their whole latency one after another.
//
// What the design does about it: one thread a channel, the state in
// registers through the whole block, 32 channels a block, and as little as
// possible on the scanning warp between one step and the next:
// - a second warp, the helper, takes what is off the chain and costs the
//   most, the divides and log10f that do not feed the next step: TxALC's
//   target/magn of the next tile ahead of the scan, WcpAGC's gain law on
//   the last tile's volts behind it.  The two meet once a tile (a named
//   barrier) and pass tiles through shared memory, two buffers deep.
//   HangAGC, which has none, runs the scanning warp alone;
// - the scanning warp's lanes each copy their own rows' next tile into
//   shared memory with cp.async (16-byte copies where the row is 16-byte
//   aligned, else one a sample), in flight while the current tile is
//   scanned, and take a landed tile into registers with four 16-byte
//   loads, so no step waits on a load and no load on a step; outputs (and
//   TxALC's clip bytes, packed four to a word) stay in registers over the
//   tile and go out as vectors;
// - the steps select instead of branching: every path of WcpAGC's and
//   HangAGC's machines and of TxALC's observe step is computed and the
//   result taken by a select the compiler cannot turn back into a branch
//   (fsel / isel), so no lane waits on another's path;
// - TxALC's clip and block-complete ramps (two divides) are the one
//   exception: they are computed only when a lane of the warp needs one,
//   a branch the whole warp takes or skips together (most samples need
//   neither), and they select their target first and divide once.  Fully
//   selected, TxALC ran slower than the earlier branching design at C=1;
// - TxALC's divides by a positive number skip __fdiv_rn's slow path on a
//   dividend of exactly 0 (div_pos), which a constant-envelope row gives
//   them sample after sample.
// Each selected value comes from the same operations in the same order as
// the plain version's, so the bits are its bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 32;           // channels a block, a warp's lanes
constexpr int kTile = 16;              // samples a lane holds in registers
constexpr int kPitch = kTile + 4;      // shared tile row: 16-byte aligned,
                                       // a warp's 16-byte accesses disjoint
constexpr int kMaxState = 8;           // state tensors a mode may carry
constexpr int kErrBadShape = -1;
constexpr int kTxAlc = 0;
constexpr int kWcp = 1;
constexpr int kHang = 2;

struct Args {
  const float* x0;                     // magn | rm | lim
  long long ld0;
  const float* x1;                     // ao (kWcp)
  long long ld1;
  const void* st_in[kMaxState];        // float32 [C] ..., int32 [C] ...
  void* st_out[kMaxState];
  const float* coef;
  float* y;                            // [C, B]
  unsigned char* clip;                 // [C, B] bool (kTxAlc), or null
  int C;
  long long B;
  int n;                               // A (kTxAlc) | hang samples
  int flag;                            // hang_enable (kWcp)
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Samples [t0, t0 + len) of a row into v (len <= kTile; the rest 0).
__device__ __forceinline__ void load_tile(float (&v)[kTile], const float* row,
                                          long long t0, int len, bool vec) {
  if (vec && len == kTile) {
    const float4* q = reinterpret_cast<const float4*>(row + t0);
#pragma unroll
    for (int i = 0; i < kTile / 4; ++i) {
      const float4 f = __ldg(q + i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      v[t] = t < len ? __ldg(row + t0 + t) : 0.f;
  }
}

// Copies from device to shared memory that do not wait: 16 or 4 bytes.
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void copies_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copy of samples [t0, t0 + len) of a row into a shared tile row
// (dst 16-byte aligned; vec: the row's samples are too).
__device__ __forceinline__ void copy_tile(float* dst, const float* row,
                                          long long t0, int len, bool vec) {
  if (vec && len == kTile) {
#pragma unroll
    for (int i = 0; i < kTile / 4; ++i)
      copy16_async(dst + 4 * i, row + t0 + 4 * i);
  } else {
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      if (t < len) copy4_async(dst + t, row + t0 + t);
  }
}

__device__ __forceinline__ void store_tile(float* row, long long t0, int len,
                                           bool vec, const float (&v)[kTile]) {
  if (vec && len == kTile) {
    float4* q = reinterpret_cast<float4*>(row + t0);
#pragma unroll
    for (int i = 0; i < kTile / 4; ++i)
      q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      if (t < len) row[t0 + t] = v[t];
  }
}

// The tile's clip bytes, packed four to a word (byte t & 3 of word t >> 2).
__device__ __forceinline__ void store_clips(unsigned char* row, long long t0,
                                            int len, bool vec,
                                            const unsigned (&w)[kTile / 4]) {
  if (vec && len == kTile) {
    *reinterpret_cast<uint4*>(row + t0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      if (t < len) row[t0 + t] = (unsigned char)(w[t >> 2] >> (8 * (t & 3)));
  }
}

// p ? a : b as one select instruction.  Written as plain conditionals, the
// compiler turns a chain of selects keyed on one integer (WcpAGC's state)
// into a branch table, and a select of a quotient into a branch around the
// divide; lanes in different states then run each other's paths.
__device__ __forceinline__ float fsel(bool p, float a, float b) {
  float r;
  asm("{.reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;}"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)p));
  return r;
}
__device__ __forceinline__ int isel(bool p, int a, int b) {
  int r;
  asm("{.reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.b32 %0, %1, %2, q;}"
      : "=r"(r) : "r"(a), "r"(b), "r"((int)p));
  return r;
}

// __fdiv_rn(a, b) for a divisor that is positive or NaN.  __fdiv_rn sends a
// zero dividend down its slow path (a call), and TxALC's differences are
// exactly 0 sample after sample on a constant-envelope (FM) row; the
// quotient of such a zero is that zero, sign and all, so the divide runs
// on 1 instead and the zero is taken.
__device__ __forceinline__ float div_pos(float a, float b) {
  const float q = __fdiv_rn(a == 0.f ? 1.f : a, b);
  return fsel(a == 0.f && b > 0.f, a, q);
}

// torch's minimum / maximum / clamp: a NaN operand comes through.
__device__ __forceinline__ float nan_min(float a, float b) {
  const float m = fminf(a, b);
  const float r = b != b ? b : m;
  return a != a ? a : r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  const float m = fmaxf(a, b);
  const float r = b != b ? b : m;
  return a != a ? a : r;
}
__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  return nan_min(nan_max(v, lo), hi);
}

struct TxAlcState {
  float g, gc, fg, nc, cnt, flt;
  int bi, ix;
};

struct WcpState {
  float volts, save, fba, hba;
  int hc, s, dt;
};

struct HangState {
  float lg;
  int hang;
};

// One TxALC sample, tm = target/max(magn, 1e-9) and sil = magn < min_magn
// computed ahead; returns g before the step, *clip the decision.
__device__ __forceinline__ float tx_alc_step(TxAlcState& z, float mg,
                                             float tm, bool sil,
                                             const float* k, int A,
                                             bool* clip_out) {
  const float tgt = k[0], lo = k[1], hi = k[2], d_limit = k[3];
  const float Af = (float)A;
  const bool clip =
      __fmul_rn(mg, __fadd_rn(z.g, __fmul_rn(z.gc, Af))) > tgt;
  const bool blk = z.bi == z.ix;
  const bool rst = clip || blk;
  // the two ramps, only when a lane of the warp needs one (a clip, or a
  // block complete): most samples need neither
  float f = z.fg, gc_r = z.gc;
  if (__any_sync(0xffffffffu, rst)) {
    // clip: down-ramp to land exactly at the safe gain
    const float f1 = nan_clamp(
        __fadd_rn(z.g, __fmul_rn(div_pos(__fsub_rn(tm, z.g), Af), Af)),
        lo, hi);
    // block complete: recovery ramp from the observed headroom, bounded by
    // d_limit
    const float nc_lim = z.nc != z.nc ? z.nc : fminf(z.nc, d_limit);
    const float g2 = fsel(z.flt < (float)(A - 10), nc_lim, z.gc);
    const float f2 = nan_clamp(__fadd_rn(z.g, __fmul_rn(g2, Af)), lo, hi);
    // both ramps end in (f - g)/A: one divide
    f = fsel(clip, f1, f2);
    gc_r = div_pos(__fsub_rn(f, z.g), Af);
  }
  // observe
  const float cnt3 = __fadd_rn(z.cnt, sil ? 0.f : 1.f);
  const float d3 = div_pos(__fsub_rn(tm, z.fg), cnt3 < 1.f ? 1.f : cnt3);
  const float nc3 = fsel(sil, z.nc, nan_min(z.nc, d3));
  const float flt3 = __fadd_rn(z.flt, sil ? 1.f : 0.f);
  const float gc_n = fsel(rst, gc_r, z.gc);
  const float g = z.g;
  z.nc = fsel(rst, (float)1e10, nc3);
  z.cnt = fsel(rst, 0.f, cnt3);
  z.flt = fsel(rst, 0.f, flt3);
  z.bi = isel(clip, z.ix, z.bi);
  z.g = __fadd_rn(g, gc_n);
  z.gc = gc_n;
  z.fg = fsel(rst, f, z.fg);
  z.ix = z.ix + 1 == A ? 0 : z.ix + 1;
  *clip_out = clip;
  return g;
}

// One WcpAGC sample, the back-averages fba and hba (after this sample)
// computed ahead; returns volts.  k in WCP_COEF order (ops/agc_scan.py).
__device__ __forceinline__ float wcp_step(WcpState& z, float rm, float fba,
                                          float hba,
                                          const float* k, int hang_samples,
                                          bool hang_enable) {
  const float attack_mult = k[0], decay_mult = k[1], fast_decay_mult = k[2];
  const float hang_decay_mult = k[5], min_volts = k[7];
  const float hang_level = k[9], pop_ratio = k[10];
  const int hc = max(z.hc - 1, 0);
  const float volts = z.volts;
  const float dv = __fsub_rn(rm, volts);
  const float att = __fadd_rn(volts, __fmul_rn(dv, attack_mult));
  const float dec = __fadd_rn(volts, __fmul_rn(dv, decay_mult));
  const float fdec = __fadd_rn(volts, __fmul_rn(dv, fast_decay_mult));
  const float hdec = __fadd_rn(volts, __fmul_rn(dv, hang_decay_mult));
  const bool attack = rm >= volts;
  const bool hang_ok = hang_enable && hba > hang_level;
  const bool pop = volts > __fmul_rn(pop_ratio, fba);
  const bool above = volts > z.save;
  const int s = z.s;
  // the state after a step without attack, by state: 0 attack / pop fast
  // decay / hang entry / decay; 1 fast decay toward save_volts; 2 hang
  // hold; 3 decay; 4 (and any other) post-hang decay.  Each next state
  // has one value: 1 fdec, 2 volts, 3 dec, 4 hdec.
  const int n0 = isel(pop, 1, isel(hang_ok, 2, 3));
  const int n1 = isel(above, 1, isel(hc > 0, 2, isel(z.dt == 0, 3, 4)));
  const int n2 = isel(hc == 0, 4, 2);
  const int ns = isel(s == 0, n0, isel(s == 1, n1, isel(s == 2, n2,
                                                          isel(s == 3, 3,
                                                               4))));
  const float vd = fsel(ns == 1, fdec, fsel(ns == 2, volts,
                                            fsel(ns == 3, dec, hdec)));
  const float v = fsel(attack, att, vd);
  // re-entering attack from 2/3/4 snapshots save_volts
  z.save = fsel(s >= 2 && attack, volts, z.save);
  const bool enter = s == 0 && !attack && !pop;
  z.hc = isel(enter && hang_ok, hang_samples, hc);
  z.dt = isel(enter, hang_ok ? 1 : 0, z.dt);
  z.s = isel(attack, 0, ns);
  z.volts = nan_max(v, min_volts);
  return z.volts;
}

// One HangAGC sample; returns the new log-gain.
__device__ __forceinline__ float hang_step(HangState& z, float lim,
                                           float inc, int hang_samples) {
  const bool attack = lim < z.lg;
  const float rel = nan_min(__fadd_rn(z.lg, inc), lim);
  const float held = fsel(z.hang > 0, z.lg, rel);
  z.lg = fsel(attack, lim, held);
  z.hang = isel(attack, hang_samples, max(z.hang - 1, 0));
  return z.lg;
}

// The block's two warps meet (every thread of the block, from either
// role; barrier 1, as barrier 0 is __syncthreads').
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(2 * kThreads) : "memory");
}

// A shared tile row <-> registers, 16 bytes at a time.
__device__ __forceinline__ void get_row(float (&v)[kTile], const float* row) {
#pragma unroll
  for (int i = 0; i < kTile / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(row)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void put_row(float* row, const float (&v)[kTile]) {
#pragma unroll
  for (int i = 0; i < kTile / 4; ++i)
    reinterpret_cast<float4*>(row)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// One tile of each mode's scan: the steps of samples [0, len) of the tile,
// their outputs into y (TxALC's clip bytes into cw, WcpAGC's volts);
// FULL: len == kTile.
template <bool FULL>
__device__ __forceinline__ void tx_alc_tile(TxAlcState& z,
                                            const float (&mg)[kTile],
                                            const float (&tm)[kTile],
                                            float (&y)[kTile],
                                            unsigned (&cw)[kTile / 4],
                                            const float* k, int A, int len) {
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    if (FULL || t < len) {
      bool cl;
      y[t] = tx_alc_step(z, mg[t], tm[t], mg[t] < k[4], k, A, &cl);
      cw[t >> 2] |= (unsigned)cl << (8 * (t & 3));
    }
  }
}

template <bool FULL>
__device__ __forceinline__ void wcp_tile(WcpState& z,
                                         const float (&rm)[kTile],
                                         const float (&ao)[kTile],
                                         float (&volts)[kTile],
                                         const float* k, int hang_samples,
                                         bool hang_enable, int len) {
  // the back-averages: a chain of their own that never reads volts
  const float fb = k[3], hb = k[4];
  const float fb1 = __fsub_rn(1.f, fb), hb1 = __fsub_rn(1.f, hb);
  float fba[kTile], hba[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    if (FULL || t < len) {
      z.fba = __fadd_rn(__fmul_rn(fb, ao[t]), __fmul_rn(fb1, z.fba));
      z.hba = __fadd_rn(__fmul_rn(hb, ao[t]), __fmul_rn(hb1, z.hba));
    }
    fba[t] = z.fba;
    hba[t] = z.hba;
  }
#pragma unroll
  for (int t = 0; t < kTile; ++t)
    volts[t] = FULL || t < len ? wcp_step(z, rm[t], fba[t], hba[t], k,
                                          hang_samples, hang_enable)
                               : 1.f;
}

template <bool FULL>
__device__ __forceinline__ void hang_tile(HangState& z,
                                          const float (&lim)[kTile],
                                          float (&y)[kTile], float inc,
                                          int hang_samples, int len) {
#pragma unroll
  for (int t = 0; t < kTile; ++t)
    if (FULL || t < len) y[t] = hang_step(z, lim[t], inc, hang_samples);
}

// The helper warp's work, off the chain: TxALC's target/magn of a tile
// ahead of its scan, WcpAGC's gain law on a scanned tile's volts.
__device__ __forceinline__ void tx_alc_terms(float (&tm)[kTile],
                                             const float (&mg)[kTile],
                                             const float* k) {
#pragma unroll
  for (int t = 0; t < kTile; ++t)
    tm[t] = __fdiv_rn(k[0], mg[t] < (float)1e-9 ? (float)1e-9 : mg[t]);
}

__device__ __forceinline__ void wcp_gain(float (&y)[kTile],
                                         const float (&volts)[kTile],
                                         const float* k) {
  const float out_target = k[6], slope = k[8], inv_max_input = k[11];
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    float l = log10f(__fmul_rn(inv_max_input, volts[t]));
    l = l != l ? l : fminf(l, 0.f);
    y[t] = __fsub_rn(out_target, __fmul_rn(slope, l));
  }
#pragma unroll
  for (int t = 0; t < kTile; ++t) y[t] = __fdiv_rn(y[t], volts[t]);
}

// Warp 0 scans; TxALC and WcpAGC have a second warp, the helper, whose lane
// l serves the same channel as the scan's lane l.  Tile i's iteration: the
// scan steps through tile i while the helper computes TxALC's tile i + 1
// terms, or WcpAGC's tile i - 1 gain law; the two meet at its end.  Their
// tiles pass through shared memory, two buffers deep.
template <int MODE>
__global__ void __launch_bounds__(2 * kThreads) agc_scan_kernel(
    const Args a) {
  constexpr int kIn = MODE == kWcp ? 2 : 1;
  constexpr bool kHelper = MODE != kHang;
  // sx: the scan's input tiles, two deep, a row a lane; sh: the tiles the
  // two warps pass each other (TxALC's terms, WcpAGC's volts), two deep
  __shared__ __align__(16) float sx[2][kIn][kThreads * kPitch];
  __shared__ __align__(16) float sh[2][kHelper ? kThreads * kPitch : 4];
  const int lane = threadIdx.x % kThreads;
  const bool scan = threadIdx.x < kThreads;
  const int c = blockIdx.x * kThreads + lane;
  const bool live = c < a.C;
  const long long B = a.B;

  constexpr int kCoef = MODE == kTxAlc ? 5 : (MODE == kWcp ? 12 : 1);
  float k[kCoef];
#pragma unroll
  for (int i = 0; i < kCoef; ++i) k[i] = a.coef[i];

  auto f_in = [&](int i) { return ((const float*)a.st_in[i])[c]; };
  auto i_in = [&](int i) { return ((const int*)a.st_in[i])[c]; };
  // a lane past the last channel never clips nor completes a block, so it
  // never calls for the ramps
  TxAlcState za{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1, 0};
  WcpState zw{};
  HangState zh{};
  if (live && scan) {
    if constexpr (MODE == kTxAlc) {
      za = {f_in(0), f_in(1), f_in(2), f_in(3), f_in(4), f_in(5), i_in(6),
            0};
      const int ix = ((const int*)a.st_in[7])[0] % a.n;
      za.ix = ix < 0 ? ix + a.n : ix;
    } else if constexpr (MODE == kWcp) {
      zw = {f_in(0), f_in(1), f_in(2), f_in(3), i_in(4), i_in(5), i_in(6)};
    } else {
      zh = {f_in(0), i_in(1)};
    }
  }

  // this lane's rows; a lane past the last channel reads and writes none
  const size_t r = live ? (size_t)c : 0;
  const float* xr[2] = {a.x0 + r * (size_t)a.ld0,
                        a.x1 + (kIn > 1 ? r * (size_t)a.ld1 : 0)};
  bool xv[2] = {aligned16(xr[0]), aligned16(xr[1])};
  float* yr = a.y + r * (size_t)B;
  const bool yv = aligned16(yr);
  unsigned char* cr = MODE == kTxAlc && a.clip ? a.clip + r * (size_t)B
                                               : nullptr;
  const bool cv = cr != nullptr && aligned16(cr);
  const long long ntiles = (B + kTile - 1) / kTile;
  auto len_of = [&](long long i) {
    return (int)min((long long)kTile, B - i * kTile);
  };
  auto in_row = [&](long long i, int j) {
    return sx[i & 1][j] + lane * kPitch;
  };
  auto pass_row = [&](long long i) { return sh[i & 1] + lane * kPitch; };
  if (scan) {
    if (live) {
#pragma unroll
      for (int j = 0; j < kIn; ++j)
        copy_tile(in_row(0, j), xr[j], 0, len_of(0), xv[j]);
    } else {                           // a lane past the last channel: 0s
      const float zero[kTile] = {};
#pragma unroll
      for (int j = 0; j < kIn; ++j) {
        put_row(in_row(0, j), zero);
        put_row(in_row(1, j), zero);
      }
    }
    copies_commit();
  }
  if constexpr (MODE == kTxAlc) {
    if (!scan) {
      float mg[kTile] = {}, tm[kTile];
      if (live) load_tile(mg, xr[0], 0, len_of(0), xv[0]);
      tx_alc_terms(tm, mg, k);
      put_row(pass_row(0), tm);
    }
  }
  if constexpr (kHelper) block_sync();

  auto iteration = [&](auto full, long long i) {
    constexpr bool kFull = decltype(full)::value;
    const long long t0 = i * kTile;
    const int len = kFull ? kTile : len_of(i);
    if (scan) {
      // the next tile's copies, in flight while this one is scanned
      if (live && i + 1 < ntiles)
#pragma unroll
        for (int j = 0; j < kIn; ++j)
          copy_tile(in_row(i + 1, j), xr[j], t0 + kTile, len_of(i + 1),
                    xv[j]);
      copies_commit();                 // an empty group on the last tile
      copies_wait_but_newest();
      float x[kIn][kTile], y[kTile];
#pragma unroll
      for (int j = 0; j < kIn; ++j) get_row(x[j], in_row(i, j));
      if constexpr (MODE == kTxAlc) {
        float tm[kTile];
        unsigned cw[kTile / 4] = {};
        get_row(tm, pass_row(i));
        tx_alc_tile<kFull>(za, x[0], tm, y, cw, k, a.n, len);
        if (live) {
          store_tile(yr, t0, len, yv, y);
          if (cr) store_clips(cr, t0, len, cv, cw);
        }
      } else if constexpr (MODE == kWcp) {
        wcp_tile<kFull>(zw, x[0], x[kIn - 1], y, k, a.n, a.flag != 0, len);
        put_row(pass_row(i), y);
      } else {
        hang_tile<kFull>(zh, x[0], y, k[0], a.n, len);
        if (live) store_tile(yr, t0, len, yv, y);
      }
    } else if constexpr (MODE == kTxAlc) {
      if (i + 1 < ntiles) {
        float mg[kTile] = {}, tm[kTile];
        if (live) load_tile(mg, xr[0], t0 + kTile, len_of(i + 1), xv[0]);
        tx_alc_terms(tm, mg, k);
        put_row(pass_row(i + 1), tm);
      }
    } else if constexpr (MODE == kWcp) {
      if (i > 0) {                     // tile i - 1, a whole one
        float volts[kTile], y[kTile];
        get_row(volts, pass_row(i - 1));
        wcp_gain(y, volts, k);
        if (live) store_tile(yr, t0 - kTile, kTile, yv, y);
      }
    }
    if constexpr (kHelper) block_sync();
  };
  const long long nfull = B / kTile;
  for (long long i = 0; i < nfull; ++i) iteration(std::true_type{}, i);
  if (nfull < ntiles) iteration(std::false_type{}, nfull);
  if constexpr (MODE == kWcp) {
    if (!scan) {                       // the last tile's gain law
      float volts[kTile], y[kTile];
      get_row(volts, pass_row(ntiles - 1));
      wcp_gain(y, volts, k);
      if (live) store_tile(yr, (ntiles - 1) * kTile, len_of(ntiles - 1), yv,
                           y);
    }
  }
  if (live && scan) {
    auto f_out = [&](int i, float v) { ((float*)a.st_out[i])[c] = v; };
    auto i_out = [&](int i, int v) { ((int*)a.st_out[i])[c] = v; };
    if constexpr (MODE == kTxAlc) {
      f_out(0, za.g); f_out(1, za.gc); f_out(2, za.fg); f_out(3, za.nc);
      f_out(4, za.cnt); f_out(5, za.flt); i_out(6, za.bi);
      if (c == 0) ((int*)a.st_out[7])[0] = za.ix;
    } else if constexpr (MODE == kWcp) {
      f_out(0, zw.volts); f_out(1, zw.save); f_out(2, zw.fba);
      f_out(3, zw.hba); i_out(4, zw.hc); i_out(5, zw.s); i_out(6, zw.dt);
    } else {
      f_out(0, zh.lg); i_out(1, zh.hang);
    }
  }
}

}  // namespace

// mode 0: TxALC (x0 magn; n = A; clip may be null), 1: WcpAGC (x0 the
// window max, x1 the delayed |x|; n = hang samples, flag = hang_enable),
// 2: HangAGC (x0 the log-gain limit; n = hang samples).  x0 / x1: C rows of
// B float32 samples, row r at x + r*ld (any alignment).  st_in / st_out:
// host arrays of the state tensors' device pointers, float32 [C] first,
// then int32 [C] (and TxALC's 0-dim int32 index last).  coef: float32 [5 |
// 12 | 1].  y: [C, B] float32.  Launches on ``stream``; returns
// kErrBadShape for a shape or a parameter the kernel cannot take, else the
// CUDA error of the launch (0 on success).
extern "C" int agc_scan(int mode, const void* x0, long long ld0,
                        const void* x1, long long ld1,
                        const void* const* st_in, void* const* st_out,
                        const void* coef, void* y, void* clip, int C,
                        long long B, int n, int flag, void* stream) {
  if (C < 1 || B < 1 || ld0 < B || ld1 < B || n < 0 ||
      (mode == kTxAlc && n < 1) || mode < kTxAlc || mode > kHang)
    return kErrBadShape;
  Args a;
  a.x0 = (const float*)x0;
  a.ld0 = ld0;
  a.x1 = (const float*)x1;
  a.ld1 = ld1;
  for (int i = 0; i < kMaxState; ++i) {
    a.st_in[i] = st_in[i];
    a.st_out[i] = st_out[i];
  }
  a.coef = (const float*)coef;
  a.y = (float*)y;
  a.clip = (unsigned char*)clip;
  a.C = C;
  a.B = B;
  a.n = n;
  a.flag = flag;
  const dim3 grid((C + kThreads - 1) / kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == kTxAlc)
    agc_scan_kernel<kTxAlc><<<grid, 2 * kThreads, 0, st>>>(a);
  else if (mode == kWcp)
    agc_scan_kernel<kWcp><<<grid, 2 * kThreads, 0, st>>>(a);
  else
    agc_scan_kernel<kHang><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
