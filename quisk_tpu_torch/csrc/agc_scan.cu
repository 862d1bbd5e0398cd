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
// __fsub_rn / __fdiv_rn in the plain version's order, so nvcc contracts
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
// writes 19-25 MB (~0.007 ms at 3.35 TB/s) and does ~0.1 GFLOP, while each
// step waits on the last through the compare, a divide or two and the
// selects (TxALC), the state machine (WcpAGC) or a compare and a select
// (HangAGC), whatever the number of channels.
//
// What the design does about it, as pll_demod.cu: one thread a channel,
// the state in registers through the whole block, so the chain is all a
// warp waits on; a block is one warp of 32 channels.  Global memory is never
// walked down a channel's row: the block copies tiles of kTile samples x 32
// channels into shared memory with cp.async (a warp's copies run along one
// row, so they are coalesced), two buffers, the next tile's copies in flight
// while the current tile is scanned; the outputs go to a shared tile and out
// the same way.  Rows are padded by one element so a warp's accesses down a
// column hit distinct banks.  WcpAGC's log10f and divide are off the carried
// chain (only volts is carried into them), so they cost issue slots, not
// latency.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 32;           // channels a block (one warp)
constexpr int kTile = 64;              // samples a tile
constexpr int kPitch = kTile + 1;      // shared row pitch, padded
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

// 4-byte copy from device to shared memory that does not wait.
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sdst),
               "l"(src));
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void copies_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copies of samples [t0, t0 + len) of rows c0 .. c0 + rows - 1.
__device__ __forceinline__ void load_tile(float* buf, const float* x,
                                          long long ld, int c0, int rows,
                                          long long t0, int len) {
  for (int r = 0; r < rows; ++r) {
    const float* src = x + (size_t)(c0 + r) * (size_t)ld + (size_t)t0;
    for (int t = threadIdx.x; t < len; t += kThreads)
      copy4_async(buf + r * kPitch + t, src + t);
  }
}

// torch's minimum / maximum / clamp: a NaN operand comes through.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
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

// One TxALC sample; returns g before the step, *clip the decision.
__device__ __forceinline__ float tx_alc_step(TxAlcState& z, float mg,
                                             const float* k, int A,
                                             bool* clip_out) {
  const float tgt = k[0], lo = k[1], hi = k[2], d_limit = k[3];
  const float min_magn = k[4];
  const float Af = (float)A;
  const float tm = __fdiv_rn(tgt, mg < (float)1e-9 ? (float)1e-9 : mg);
  const bool sil = mg < min_magn;
  const bool clip =
      __fmul_rn(mg, __fadd_rn(z.g, __fmul_rn(z.gc, Af))) > tgt;
  const bool blk = z.bi == z.ix;
  float gc_n = z.gc, fg_n = z.fg;
  if (clip) {
    // down-ramp to land exactly at the safe gain
    const float f1 = nan_clamp(
        __fadd_rn(z.g, __fmul_rn(__fdiv_rn(__fsub_rn(tm, z.g), Af), Af)),
        lo, hi);
    fg_n = f1;
    gc_n = __fdiv_rn(__fsub_rn(f1, z.g), Af);
  } else if (blk) {
    // recovery ramp from the observed headroom, bounded by d_limit
    const float g2 =
        z.flt < (float)(A - 10) ? (z.nc != z.nc ? z.nc : fminf(z.nc, d_limit))
                                : z.gc;
    const float f2 =
        nan_clamp(__fadd_rn(z.g, __fmul_rn(g2, Af)), lo, hi);
    fg_n = f2;
    gc_n = __fdiv_rn(__fsub_rn(f2, z.g), Af);
  }
  if (clip || blk) {
    z.nc = (float)1e10;
    z.cnt = 0.f;
    z.flt = 0.f;
  } else {
    // observe
    const float cnt3 = __fadd_rn(z.cnt, sil ? 0.f : 1.f);
    if (!sil) {
      const float d3 =
          __fdiv_rn(__fsub_rn(tm, z.fg), cnt3 < 1.f ? 1.f : cnt3);
      z.nc = nan_min(z.nc, d3);
    }
    z.cnt = cnt3;
    z.flt = __fadd_rn(z.flt, sil ? 1.f : 0.f);
  }
  if (clip) z.bi = z.ix;
  const float g = z.g;
  z.g = __fadd_rn(z.g, gc_n);
  z.gc = gc_n;
  z.fg = fg_n;
  z.ix = z.ix + 1 == A ? 0 : z.ix + 1;
  *clip_out = clip;
  return g;
}

// One WcpAGC sample; returns mult.  k in WCP_COEF order (ops/agc_scan.py).
__device__ __forceinline__ float wcp_step(WcpState& z, float rm, float ao,
                                          const float* k, int hang_samples,
                                          bool hang_enable) {
  const float attack_mult = k[0], decay_mult = k[1], fast_decay_mult = k[2];
  const float fast_backmult = k[3], hang_backmult = k[4];
  const float hang_decay_mult = k[5], out_target = k[6], min_volts = k[7];
  const float slope = k[8], hang_level = k[9], pop_ratio = k[10];
  const float inv_max_input = k[11];
  z.fba = __fadd_rn(__fmul_rn(fast_backmult, ao),
                    __fmul_rn(__fsub_rn(1.f, fast_backmult), z.fba));
  z.hba = __fadd_rn(__fmul_rn(hang_backmult, ao),
                    __fmul_rn(__fsub_rn(1.f, hang_backmult), z.hba));
  const int hc = max(z.hc - 1, 0);
  const float volts = z.volts;
  const float dv = __fsub_rn(rm, volts);
  const float att = __fadd_rn(volts, __fmul_rn(dv, attack_mult));
  const float dec = __fadd_rn(volts, __fmul_rn(dv, decay_mult));
  const float fdec = __fadd_rn(volts, __fmul_rn(dv, fast_decay_mult));
  const float hdec = __fadd_rn(volts, __fmul_rn(dv, hang_decay_mult));
  const bool attack = rm >= volts;
  const bool hang_ok = hang_enable && z.hba > hang_level;
  float v;
  int s;
  int hc_n = hc, dt_n = z.dt;
  if (z.s == 0) {
    // attack / pop fast-decay / hang entry / decay
    const bool pop = volts > __fmul_rn(pop_ratio, z.fba);
    v = attack ? att : (pop ? fdec : (hang_ok ? volts : dec));
    s = attack ? 0 : (pop ? 1 : (hang_ok ? 2 : 3));
    if (!attack && !pop && hang_ok) hc_n = hang_samples;
    if (!attack && !pop) dt_n = hang_ok ? 1 : 0;
  } else if (z.s == 1) {
    // fast decay toward save_volts
    const bool above = volts > z.save;
    v = attack ? att
               : (above ? fdec
                        : (hc > 0 ? volts : (z.dt == 0 ? dec : hdec)));
    s = attack ? 0 : (above ? 1 : (hc > 0 ? 2 : (z.dt == 0 ? 3 : 4)));
  } else if (z.s == 2) {
    // hang hold
    v = attack ? att : (hc == 0 ? hdec : volts);
    s = attack ? 0 : (hc == 0 ? 4 : 2);
  } else if (z.s == 3) {
    v = attack ? att : dec;
    s = attack ? 0 : 3;
  } else {
    v = attack ? att : hdec;
    s = attack ? 0 : 4;
  }
  // re-entering attack from 2/3/4 snapshots save_volts
  if (z.s >= 2 && attack) z.save = volts;
  v = nan_max(v, min_volts);
  z.volts = v;
  z.s = s;
  z.hc = hc_n;
  z.dt = dt_n;
  float l = log10f(__fmul_rn(inv_max_input, v));
  l = l != l ? l : fminf(l, 0.f);
  return __fdiv_rn(__fsub_rn(out_target, __fmul_rn(slope, l)), v);
}

// One HangAGC sample; returns the new log-gain.
__device__ __forceinline__ float hang_step(HangState& z, float lim,
                                           float inc, int hang_samples) {
  const bool attack = lim < z.lg;
  z.lg = attack ? lim
                : (z.hang > 0 ? z.lg : nan_min(__fadd_rn(z.lg, inc), lim));
  z.hang = attack ? hang_samples : max(z.hang - 1, 0);
  return z.lg;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) agc_scan_kernel(const Args a) {
  constexpr int kIn = MODE == kWcp ? 2 : 1;
  __shared__ float sx[2][kIn][kThreads * kPitch];
  __shared__ float sy[kThreads * kPitch];
  __shared__ unsigned char sc[MODE == kTxAlc ? kThreads * kPitch : 1];
  const int c0 = blockIdx.x * kThreads;
  const int lane = threadIdx.x;
  const int c = c0 + lane;
  const int rows = min(kThreads, a.C - c0);
  const bool live = c < a.C;
  const long long B = a.B;

  constexpr int kCoef = MODE == kTxAlc ? 5 : (MODE == kWcp ? 12 : 1);
  float k[kCoef];
#pragma unroll
  for (int i = 0; i < kCoef; ++i) k[i] = a.coef[i];

  auto f_in = [&](int i) { return ((const float*)a.st_in[i])[c]; };
  auto i_in = [&](int i) { return ((const int*)a.st_in[i])[c]; };
  TxAlcState za{};
  WcpState zw{};
  HangState zh{};
  if (live) {
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

  const long long ntiles = (B + kTile - 1) / kTile;
  const float* xs[2] = {a.x0, a.x1};
  const long long lds[2] = {a.ld0, a.ld1};
  for (int i = 0; i < kIn; ++i)
    load_tile(sx[0][i], xs[i], lds[i], c0, rows, 0,
              (int)min((long long)kTile, B));
  copies_commit();
  for (long long tile = 0; tile < ntiles; ++tile) {
    const long long t0 = tile * kTile;
    const int len = (int)min((long long)kTile, B - t0);
    if (tile + 1 < ntiles)
      for (int i = 0; i < kIn; ++i)
        load_tile(sx[(tile + 1) & 1][i], xs[i], lds[i], c0, rows,
                  t0 + kTile, (int)min((long long)kTile, B - t0 - kTile));
    copies_commit();                   // an empty group on the last tile
    copies_wait_but_newest();
    __syncthreads();
    if (live) {
      const float* row0 = sx[tile & 1][0] + lane * kPitch;
      const float* row1 = sx[tile & 1][kIn - 1] + lane * kPitch;
      float* out = sy + lane * kPitch;
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        if constexpr (MODE == kTxAlc) {
          bool cl;
          out[t] = tx_alc_step(za, row0[t], k, a.n, &cl);
          sc[lane * kPitch + t] = cl;
        } else if constexpr (MODE == kWcp) {
          out[t] = wcp_step(zw, row0[t], row1[t], k, a.n, a.flag != 0);
        } else {
          out[t] = hang_step(zh, row0[t], k[0], a.n);
        }
      }
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const size_t base = (size_t)(c0 + r) * (size_t)B + (size_t)t0;
      for (int t = lane; t < len; t += kThreads) {
        a.y[base + t] = sy[r * kPitch + t];
        if constexpr (MODE == kTxAlc)
          if (a.clip) a.clip[base + t] = sc[r * kPitch + t];
      }
    }
  }
  if (live) {
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
// B float32 samples, row r at x + r*ld.  st_in / st_out: host arrays of the
// state tensors' device pointers, float32 [C] first, then int32 [C] (and
// TxALC's 0-dim int32 index last).  coef: float32 [5 | 12 | 1].  y: [C, B]
// float32.  Launches on ``stream``; returns kErrBadShape for a shape or a
// parameter the kernel cannot take, else the CUDA error of the launch (0 on
// success).
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
    agc_scan_kernel<kTxAlc><<<grid, kThreads, 0, st>>>(a);
  else if (mode == kWcp)
    agc_scan_kernel<kWcp><<<grid, kThreads, 0, st>>>(a);
  else
    agc_scan_kernel<kHang><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
