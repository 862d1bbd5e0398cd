// The per-channel mixed-mode demodulator of the receive chain
// (ops/demod.py MixedDemod), one block of filtered IQ in one pass: SSB, the
// AM envelope and its DC blocker, the FM discriminator and its
// de-emphasis, the per-channel selection and the carried state, one thread
// block a channel row.
//
// Replaces no Pallas kernel: the JAX package computes these families with
// jnp ops and lax.associative_scan (quisk_tpu/ops/demod.py MixedDemod), and
// so does the port's plain version, as torch ops (MixedDemod.plain: ~70
// launches a block, each streaming a [C, B] plane through device memory).
// Per channel row x[0 .. B) of complex samples, with the carried state
// (ex, ya) of AM and (p, yf) of FM:
//
//   ssb[n]  = g_ssb * Re x[n]
//   env[n]  = |x[n]|,                     env[-1] = ex
//   ya[n]   = a_am ya[n-1] + (env[n] - env[n-1]);   am[n] = g_am * ya[n]
//   d[n]    = x[n] conj(x[n-1]),           x[-1] = p
//   disc[n] = atan2(Im d, Re d) if |d[n]|^2 > 1e-24 else 0
//   yf[n]   = a_fm yf[n-1] + b_fm (g_fm disc[n]);   fm[n] = yf[n]
//   out[n]  = am / fm / the EXT op's audio / ssb by the row's mode
//   state'  = (env[B-1], ya[B-1]), (x[B-1], yf[B-1])
//
// Every family's state advances on every row, whatever its mode, as in the
// JAX reference: a row retuned from EXT to AM, or from USB to FM, goes on
// from a warm state.  The mode is read on the card each launch, so a
// retune needs no rebuild.  The envelope is hypotf and the angle atan2f,
// the full-precision functions torch's abs and atan2 call on a CUDA tensor
// (the build has no --use_fast_math), so the envelope is the plain version's
// bits; the products and sums that feed the two recurrences are rounded as
// the plain version rounds them.  The FM gate compares |d|^2 with 1e-24
// (GroupedDemodTM's form) where the plain version compares hypotf(d) with
// 1e-12: one hypotf a sample less, and the two differ only where |d| lies
// within a rounding of 1e-12, as a signal switches on (ROADMAP Queue F).
// That third spelling of the gate is accepted for what it was measured to
// save on an H100: 8% of the kernel's time at [8192, 2048].  The price is
// that a comparison with the plain version skips FM in a signal's onset
// block.
//
// The recurrences: thread t of a pass owns kPer = 8 consecutive samples.
// It runs both one-poles over its chunk from zero (float32 fma), giving
// the chunk's sum e_t; the carry into chunk t is then
//   y_in(t) = a^(8t) c + sum over j < t of a^(8(t-1-j)) e_j
// (c the carry into the pass), a scan whose coefficient is a power of a
// known from the position alone: warp shuffles with a^8, a^16, .. a^128,
// then one shared slot a warp (the powers made in float64, rounded once).
// Each thread then steps its chunk again from its carry, so every output is
// the serial float32 recurrence over at most 8 samples from a carry a few
// roundings off: on the CPU, through a stub of the CUDA names, >= 126 dB a
// row against float64 (a float64 scan read >= 136 but took 10% longer on
// the card, for its registers; the plain version reads >= 116).  Only the
// last chunk of a row can be short, and nothing after it reads its sum.
//
// What bounds it on an H100: the bytes.  A row reads B complex samples
// (8 B each) and, on EXT rows, B samples of the EXT op's audio, and writes
// B samples: at [8192, 2048], 201.3 MB = 0.060 ms at 3.35 TB/s (268.4 MB =
// 0.080 ms when every row is EXT).  Operations: ~70 a sample (two hypotf,
// an atan2f, the four recurrence fma, the selection), 1.2 G = 0.018 ms at
// FP32's 67 TFLOP/s.  What the design does about it: every sample is read
// from device memory once, in 16-byte loads straight into the registers
// of the thread that owns it (the neighbour's last sample by a shuffle),
// the EXT audio loaded before the work that hides its latency, and every
// output written once, in 16-byte stores; the scan is 5 shuffle rounds and
// one barrier a pass, so nothing but registers holds a sample.  What holds
// it back: latency.  A block's 256 threads load, then compute, then store;
// only other blocks overlap them, and 64 registers a thread (4 blocks, half
// the multiprocessor's threads) is the most that still spills little.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPer = 8;                    // consecutive samples a thread
constexpr int kMaxWarps = 8;               // a block: one row, <= 256 threads
constexpr int kMinBlocks = 4;              // resident a multiprocessor: 64
                                           // registers a thread
constexpr int kErrBadShape = -1;
constexpr float kGate2 = 1e-24f;           // the FM gate on |d|^2

struct Args {
  const float2* x;                         // [C, B], row r at x + r*ldx
  long long ldx;
  const int* mode;                         // [C], mode[r*lm]
  long long lm;
  const float* am_x;                       // [C] each, element r at r*stride
  long long s_amx;
  const float* am_y;
  long long s_amy;
  const float2* fm_p;
  long long s_fmp;
  const float* fm_y;
  long long s_fmy;
  const float* ext;                        // [C, B] EXT audio, or null
  long long lde;
  const float* ssb_gain;                   // 0-dim each
  const float* am_gain;
  const float* am_a;
  const float* fm_gain;
  const float* fm_a;
  const float* fm_b;
  float* out;                              // [C, B] contiguous
  float* st;                               // [5, C]: fm p (re, im), am x,
                                           // am y, fm y
  int B;
  int C;
  int m_am, m_fm, m_ext;                   // mode numbers; m_ext -1: no EXT
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    mixed_demod_kernel(const Args p) {
  __shared__ float slots[2][2][kMaxWarps];  // pass parity, family, warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long c = blockIdx.x;
  const int B = p.B;
  const float2* xr = p.x + c * p.ldx;
  float* orow = p.out + c * B;
  const int mode = __ldg(p.mode + c * p.lm);
  const bool is_am = mode == p.m_am, is_fm = mode == p.m_fm;
  const bool is_ext = p.ext != nullptr && mode == p.m_ext;
  const float* er = is_ext ? p.ext + c * p.lde : nullptr;
  const float g_ssb = __ldg(p.ssb_gain), g_am = __ldg(p.am_gain);
  const float a_am = __ldg(p.am_a), g_fm = __ldg(p.fm_gain);
  const float a_fm = __ldg(p.fm_a), b_fm = __ldg(p.fm_b);
  const bool xvec = aligned16(xr), ovec = aligned16(orow);
  const bool evec = is_ext && aligned16(er);

  // a^8 (a chunk), a^(8 lane) (the chunks before this lane in its warp)
  // and a^256 (a warp), made in float64 and rounded once
  double qa = 1.0, qf = 1.0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    qa *= a_am;
    qf *= a_fm;
  }
  const float a8a = (float)qa, a8f = (float)qf;
  double pa = 1.0, pf = 1.0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (lane & (1 << i)) {
      pa *= qa;
      pf *= qf;
    }
    qa *= qa;
    qf *= qf;
  }
  const float la = (float)pa, lf = (float)pf, wa = (float)qa, wf = (float)qf;

  float ca = __ldg(p.am_y + c * p.s_amy);    // the carries into a pass
  float cf = __ldg(p.fm_y + c * p.s_fmy);
  const int pass_len = blockDim.x * kPer;
  for (int t0 = 0, pass = 0; t0 < B; t0 += pass_len, ++pass) {
    const int p0 = t0 + threadIdx.x * kPer;
    const int m = max(0, min(kPer, B - p0));
    float2 z[kPer];
    if (m == kPer && xvec) {
      const float4* q = reinterpret_cast<const float4*>(xr + p0);
#pragma unroll
      for (int h = 0; h < kPer / 2; ++h) {
        const float4 f = __ldg(q + h);
        z[2 * h] = make_float2(f.x, f.y);
        z[2 * h + 1] = make_float2(f.z, f.w);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        z[r] = r < m ? __ldg(xr + p0 + r) : make_float2(0.f, 0.f);
    }
    float o[kPer];                         // the EXT rows' audio, loaded
    if (is_ext) {                          // before the work that hides it
      if (m == kPer && evec) {
        const float4* q = reinterpret_cast<const float4*>(er + p0);
#pragma unroll
        for (int h = 0; h < kPer / 4; ++h) {
          const float4 f = __ldg(q + h);
          o[4 * h] = f.x;
          o[4 * h + 1] = f.y;
          o[4 * h + 2] = f.z;
          o[4 * h + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kPer; ++r) o[r] = r < m ? __ldg(er + p0 + r) : 0.f;
      }
    }
    float env[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) env[r] = hypotf(z[r].x, z[r].y);

    // the sample before the chunk and its envelope: the lane before's last,
    // the row's previous sample, or the carried state at the row's start
    float2 pz;
    float pe;
    pz.x = __shfl_up_sync(0xffffffffu, z[kPer - 1].x, 1);
    pz.y = __shfl_up_sync(0xffffffffu, z[kPer - 1].y, 1);
    pe = __shfl_up_sync(0xffffffffu, env[kPer - 1], 1);
    if (lane == 0) {
      if (p0 == 0) {
        pz = __ldg(p.fm_p + c * p.s_fmp);
        pe = __ldg(p.am_x + c * p.s_amx);
      } else if (p0 < B) {
        pz = __ldg(xr + p0 - 1);
        pe = hypotf(pz.x, pz.y);
      }
    }

    // the recurrences' inputs, as the plain version rounds them, and each
    // chunk's sums from zero
    float ua[kPer], uf[kPer];
    float ea = 0.f, ef = 0.f;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      ua[r] = __fsub_rn(env[r], pe);
      const float dr = __fadd_rn(__fmul_rn(z[r].x, pz.x),
                                 __fmul_rn(z[r].y, pz.y));
      const float di = __fsub_rn(__fmul_rn(z[r].y, pz.x),
                                 __fmul_rn(z[r].x, pz.y));
      const float mag2 = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
      const float disc = mag2 > kGate2 ? atan2f(di, dr) : 0.f;
      uf[r] = __fmul_rn(b_fm, __fmul_rn(disc, g_fm));
      if (r < m) {
        ea = fmaf(a_am, ea, ua[r]);
        ef = fmaf(a_fm, ef, uf[r]);
      }
      pz = z[r];
      pe = env[r];
    }

    // inclusive scan of the chunk sums across the warp, then the warps
    float sa = ea, sf = ef, qa = a8a, qf = a8f;     // q: a^(8d)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float oa = __shfl_up_sync(0xffffffffu, sa, d);
      const float of = __shfl_up_sync(0xffffffffu, sf, d);
      if (lane >= d) {
        sa = fmaf(qa, oa, sa);
        sf = fmaf(qf, of, sf);
      }
      qa *= qa;
      qf *= qf;
    }
    float xa = __shfl_up_sync(0xffffffffu, sa, 1);   // lanes before
    float xf = __shfl_up_sync(0xffffffffu, sf, 1);
    if (lane == 0) xa = xf = 0.f;
    if (lane == 31) {
      slots[pass & 1][0][warp] = sa;
      slots[pass & 1][1][warp] = sf;
    }
    __syncthreads();
    float ya = ca, yf = cf;                 // into this warp, then the pass
    for (int w = 0; w < nwarps; ++w) {
      if (w == warp) {
        ca = ya;
        cf = yf;
      }
      ya = fmaf(wa, ya, slots[pass & 1][0][w]);
      yf = fmaf(wf, yf, slots[pass & 1][1][w]);
    }
    float ra = fmaf(la, ca, xa);             // the carry into this chunk
    float rf = fmaf(lf, cf, xf);
    ca = ya;                                 // the carry into the next pass
    cf = yf;

    // the chunk again from its carry; the selection; the state
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      ra = fmaf(a_am, ra, ua[r]);
      rf = fmaf(a_fm, rf, uf[r]);
      if (!is_ext)
        o[r] = is_am ? __fmul_rn(g_am, ra)
                     : is_fm ? rf : __fmul_rn(g_ssb, z[r].x);
      if (p0 + r == B - 1) {
        const int C = p.C;
        p.st[2 * c] = z[r].x;
        p.st[2 * c + 1] = z[r].y;
        p.st[2 * C + c] = env[r];
        p.st[3 * C + c] = ra;
        p.st[4 * C + c] = rf;
      }
    }
    if (m == kPer && ovec) {
      float4* q = reinterpret_cast<float4*>(orow + p0);
#pragma unroll
      for (int h = 0; h < kPer / 4; ++h)
        q[h] = make_float4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (r < m) orow[p0 + r] = o[r];
    }
  }
}

}  // namespace

// x [C, B] complex64 (row r at x + r*ldx complex samples, its samples
// contiguous, any alignment); mode [C] int32 (element r at mode + r*lm);
// am_x, am_y, fm_y [C] float32 and fm_p [C] complex64 (element r at r times
// its stride); ext [C, B] float32 (row r at ext + r*lde, its samples
// contiguous) or null; the six parameters 0-dim float32 on the card; out
// [C, B] float32 and st [5C] float32, contiguous.  Rows whose mode is m_am
// take AM, m_fm FM, m_ext (with ext) the EXT audio, every other SSB.
// Launches on ``stream``; returns kErrBadShape for a shape the kernel cannot
// take, else the CUDA error of the launch (0 on success).
extern "C" int mixed_demod(const void* x, long long ldx, const void* mode,
                           long long lm, const void* am_x, long long s_amx,
                           const void* am_y, long long s_amy,
                           const void* fm_p, long long s_fmp,
                           const void* fm_y, long long s_fmy,
                           const void* ext, long long lde,
                           const void* ssb_gain, const void* am_gain,
                           const void* am_a, const void* fm_gain,
                           const void* fm_a, const void* fm_b, void* out,
                           void* st, int C, int B, int m_am, int m_fm,
                           int m_ext, void* stream) {
  if (C < 1 || B < 1 || B > (1 << 30) || (C > 1 && ldx < B) ||
      (ext != nullptr && C > 1 && lde < B))
    return kErrBadShape;
  const int chunks = (B + kPer - 1) / kPer;
  const int warps = min(kMaxWarps, (chunks + 31) / 32);
  Args a;
  a.x = (const float2*)x;
  a.ldx = ldx;
  a.mode = (const int*)mode;
  a.lm = lm;
  a.am_x = (const float*)am_x;
  a.s_amx = s_amx;
  a.am_y = (const float*)am_y;
  a.s_amy = s_amy;
  a.fm_p = (const float2*)fm_p;
  a.s_fmp = s_fmp;
  a.fm_y = (const float*)fm_y;
  a.s_fmy = s_fmy;
  a.ext = (const float*)ext;
  a.lde = lde;
  a.ssb_gain = (const float*)ssb_gain;
  a.am_gain = (const float*)am_gain;
  a.am_a = (const float*)am_a;
  a.fm_gain = (const float*)fm_gain;
  a.fm_a = (const float*)fm_a;
  a.fm_b = (const float*)fm_b;
  a.out = (float*)out;
  a.st = (float*)st;
  a.B = B;
  a.C = C;
  a.m_am = m_am;
  a.m_fm = m_fm;
  a.m_ext = ext != nullptr ? m_ext : -1;
  mixed_demod_kernel<<<C, warps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
