// The last stage of the transmit chain (tx/chain.py TxChain.place), one
// block of I/Q at the TX rate in one pass: Spot, the TX tune NCO and the TX
// I/Q balance trim.
//
// Replaces no Pallas kernel: the JAX package computes this stage with jnp
// ops (quisk_tpu/tx/chain.py TxChain.step), and so does the port's plain
// version, as torch ops (TxChain.place_plain with NCO.phasor: ~21 launches
// a block, among them an int64 phase ramp of four passes, each a [C, N]
// plane through device memory, ~6.5 GB at [8192, 4096]).  Per channel row
// c, with spot[c] < 0 meaning off, for each sample n of the N in the row:
//
//   p      = phase[c] + word[c] * n                  mod 2^32 (uint32)
//   ang    = float(p) * (2 pi / 2^32)                float32, one rounding
//   x      = spot[c] >= 0 ? (spot[c], 0) : iq[c, n]
//   y      = x * (cos ang, sin ang)
//   out    = (m00[c] Re y, m10[c] Re y + m11[c] Im y)
//   phase' = phase[c] + word[c] * N                  mod 2^32
//
// The word and phase ride as int64 holding uint32 values (ops/nco.py); the
// uint32 wrap of the kernel is the plain version's int64 `& MASK32`, so
// the phase is the plain version's bits.  The angle is its unsigned phase
// rounded to float32 (__uint2float_rn, as torch converts an int64 in
// [0, 2^32)) times the same float32 constant, the product rounded alone
// (__fmul_rn: nothing is contracted into it), so it is the plain version's
// bits too.  sincosf is the full-precision function (the build has no
// --use_fast_math), as torch's cos and sin on a CUDA tensor.  The complex
// product and the trim are rounded term by term (__f*_rn), as the separate
// torch ops round them.
//
// What bounds it on an H100: the bytes.  A row reads N complex samples and
// writes N: at [8192, 4096], 536.9 MB = 0.160 ms at 3.35 TB/s.
// Operations: one sincosf (~40 instructions on its fast path: the angle
// lies in [0, 2 pi)) and ~12 more a sample, 1.8 G = 0.027 ms at FP32's 67
// TFLOP/s.  What the design does about it: one launch, every sample read
// once and written once.  A thread takes kPer = 4 consecutive samples of a
// row in two 16-byte loads and two 16-byte stores (a scalar path where the
// row's tail or an odd row start leaves fewer or unaligned samples); a
// thread block covers kSpan samples of one row, so the row's six
// parameters are loaded once a thread from cache, and consecutive blocks
// cover consecutive memory.  The flat grid takes any C and any N.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                    // consecutive samples a thread
constexpr int kSpan = kThreads * kPer;     // samples a block covers
constexpr int kErrBadShape = -1;

struct Args {
  const float2* iq;                        // [C, N] contiguous
  const float* spot;                       // [C]
  const long long* word;                   // [C], uint32 values
  const long long* phase;                  // [C], uint32 values
  const float* m00;                        // [C] each
  const float* m10;
  const float* m11;
  float2* out;                             // [C, N] contiguous
  long long* next_phase;                   // [C]
  long long N;
  long long spans;                         // thread blocks a row
  float ang_scale;                         // float32 of 2 pi / 2^32
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads) tx_place_kernel(const Args a) {
  const long long c = blockIdx.x / a.spans;
  const long long n0 =
      (blockIdx.x - c * a.spans) * (long long)kSpan + threadIdx.x * kPer;
  const uint32_t w = (uint32_t)__ldg(a.word + c);
  const uint32_t ph = (uint32_t)__ldg(a.phase + c);
  if (n0 == 0)
    a.next_phase[c] = (long long)(uint32_t)(ph + w * (uint32_t)a.N);
  if (n0 >= a.N) return;
  const float sp = __ldg(a.spot + c);
  const float t00 = __ldg(a.m00 + c), t10 = __ldg(a.m10 + c);
  const float t11 = __ldg(a.m11 + c);
  const float2* in = a.iq + c * a.N + n0;
  float2* o = a.out + c * a.N + n0;
  const int m = (int)min((long long)kPer, a.N - n0);
  const bool vec = m == kPer && aligned16(in) && aligned16(o);

  float2 x[kPer];
  if (vec) {
    const float4 q0 = __ldcs(reinterpret_cast<const float4*>(in));
    const float4 q1 = __ldcs(reinterpret_cast<const float4*>(in) + 1);
    x[0] = make_float2(q0.x, q0.y);
    x[1] = make_float2(q0.z, q0.w);
    x[2] = make_float2(q1.x, q1.y);
    x[3] = make_float2(q1.z, q1.w);
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      x[r] = r < m ? __ldcs(in + r) : make_float2(0.f, 0.f);
  }

  float2 y[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const uint32_t p = ph + w * (uint32_t)(n0 + r);
    const float ang = __fmul_rn(__uint2float_rn(p), a.ang_scale);
    float s, co;
    sincosf(ang, &s, &co);
    const float xr = sp >= 0.f ? sp : x[r].x;
    const float xi = sp >= 0.f ? 0.f : x[r].y;
    const float yr = __fsub_rn(__fmul_rn(xr, co), __fmul_rn(xi, s));
    const float yi = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, co));
    y[r] = make_float2(__fmul_rn(t00, yr),
                       __fadd_rn(__fmul_rn(t10, yr), __fmul_rn(t11, yi)));
  }

  if (vec) {
    __stcs(reinterpret_cast<float4*>(o),
           make_float4(y[0].x, y[0].y, y[1].x, y[1].y));
    __stcs(reinterpret_cast<float4*>(o) + 1,
           make_float4(y[2].x, y[2].y, y[3].x, y[3].y));
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      if (r < m) __stcs(o + r, y[r]);
  }
}

}  // namespace

// iq [C, N] complex64 contiguous; spot, m00, m10, m11 [C] float32 (the
// chain's [C, 1] columns); word, phase [C] int64 holding uint32 values;
// out [C, N] complex64 and next_phase [C] int64, contiguous; ang_scale the
// float32 of 2 pi / 2^32.  Launches on ``stream``; returns kErrBadShape for
// a shape the grid cannot take, else the CUDA error of the launch (0 on
// success).
extern "C" int tx_place(const void* iq, const void* spot, const void* word,
                        const void* phase, const void* m00, const void* m10,
                        const void* m11, void* out, void* next_phase,
                        long long C, long long N, float ang_scale,
                        void* stream) {
  if (C < 1 || N < 1 || N > (1LL << 31) - kSpan) return kErrBadShape;
  const long long spans = (N + kSpan - 1) / kSpan;
  if (C > ((1LL << 31) - 1) / spans) return kErrBadShape;
  Args a;
  a.iq = (const float2*)iq;
  a.spot = (const float*)spot;
  a.word = (const long long*)word;
  a.phase = (const long long*)phase;
  a.m00 = (const float*)m00;
  a.m10 = (const float*)m10;
  a.m11 = (const float*)m11;
  a.out = (float2*)out;
  a.next_phase = (long long*)next_phase;
  a.N = N;
  a.spans = spans;
  a.ang_scale = ang_scale;
  tx_place_kernel<<<(unsigned)(C * spans), kThreads, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
