// The lookahead AGC of the receive chain (ops/agc.py AGC), one block of
// audio in one pass: the delay line, the lookahead window max, the gain
// limit, the release scan and the gain, one thread block a channel.
//
// Replaces no Pallas kernel: the JAX package computes this AGC with
// lax.associative_scan (quisk_tpu/ops/agc.py AGC.__call__), and so does the
// port's plain version, as torch ops (a concatenation, two cummaxes, four
// ops for the limit and an 11-round doubling scan at B = 2048: 78 launches
// that move ~9.6 GB at [8192, 2048]).  Per channel row, with W the lookahead
// and B the block:
//
//   ext   = [delay | a]                                   W + B samples
//   env   = max |ext[n .. n+W-1]|                          n < B
//   limit = min(log(target / max(env, 1e-9)), max_lgain)
//   lg[n] = min(lg[n-1] + inc, limit[n]),  lg[-1] = lg0
//   out   = ext[n] * exp(lg[n]);  delay' = ext[B .. B+W);  lg0' = lg[B-1]
//
// The recurrence is a composition of the counted maps (k, m): x ->
// min(x + k*inc, m), and the prefix of the first n+1 of them is
//   (n+1, n*inc + min over j <= n of (limit[j] - j*inc)),
// so the kernel scans u[j] = limit[j] - j*inc (one fma) with a plain prefix
// min, which is exact, and takes
//   lg[n] = min(lg0 + (n+1)*inc, n*inc + U[n])
// with one fma a term: each log gain lies two roundings from the exact
// recurrence's (the doubling's lies up to log2(B) + 1 roundings from it).
// The sequential recurrence lg += inc would drift ~1e-3 over 2048 samples
// at a log gain near 9; it is not used.
//
// The window max is the plain version's van Herk: segments of W from the
// start of ext, a suffix max and a prefix max within each, env[n] =
// max(suffix[n], prefix[n + W - 1]).  Max and min are exact, so env and the
// limit are the plain version's bits on the card; NaN passes through every
// max, min and clamp (max.NaN / min.NaN), as through torch's.  The divide
// is __fdiv_rn and logf / expf are the full-precision functions (the build
// has no --use_fast_math), as torch's on a CUDA tensor; 1e-9 is the float32
// of the double, as torch rounds a Python float.
//
// What bounds it on an H100: the bytes.  A row reads W + B samples and the
// log gain and writes B + W samples and the log gain: at [8192, 2048] and
// W = 720, 181.5 MB = 0.054 ms at 3.35 TB/s, against ~0.2 GFLOP.  What the
// design does about it: every sample is read from device memory once, into
// shared memory (16-byte loads where the rows allow), and every output
// written once; the three scans (suffix max, prefix max with the limit and
// u in its epilogue, prefix min with the gain and the output in its
// epilogue) run on shared memory, 8 consecutive positions a thread in
// registers, warp shuffles across a warp and one barrier across the block's
// 8 warps a 2048-position pass.  The shared arrays keep one spare float
// every 8 (sx), so a warp's threads, 8 positions apart, hit 32 distinct
// banks.  Shared memory: (2 (W+B) + 2 (W+B)/8) floats + 128 bytes, 25 KB at
// the flagship's W = 720, B = 2048.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // a block: one channel row
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // consecutive positions a thread
constexpr int kPass = kThreads * kPer;     // positions a scan pass covers
constexpr int kErrBadShape = -1;
constexpr int kErrSharedMemory = -2;
constexpr float kEnvFloor = (float)1e-9;   // torch's float32 of 1e-9

struct Args {
  const float* a;                          // [C, B], row r at a + r*lda
  long long lda;
  const float* delay;                      // [C, W], row r at delay + r*ldd
  long long ldd;
  const float* lg;                         // [C], lg[r*lgs]
  long long lgs;
  const float* target;                     // 0-dim each
  const float* max_lgain;
  const float* inc;
  float* out;                              // [C, B] contiguous
  float* delay_out;                        // [C, W] contiguous
  float* lg_out;                           // [C]
  int W;
  int B;
};

// A shared array's index of position i: one spare float every 8.
__device__ __forceinline__ int sx(int i) { return i + (i >> 3); }

__host__ __device__ inline int padded(int n) { return n + (n >> 3) + 1; }

__host__ inline size_t shared_bytes(int W, int B) {
  return 2 * kWarps * 8 + 2 * (size_t)padded(W + B) * sizeof(float);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float max_nan(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// An element of a segmented scan: the segment and the value.  A segment
// of -1 is the empty prefix, neutral on the left only.
struct Seg {
  int s;
  float v;
};

template <bool kMin>
__device__ __forceinline__ Seg combine(Seg x, Seg y) {  // x, then y
  const float m = kMin ? min_nan(x.v, y.v) : max_nan(x.v, y.v);
  return {y.s, x.s == y.s ? m : y.v};
}

__device__ __forceinline__ Seg shfl_up(Seg e, int d) {
  return {__shfl_up_sync(0xffffffffu, e.s, d),
          __shfl_up_sync(0xffffffffu, e.v, d)};
}

// Inclusive segmented scan (max, or min) over positions [0, n): thread t
// takes positions p0 .. p0+kPer-1, p0 = pass start + t*kPer.  load(p0, e,
// m) fills e[0 .. m) (m < kPer only in the last pass); put(p0, e, m) gets
// the inclusive results.  slots: 2*kWarps Seg of shared memory, alternated
// between passes so one barrier a pass suffices.
template <bool kMin, class Load, class Put>
__device__ __forceinline__ void block_scan(int n, Load load, Put put,
                                           Seg* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg carry{-1, 0.f};
  for (int t0 = 0, pass = 0; t0 < n; t0 += kPass, ++pass) {
    const int p0 = t0 + threadIdx.x * kPer;
    const int m = max(0, min(kPer, n - p0));
    Seg e[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) e[r] = Seg{-1, 0.f};
    load(p0, e, m);
#pragma unroll
    for (int r = 1; r < kPer; ++r) e[r] = combine<kMin>(e[r - 1], e[r]);
    Seg agg = e[kPer - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg o = shfl_up(agg, d);
      if (lane >= d) agg = combine<kMin>(o, agg);
    }
    const Seg pre = shfl_up(agg, 1);       // lanes before this one
    Seg* slot = slots + (pass & 1) * kWarps;
    if (lane == 31) slot[warp] = agg;
    __syncthreads();
    Seg before = carry;
    for (int w = 0; w < warp; ++w) before = combine<kMin>(before, slot[w]);
    Seg total = before;
    for (int w = warp; w < kWarps; ++w) total = combine<kMin>(total, slot[w]);
    if (lane > 0) before = combine<kMin>(before, pre);
#pragma unroll
    for (int r = 0; r < kPer; ++r) e[r] = combine<kMin>(before, e[r]);
    put(p0, e, m);
    carry = total;                         // used only after a full pass
  }
}

__global__ void __launch_bounds__(kThreads)
    agc_delay_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Seg* slots = reinterpret_cast<Seg*>(smem);
  const int W = a.W, B = a.B, L = W + B;
  float* X = reinterpret_cast<float*>(smem + 2 * kWarps * sizeof(Seg));
  float* S = X + padded(L);
  const long long c = blockIdx.x;
  const float* ar = a.a + c * a.lda;
  const float* dr = a.delay + c * a.ldd;

  // ext = [delay | a] into shared memory, read once
  if (W % 4 == 0 && aligned16(ar) && aligned16(dr)) {
    const int nq = L >> 2;
#pragma unroll 4
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const int i = 4 * q;
      const float4 f =
          i < W ? __ldg(reinterpret_cast<const float4*>(dr + i))
                : __ldg(reinterpret_cast<const float4*>(ar + (i - W)));
      X[sx(i)] = f.x;
      X[sx(i + 1)] = f.y;
      X[sx(i + 2)] = f.z;
      X[sx(i + 3)] = f.w;
    }
    for (int i = 4 * nq + threadIdx.x; i < L; i += kThreads)
      X[sx(i)] = __ldg(ar + (i - W));
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < L; i += kThreads)
      X[sx(i)] = __ldg(i < W ? dr + i : ar + (i - W));
  }
  const float target = __ldg(a.target), max_lgain = __ldg(a.max_lgain);
  const float inc = __ldg(a.inc), lg0 = __ldg(a.lg + c * a.lgs);
  __syncthreads();

  float* dout = a.delay_out + c * W;
  for (int j = threadIdx.x; j < W; j += kThreads) dout[j] = X[sx(B + j)];

  // suffix max of |ext| within each W-segment, scanned from the end
  block_scan<false>(
      L,
      [&](int p0, Seg(&e)[kPer], int m) {
        if (m <= 0) return;
        const int i0 = L - 1 - p0;
        int s = i0 / W, rem = i0 - s * W;
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          if (r < m) e[r] = Seg{s, fabsf(X[sx(i0 - r)])};
          if (rem == 0) {
            rem = W - 1;
            --s;
          } else {
            --rem;
          }
        }
      },
      [&](int p0, const Seg(&e)[kPer], int m) {
#pragma unroll
        for (int r = 0; r < kPer; ++r)
          if (r < m) S[sx(L - 1 - p0 - r)] = e[r].v;
      },
      slots);
  __syncthreads();

  // prefix max within each W-segment; at position i = n + W - 1 the window
  // of n is whole: env[n], the limit, and u[n] in place of suffix[n] (read
  // and written by this thread alone)
  block_scan<false>(
      L,
      [&](int p0, Seg(&e)[kPer], int m) {
        if (m <= 0) return;
        int s = p0 / W, rem = p0 - s * W;
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          if (r < m) e[r] = Seg{s, fabsf(X[sx(p0 + r)])};
          if (++rem == W) {
            rem = 0;
            ++s;
          }
        }
      },
      [&](int p0, const Seg(&e)[kPer], int m) {
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int n = p0 + r - (W - 1);
          if (r < m && n >= 0 && n < B) {
            const float env = max_nan(S[sx(n)], e[r].v);
            const float lim = min_nan(
                logf(__fdiv_rn(target, max_nan(env, kEnvFloor))), max_lgain);
            S[sx(n)] = fmaf(-(float)n, inc, lim);
          }
        }
      },
      slots);
  __syncthreads();

  // prefix min of u; the log gain, the gain and the output
  float* orow = a.out + c * B;
  const bool ovec = aligned16(orow);
  block_scan<true>(
      B,
      [&](int p0, Seg(&e)[kPer], int m) {
#pragma unroll
        for (int r = 0; r < kPer; ++r)
          if (r < m) e[r] = Seg{0, S[sx(p0 + r)]};
      },
      [&](int p0, const Seg(&e)[kPer], int m) {
        float y[kPer] = {};
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int n = p0 + r;
          if (r < m) {
            const float lg = min_nan(fmaf((float)(n + 1), inc, lg0),
                                     fmaf((float)n, inc, e[r].v));
            y[r] = X[sx(n)] * expf(lg);
            if (n == B - 1) a.lg_out[c] = lg;
          }
        }
        if (ovec && m == kPer) {
          float4* q = reinterpret_cast<float4*>(orow + p0);
          q[0] = make_float4(y[0], y[1], y[2], y[3]);
          q[1] = make_float4(y[4], y[5], y[6], y[7]);
        } else {
#pragma unroll
          for (int r = 0; r < kPer; ++r)
            if (r < m) orow[p0 + r] = y[r];
        }
      },
      slots);
}

}  // namespace

// a [C, B] float32 (row r at a + r*lda, its samples contiguous, any
// alignment), delay [C, W] float32 (row r at delay + r*ldd), lg [C]
// float32 (element r at lg + r*lgs), target / max_lgain / inc 0-dim
// float32 on the card; out [C, B], delay_out [C, W], lg_out [C] float32,
// contiguous.  Launches on ``stream``; returns kErrBadShape for a shape the
// kernel cannot take, kErrSharedMemory where (W, B) needs more shared
// memory than a block may have, else the CUDA error of the launch (0 on
// success).
extern "C" int agc_delay(const void* a, long long lda, const void* delay,
                         long long ldd, const void* lg, long long lgs,
                         const void* target, const void* max_lgain,
                         const void* inc, void* out, void* delay_out,
                         void* lg_out, int C, int W, int B, void* stream) {
  if (C < 1 || W < 1 || B < 1 || (long long)W + B > (1LL << 30) ||
      (C > 1 && (lda < B || ldd < W)))
    return kErrBadShape;
  const size_t bytes = shared_bytes(W, B);
  if (bytes > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (bytes > (size_t)optin) return kErrSharedMemory;
    e = cudaFuncSetAttribute(agc_delay_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  Args args;
  args.a = (const float*)a;
  args.lda = lda;
  args.delay = (const float*)delay;
  args.ldd = ldd;
  args.lg = (const float*)lg;
  args.lgs = lgs;
  args.target = (const float*)target;
  args.max_lgain = (const float*)max_lgain;
  args.inc = (const float*)inc;
  args.out = (float*)out;
  args.delay_out = (float*)delay_out;
  args.lg_out = (float*)lg_out;
  args.W = W;
  args.B = B;
  agc_delay_kernel<<<C, kThreads, bytes, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
