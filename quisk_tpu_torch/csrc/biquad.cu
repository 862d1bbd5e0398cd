// The second-order IIR section of the receive chain (ops/iir.py Biquad,
// the CTCSS notch of PLLFMDemod), one block of audio in one pass: direct
// form I in float64, one thread a channel.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence with
// lax.associative_scan over 2x2 affine maps in float32 (quisk_tpu/ops/iir.py
// Biquad), and the port's plain version runs the same log-step scan in
// float64 as torch ops (Biquad.plain: at B = 2048 eleven rounds, each a
// K = 2 float64 GEMM and a concatenation that rewrite the [C, B, 2] carry,
// ~100 launches that move several GB at [8192, 2048]).  Per channel row,
// with the state x[-1], x[-2], y[-1], y[-2] carried from the last block:
//
//   f[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2]
//   t[n] = f[n] - a2 y[n-2]
//   y[n] = t[n] - a1 y[n-1]
//
// every term in float64 (the five coefficients are float32 on the card,
// read by pointer and widened once); y and the new state are rounded to
// float32 once each.  A float32 recurrence of this pole pair (r ~ 0.9987 for
// the 100 Hz, q = 5 notch at 48 kS/s) loses every digit, so no step here
// is narrower than float64.  t[n] needs y[n-2] only, so it is ready a step
// ahead and the dependent chain is one DFMA a sample.
//
// What bounds it on an H100: the bytes.  A row reads B samples and writes
// B: at [8192, 2048] 134.2 MB = 0.040 ms at 3.35 TB/s, against 9 float64
// operations a sample (0.15 GFLOP).  What the design does about it: a block
// is one warp that owns 32 channels, a lane a channel, so the recurrence
// runs in registers with no exchange between threads, and the card holds
// C / 32 warps.  The warp streams its rows through a ring of kStages
// shared tiles of 64 samples, kStages - 1 in flight with cp.async while it
// steps the one that landed (16-byte copies where the rows allow, each
// warp copy two rows' contiguous 256 bytes), writes y over x in place and
// stores the tile with the same coalesced 16-byte pattern.  A lane steps
// its row 16 samples at a time: four 16-byte shared loads, the 16
// feedforward sums (independent of one another, so they overlap), then the
// chain, in which t[n+1] issues beside y[n] and each step waits on one
// DFMA, then four 16-byte shared stores.  A shared row is 68 floats, so the
// eight lanes of a quarter warp loading 16 bytes each from eight rows hit
// 32 distinct banks.  Shared memory: 5 * 32 * 68 floats = 43 520 bytes,
// under the 48 KB a block gets without opting in.  A partial last tile, B =
// 1 and rows that are not 16-byte aligned take the edge path: 4-byte copies
// for what 16-byte ones cannot move, and a sample at a time past the last
// whole group.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;               // a block: one warp
constexpr int kRows = 32;                  // channels a block: a lane each
constexpr int kTile = 64;                  // samples a tile
constexpr int kPitch = kTile + 4;          // floats a shared row (mod 32: 4)
constexpr int kStages = 5;                 // tiles of the shared ring
constexpr int kGroup = 16;                 // samples a chain step group
constexpr int kErrBadShape = -1;

struct Args {
  const float* x;                          // [C, B], row r at x + r*ldx
  long long ldx;
  const float* st[4];                      // x1, x2, y1, y2: [C] each,
  long long sts[4];                        // element r at st[k] + r*sts[k]
  const float* coef[5];                    // b0, b1, b2, a1, a2: 0-dim each
  float* y;                                // [C, B] contiguous
  float* st_out;                           // [4, C] contiguous
  int C;
  int B;
};

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
// Wait until tile k has landed: the kStages - 1 newer groups may fly on.
__device__ __forceinline__ void copies_wait_tile() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// The edge path, for a partial last tile or rows that are not 16-byte
// aligned: samples [t0, t0 + m) of the block's rows, 16 bytes a copy where
// vec, and the rest one sample a copy.
__device__ __forceinline__ void load_edge(float* tile, const Args& a, int c0,
                                          int nrows, long long t0, int m,
                                          bool vec) {
  const float* x = a.x + c0 * a.ldx + t0;
  const int m4 = vec ? m / 4 : 0;
  for (int i = threadIdx.x; i < nrows * m4; i += kThreads) {
    const int r = i / m4, q = i % m4;
    copy16_async(tile + r * kPitch + 4 * q, x + r * a.ldx + 4 * q);
  }
  for (int r = 0; r < nrows; ++r)
    for (int n = 4 * m4 + (int)threadIdx.x; n < m; n += kThreads)
      copy4_async(tile + r * kPitch + n, x + r * a.ldx + n);
}

__device__ __forceinline__ void store_edge(const float* tile, const Args& a,
                                           int c0, int nrows, long long t0,
                                           int m, bool vec) {
  const long long B = a.B;
  float* y = a.y + c0 * B + t0;
  const int m4 = vec ? m / 4 : 0;
  for (int i = threadIdx.x; i < nrows * m4; i += kThreads) {
    const int r = i / m4, q = i % m4;
    *reinterpret_cast<float4*>(y + r * B + 4 * q) =
        *reinterpret_cast<const float4*>(tile + r * kPitch + 4 * q);
  }
  for (int r = 0; r < nrows; ++r)
    for (int n = 4 * m4 + (int)threadIdx.x; n < m; n += kThreads)
      y[r * B + n] = tile[r * kPitch + n];
}

struct Section {
  double b0, b1, b2, na1, na2;             // the coefficients, a's negated
  double x1, x2, y1, y2;                   // the state, widened

  // n samples of a row in place (n <= kGroup): the feedforward sums of all
  // of them first, independent of one another, then the chain, where
  // t[j+1] = f[j+1] - a2 y[j-1] issues beside y[j] = t[j] - a1 y[j-1], so
  // each step waits on one DFMA; then the roundings to float32.
  // p is 16-byte aligned where n is a multiple of 4 (4 samples a load).
  template <int n>
  __device__ __forceinline__ void steps(float* p) {
    float v[n];
    double f[n];
#pragma unroll
    for (int j = 0; j < n; j += 4) {
      if constexpr (n % 4 == 0) {
        const float4 w = *reinterpret_cast<const float4*>(p + j);
        v[j] = w.x;
        v[j + 1] = w.y;
        v[j + 2] = w.z;
        v[j + 3] = w.w;
      } else {
        for (int i = j; i < n && i < j + 4; ++i) v[i] = p[i];
      }
    }
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const double xd = (double)v[j];
      f[j] = fma(b2, x2, fma(b1, x1, b0 * xd));
      x2 = x1;
      x1 = xd;
    }
    double t = fma(na2, y2, f[0]);
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const double yn = fma(na1, y1, t);
      if (j + 1 < n) t = fma(na2, y1, f[j + 1]);
      y2 = y1;
      y1 = yn;
      f[j] = yn;
    }
#pragma unroll
    for (int j = 0; j < n; j += 4) {
      if constexpr (n % 4 == 0) {
        *reinterpret_cast<float4*>(p + j) =
            make_float4((float)f[j], (float)f[j + 1], (float)f[j + 2],
                        (float)f[j + 3]);
      } else {
        for (int i = j; i < n && i < j + 4; ++i) p[i] = (float)f[i];
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads) biquad_df1_kernel(const Args a) {
  extern __shared__ __align__(16) float ring[];   // kStages tiles
  constexpr int kQ = kTile / 4;            // float4s a tile row
  constexpr int kRowStep = kThreads / kQ;  // rows a warp's vector copy spans
  static_assert(kThreads % kQ == 0 && kRows % kRowStep == 0, "tile shape");
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.C - c0);
  const int c = c0 + lane;
  const bool live = lane < nrows;
  const int B = a.B;
  const int ntiles = (B + kTile - 1) / kTile;
  const bool vin = ((reinterpret_cast<uintptr_t>(a.x) & 15) == 0) &&
                   (a.ldx % 4 == 0 || a.C == 1);
  const bool vout = ((reinterpret_cast<uintptr_t>(a.y) & 15) == 0) &&
                    B % 4 == 0;
  // a lane's place in a whole tile's vector copies: float4 q of rows r0,
  // r0 + kRowStep, ...
  const int q = lane % kQ, r0 = lane / kQ;
  const float* xl = a.x + (c0 + r0) * a.ldx + 4 * q;
  float* yl = a.y + (c0 + r0) * (long long)B + 4 * q;
  float* sl = ring + r0 * kPitch + 4 * q;

  auto load = [&](int k) {                 // start tile k's copies
    float* tile = ring + (k % kStages) * kRows * kPitch;
    const long long t0 = (long long)k * kTile;
    const int m = min(kTile, B - k * kTile);
    if (vin && m == kTile) {
#pragma unroll
      for (int j = 0; j < kRows / kRowStep; ++j)
        if (r0 + j * kRowStep < nrows)
          copy16_async(sl + (tile - ring) + j * kRowStep * kPitch,
                       xl + j * kRowStep * a.ldx + t0);
    } else {
      load_edge(tile, a, c0, nrows, t0, m, vin);
    }
    copies_commit();                       // one group a tile
  };

  Section s;
  s.b0 = (double)__ldg(a.coef[0]);
  s.b1 = (double)__ldg(a.coef[1]);
  s.b2 = (double)__ldg(a.coef[2]);
  s.na1 = -(double)__ldg(a.coef[3]);
  s.na2 = -(double)__ldg(a.coef[4]);
  s.x1 = s.x2 = s.y1 = s.y2 = 0.0;
  if (live) {
    s.x1 = (double)__ldg(a.st[0] + c * a.sts[0]);
    s.x2 = (double)__ldg(a.st[1] + c * a.sts[1]);
    s.y1 = (double)__ldg(a.st[2] + c * a.sts[2]);
    s.y2 = (double)__ldg(a.st[3] + c * a.sts[3]);
  }

  for (int k = 0; k < kStages - 1; ++k) {  // the ring's first tiles
    if (k < ntiles)
      load(k);
    else
      copies_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    const int kn = k + kStages - 1;        // into the slot tile k-1 left
    if (kn < ntiles)
      load(kn);
    else
      copies_commit();
    copies_wait_tile();
    __syncwarp();
    float* tile = ring + (k % kStages) * kRows * kPitch;
    float* row = tile + lane * kPitch;
    const long long t0 = (long long)k * kTile;
    const int m = min(kTile, B - k * kTile);
    if (live) {
      if (m == kTile) {
#pragma unroll
        for (int g = 0; g < kTile; g += kGroup) s.steps<kGroup>(row + g);
      } else {
        int g = 0;
        for (; g + kGroup <= m; g += kGroup) s.steps<kGroup>(row + g);
        for (; g < m; ++g) s.steps<1>(row + g);
      }
    }
    __syncwarp();
    if (vout && m == kTile) {
#pragma unroll
      for (int j = 0; j < kRows / kRowStep; ++j)
        if (r0 + j * kRowStep < nrows)
          *reinterpret_cast<float4*>(yl + j * kRowStep * (long long)B + t0) =
              *reinterpret_cast<const float4*>(sl + (tile - ring) +
                                               j * kRowStep * kPitch);
    } else {
      store_edge(tile, a, c0, nrows, t0, m, vout);
    }
    __syncwarp();
  }

  if (live) {
    a.st_out[c] = (float)s.x1;
    a.st_out[a.C + c] = (float)s.x2;
    a.st_out[2 * a.C + c] = (float)s.y1;
    a.st_out[3 * a.C + c] = (float)s.y2;
  }
}

}  // namespace

// x [C, B] float32 (row r at x + r*ldx, its samples contiguous, any
// alignment); x1, x2, y1, y2 [C] float32 (element r at p + r*stride);
// b0, b1, b2, a1, a2 0-dim float32 on the card; y [C, B] and st_out [4, C]
// (x1', x2', y1', y2') float32, contiguous.  Launches on ``stream``;
// returns kErrBadShape for a shape the kernel cannot take, else the CUDA
// error of the launch (0 on success).
extern "C" int biquad_df1(const void* x, long long ldx, const void* x1,
                          long long s1, const void* x2, long long s2,
                          const void* y1, long long s3, const void* y2,
                          long long s4, const void* b0, const void* b1,
                          const void* b2, const void* a1, const void* a2,
                          void* y, void* st_out, int C, int B,
                          void* stream) {
  if (C < 1 || B < 1 || ldx < 0) return kErrBadShape;
  Args args;
  args.x = (const float*)x;
  args.ldx = ldx;
  const void* st[4] = {x1, x2, y1, y2};
  const long long sts[4] = {s1, s2, s3, s4};
  for (int k = 0; k < 4; ++k) {
    args.st[k] = (const float*)st[k];
    args.sts[k] = sts[k];
  }
  const void* coef[5] = {b0, b1, b2, a1, a2};
  for (int k = 0; k < 5; ++k) args.coef[k] = (const float*)coef[k];
  args.y = (float*)y;
  args.st_out = (float*)st_out;
  args.C = C;
  args.B = B;
  const size_t bytes = (size_t)kStages * kRows * kPitch * sizeof(float);
  biquad_df1_kernel<<<(C + kRows - 1) / kRows, kThreads, bytes,
                      (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
