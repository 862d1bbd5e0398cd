// Polyphase branch sums of the PFB channelizers: one kernel template, two
// launchers (2x-oversampled and critically sampled).
//
// Replaces the Pallas TPU kernels of quisk_tpu/ops/pallas_kernels.py
// _pfb_poly_kernel (via pfb_poly_oversampled) and _pfb_poly_crit_kernel (via
// pfb_poly_critical).  With ext = [hist | x] cut into frames of Mf = K/HOP
// samples, G[f, q] = ext[f*Mf + q] (HOP = 2: half-frames, hop K/2; HOP = 1:
// whole frames), output frame m and output lane j:
//
//   kk = K-1-j,  hh = kk / Mf,  q = kk % Mf
//   v[m, j] = sum_{p<P} G[m + HOP*p + hh, q] * h_poly[P-1-p, j]
//
// on the real and on the imaginary plane.  That is the TPU kernel's
// v[m, hh*Mf + q] = sum_p G[m + HOP*p + hh, q] * hrev[p, hh*Mf + q] with
// hrev = h_poly[::-1, ::-1] and with the caller's trailing lane reversal
// (the commutator's K-1-q flip) folded into the indexing.  hist holds the
// HOP*P - 1 frames ahead of x, so frame f comes from hist when f < HOP*P-1
// and from x otherwise: both interleaved complex64 buffers are read as they
// lie (no concat, no re/im split).  The output is [S, n_out, 2, K] float32:
// per frame the real row, then the imaginary row, which is at once the
// (re, im) plane pair the cross-branch IDFT takes and the [ar; ai] stack
// the receiver's stage-1 product takes.
//
// What bounds it on an H100: bytes.  At the receiver's shape (K=4096,
// n_out=16384, P=8) it reads 268.7 MB and writes 536.9 MB (0.24 ms at
// 3.35 TB/s) against 2.1 GFLOP of fp32 FMA (0.03 ms).
//
// What the design does about it: the TPU kernel's tile-plus-successor pair
// and the pad to whole tiles exist because a VMEM block cannot be sliced
// across tiles; here a thread owns one output lane j and walks a tile of
// frames down its column.  It keeps the HOP*P frames its next outputs need
// in a register ring (the loop is unrolled by the ring length, so every
// ring index is static), loads each input sample once per tile, coalesced
// across the warp (consecutive j are consecutive q, descending), and keeps
// its P taps in registers.  Tiles re-read HOP*(P-1) frames of their
// neighbour (11% at a tile of 128), which the L2 mostly absorbs.  Other
// tap counts than 8 take a plain loop over p with the same indexing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;             // frames a thread walks
constexpr int kErrBadShape = -1;

struct Column {
  const float2* hist;                  // this lane's column of the history
  const float2* x;                     // and of the block
  int hist_frames;
  size_t stride;                       // Mf
  __device__ float2 frame(int f) const {
    return f < hist_frames ? hist[(size_t)f * stride]
                           : x[(size_t)(f - hist_frames) * stride];
  }
};

__device__ Column column_of(const float2* hist, const float2* x, long long B,
                            int K, int P, int HOP, int j, int s, int* hh) {
  const int Mf = K / HOP;
  const int kk = K - 1 - j;
  *hh = kk / Mf;
  const int q = kk - *hh * Mf;
  const int hist_frames = HOP * P - 1;
  return Column{hist + (size_t)s * hist_frames * Mf + q,
                x + (size_t)s * (size_t)B + q, hist_frames, (size_t)Mf};
}

template <int P, int HOP>
__global__ void __launch_bounds__(kThreads)
pfb_poly_ring(const float2* __restrict__ hist, const float2* __restrict__ x,
              const float* __restrict__ h_poly, float* __restrict__ out,
              long long B, int K, int n_out) {
  constexpr int R = HOP * P;           // ring length
  constexpr int AHEAD = HOP * (P - 1); // newest frame of an output
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= K) return;
  const int s = blockIdx.z;
  int hh;
  const Column col = column_of(hist, x, B, K, P, HOP, j, s, &hh);
  float taps[P];
#pragma unroll
  for (int p = 0; p < P; ++p) taps[p] = h_poly[(size_t)(P - 1 - p) * K + j];

  const int m0 = blockIdx.y * kTile;
  const int m1 = min(m0 + kTile, n_out);
  float2 w[R];                         // slot (u + i) % R: frame m + hh + i
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) w[i] = col.frame(m0 + hh + i);
  float* o = out + (size_t)s * n_out * 2 * K + j;
  for (int mb = m0; mb < m1; mb += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int m = mb + u;
      if (m < m1) {
        w[(u + AHEAD) % R] = col.frame(m + hh + AHEAD);
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float2 g = w[(u + HOP * p) % R];
          ar = fmaf(g.x, taps[p], ar);
          ai = fmaf(g.y, taps[p], ai);
        }
        o[((size_t)m * 2) * K] = ar;
        o[((size_t)m * 2 + 1) * K] = ai;
      }
    }
  }
}

// Any tap count: every term from memory (the L1 holds a thread's column).
__global__ void __launch_bounds__(kThreads)
pfb_poly_any(const float2* __restrict__ hist, const float2* __restrict__ x,
             const float* __restrict__ h_poly, float* __restrict__ out,
             long long B, int K, int n_out, int P, int HOP) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= K) return;
  const int s = blockIdx.z;
  int hh;
  const Column col = column_of(hist, x, B, K, P, HOP, j, s, &hh);
  const int m0 = blockIdx.y * kTile;
  const int m1 = min(m0 + kTile, n_out);
  float* o = out + (size_t)s * n_out * 2 * K + j;
  for (int m = m0; m < m1; ++m) {
    float ar = 0.f, ai = 0.f;
    for (int p = 0; p < P; ++p) {
      const float2 g = col.frame(m + hh + HOP * p);
      const float t = h_poly[(size_t)(P - 1 - p) * K + j];
      ar = fmaf(g.x, t, ar);
      ai = fmaf(g.y, t, ai);
    }
    o[((size_t)m * 2) * K] = ar;
    o[((size_t)m * 2 + 1) * K] = ai;
  }
}

template <int HOP>
int launch(const void* hist, const void* x, const void* h_poly, void* out,
           int S, long long B, int K, int P, void* stream) {
  if (S < 1 || K < HOP || K % HOP || P < 1 || B < 1 || B % (K / HOP))
    return kErrBadShape;
  const long long n_out = B / (K / HOP);
  const long long tiles = (n_out + kTile - 1) / kTile;
  if (tiles > 65535 || S > 65535 || n_out > 0x7fffff00LL) return kErrBadShape;
  const dim3 grid((K + kThreads - 1) / kThreads, (unsigned)tiles, S);
  const cudaStream_t st = (cudaStream_t)stream;
  if (P == 8)
    pfb_poly_ring<8, HOP><<<grid, kThreads, 0, st>>>(
        (const float2*)hist, (const float2*)x, (const float*)h_poly,
        (float*)out, B, K, (int)n_out);
  else
    pfb_poly_any<<<grid, kThreads, 0, st>>>(
        (const float2*)hist, (const float2*)x, (const float*)h_poly,
        (float*)out, B, K, (int)n_out, P, HOP);
  return (int)cudaGetLastError();
}

}  // namespace

// hist [S, (2P-1)*K/2] and x [S, B] complex64, h_poly [P, K] float32 (not
// reversed), out [S, 2B/K, 2, K] float32; K even, B a multiple of K/2.
extern "C" int pfb_poly_oversampled(const void* hist, const void* x,
                                    const void* h_poly, void* out, int S,
                                    long long B, int K, int P, void* stream) {
  return launch<2>(hist, x, h_poly, out, S, B, K, P, stream);
}

// hist [S, (P-1)*K] and x [S, B] complex64, h_poly [P, K] float32, out
// [S, B/K, 2, K] float32; B a multiple of K.
extern "C" int pfb_poly_critical(const void* hist, const void* x,
                                 const void* h_poly, void* out, int S,
                                 long long B, int K, int P, void* stream) {
  return launch<1>(hist, x, h_poly, out, S, B, K, P, stream);
}
