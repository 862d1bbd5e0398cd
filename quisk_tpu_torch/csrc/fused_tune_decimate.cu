// Fused NCO mix + decimating FIR for the receive chain's front end.
//
// Replaces the Pallas TPU kernel quisk_tpu/ops/pallas_kernels.py
// _fused_kernel / _fused_call (plain mode, called through
// FusedTuneDecimate.__call__).  For channel c and output k:
//
//   tuned[n] = ext[n] * e^{-j theta[n]},  theta[n] = int32(phase0 + word*n) * 2pi/2^32
//   y[c, k]  = sum_{t<T} tuned[k*d + t] * h_rev[t]
//
// where ext = [hist (T-1 samples) | x (B samples)], read straight from the
// two interleaved complex64 buffers (no concat, no re/im split copies).
//
// What bounds it on an H100: the flagship shape (C=1024, B=40960, T=1421,
// d=20) needs 11.9 GFLOP of fp32 FMA per block against ~364 MB of device
// memory traffic, so FP32 FMA issue bounds it (0.18 ms at 67 TFLOP/s vs
// 0.11 ms of bytes at 3.35 TB/s).  TF32 is not allowed (the reference's
// dots are f32-exact), so the tensor cores are out.
//
// What the design does about it:
// - the direct polyphase dot: T MACs per output, not the TPU's banded
//   [128*d + T - 1, 128] matrix (2.8x the work, mostly zeros);
// - one thread block per (channel, tile of outputs); the tile's input
//   window is read once, coalesced, mixed as it is loaded (full-precision
//   sincosf) and stored to shared memory in polyphase order
//   win[p][j] = tuned[j*d + p], so for every tap the threads of a warp read
//   consecutive addresses (no bank conflicts) and the tap itself is a
//   broadcast;
// - each thread accumulates one complex output in registers.
// Inner loop per tap: one 8-byte shared load, one broadcast load, two FMAs
// — shared-memory issue, not FMA, is the limit of this simple form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32(2 pi / 2^32), rounded from the double value as the reference does
constexpr float kTwoPiOver2_32 = (float)(6.283185307179586 / 4294967296.0);

__global__ void fused_tune_decimate_kernel(
    const float2* __restrict__ x, const float2* __restrict__ hist,
    const long long* __restrict__ word, const long long* __restrict__ phase0,
    const float* __restrict__ h_rev, float2* __restrict__ y,
    int B, int T, int d, int N, int plen, int nq) {
  extern __shared__ float2 smem[];
  float2* win = smem;                                        // [d][plen]
  float* hp = reinterpret_cast<float*>(smem + (size_t)d * plen);  // [d][nq]

  const int c = blockIdx.y;
  const int tile = blockDim.x;
  const int k0 = blockIdx.x * tile;
  const int H = T - 1;
  const long long L = (long long)B + H;
  const long long n0 = (long long)k0 * d;
  const int W = tile * d + H;
  const uint32_t w = (uint32_t)word[c];
  const uint32_t p0 = (uint32_t)phase0[c];
  const float2* xc = x + (size_t)c * B;
  const float2* hc = hist + (size_t)c * H;

  // taps in polyphase order: hp[p][q] = h_rev[q*d + p] (zero past T)
  for (int i = threadIdx.x; i < d * nq; i += tile) {
    const int p = i / nq;
    const int t = (i - p * nq) * d + p;
    hp[i] = t < T ? h_rev[t] : 0.f;
  }
  // the mixed window, read in sample order (coalesced), stored polyphase
  for (int i = threadIdx.x; i < d * plen; i += tile) {
    const long long n = n0 + i;
    float2 v = make_float2(0.f, 0.f);
    if (i < W && n < L) {
      const float2 s = n < H ? hc[n] : xc[n - H];
      const uint32_t ph = p0 + w * (uint32_t)n;            // exact mod 2^32
      const float ang = (float)static_cast<int32_t>(ph) * kTwoPiOver2_32;
      float sn, cs;
      sincosf(ang, &sn, &cs);
      v.x = s.x * cs + s.y * sn;                           // s * conj(e^{j ang})
      v.y = s.y * cs - s.x * sn;
    }
    const int p = i % d;
    win[p * plen + i / d] = v;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k0 + k >= N) return;
  float ar = 0.f, ai = 0.f;
  for (int p = 0; p < d; ++p) {
    const float2* wp = win + p * plen + k;
    const float* hq = hp + p * nq;
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      const float h = hq[q];
      const float2 v = wp[q];
      ar = fmaf(v.x, h, ar);
      ai = fmaf(v.y, h, ai);
    }
  }
  y[(size_t)c * N + k0 + k] = make_float2(ar, ai);
}

// Shared memory bytes of one block: the polyphase window [d][plen] and the
// polyphase taps [d][nq]; an odd row length spreads the polyphase stores
// over the banks.
int smem_bytes(int nq, int d, int tile, int* plen) {
  *plen = (tile + nq - 1) | 1;
  return (int)(sizeof(float2) * (size_t)d * *plen +
               sizeof(float) * (size_t)d * nq);
}

constexpr int kMaxDevices = 64;

}  // namespace

// Returned when the taps at this decimation need more shared memory than
// one block has, at every tile.
constexpr int kErrTapsTooLong = -1;

// Launches on `stream` on the current device.  The tile (outputs per
// thread block) is 256 unless the device's shared memory or N say less.
// Returns kErrTapsTooLong, or cudaGetLastError() after the launch.
extern "C" int fused_tune_decimate(const void* x, const void* hist,
                                   const void* word, const void* phase0,
                                   const void* h_rev, void* y, int C, int B,
                                   int T, int d, void* stream) {
  static int smem_optin[kMaxDevices];  // per device; 0 = not read yet
  static int smem_set[kMaxDevices];    // largest attribute set so far
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem_optin[dev] == 0) {
    err = cudaDeviceGetAttribute(&smem_optin[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int N = B / d;
  const int nq = (T + d - 1) / d;
  int tile = 256, plen;
  while (tile > 32 && (smem_bytes(nq, d, tile, &plen) > smem_optin[dev] ||
                       tile / 2 >= N))
    tile /= 2;
  const int smem = smem_bytes(nq, d, tile, &plen);
  if (smem > smem_optin[dev]) return kErrTapsTooLong;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(fused_tune_decimate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const dim3 grid((N + tile - 1) / tile, C);
  fused_tune_decimate_kernel<<<grid, tile, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)hist, (const long long*)word,
      (const long long*)phase0, (const float*)h_rev, (float2*)y, B, T, d, N,
      plen, nq);
  return (int)cudaGetLastError();
}
