// Fused NCO mix + decimating FIR for the receive chain's front end, in
// three modes of one kernel template.
//
// Replaces the Pallas TPU kernel quisk_tpu/ops/pallas_kernels.py
// _fused_kernel / _fused_call in its plain mode
// (FusedTuneDecimate.__call__), its gained mode (__call__ with gain16) and
// its NB-detect mode (_nb_detect_in_kernel, FusedTuneDecimate.call_nb).
// For channel c and output k:
//
//   tuned[n] = g[n] * ext[n] * e^{-j theta[n]},
//   theta[n] = int32(phase0 + word*n) * 2pi/2^32
//   y[c, k]  = sum_{t<T} tuned[k*d + t] * h_rev[t]
//
// where ext = [hist (T-1 samples) | x (B samples)], read straight from the
// two interleaved complex64 buffers (no concat, no re/im split copies).
//
// g is 1 in the plain mode.  In the other two it is the noise blanker's
// gain on the stream's 16:1 coarse grid, linearly interpolated: ext sample
// n lies in coarse group gg = (n+off)/16 at offset p = (n+off)%16 with
// off = (-(T-1)) mod 16, and g[n] = G[gg]*(1-p/16) + G[gg+1]*(p/16).
// Groups below GH = (T-1+off)/16 cover the history.
// - gained: G is the caller's gain16 [C, GH + B/16], edge-replicated one
//   group past the end.
// - NB-detect: G is computed here from the raw samples (quisk.c:680 on the
//   coarse grid).  For x-group m (16 samples of x): S[m], X[m] = sum and
//   max of |x|; avg[m] = (S[m] + ... + S[m-W4+1]) / avg_win, reaching back
//   into the raw history (zeros before it); pulse[m] = X[m] > limit *
//   max(avg[m], 1e-12) for m in [0, B/16), else 0; pw[m] = sum_i rc[i] *
//   pulse[m+i-HC]; gain = 1 + on*(clip(1-pw, 0, 1) - 1).  History groups
//   take the caller's hist_gain [C, GH].  The gain of the block's B/16
//   groups is also written to gout (the next block's history gain).
//
// What bounds it on an H100: the flagship shape (C=1024, B=40960, T=1421,
// d=20) needs 11.9 GFLOP of fp32 FMA per block against ~364 MB of device
// memory traffic, so FP32 FMA issue bounds it (0.18 ms at 67 TFLOP/s vs
// 0.11 ms of bytes at 3.35 TB/s).  TF32 is not allowed (the reference's
// dots are f32-exact), so the tensor cores are out.  The detection adds
// about ten operations per input sample (0.4 GFLOP) and 2.7 MB of gout.
//
// What the design does about it:
// - the direct polyphase dot: T MACs per output, not the TPU's banded
//   [128*d + T - 1, 128] matrix (2.8x the work, mostly zeros);
// - one thread block per (channel, tile of outputs); the tile's input
//   window is read once, coalesced, scaled and mixed as it is loaded
//   (full-precision sincosf) and stored to shared memory in polyphase
//   order win[p][j] = tuned[j*d + p], so for every tap the threads of a
//   warp read consecutive addresses (no bank conflicts) and the tap itself
//   is a broadcast;
// - each thread accumulates one complex output in registers;
// - NB-detect: blocks share nothing, so each tile recomputes the group
//   statistics of its own halo (HC groups each way for the widening, W4
//   back for the average: about 15% more samples than its FIR window,
//   mostly L2 hits) with 16 lanes per group (coalesced 128-byte reads, a
//   shuffle tree for sum and max).  The arithmetic is a function of the
//   group alone, so neighbouring tiles get the same gain for a group they
//   both need.  Each tile writes the gout groups of its own tile*d input
//   samples (tile*d is a multiple of 16).
// Inner loop per tap: one 8-byte shared load, one broadcast load, two FMAs
// — shared-memory issue, not FMA, is the limit of this simple form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32(2 pi / 2^32), rounded from the double value as the reference does
constexpr float kTwoPiOver2_32 = (float)(6.283185307179586 / 4294967296.0);

enum Mode { kPlain = 0, kGained = 1, kNbDetect = 2 };

// What the gain modes need beyond the plain kernel's arguments.
struct GainArgs {
  const float* gin;    // gained: gain16 [C, GH+GB]; NB-detect: hist_gain [C, GH]
  const float* on;     // NB-detect: stage toggle [C]
  const float* limit;  // NB-detect: threshold, one float on the device
  const float* rc;     // NB-detect: coarse raised cosine [2*HC+1]
  float* gout;         // NB-detect: coarse gain out [C, GB]
  int HC;              // widening half-window in groups
  int W4;              // averaging window in groups
  float inv_avg;       // 1 / avg_win
  int ng;              // gain slab length (groups a window can touch)
};

template <int MODE>
__global__ void fused_tune_decimate_kernel(
    const float2* __restrict__ x, const float2* __restrict__ hist,
    const long long* __restrict__ word, const long long* __restrict__ phase0,
    const float* __restrict__ h_rev, float2* __restrict__ y,
    int B, int T, int d, int N, int plen, int nq, GainArgs ga) {
  extern __shared__ float2 smem[];
  float2* win = smem;                                        // [d][plen]
  float* hp = reinterpret_cast<float*>(smem + (size_t)d * plen);  // [d][nq]
  float* gs = hp + (size_t)d * nq;                           // [ng] gain slab
  float* S = gs + ga.ng;                                     // group sums
  float* X = S + (ga.ng + 2 * ga.HC + ga.W4);                // maxes, pulses

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
  const int off = (16 - (H & 15)) & 15;
  const int GH = (H + off) >> 4;
  const int GB = B >> 4;
  const int g_lo = (int)((n0 + off) >> 4);   // ext group of the slab's start

  // taps in polyphase order: hp[p][q] = h_rev[q*d + p] (zero past T)
  for (int i = threadIdx.x; i < d * nq; i += tile) {
    const int p = i / nq;
    const int t = (i - p * nq) * d + p;
    hp[i] = t < T ? h_rev[t] : 0.f;
  }

  if (MODE == kGained) {
    const float* gr = ga.gin + (size_t)c * (GH + GB);
    for (int i = threadIdx.x; i < ga.ng; i += tile)
      gs[i] = gr[min(g_lo + i, GH + GB - 1)];
    __syncthreads();
  }
  if (MODE == kNbDetect) {
    const int HC = ga.HC, W4 = ga.W4;
    // x-groups whose gain the slab needs, the pulses those need, and the
    // group sums the pulses' averages need (S index 0 is group sbase)
    const int mA = max(0, g_lo - GH);
    const int mB = min(GB, g_lo + ga.ng - 1 - GH);
    const int jlo = max(0, mA - HC);
    const int jhi = min(GB - 1, mB + HC);
    const int sbase = jlo - (W4 - 1);
    const int nst = jhi - sbase + 1;
    const int lane16 = threadIdx.x & 15;
    // 16 lanes per group, two groups per warp and step (warp-uniform trip
    // count: the shuffles need every lane)
    for (int r0 = (threadIdx.x >> 5) * 2; r0 < nst; r0 += tile >> 4) {
      const int r = r0 + ((threadIdx.x >> 4) & 1);
      float m = 0.f;
      if (r < nst) {
        const long long e = (long long)H + 16LL * (sbase + r) + lane16;
        if (e >= 0) {
          const float2 s = e < H ? hc[e] : xc[e - H];
          m = sqrtf(s.x * s.x + s.y * s.y);
        }
      }
      float sum = m, mx = m;
#pragma unroll
      for (int o = 8; o; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      if (r < nst && lane16 == 0) {
        S[r] = sum;
        X[r] = mx;
      }
    }
    __syncthreads();
    // pulses, written over the maxes (each thread reads only its own X)
    const float lim = *ga.limit;
    for (int r = threadIdx.x + (W4 - 1); r < nst; r += tile) {
      float acc = S[r];
      for (int k = 1; k < W4; ++k) acc += S[r - k];
      const float thr = lim * fmaxf(acc * ga.inv_avg, 1e-12f);
      X[r] = X[r] > thr ? 1.f : 0.f;
    }
    __syncthreads();
    const float on = ga.on[c];
    const float* hg = ga.gin + (size_t)c * GH;
    for (int i = threadIdx.x; i < ga.ng; i += tile) {
      const int gg = g_lo + i;
      float g = 1.f;
      if (gg < GH) {
        g = hg[gg];
      } else if (gg - GH <= GB) {
        const int m = gg - GH;
        float pw = 0.f;
        for (int t = 0; t <= 2 * HC; ++t) {
          const int j = m + t - HC;
          if (j >= jlo && j <= jhi) pw += ga.rc[t] * X[j - sbase];
        }
        g = fminf(fmaxf(1.f - pw, 0.f), 1.f);
        g = 1.f + on * (g - 1.f);
      }
      gs[i] = g;
    }
    __syncthreads();
    // the coarse gain of this tile's own input samples
    const int m0 = (int)(n0 >> 4);
    const int m1 = min(GB, m0 + ((tile * d) >> 4));
    float* go = ga.gout + (size_t)c * GB;
    for (int m = m0 + threadIdx.x; m < m1; m += tile)
      go[m] = gs[GH + m - g_lo];
  }

  // the scaled, mixed window, read in sample order (coalesced), stored
  // polyphase
  for (int i = threadIdx.x; i < d * plen; i += tile) {
    const long long n = n0 + i;
    float2 v = make_float2(0.f, 0.f);
    if (i < W && n < L) {
      float2 s = n < H ? hc[n] : xc[n - H];
      if (MODE != kPlain) {
        const int e = (int)(n + off);
        const float wq = (float)(e & 15) * 0.0625f;
        const float* gp = gs + ((e >> 4) - g_lo);
        const float g = gp[0] * (1.f - wq) + gp[1] * wq;
        s.x *= g;
        s.y *= g;
      }
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

// Shared memory bytes of one block: the polyphase window [d][plen], the
// polyphase taps [d][nq] and, in the gain modes, the gain slab (and the
// group statistics with their halo); an odd row length spreads the
// polyphase stores over the banks.  Sets *ng, the slab's length: a window
// of W samples touches at most (W+14)/16 + 1 groups, plus the next one.
int smem_bytes(int mode, int T, int nq, int d, int tile, int HC, int W4,
               int* plen, int* ng) {
  *plen = (tile + nq - 1) | 1;
  size_t floats = (size_t)d * nq;
  *ng = 0;
  if (mode != kPlain) {
    *ng = (tile * d + T - 1 + 14) / 16 + 2;
    floats += *ng;
  }
  if (mode == kNbDetect) floats += 2 * (size_t)(*ng + 2 * HC + W4);
  return (int)(sizeof(float2) * (size_t)d * *plen + sizeof(float) * floats);
}

constexpr int kMaxDevices = 64;

// Returned when the taps at this decimation need more shared memory than
// one block has, at every tile.
constexpr int kErrTapsTooLong = -1;

// Launches one mode on `stream` on the current device.  The tile (outputs
// per thread block) is 256 unless the device's shared memory or N say
// less.  Returns kErrTapsTooLong, or cudaGetLastError() after the launch.
template <int MODE>
int launch(const void* x, const void* hist, const void* word,
           const void* phase0, const void* h_rev, void* y, int C, int B,
           int T, int d, GainArgs ga, void* stream) {
  static int smem_optin[kMaxDevices];  // per device; 0 = not read yet
  // largest attribute set so far: the attribute belongs to the kernel
  // function, so each mode keeps its own
  static int smem_set[kMaxDevices];
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
  while (tile > 32 &&
         (smem_bytes(MODE, T, nq, d, tile, ga.HC, ga.W4, &plen, &ga.ng) >
              smem_optin[dev] ||
          tile / 2 >= N))
    tile /= 2;
  const int smem = smem_bytes(MODE, T, nq, d, tile, ga.HC, ga.W4, &plen,
                              &ga.ng);
  if (smem > smem_optin[dev]) return kErrTapsTooLong;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(fused_tune_decimate_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const dim3 grid((N + tile - 1) / tile, C);
  fused_tune_decimate_kernel<MODE><<<grid, tile, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)hist, (const long long*)word,
      (const long long*)phase0, (const float*)h_rev, (float2*)y, B, T, d, N,
      plen, nq, ga);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_tune_decimate(const void* x, const void* hist,
                                   const void* word, const void* phase0,
                                   const void* h_rev, void* y, int C, int B,
                                   int T, int d, void* stream) {
  return launch<kPlain>(x, hist, word, phase0, h_rev, y, C, B, T, d,
                        GainArgs{}, stream);
}

// gain16 [C, (T-1+off)/16 + B/16] float32; B must be a multiple of 16.
extern "C" int fused_tune_decimate_gained(const void* x, const void* hist,
                                          const void* word, const void* phase0,
                                          const void* h_rev, void* y,
                                          const void* gain16, int C, int B,
                                          int T, int d, void* stream) {
  GainArgs ga{};
  ga.gin = (const float*)gain16;
  return launch<kGained>(x, hist, word, phase0, h_rev, y, C, B, T, d, ga,
                         stream);
}

// hist_gain [C, (T-1+off)/16], on [C], limit [1], rc [2*HC+1], gout
// [C, B/16], all float32 on the device; B and avg_win multiples of 16.
extern "C" int fused_tune_decimate_nb(const void* x, const void* hist,
                                      const void* word, const void* phase0,
                                      const void* h_rev, void* y,
                                      const void* hist_gain, const void* on,
                                      const void* limit, const void* rc,
                                      void* gout, int HC, int avg_win, int C,
                                      int B, int T, int d, void* stream) {
  GainArgs ga{};
  ga.gin = (const float*)hist_gain;
  ga.on = (const float*)on;
  ga.limit = (const float*)limit;
  ga.rc = (const float*)rc;
  ga.gout = (float*)gout;
  ga.HC = HC;
  ga.W4 = avg_win / 16;
  ga.inv_avg = 1.f / (float)avg_win;
  return launch<kNbDetect>(x, hist, word, phase0, h_rev, y, C, B, T, d, ga,
                           stream);
}
