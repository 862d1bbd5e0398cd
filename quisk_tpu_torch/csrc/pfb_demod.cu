// Stage 2 of the PFB receiver's cross-branch IDFT fused with the per-channel
// demodulators and the power spectrum.
//
// Replaces the Pallas TPU kernel quisk_tpu/ops/pallas_kernels.py
// _pfb_demod_kernel (via pfb_demod_call).  K = K1*K2 channels, K2 = 128;
// the input bb [S, n_out*2*K1, K2] holds the stage-1 planes, rows ordered
// (t, re|im, c1), columns n2.  For frame t, c1 and c2 (channel c1 + K1*c2,
// written at position c1*K2 + c2 of its row):
//
//   c[n2]  = (br + j bi)[t, c1, n2] * tw[c1, n2] * (-1)^((t%2)*(c1%2))
//   z      = sum_n2 c[n2] * w2[n2, c2]             (128-point IDFT column;
//            the commutator rotation is folded into tw and w2)
//   SSB    a_ssb = g_ssb * Re z
//   AM     env = |z|,  y_dc[t] = a_dc*y_dc[t-1] + env[t] - env[t-1],
//          a_am = g_am * y_dc
//   FM     d = z[t] conj(z[t-1]),  disc = |d|^2 > 1e-24 ? atan2(Im d, Re d)
//          : 0,  y_de[t] = a_de*y_de[t-1] + (b_de*g_fm)*disc,  a_fm = y_de
//   audio  = a_ssb + is_am*(a_am - a_ssb) + is_fm*(a_fm - a_ssb)
//   spec   = sum_t |z|^2
//
// z[-1], env[-1], y_de[-1] and y_dc[-1] enter from st [S, 5*K1, K2] (rows
// zr, zi, y_de, env, y_dc, K1 each) and leave in st_out.  t counts within
// the call (n_out is even in the receiver, so blocks do not shift the
// parity).
//
// What bounds it on an H100: by bytes 0.24 ms at the receiver's shape
// (537 MB in, 268 MB out at 3.35 TB/s); the direct 128-point product is
// 68.7 GFLOP of fp32 (1.03 ms at 67 TFLOP/s), and the reference's numerics
// are f32-exact, so the tensor cores (TF32) are out.  As written the
// kernel is limited by the FP32 FMA rate and the shared-memory reads that
// feed it.
//
// What the design does about it.  The TPU grid walks time tiles in order
// and carries the one-pole and FM states through scratch memory, and runs
// the recurrences as triangular products on its matrix unit.  CUDA blocks
// share nothing and have no order, so a block owns one c1 and 32 of its c2
// for the whole call and walks time itself, 128 frames a tile: each of its
// 16 warps takes 8 consecutive frames, a lane one c2.
// - A warp reads its 8 input row pairs coalesced, twiddles and signs them
//   and stores them to shared memory as (re, im) of two frames per float4,
//   so that in the product every lane reads the same address (a broadcast)
//   and gets two frames per load; the w2 columns of the block's 32
//   channels sit in shared memory, one conflict-free 8-byte load per n2.
//   Per n2 a thread makes 5 shared loads for 32 FMAs into 16 accumulators.
// - The demodulators run on those accumulators in registers.  A warp gets
//   the frame before its first from the warp before it (or from the carry)
//   through shared memory, runs both one-poles over its 8 frames from a zero
//   state, and publishes each one's end value and decay a^8; after a
//   barrier every warp folds the carry through the warps before it
//   (y = y_local + a^(k+1) * carry_in), the chunked form of the
//   recurrence with a chunk of 8.  Two barriers per 128 frames.
// - The power sum is a per-thread accumulator, reduced across the 16 warps
//   once at the end; st_out is written by the thread that holds the last
//   frame.  No atomics: the result does not depend on scheduling.
// The 4 blocks of one c1 read the same input rows; the L2 serves the
// repeats.  Frames past n_out in the last tile are skipped step by step, so
// any n_out >= 1 is taken.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int K2 = 128;                // stage-2 length, columns of every row
constexpr int TT = 8;                  // frames per warp and tile
constexpr int NW = 16;                 // warps per block
constexpr int C2B = 32;                // channels (c2) per block: one a lane
constexpr int kThreads = NW * 32;
constexpr int kErrBadShape = -1;
constexpr int kMaxDevices = 64;

struct Smem {
  float2 w2[K2][C2B];                  // (w2r, w2i)[n2][c2 of this block]
  float4 cs[NW][TT / 2][K2];           // twiddled rows, two frames a float4
  float zlast[NW][3][C2B];             // zr, zi, env of a warp's last frame
  float pole[NW][4][C2B];              // e_dc, f_dc, e_de, f_de of a warp
  float pw[NW][C2B];                   // power partial sums
};

struct Params {
  const float* bb;
  const float* st;
  const float* twr;
  const float* twi;
  const float* w2r;
  const float* w2i;
  const float* am;
  const float* fm;
  float* audio;
  float* spec;
  float* st_out;
  int n_out, K1;
  float g_ssb, g_am, bg_fm, a_dc, a_de;
};

__global__ void __launch_bounds__(kThreads, 1) pfb_demod_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c1 = blockIdx.y;
  const int c2 = blockIdx.x * C2B + lane;
  const int s = blockIdx.z;
  const int K1 = p.K1, n_out = p.n_out;
  const size_t plane = (size_t)K1 * K2;          // one st / spec row group

  for (int i = threadIdx.x; i < K2 * C2B; i += kThreads) {
    const int n2 = i / C2B, l = i % C2B;
    const int src = n2 * K2 + blockIdx.x * C2B + l;
    sm.w2[n2][l] = make_float2(p.w2r[src], p.w2i[src]);
  }
  float tr[4], ti[4];                  // twiddles of n2 = lane + 32*i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tr[i] = p.twr[c1 * K2 + lane + 32 * i];
    ti[i] = p.twi[c1 * K2 + lane + 32 * i];
  }
  const int pos = c1 * K2 + c2;
  const float is_am = p.am[pos], is_fm = p.fm[pos];
  const float* st = p.st + (size_t)s * 5 * plane + pos;
  float cz_r = st[0], cz_i = st[plane], cy_de = st[2 * plane];
  float c_env = st[3 * plane], cy_dc = st[4 * plane];
  const float sgn_odd = (c1 & 1) ? -1.f : 1.f;   // sign of odd frames
  const float* bb = p.bb + (size_t)s * n_out * 2 * plane + (size_t)c1 * K2;
  float* audio = p.audio + (size_t)s * n_out * plane + pos;
  float* st_out = p.st_out + (size_t)s * 5 * plane + pos;
  float power = 0.f;
  __syncthreads();

  for (int tb = 0; tb < n_out; tb += NW * TT) {
    const int t0 = tb + w * TT;
    const int nv = max(0, min(TT, n_out - t0));  // frames of this warp
    float zr[TT], zi[TT], env[TT];
#pragma unroll
    for (int k = 0; k < TT; ++k) zr[k] = zi[k] = env[k] = 0.f;

    if (nv > 0) {
      // twiddled, signed input rows -> shared memory
#pragma unroll
      for (int tp = 0; tp < TT / 2; ++tp) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n2 = lane + 32 * i;
          float c[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 2 * tp + h;
            float br = 0.f, bi = 0.f;
            if (k < nv) {
              const float* row = bb + (size_t)(t0 + k) * 2 * plane + n2;
              br = row[0];
              bi = row[plane];
            }
            const float sg = ((t0 + k) & 1) ? sgn_odd : 1.f;
            c[2 * h] = (br * tr[i] - bi * ti[i]) * sg;
            c[2 * h + 1] = (br * ti[i] + bi * tr[i]) * sg;
          }
          sm.cs[w][tp][n2] = make_float4(c[0], c[1], c[2], c[3]);
        }
      }
      __syncwarp();
      // z[k] = sum_n2 c[k][n2] * w2[n2][c2]
#pragma unroll 4
      for (int n2 = 0; n2 < K2; ++n2) {
        const float2 wv = sm.w2[n2][lane];
#pragma unroll
        for (int tp = 0; tp < TT / 2; ++tp) {
          const float4 c = sm.cs[w][tp][n2];
          zr[2 * tp] = fmaf(c.x, wv.x, fmaf(-c.y, wv.y, zr[2 * tp]));
          zi[2 * tp] = fmaf(c.x, wv.y, fmaf(c.y, wv.x, zi[2 * tp]));
          zr[2 * tp + 1] = fmaf(c.z, wv.x, fmaf(-c.w, wv.y, zr[2 * tp + 1]));
          zi[2 * tp + 1] = fmaf(c.z, wv.y, fmaf(c.w, wv.x, zi[2 * tp + 1]));
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < TT; ++k) {
        if (k < nv) {
          const float m2 = zr[k] * zr[k] + zi[k] * zi[k];
          env[k] = sqrtf(m2);
          power += m2;
          if (k == nv - 1) {
            sm.zlast[w][0][lane] = zr[k];
            sm.zlast[w][1][lane] = zi[k];
            sm.zlast[w][2][lane] = env[k];
          }
        }
      }
    }
    __syncthreads();

    // the frame before this warp's first; the carry out of this tile
    float pr = cz_r, pi = cz_i, pe = c_env;
    if (w > 0) {
      pr = sm.zlast[w - 1][0][lane];
      pi = sm.zlast[w - 1][1][lane];
      pe = sm.zlast[w - 1][2][lane];
    }
    if (tb + NW * TT < n_out) {        // a next tile: this one is full
      cz_r = sm.zlast[NW - 1][0][lane];
      cz_i = sm.zlast[NW - 1][1][lane];
      c_env = sm.zlast[NW - 1][2][lane];
    }
    // both one-poles over the warp's frames from a zero state
    float ydc[TT], yde[TT], fdc[TT], fde[TT];
    float e_dc = 0.f, f_dc = 1.f, e_de = 0.f, f_de = 1.f;
#pragma unroll
    for (int k = 0; k < TT; ++k) {
      if (k < nv) {
        const float dr = zr[k] * pr + zi[k] * pi;
        const float di = zi[k] * pr - zr[k] * pi;
        const float disc = (dr * dr + di * di > 1e-24f) ? atan2f(di, dr) : 0.f;
        e_de = fmaf(p.a_de, e_de, p.bg_fm * disc);
        e_dc = fmaf(p.a_dc, e_dc, env[k] - pe);
        f_de *= p.a_de;
        f_dc *= p.a_dc;
        pr = zr[k];
        pi = zi[k];
        pe = env[k];
      }
      yde[k] = e_de;
      ydc[k] = e_dc;
      fde[k] = f_de;
      fdc[k] = f_dc;
    }
    sm.pole[w][0][lane] = e_dc;
    sm.pole[w][1][lane] = f_dc;
    sm.pole[w][2][lane] = e_de;
    sm.pole[w][3][lane] = f_de;
    __syncthreads();

    // fold the carry through the warps before this one, and on to the end
    float in_dc = cy_dc, in_de = cy_de;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      if (v == w) {
        in_dc = cy_dc;
        in_de = cy_de;
      }
      cy_dc = fmaf(sm.pole[v][1][lane], cy_dc, sm.pole[v][0][lane]);
      cy_de = fmaf(sm.pole[v][3][lane], cy_de, sm.pole[v][2][lane]);
    }
#pragma unroll
    for (int k = 0; k < TT; ++k) {
      if (k < nv) {
        const int t = t0 + k;
        const float y_dc = fmaf(fdc[k], in_dc, ydc[k]);
        const float y_de = fmaf(fde[k], in_de, yde[k]);
        const float a_ssb = p.g_ssb * zr[k];
        const float a_am = p.g_am * y_dc;
        audio[(size_t)t * plane] =
            a_ssb + is_am * (a_am - a_ssb) + is_fm * (y_de - a_ssb);
        if (t == n_out - 1) {
          st_out[0] = zr[k];
          st_out[plane] = zi[k];
          st_out[2 * plane] = y_de;
          st_out[3 * plane] = env[k];
          st_out[4 * plane] = y_dc;
        }
      }
    }
  }

  sm.pw[w][lane] = power;
  __syncthreads();
  if (w == 0) {
    float tot = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) tot += sm.pw[v][lane];
    p.spec[(size_t)s * plane + pos] = tot;
  }
}

}  // namespace

// bb [S, n_out*2*K1, 128], st and st_out [S, 5*K1, 128], twr/twi/am/fm
// [K1, 128], w2r/w2i [128, 128], audio [S, n_out*K1, 128], spec [S, K1, 128],
// all float32 and contiguous; bg_fm = float32(b_de * g_fm).
extern "C" int pfb_demod(const void* bb, const void* st, const void* twr,
                         const void* twi, const void* w2r, const void* w2i,
                         const void* am, const void* fm, void* audio,
                         void* spec, void* st_out, int S, int n_out, int K1,
                         float g_ssb, float g_am, float bg_fm, float a_dc,
                         float a_de, void* stream) {
  static bool attr_set[kMaxDevices];
  if (S < 1 || S > 65535 || n_out < 1 || K1 < 1 || K1 > 65535)
    return kErrBadShape;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(pfb_demod_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  Params p{(const float*)bb,  (const float*)st,  (const float*)twr,
           (const float*)twi, (const float*)w2r, (const float*)w2i,
           (const float*)am,  (const float*)fm,  (float*)audio,
           (float*)spec,      (float*)st_out,    n_out,
           K1,                g_ssb,             g_am,
           bg_fm,             a_dc,              a_de};
  const dim3 grid(K2 / C2B, K1, S);
  pfb_demod_kernel<<<grid, kThreads, sizeof(Smem), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
