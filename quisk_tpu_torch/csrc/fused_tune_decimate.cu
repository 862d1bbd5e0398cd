// Fused NCO mix + decimating FIR for the receive chain's front end, in
// three modes of one kernel template.
//
// Replaces the Pallas TPU kernel quisk_tpu/ops/pallas_kernels.py
// _fused_kernel / _fused_call (:137, call :343) in its plain mode
// (FusedTuneDecimate.__call__), its gained mode (__call__ with gain16,
// :168-174, :209-219) and its NB-detect mode (_nb_detect_in_kernel :77,
// FusedTuneDecimate.call_nb).  For channel c and output k:
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
// dots are f32-exact), so the tensor cores are out.  Beside the FMAs every
// window sample costs instructions of its own: the copy into shared memory
// and the mix, a full-precision sincosf on the int32 angle (about 60
// instructions a sample in all, some 40% of the FIR's issue at the flagship
// shape); the detection adds about ten operations per input sample and
// 2.7 MB of gout.  At the NFM shape (B=8192, T=133, d=4) the bytes bound
// it.
//
// The design: register blocking over consecutive outputs.  It replaces a
// form with one output a thread, whose every tap cost a warp 3 shared-memory
// wavefronts (an 8-byte window load and a broadcast tap) against 2 FFMA
// instructions: 6x the FMA bound.
// - A thread owns R consecutive outputs of one channel; a block of `nt`
//   threads owns a tile of O = R*nt outputs (one block per channel and
//   tile).  For phase p, output k+r needs win[p][k+r+q] at tap q
//   (win[p][j] = tuned[j*d + p]), so the thread keeps the R samples of the
//   current chunk of taps and the R of the next in registers: at each tap
//   it does 2R FMAs, and a chunk's loads (R samples, R/4 float4 tap
//   broadcasts) are issued a chunk ahead of their use.  The chunk loop is
//   unrolled, so the slide is register renaming.  Per tap and warp, shared
//   memory serves 2 wavefronts for the sample and 1/4 for the taps against
//   2R FFMA instructions: at R=8 the FMA pipe, not shared memory, binds the
//   FIR.
// - Each output sums over p, then over q, with fmaf, in the order the
//   one-output-per-thread form used.
//   Taps are zero-padded per phase to nqp, a multiple of R (plus one chunk
//   of zeros past the last row); a padded product adds an exact zero.
// - Bank conflicts: a window row stores element j at j + j/R (a chunk of R
//   samples takes R+1 slots), so lane t reads slot t*(R+1) + s: an odd
//   stride, and the 16 lanes of a half-warp hit 16 distinct 8-byte bank
//   pairs at every slide step.  The row stride rs is = 16/P mod 16, so a
//   half-warp's copies and mixes (16/P consecutive j in each of P rows)
//   spread over the banks too.
// - The window is staged one group of P phases at a time (samples
//   j*d + pa .. pa+P-1 of the tile: at d=20, P=4, whole 32-byte sectors):
//   each thread starts its 8-byte copies with cp.async (coalesced runs of P
//   samples a warp, all in flight at once), waits for them, then scales
//   and mixes the same samples in place, kWalkUnroll samples a pass so
//   that their sincosf chains overlap; a barrier, the FMAs of the group, a
//   barrier.  One window buffer, so a block needs ~82 KB of shared memory
//   at O=2048 and two blocks fit an SM; while one waits on device memory
//   or a barrier the other issues FMAs.  (Two buffers, fetching group g+1
//   during group g's FMAs, measured slower: one block an SM.)  The mixed
//   halo is nqp samples a phase: 3.5% at O=2048, d=20 (the
//   one-output-per-thread form mixed 28%).
// - Ragged edges are masks in the one body: samples past the tile's window
//   or the block are copied as zeros, outputs at or past N are not written;
//   T < R and T < d pad more taps with zeros, d < P takes smaller groups.
// - NB-detect: blocks share nothing, so each tile recomputes the group
//   statistics of its own halo (HC groups each way for the widening, W4
//   back for the average) with 16 lanes per group (coalesced 128-byte
//   reads, kStats of them in flight a thread, a shuffle tree for sum and
//   max).  The arithmetic is a function of the group alone, so
//   neighbouring tiles get the same gain for a group they both need.  The
//   statistics share the window's shared memory (they are done with before
//   the first copy).  A bit mask of the pulses lets a group with no pulse
//   in its widening's reach skip the sum, whose every product would be +0.
//   Each tile writes the gout groups of its own O*d input samples (O*d is a
//   multiple of 16, so the tiles cover each x-group once).
// The tile rule (nt, P) and the shared-memory sizes live in the launcher
// below only.  ptxas (sm_90a): 71 / 71 / 95 registers
// (plain / gained / NB-detect), no spills; the 32-byte stack frame is
// sincosf's large-argument path, which |angle| <= pi never takes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;            // outputs a thread
constexpr int kThreads = 256;   // threads a block at full size
constexpr int kPhases = 4;      // phases staged a group at full size
static_assert(R % 4 == 0 && (R & (R - 1)) == 0, "R: a multiple of 4 "
              "(float4 taps), a power of two (slot = j + j/R by a shift)");
static_assert((kPhases & (kPhases - 1)) == 0 && kPhases <= 4,
              "groups of 1, 2 or 4 phases: a group divides every block size");
// NB-detect: passes of the group statistics whose reads are in flight at once
constexpr int kStats = 16;
// samples a thread's copy and mix loops take per pass: independent sincosf
// chains side by side, so the mix is not held up by its own latencies
constexpr int kWalkUnroll = 8;

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

// One launch's shape: threads a block, phases a group, padded taps a
// phase, window row stride (float2 slots), dynamic shared memory bytes,
// gain slab length, floats of the window buffers.
struct Plan {
  int nt, P, nqp, rs, smem, ng, win_floats;
};

// 8-byte copy from device to shared memory that does not wait (cp.async,
// cached in L1); !ok fills zeros and reads nothing.
__device__ __forceinline__ void copy8_async(float2* dst, const float2* src,
                                            bool ok) {
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sdst),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2) fused_tune_decimate_kernel(
    const float2* __restrict__ x, const float2* __restrict__ hist,
    const long long* __restrict__ word, const long long* __restrict__ phase0,
    const float* __restrict__ h_rev, float2* __restrict__ y, int B, int T,
    int d, int N, Plan pl, GainArgs ga) {
  extern __shared__ float4 smem4[];
  const int nqp = pl.nqp, rs = pl.rs, P = pl.P;
  const int nt = blockDim.x;
  const int O = nt * R;
  const int rowj = O + nqp;             // window row length (R-chunk aligned)
  float* hp = reinterpret_cast<float*>(smem4);      // [d][nqp] + one chunk
  float2* win = reinterpret_cast<float2*>(hp + (size_t)d * nqp + R);
  float* gs = reinterpret_cast<float*>(win) + pl.win_floats;     // gain slab
  // NB-detect's group statistics live where the window will be: they are
  // done with before the first fetch
  float* S = reinterpret_cast<float*>(win);                  // group sums
  float* X = S + (ga.ng + 2 * ga.HC + ga.W4);                // maxes, pulses
  float* rcs = X + (ga.ng + 2 * ga.HC + ga.W4);              // raised cosine
  unsigned* pbits = reinterpret_cast<unsigned*>(rcs + 2 * ga.HC + 1);  // pulses

  // ext offsets fit an int (the launcher checks it)
  const int c = blockIdx.y;
  const int k0 = blockIdx.x * O;
  const int H = T - 1;
  const int L = B + H;
  const int n0 = k0 * d;
  const int n_end = min(n0 + O * d + H, L);  // past the samples the tile uses
  const uint32_t w = (uint32_t)word[c];
  const uint32_t p0 = (uint32_t)phase0[c];
  const float2* xc = x + (size_t)c * B;
  const float2* hc = hist + (size_t)c * H;
  const int off = (16 - (H & 15)) & 15;
  const int GH = (H + off) >> 4;
  const int GB = B >> 4;
  const int g_lo = (n0 + off) >> 4;     // ext group of the slab's start

  // Walk the window samples n0 + j*d + pa + pp of the group of np phases
  // at pa (np a power of two, so it divides nt), j < rowj: thread t takes
  // pp = t % np and j = t/np, t/np + nt/np, ..., so a warp reads runs of np
  // consecutive samples (coalesced); fn(n, slot) with the sample's ext
  // offset and its slot pp*rs + j + j/R in the padded polyphase rows.  A
  // thread meets the same samples in every walk of a group, so it mixes in
  // place the samples it fetched itself.
  auto walk = [&](int pa, int np, auto&& fn) {
    const int pp = threadIdx.x & (np - 1);
    const int dj = nt / np;
    int n = n0 + (threadIdx.x / np) * d + pa + pp;
#pragma unroll kWalkUnroll
    for (int j = threadIdx.x / np; j < rowj; j += dj, n += dj * d)
      fn(n, pp * rs + j + j / R);
  };
  // The raw samples of a group into dst, without waiting (zeros past the
  // samples the tile uses).
  auto fetch = [&](int pa, int np, float2* dst) {
    walk(pa, np, [&](int n, int slot) {
      const bool ok = n < n_end;
      copy8_async(dst + slot, !ok ? xc : n < H ? hc + n : xc + (n - H), ok);
    });
    copies_commit();
  };

  // taps in polyphase order: hp[p][q] = h_rev[q*d + p] (zero past T and nq,
  // and one chunk of zeros past the last row)
#pragma unroll 4
  for (int i = threadIdx.x; i < d * nqp + R; i += nt) {
    const int p = i / nqp;
    const int t = (i - p * nqp) * d + p;
    hp[i] = p < d && t < T ? h_rev[t] : 0.f;
  }

  if (MODE == kGained) {
    const float* gr = ga.gin + (size_t)c * (GH + GB);
#pragma unroll 4
    for (int i = threadIdx.x; i < ga.ng; i += nt)
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
    for (int i = threadIdx.x; i <= 2 * HC; i += nt) rcs[i] = ga.rc[i];
    // 16 lanes per group, two groups per warp and pass, kStats passes at
    // once so that their reads are in flight together (warp-uniform trip
    // count: the shuffles need every lane)
    const int pass = nt >> 4;
    for (int r0 = (threadIdx.x >> 5) * 2; r0 < nst; r0 += kStats * pass) {
      float2 v[kStats];
#pragma unroll
      for (int u = 0; u < kStats; ++u) {
        const int r = r0 + u * pass + ((threadIdx.x >> 4) & 1);
        const int e = H + 16 * (sbase + r) + lane16;
        const bool ok = r < nst && e >= 0;
        v[u] = *(!ok ? xc : e < H ? hc + e : xc + (e - H));
      }
#pragma unroll
      for (int u = 0; u < kStats; ++u) {
        const int r = r0 + u * pass + ((threadIdx.x >> 4) & 1);
        const int e = H + 16 * (sbase + r) + lane16;
        const float m = r < nst && e >= 0
                            ? sqrtf(v[u].x * v[u].x + v[u].y * v[u].y)
                            : 0.f;
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
    }
    __syncthreads();
    // pulses, written over the maxes (each thread reads only its own X)
    const float lim = *ga.limit;
    for (int r = threadIdx.x + (W4 - 1); r < nst; r += nt) {
      float acc = S[r];
      for (int k = 1; k < W4; ++k) acc += S[r - k];
      const float thr = lim * fmaxf(acc * ga.inv_avg, 1e-12f);
      X[r] = X[r] > thr ? 1.f : 0.f;
    }
    __syncthreads();
    // a bit per group with a pulse (groups from W4-1 on hold pulses)
    for (int r0 = (threadIdx.x >> 5) * 32; r0 < nst; r0 += nt) {
      const int r = r0 + (threadIdx.x & 31);
      const unsigned bits = __ballot_sync(
          0xffffffffu, r >= W4 - 1 && r < nst && X[r] != 0.f);
      if ((threadIdx.x & 31) == 0) pbits[r0 >> 5] = bits;
    }
    __syncthreads();
    const float on = ga.on[c];
    const float* hg = ga.gin + (size_t)c * GH;
    for (int i = threadIdx.x; i < ga.ng; i += nt) {
      const int gg = g_lo + i;
      float g = 1.f;
      if (gg < GH) {
        g = hg[gg];
      } else if (gg - GH <= GB) {
        const int m = gg - GH;
        // the widening sums rc[t] * pulse[m+t-HC] in t order; with no pulse
        // in its reach every product is +0, so the sum is skipped
        const int lo = max(m - HC, jlo) - sbase, hi = min(m + HC, jhi) - sbase;
        bool any = false;
        for (int wd = lo >> 5; lo <= hi && wd <= hi >> 5; ++wd) {
          unsigned bits = pbits[wd];
          if (wd == lo >> 5) bits &= ~0u << (lo & 31);
          if (wd == hi >> 5) bits &= ~0u >> (31 - (hi & 31));
          any |= bits != 0;
        }
        float pw = 0.f;
        if (any) {
#pragma unroll 4
          for (int t = 0; t <= 2 * HC; ++t) {
            const int j = m + t - HC;
            if (j >= jlo && j <= jhi) pw += rcs[t] * X[j - sbase];
          }
        }
        g = fminf(fmaxf(1.f - pw, 0.f), 1.f);
        g = 1.f + on * (g - 1.f);
      }
      gs[i] = g;
    }
    __syncthreads();
    // the coarse gain of this tile's own O*d input samples
    const int m0 = n0 >> 4;
    const int m1 = min(GB, m0 + ((O * d) >> 4));
    float* go = ga.gout + (size_t)c * GB;
    for (int m = m0 + threadIdx.x; m < m1; m += nt)
      go[m] = gs[GH + m - g_lo];
  }

  // Scale and mix, in place, the samples of a group this thread fetched.
  auto mix = [&](int pa, int np, float2* dst) {
    walk(pa, np, [&](int n, int slot) {
      float2 s = dst[slot];
      if (MODE != kPlain && n < n_end) {
        const int e = n + off;
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
      dst[slot] = make_float2(s.x * cs + s.y * sn,          // s * conj(e^{j ang})
                              s.y * cs - s.x * sn);
    });
  };

  // The groups in turn: fetch, mix, and accumulate into this thread's R
  // outputs, two barriers a group; the other blocks on the SM cover the
  // wait for device memory.
  float2 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
  const bool live = k0 + (int)threadIdx.x * R < N;
  const int nch = nqp / R;
  // groups of np = P phases, the last ones halved to fit d
  auto group_size = [&](int pa) {
    int np = P;
    while (np > d - pa) np >>= 1;
    return np;
  };
  for (int pa = 0, np = group_size(0); pa < d;
       pa += np, np = group_size(pa)) {
    fetch(pa, np, win);
    copies_wait();
    mix(pa, np, win);
    __syncthreads();               // window mixed; taps and gains in place
    for (int pp = 0; live && pp < np; ++pp) {
      // chunk ch of this thread's samples (j = t*R + ch*R + s) sits at
      // slot (t + ch)*(R+1) + s
      const float2* wb = win + pp * rs + threadIdx.x * (R + 1);
      const float4* h4 = reinterpret_cast<const float4*>(hp + (pa + pp) * nqp);
      float2 now[R], nxt[R];
      float h[R], hn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) now[r] = wb[r];
#pragma unroll
      for (int s4 = 0; s4 < R / 4; ++s4) {
        const float4 t4 = h4[s4];
        h[4 * s4] = t4.x;
        h[4 * s4 + 1] = t4.y;
        h[4 * s4 + 2] = t4.z;
        h[4 * s4 + 3] = t4.w;
      }
#pragma unroll 2
      for (int ch = 0; ch < nch; ++ch) {
        // the next chunk's samples and taps, read a chunk ahead of use
        wb += R + 1;
#pragma unroll
        for (int r = 0; r < R; ++r) nxt[r] = wb[r];
#pragma unroll
        for (int s4 = 0; s4 < R / 4; ++s4) {
          const float4 t4 = h4[(ch + 1) * (R / 4) + s4];
          hn[4 * s4] = t4.x;
          hn[4 * s4 + 1] = t4.y;
          hn[4 * s4 + 2] = t4.z;
          hn[4 * s4 + 3] = t4.w;
        }
        // tap q = ch*R + s: output r takes sample j = t*R + r + q, which
        // is now[r+s] below R and nxt[r+s-R] from R on; the products with
        // now come first, so each output still sums over s in order
#pragma unroll
        for (int s = 0; s < R; ++s)
#pragma unroll
          for (int r = 0; r + s < R; ++r) {
            acc[r].x = fmaf(now[r + s].x, h[s], acc[r].x);
            acc[r].y = fmaf(now[r + s].y, h[s], acc[r].y);
          }
#pragma unroll
        for (int s = 1; s < R; ++s)
#pragma unroll
          for (int r = R - s; r < R; ++r) {
            acc[r].x = fmaf(nxt[r + s - R].x, h[s], acc[r].x);
            acc[r].y = fmaf(nxt[r + s - R].y, h[s], acc[r].y);
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          now[r] = nxt[r];
          h[r] = hn[r];
        }
      }
    }
    __syncthreads();               // window free for the next fetch
  }

  float2* yc = y + (size_t)c * N;
  const int kb = k0 + threadIdx.x * R;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (kb + r < N) yc[kb + r] = acc[r];
}

// Shared memory of one launch: the polyphase taps [d][nqp] and one chunk
// of zeros, the window [P][rs] (in NB-detect at least the group statistics
// with their halo, the raised cosine and the pulse bits) and, in the gain
// modes, the gain slab: a window of O*d + T-1 samples touches at most
// (O*d + T-1 + 14)/16 + 1 groups, plus the next one.
void size_plan(int mode, int T, int d, int HC, int W4, Plan* pl) {
  const int O = pl->nt * R;
  const int slots = (O + pl->nqp) / R * (R + 1);
  const int want = (16 / pl->P) & 15;        // rs = 16/P mod 16
  pl->rs = slots + ((want - slots % 16) + 16) % 16;
  size_t win = 2 * (size_t)pl->P * pl->rs;   // floats
  pl->ng = 0;
  if (mode != kPlain) pl->ng = (O * d + T - 1 + 14) / 16 + 2;
  if (mode == kNbDetect) {
    const size_t groups = (size_t)pl->ng + 2 * HC + W4;
    const size_t stats = 2 * groups + 2 * HC + 1 + (groups + 31) / 32;
    win = stats > win ? stats : win;
  }
  pl->win_floats = win > 0x7fffffff ? 0x7fffffff : (int)win;
  const size_t bytes =
      sizeof(float) * ((size_t)d * pl->nqp + R + win + pl->ng);
  pl->smem = bytes > 0x7fffffff ? 0x7fffffff : (int)bytes;
}

constexpr int kMaxDevices = 64;

// Returned when the taps at this decimation need more shared memory than
// one block has, at every tile.
constexpr int kErrTapsTooLong = -1;

// The tile rule: kThreads threads and kPhases phases a group, fewer
// threads while half the tile still covers N, then fewer phases and then
// fewer threads while the shared memory exceeds what a block may opt in
// to.  Returns 0 or kErrTapsTooLong.
int choose_plan(int mode, int N, int T, int d, int HC, int W4, int optin,
                Plan* pl) {
  const int nq = (T + d - 1) / d;
  pl->nqp = (nq + R - 1) / R * R;
  pl->nt = kThreads;
  pl->P = kPhases;
  while (pl->P > d) pl->P /= 2;
  while (pl->nt > 32 && (pl->nt / 2) * R >= N) pl->nt /= 2;
  for (;;) {
    size_plan(mode, T, d, HC, W4, pl);
    if (pl->smem <= optin) return 0;
    if (pl->P > 1) {
      pl->P /= 2;
    } else if (pl->nt > 32) {
      pl->nt /= 2;
    } else {
      return kErrTapsTooLong;
    }
  }
}

// The device's opt-in shared memory per block, read once per device.
int smem_optin(int* optin) {
  static int cached[kMaxDevices];  // 0 = not read yet
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *optin = cached[dev];
  return 0;
}

// Launches one mode on `stream` on the current device.  Returns
// kErrTapsTooLong, or cudaGetLastError() after the launch.
template <int MODE>
int launch(const void* x, const void* hist, const void* word,
           const void* phase0, const void* h_rev, void* y, int C, int B,
           int T, int d, GainArgs ga, void* stream) {
  // largest attribute set so far: the attribute belongs to the kernel
  // function, so each mode keeps its own
  static int smem_set[kMaxDevices];
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const int N = B / d;
  Plan pl;
  rc = choose_plan(MODE, N, T, d, ga.HC, ga.W4, optin, &pl);
  if (rc != 0) return rc;
  // the kernel's ext offsets are ints: the last tile's walk ends below
  // B + T + (O + nqp + 1)*d
  if ((long long)B + T + (long long)(pl.nt * R + pl.nqp + 1) * d > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  ga.ng = pl.ng;
  if (pl.smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(fused_tune_decimate_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pl.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = pl.smem;
  }
  const int O = pl.nt * R;
  const dim3 grid((N + O - 1) / O, C);
  fused_tune_decimate_kernel<MODE><<<grid, pl.nt, pl.smem,
                                     (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)hist, (const long long*)word,
      (const long long*)phase0, (const float*)h_rev, (float2*)y, B, T, d, N,
      pl, ga);
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

// The launcher's choice for one call shape on the current device, without
// launching: out[0..4] = outputs a block (O), outputs a thread (R), phases
// a group (P), threads a block, dynamic shared memory bytes.  mode 0 plain,
// 1 gained, 2 NB-detect (HC, avg_win as for fused_tune_decimate_nb).
// Returns 0, kErrTapsTooLong or a CUDA error.
extern "C" int fused_tune_decimate_plan(int mode, int B, int T, int d,
                                        int HC, int avg_win, int* out) {
  int optin;
  int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  Plan pl;
  rc = choose_plan(mode, B / d, T, d, HC, avg_win / 16, optin, &pl);
  if (rc != 0) return rc;
  out[0] = pl.nt * R;
  out[1] = R;
  out[2] = pl.P;
  out[3] = pl.nt;
  out[4] = pl.smem;
  return 0;
}
