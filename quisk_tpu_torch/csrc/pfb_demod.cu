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
// What bounds it on an H100, at the receiver's shape (K1 = 32, n_out =
// 16384, S = 1): the bytes, 537 MB in and 268 MB out = 805.7 MB, 0.2405 ms
// at 3.35 TB/s.  The operations the function needs are a 128-point FFT a
// row (5 N log2 N) and ~50 a sample for twiddle, demodulators and power:
// 5.70 GFLOP, 0.085 ms at the fp32 peak of 67 TFLOP/s.  The reference's
// numerics are f32-exact, so the tensor cores (TF32) are out.  In issued
// instructions the demodulators cost more than the transform: atan2f and
// the IEEE sqrtf are ~65 instructions a sample (branches for their special
// cases included), the FFT below ~2 a sample.
//
// Why an FFT.  PFBRxPipeline.create builds w2[n2, c2] = W^(n2*c2) * r[c2],
// W = e^(2 pi i/128): the unnormalised inverse DFT followed by a rotation
// of each output column, r[c2] = w2[0, c2].  A direct 128 x 128 product
// would cost 72.1 GFLOP (1.08 ms at the fp32 peak, 4.5x the byte bound);
// the FFT costs 1/18 of that.  The wrapper checks that w2 has this form
// before it launches (ops/pfb_kernels.py _stage2_rotation) and raises if
// not.  The twiddles W^j come in a float32 table made in float64 on the
// host, as the other constants are.
//
// The transform, one warp a frame.  Lane l holds n2 = 4l + i, i < 4, read
// as one 16-byte word of each plane.  With c2 = b + 32a (b < 32, a < 4):
//   z[b + 32a] = sum_i j^(i a) W^(i b) U_i[b],
//   U_i[b] = sum_l c[4l + i] W^(4 l b)
// so the warp runs four 32-point DFTs across its lanes (decimation in
// frequency by __shfl_xor_sync, five radix-2 stages; lane l then holds bin
// b = bitreverse5(l)), multiplies by W^(i b), runs a 4-point DFT over i in
// registers, rotates by r and writes z over the frame's rows in shared
// memory (each lane's 32 stores of one a hit 32 banks).
//
// Time split across blocks, launch (a).  The grid is (chunks of kChunk =
// 256 frames, K1, S): 2048 blocks at the receiver's shape, of 128 threads,
// six a SM.
// A block owns one c1 and all 128 c2 of its chunk and walks it in tiles of
// 16 frames.  Each warp copies the rows of its 4 frames of the next tile
// into shared memory with cp.async while the current tile is worked on
// (two buffers), then transforms its 4 frames in place.  After a barrier
// thread c2 demodulates position c2 through the tile's 16 frames in order,
// carrying z[t-1], env[t-1] and both one-poles in registers, and writes
// each frame's audio as one coalesced 512-byte row.  The first frame of a
// chunk after the first needs the frame before it: warp 0 transforms that
// frame too (1/256 more reads, from the L2 mostly); chunk 0 takes it from
// st.  The one-poles start from zero in every chunk, so launch (a) writes
// the final audio of SSB positions and the zero-carry audio of AM and FM
// positions, and per chunk and position the chunk's end values of both
// one-poles from zero and its power sum into scratch (3 floats a position
// and chunk), plus zr, zi and env of the last frame into st_out.
//
// Across blocks, launch (b), the same grid, 256 threads.  A block forms the
// carries entering its chunk from st's y_dc and y_de and the scratch of the
// chunks before it, C_k+1 = a^L_k * C_k + e_k: each of its 8 warps folds
// one eighth of those chunks from zero, in order, and the 8 partial carries
// are then folded in order.  It adds g_am*a_dc^(j+1)*C_dc and
// a_de^(j+1)*C_de to the AM and FM positions of its frames j (the powers
// formed in double); the loads of its audio are in flight before the
// carries are known.  The last chunk's block writes y_de and y_dc of the
// last frame into st_out and sums the power partials, the same way, into
// spec.  No atomics, no waiting on another block: the order of every sum is
// fixed, so the result does not depend on scheduling.  Any n_out >= 1 is
// taken; frames past n_out are skipped and the last chunk may be short.
//
// Bytes this design moves at the receiver's shape: launch (a) reads the
// 537 MB of planes once (+1/256) and writes the 268 MB of audio; launch (b)
// reads and writes again the AM and FM half of the audio, 134 MB each way,
// and 3 MB of scratch: ~1076 MB, 0.32 ms at 3.35 TB/s.  Both launches run
// from one call of pfb_demod below, which alone owns the chunk rule:
// pfb_demod_scratch_floats says how much scratch the caller allocates.
//
// ptxas (sm_90a, -O3): launch (a) 71 registers, 37632 bytes of shared
// memory, no stack, no spills; launch (b) 92 registers, 14400 bytes, no
// stack, no spills.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int K2 = 128;                // stage-2 length, columns of every row
constexpr int NW = 4;                  // warps per block of launch (a)
constexpr int TT = 4;                  // frames a warp transforms a tile
constexpr int kTile = NW * TT;         // frames per tile
constexpr int kChunk = 256;            // frames per block of launch (a)
constexpr int kThreads = NW * 32;      // a thread per position c2
constexpr int kFixThreads = 256;       // threads per block of launch (b)
constexpr int kFixWarps = kFixThreads / 32;
constexpr int kErrBadShape = -1;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == K2, "launch (a) demodulates a position a thread");

struct Params {
  const float* bb;
  const float* st;
  const float* twr;
  const float* twi;
  const float* w2r;
  const float* w2i;
  const float* am;
  const float* fm;
  const float* tab;                    // [2][128]: cos, sin of 2 pi j/128
  float* audio;
  float* spec;
  float* st_out;
  float* scratch;                      // [S][chunks][e_dc, e_de, power][K1*K2]
  int n_out, K1, n_chunks;
  float g_ssb, g_am, bg_fm, a_dc, a_de;
};

// A frame's slot: its rows (re, im) as copied in, lane l's word at [p][l]
// (n2 = 4l..4l+3); after the transform, as floats, zr[c2] then zi[c2].
struct Frame {
  float4 row[2][32];
};

struct Smem {
  Frame buf[2][kTile];                 // two tiles
  Frame pre;                           // the frame before the chunk
  float4 twr[32], twi[32];             // tw[c1, 4l + i], i = x..w
  float2 wst[4][32];                   // stage twiddles, h = 16, 8, 4, 2
  float2 wstep[3][32];                 // W^(i b), i = 1..3
  float2 rot[4][32];                   // r[b + 32a]
};

__device__ __forceinline__ void unpack(float4 q, float v[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float2 twiddle(const float* tab, int j) {
  return make_float2(__ldg(tab + j), __ldg(tab + K2 + j));
}

__device__ __forceinline__ float frame_sign(int t, int c1) {
  return ((t & 1) && (c1 & 1)) ? -1.f : 1.f;
}

// The rotated, signed 128-point IDFT of one frame, in place: every lane of
// the warp takes part.
__device__ __forceinline__ void stage2(const Smem& sm, int lane, Frame& f,
                                       float sg) {
  float r4[4], i4[4], tr[4], ti[4], xr[4], xi[4];
  unpack(f.row[0][lane], r4);
  unpack(f.row[1][lane], i4);
  unpack(sm.twr[lane], tr);
  unpack(sm.twi[lane], ti);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xr[i] = r4[i] * tr[i] - i4[i] * ti[i];
    xi[i] = r4[i] * ti[i] + i4[i] * tr[i];
  }
  // 32-point DFTs across the lanes, decimation in frequency: the low lane
  // of a pair keeps x + y, the high one (y - x) * W_2h^(l mod h)
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 16 >> s;
    const float sgn = (lane & h) ? -1.f : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pr = __shfl_xor_sync(kFull, xr[i], h);
      const float pi = __shfl_xor_sync(kFull, xi[i], h);
      xr[i] = fmaf(sgn, xr[i], pr);
      xi[i] = fmaf(sgn, xi[i], pi);
    }
    if (s < 4) {
      const float2 w = sm.wst[s][lane];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float u = xr[i];
        xr[i] = u * w.x - xi[i] * w.y;
        xi[i] = u * w.y + xi[i] * w.x;
      }
    }
  }
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float2 w = sm.wstep[i - 1][lane];
    const float u = xr[i];
    xr[i] = u * w.x - xi[i] * w.y;
    xi[i] = u * w.y + xi[i] * w.x;
  }
  // 4-point DFTs over i: X_a = sum_i j^(i a) x_i
  const float s02r = xr[0] + xr[2], s02i = xi[0] + xi[2];
  const float d02r = xr[0] - xr[2], d02i = xi[0] - xi[2];
  const float s13r = xr[1] + xr[3], s13i = xi[1] + xi[3];
  const float d13r = xr[1] - xr[3], d13i = xi[1] - xi[3];
  const float Xr[4] = {s02r + s13r, d02r - d13i, s02r - s13r, d02r + d13i};
  const float Xi[4] = {s02i + s13i, d02i + d13r, s02i - s13i, d02i - d13r};
  const int b = __brev(lane) >> 27;
  float* z = reinterpret_cast<float*>(&f);
  __syncwarp();                        // every lane has read its rows
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float2 r = sm.rot[a][lane];
    z[b + 32 * a] = sg * (Xr[a] * r.x - Xi[a] * r.y);
    z[K2 + b + 32 * a] = sg * (Xr[a] * r.y + Xi[a] * r.x);
  }
}

// Launch (a): one chunk of one c1 and stream per block.
__global__ void __launch_bounds__(kThreads, 6) pfb_demod_chunk(Params p) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int pos = threadIdx.x;         // the position c2 this thread demods
  const int k = blockIdx.x, c1 = blockIdx.y, s = blockIdx.z;
  const int K1 = p.K1, n_out = p.n_out;
  const size_t plane = (size_t)K1 * K2;          // one st / spec row group
  const float* bb = p.bb + (size_t)s * n_out * 2 * plane + (size_t)c1 * K2;
  const int t_begin = k * kChunk;
  const int t_end = min(n_out, t_begin + kChunk);

  // a warp copies the rows of its frames of a tile (and warp 0 in the
  // first tile of a later chunk the frame before the chunk) into shared
  // memory; each lane reads back only its own words before the transform
  auto prefetch = [&](int tb, int buf) {
#pragma unroll
    for (int kk = 0; kk < TT; ++kk) {
      const int t = tb + w * TT + kk;
      if (t < t_end) {
        const float4* row =
            reinterpret_cast<const float4*>(bb + (size_t)t * 2 * plane);
        Frame& f = sm.buf[buf][w * TT + kk];
        cp_async16(&f.row[0][lane], row + lane);
        cp_async16(&f.row[1][lane], row + plane / 4 + lane);
      }
    }
    if (tb == t_begin && k > 0 && w == 0) {
      const float4* row = reinterpret_cast<const float4*>(
          bb + (size_t)(t_begin - 1) * 2 * plane);
      cp_async16(&sm.pre.row[0][lane], row + lane);
      cp_async16(&sm.pre.row[1][lane], row + plane / 4 + lane);
    }
    cp_async_commit();
  };
  prefetch(t_begin, 0);

  if (w == 0) {
    sm.twr[lane] = __ldg(reinterpret_cast<const float4*>(p.twr + c1 * K2) +
                         lane);
    sm.twi[lane] = __ldg(reinterpret_cast<const float4*>(p.twi + c1 * K2) +
                         lane);
  } else if (w == 1) {
#pragma unroll
    for (int s2 = 0; s2 < 4; ++s2) {
      const int h = 16 >> s2;
      sm.wst[s2][lane] = (lane & h)
                             ? twiddle(p.tab, (lane & (h - 1)) * (64 / h))
                             : make_float2(1.f, 0.f);
    }
  } else if (w == 2) {
    const int b = __brev(lane) >> 27;
#pragma unroll
    for (int i = 1; i < 4; ++i) sm.wstep[i - 1][lane] = twiddle(p.tab, i * b);
  } else {
    const int b = __brev(lane) >> 27;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      sm.rot[a][lane] =
          make_float2(__ldg(p.w2r + b + 32 * a), __ldg(p.w2i + b + 32 * a));
  }
  const float is_am = __ldg(p.am + c1 * K2 + pos);
  const float is_fm = __ldg(p.fm + c1 * K2 + pos);
  const float g_ssb = p.g_ssb, g_am = p.g_am, bg_fm = p.bg_fm;
  const float a_dc = p.a_dc, a_de = p.a_de;
  float* audio = p.audio + (size_t)s * n_out * plane + (size_t)c1 * K2 + pos;
  float* st_out = p.st_out + (size_t)s * 5 * plane + (size_t)c1 * K2 + pos;
  // the frame before the chunk: from st in chunk 0, else transformed below
  float pzr = 0.f, pzi = 0.f, penv = 0.f;
  if (k == 0) {
    const float* st = p.st + (size_t)s * 5 * plane + (size_t)c1 * K2 + pos;
    pzr = st[0];
    pzi = st[plane];
    penv = st[3 * plane];
  }
  float y_dc = 0.f, y_de = 0.f, power = 0.f;
  __syncthreads();

  int cur = 0;
  for (int tb = t_begin; tb < t_end; tb += kTile, cur ^= 1) {
    prefetch(tb + kTile, cur ^ 1);     // flies while this tile is worked on
    cp_async_wait_one();
    __syncwarp();
    // frames past t_end hold stale rows: transformed, never read
#pragma unroll
    for (int kk = 0; kk < TT; ++kk) {
      const int t = tb + w * TT + kk;
      stage2(sm, lane, sm.buf[cur][w * TT + kk], frame_sign(t, c1));
    }
    if (tb == t_begin && k > 0 && w == 0)
      stage2(sm, lane, sm.pre, frame_sign(t_begin - 1, c1));
    __syncthreads();

    if (tb == t_begin && k > 0) {
      const float* z = reinterpret_cast<const float*>(&sm.pre);
      pzr = z[pos];
      pzi = z[K2 + pos];
      penv = sqrtf(pzr * pzr + pzi * pzi);
    }
    const int nf = min(kTile, t_end - tb);
#pragma unroll 4
    for (int f = 0; f < nf; ++f) {
      const float* z = reinterpret_cast<const float*>(&sm.buf[cur][f]);
      const float zr = z[pos], zi = z[K2 + pos];
      const float m2 = zr * zr + zi * zi;
      const float env = sqrtf(m2);
      power += m2;
      const float dr = zr * pzr + zi * pzi;
      const float di = zi * pzr - zr * pzi;
      const float disc = (dr * dr + di * di > 1e-24f) ? atan2f(di, dr) : 0.f;
      y_de = fmaf(a_de, y_de, bg_fm * disc);
      y_dc = fmaf(a_dc, y_dc, env - penv);
      const float a_ssb = g_ssb * zr;
      const int t = tb + f;
      audio[(size_t)t * plane] = a_ssb + is_am * (g_am * y_dc - a_ssb) +
                                 is_fm * (y_de - a_ssb);
      if (t == n_out - 1) {
        st_out[0] = zr;
        st_out[plane] = zi;
        st_out[3 * plane] = env;
      }
      pzr = zr;
      pzi = zi;
      penv = env;
    }
    __syncthreads();                   // the tile is read: its buffer is free
  }

  // the chunk's one-pole ends from zero and its power, for launch (b)
  float* sc = p.scratch + (size_t)(s * p.n_chunks + k) * 3 * plane +
              (size_t)c1 * K2 + pos;
  sc[0] = y_dc;
  sc[plane] = y_de;
  sc[2 * plane] = power;
}

// a^n in double, by squaring
__device__ __forceinline__ float pow_n(float a, int n) {
  double r = 1.0, x = a;
  while (n) {
    if (n & 1) r *= x;
    x *= x;
    n >>= 1;
  }
  return (float)r;
}

__device__ __forceinline__ float4 ld4(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}

__device__ __forceinline__ void st4(float* q, float4 v) {
  *reinterpret_cast<float4*>(q) = v;
}

__device__ __forceinline__ float4 fma4(float d, float4 c, float4 e) {
  return make_float4(fmaf(d, c.x, e.x), fmaf(d, c.y, e.y), fmaf(d, c.z, e.z),
                     fmaf(d, c.w, e.w));
}

__device__ __forceinline__ float4 add4(float4 c, float4 e) {
  return make_float4(c.x + e.x, c.y + e.y, c.z + e.z, c.w + e.w);
}

// Launch (b): the carries entering each chunk, the AM / FM fix-up, spec and
// the one-pole rows of st_out.  A lane owns 4 consecutive positions.
__global__ void __launch_bounds__(kFixThreads) pfb_demod_carry(Params p) {
  __shared__ float pdc[kChunk], pde[kChunk];     // a^(j+1)
  __shared__ float4 part[kFixWarps][3][32];       // partial carries, power
  __shared__ float2 pdec[kFixWarps];              // their decays
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int k = blockIdx.x, c1 = blockIdx.y, s = blockIdx.z;
  const int K1 = p.K1, n_out = p.n_out, nch = p.n_chunks;
  const size_t plane = (size_t)K1 * K2;
  const int t_begin = k * kChunk;
  const int nf = min(kChunk, n_out - t_begin);
  const size_t pos = (size_t)c1 * K2 + 4 * lane;
  const float* sc = p.scratch + (size_t)s * nch * 3 * plane + pos;
  const float4 am = ld4(p.am + pos), fm = ld4(p.fm + pos);
  // SSB positions are final
  const bool fix = am.x != 0.f || am.y != 0.f || am.z != 0.f ||
                   am.w != 0.f || fm.x != 0.f || fm.y != 0.f ||
                   fm.z != 0.f || fm.w != 0.f;
  float* audio = p.audio + ((size_t)s * n_out + t_begin) * plane + pos;
  constexpr int kUnroll = 8;
  float4 v[kUnroll];                   // a group of frames, loads in flight
  auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kFixWarps;
      if (j < nf) v[u] = ld4(audio + (size_t)j * plane);
    }
  };
  if (fix) load(g);                    // before the carries are known

  for (int j = threadIdx.x; j < kChunk; j += kFixThreads) {
    pdc[j] = pow_n(p.a_dc, j + 1);
    pde[j] = pow_n(p.a_de, j + 1);
  }
  // warp g folds chunks [lo, hi) of those before this one from zero
  {
    const int lo = k * g / kFixWarps, hi = k * (g + 1) / kFixWarps;
    const float ddc = pow_n(p.a_dc, kChunk), dde = pow_n(p.a_de, kChunk);
    float4 cdc = make_float4(0.f, 0.f, 0.f, 0.f), cde = cdc;
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      cdc = fma4(ddc, cdc, ld4(sc + (size_t)j * 3 * plane));
      cde = fma4(dde, cde, ld4(sc + ((size_t)j * 3 + 1) * plane));
    }
    part[g][0][lane] = cdc;
    part[g][1][lane] = cde;
    if (lane == 0)
      pdec[g] = make_float2(pow_n(p.a_dc, kChunk * (hi - lo)),
                            pow_n(p.a_de, kChunk * (hi - lo)));
  }
  // and in the last chunk's block, the power of chunks [lo, hi) of all
  if (k == nch - 1) {
    const int lo = nch * g / kFixWarps, hi = nch * (g + 1) / kFixWarps;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = lo; j < hi; ++j)
      acc = add4(acc, ld4(sc + ((size_t)j * 3 + 2) * plane));
    part[g][2][lane] = acc;
  }
  __syncthreads();

  float4 cdc = ld4(p.st + (size_t)s * 5 * plane + 4 * plane + pos);
  float4 cde = ld4(p.st + (size_t)s * 5 * plane + 2 * plane + pos);
#pragma unroll
  for (int u = 0; u < kFixWarps; ++u) {
    cdc = fma4(pdec[u].x, cdc, part[u][0][lane]);
    cde = fma4(pdec[u].y, cde, part[u][1][lane]);
  }
  if (k == nch - 1 && g == 0) {
    float* so = p.st_out + (size_t)s * 5 * plane + pos;
    st4(so + 4 * plane, fma4(pow_n(p.a_dc, nf), cdc,
                             ld4(sc + (size_t)k * 3 * plane)));
    st4(so + 2 * plane, fma4(pow_n(p.a_de, nf), cde,
                             ld4(sc + ((size_t)k * 3 + 1) * plane)));
    float4 acc = part[0][2][lane];
#pragma unroll
    for (int u = 1; u < kFixWarps; ++u) acc = add4(acc, part[u][2][lane]);
    st4(p.spec + (size_t)s * plane + pos, acc);
  }
  if (!fix) return;
  const float4 gdc = make_float4(p.g_am * am.x * cdc.x, p.g_am * am.y * cdc.y,
                                 p.g_am * am.z * cdc.z, p.g_am * am.w * cdc.w);
  const float4 gde = make_float4(fm.x * cde.x, fm.y * cde.y, fm.z * cde.z,
                                 fm.w * cde.w);
  for (int j0 = g; j0 < nf; j0 += kFixWarps * kUnroll) {
    if (j0 > g) load(j0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kFixWarps;
      if (j < nf) {
        const float fd = pdc[j], fe = pde[j];
        st4(audio + (size_t)j * plane,
            make_float4(fmaf(fd, gdc.x, fmaf(fe, gde.x, v[u].x)),
                        fmaf(fd, gdc.y, fmaf(fe, gde.y, v[u].y)),
                        fmaf(fd, gdc.z, fmaf(fe, gde.z, v[u].z)),
                        fmaf(fd, gdc.w, fmaf(fe, gde.w, v[u].w))));
      }
    }
  }
}

int n_chunks(int n_out) { return (n_out + kChunk - 1) / kChunk; }

}  // namespace

// Floats of scratch that pfb_demod needs for these sizes, or -1 for sizes
// outside its grid.
extern "C" long long pfb_demod_scratch_floats(int S, int n_out, int K1) {
  if (S < 1 || S > 65535 || n_out < 1 || K1 < 1 || K1 > 65535)
    return kErrBadShape;
  return (long long)S * n_chunks(n_out) * 3 * K1 * K2;
}

// bb [S, n_out*2*K1, 128], st and st_out [S, 5*K1, 128], twr/twi/am/fm
// [K1, 128], w2r/w2i [128, 128] of the form W^(n2*c2) * r[c2], tab [2, 128]
// (cos, sin of 2 pi j/128), audio [S, n_out*K1, 128], spec [S, K1, 128],
// scratch of pfb_demod_scratch_floats(S, n_out, K1) floats, all float32 and
// contiguous, bb, st, twr, twi, am, fm, audio, spec, st_out and scratch
// 16-byte aligned; bg_fm = float32(b_de * g_fm).  Launches (a) and (b) on
// the stream.
extern "C" int pfb_demod(const void* bb, const void* st, const void* twr,
                         const void* twi, const void* w2r, const void* w2i,
                         const void* am, const void* fm, const void* tab,
                         void* audio, void* spec, void* st_out, void* scratch,
                         int S, int n_out, int K1, float g_ssb, float g_am,
                         float bg_fm, float a_dc, float a_de, void* stream) {
  if (pfb_demod_scratch_floats(S, n_out, K1) < 0) return kErrBadShape;
  Params p{(const float*)bb,  (const float*)st,  (const float*)twr,
           (const float*)twi, (const float*)w2r, (const float*)w2i,
           (const float*)am,  (const float*)fm,  (const float*)tab,
           (float*)audio,     (float*)spec,      (float*)st_out,
           (float*)scratch,   n_out,             K1,
           n_chunks(n_out),   g_ssb,             g_am,
           bg_fm,             a_dc,              a_de};
  const dim3 grid(n_chunks(n_out), K1, S);
  pfb_demod_chunk<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pfb_demod_carry<<<grid, kFixThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
