// Whole-block eval fusion on channels-last volumes (Hopper, sm_90a): the
// convs of one ConvX block, or two consecutive convs, in one kernel, with
// every intermediate in shared memory.
//
//   t_0 = relu0?(x * s_in + b_in)                    (identity when s_in is null)
//   m_j = relu(round(conv_j(t_j)) * s_j + b_j)       t_{j+1} = m_j, j < n - 1
//   y   = round(conv_{n-1}(t_{n-1}))
//   out = y                                  raw       (the pair)
//         y * s + b                          affine
//         relu(y * s + b)                    relu
//         relu((y * s + b) + x)              res_id
//         relu(((y * s + b) + yd * sd) + bd) res_conv, yd = round(conv_1x1(x, wd))
//
// with each product and sum rounded to the storage type as the per-op path
// rounds it (`affine`, fused_conv_common.cuh), and every t_j reading 0
// outside the volume and at or beyond the true extents (yt, xt, zt): the
// SAME padding of the unfused path, and under exact shape bucketing the
// masking of the extents instance of the fused conv (K7).  The block output
// (every mode but raw) is 0 at or beyond the extents, as the masked output
// of ConvX is; the raw output is the conv's value everywhere.  Without
// extents the caller passes the volume's own (Y, X, Z): the check against
// them is the bounds check, so one instance serves both.
//
// Replaces the TPU kernels of multimodal_fusion_fpn_tpu/ops/pallas/
// fused_conv.py `_kernel2` (the pair, launched by `fused_conv2_eval`) and
// `_chain_kernel` (the chain, launched by `fused_chain_eval`): eval only, no
// backward.  The shapes the model gives them: n = 2, two (1,3,3) convs (the
// pair, and the chain of a downsampling block with the 1x1 residual), or
// n = 3, (1,3,3), (1,3,3), (3,1,1) (the chain of an identity-residual
// block).  Other taps, or a kY = 3 conv elsewhere, are not instantiated.
//
// Bound on the H100: the 3-conv block does 2 * 21 * C^2 flops per voxel
// against 4 C bytes (C channels in and out, bf16): 168 flops per byte at C =
// 16, 672 at C = 64.  At the bf16 tensor-core peak (295 flops per byte)
// stage 1 is bytes-bound and stages 2-3 operation-bound; on the fp32 CUDA
// cores that this kernel uses (20 flops per byte) every stage is
// operation-bound, so keeping the intermediates out of device memory saves
// the per-conv path's traffic but not its FMAs.
// Design: a block of 256 threads owns a TX x 32 (x, z) window of the output
// and walks a chunk of G rows along y.  Per row it stages the activated input
// with a halo of 2 in x and z ([ci][TX + 4][36], storage type) in shared
// memory, computes conv 0 over the window with a halo of 1 ([co][TX + 2][34],
// rounded, affine, ReLU, masked), then conv 1 over the window.  A trailing
// (3,1,1) conv keeps conv 1's output for the last three rows in a ring
// ([3][co][TX][32]) and emits row y - 1 once row y + 1 is in, so along y only
// the two halo rows of each chunk are computed twice; in x and z the conv-0
// halo is computed twice (the ratio of (TX + 2) * 34 to TX * 32).  A thread
// accumulates 16 output channels of one position, or of two where the conv
// has at least two such items per thread, in fp32: the two positions share
// each weight read (four float4 through the read-only cache, one address
// across a warp): 6 loads per 32 FMAs instead of 5 per 16.  Per position
// the sums run channel by channel and tap by tap, as in the per-conv kernel,
// so the two give bitwise equal results.  The host picks TX in {16, 8, 4, 2,
// 1} so the tiles fit in shared memory (two blocks per SM where TX >= 4
// allows it) and G to balance the recomputed rows against filling the card
// (`mmf_fused_block_plan`).  No tensor cores yet.

#include "fused_conv_common.cuh"

namespace {

using namespace mmf;

enum Final : int { kRaw = 0, kAffine = 1, kRelu = 2, kResId = 3, kResConv = 4 };

constexpr int kNZ0 = kTZ + 4;   // z span of the staged input
constexpr int kNZ1 = kTZ + 2;   // z span of conv 0's output
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may opt in to
constexpr int kMaxTX = 16;           // widest tile along x

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  const void* x;          // (B, Y, X, Z, ci), storage type
  const void* s_in;       // entry prologue (ci), or null
  const void* b_in;
  const float* w[3];      // fp32 (kY, kX, kz, c_in, co) per conv
  const void* s[3];       // post-conv affines (co); the last one null for raw
  const void* b[3];
  const float* wd;        // res_conv: fp32 (1, 1, 1, ci, co) and its affine
  const void* sd;
  const void* bd;
  void* out;              // (B, Y, X, Z, co)
  int Y, X, Z, ci, co;
  int yt, xt, zt;         // true extents (the whole volume without bucketing)
  int TX, G, n_xt;        // tile width along x, rows per chunk, x tiles
  int relu0, final_mode;
};

__device__ __forceinline__ int mod3(int v) { return ((v % 3) + 3) % 3; }

// acc[p][o] += v[p] * w[o] for the P positions and the 16 output channels
// of one group: the weights are read once, through the read-only cache, as
// four float4 (the same address across a warp).
template <int P>
__device__ __forceinline__ void fma16(float (&acc)[P][kCO], const float (&v)[P],
                                      const float* __restrict__ w) {
  const float4* wp = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 w4 = __ldg(wp + q);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p][4 * q] = fmaf(v[p], w4.x, acc[p][4 * q]);
      acc[p][4 * q + 1] = fmaf(v[p], w4.y, acc[p][4 * q + 1]);
      acc[p][4 * q + 2] = fmaf(v[p], w4.z, acc[p][4 * q + 2]);
      acc[p][4 * q + 3] = fmaf(v[p], w4.w, acc[p][4 * q + 3]);
    }
  }
}

// A conv over shared-memory tiles: for each of n_pos output positions and
// each group of 16 output channels, the fp32 sum over the n_in channels and
// the taps of tile value x weight, summed channel by channel and tap by tap
// in that order (the order of the per-conv kernel's `conv_tile`), handed to
// epi(g, pos, acc).  `tap(base(pos), c, t)` is the tile value of tap t at
// channel c, `wt(c, t)` the weights of channel c and tap t.  An item is P
// positions (pos, pos + n_pos / P, ...) of one group, which share each
// weight read; P = 2 where that leaves every thread an item.
template <int P, int TAPS, typename Base, typename Tap, typename Wt, typename Epi>
__device__ __forceinline__ void conv_items(int n_pos, int n_in, int co, Base base, Tap tap,
                                           Wt wt, Epi epi) {
  const int stride = (n_pos + P - 1) / P;
  const int n_items = stride * (co / kCO);
  for (int item = threadIdx.x; item < n_items; item += kThreads) {
    const int g = item / stride, p0 = item - g * stride;
    int pos[P], off[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pos[p] = min(p0 + p * stride, n_pos - 1);
      off[p] = base(pos[p]);
    }
    float acc[P][kCO];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int o = 0; o < kCO; ++o) acc[p][o] = 0.f;
    for (int c = 0; c < n_in; ++c) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        float v[P];
#pragma unroll
        for (int p = 0; p < P; ++p) v[p] = tap(off[p], c, t);
        fma16<P>(acc, v, wt(c, t) + g * kCO);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (p == 0 || p0 + p * stride < n_pos) epi(g, pos[p], acc[p]);
  }
}

template <int TAPS, typename Base, typename Tap, typename Wt, typename Epi>
__device__ __forceinline__ void conv(int n_pos, int n_in, int co, Base base, Tap tap, Wt wt,
                                     Epi epi) {
  if (n_pos * (co / kCO) >= 2 * kThreads)
    conv_items<2, TAPS>(n_pos, n_in, co, base, tap, wt, epi);
  else
    conv_items<1, TAPS>(n_pos, n_in, co, base, tap, wt, epi);
}

// The (1,3,3) conv of a [n_in][NXs][NZs] tile over the NXo x NZo output
// window (position (xo, zo) reads the tile at (xo + dx, zo + dz)); epi gets
// (g, xo, zo, acc).  w: (1, 3, 3, n_in, co).
template <typename T, typename Epi>
__device__ __forceinline__ void conv133(const T* src, int n_in, int NXs, int NZs,
                                        const float* __restrict__ w, int co, int NXo,
                                        int NZo, Epi epi) {
  const int plane = NXs * NZs;
  conv<9>(
      NXo * NZo, n_in, co,
      [&](int pos) { return pos / NZo * NZs + pos % NZo; },
      [&](int off, int c, int t) { return to_f(src[c * plane + off + t / 3 * NZs + t % 3]); },
      [&](int c, int t) { return w + ((size_t)t * n_in + c) * co; },
      [&](int g, int pos, const float(&acc)[kCO]) {
        const int xo = pos / NZo;
        epi(g, xo, pos - xo * NZo, acc);
      });
}

// The block output of 16 channels at one position from the last conv's fp32
// sums (module note); `valid`: inside the true extents.
template <typename T>
__device__ __forceinline__ void finish(const Params& p, const T* __restrict__ x,
                                       const T* __restrict__ s, const T* __restrict__ b,
                                       int64_t pix, int g, bool valid,
                                       const float (&acc)[kCO], float (&r)[kCO]) {
  const int mode = p.final_mode;
  float yd[kCO];
  if (mode == kResConv) {
    // the 1x1 downsample of the raw block input at this position
#pragma unroll
    for (int o = 0; o < kCO; ++o) yd[o] = 0.f;
    const T* xp = x + pix * p.ci;
    const float* wg = p.wd + g * kCO;
    for (int c = 0; c < p.ci; ++c) {
      const float v = to_f(xp[c]);
      const float4* wp = reinterpret_cast<const float4*>(wg + (size_t)c * p.co);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w4 = __ldg(wp + q);
        yd[4 * q] = fmaf(v, w4.x, yd[4 * q]);
        yd[4 * q + 1] = fmaf(v, w4.y, yd[4 * q + 1]);
        yd[4 * q + 2] = fmaf(v, w4.z, yd[4 * q + 2]);
        yd[4 * q + 3] = fmaf(v, w4.w, yd[4 * q + 3]);
      }
    }
  }
  const T* sd = static_cast<const T*>(p.sd);
  const T* bd = static_cast<const T*>(p.bd);
#pragma unroll
  for (int o = 0; o < kCO; ++o) {
    const int ch = g * kCO + o;
    float v = round_to<T>(acc[o]);
    if (mode != kRaw) {
      v = affine(from_f<T>(v), s[ch], b[ch]);
      if (mode == kResId) {
        v = round_to<T>(__fadd_rn(v, to_f(x[pix * p.ci + ch])));
      } else if (mode == kResConv) {
        const float t = round_to<T>(__fmul_rn(round_to<T>(yd[o]), to_f(sd[ch])));
        v = round_to<T>(__fadd_rn(round_to<T>(__fadd_rn(v, t)), to_f(bd[ch])));
      }
      if (mode != kAffine) v = fmaxf(v, 0.f);
      if (!valid) v = 0.f;
    }
    r[o] = v;
  }
}

template <typename T, bool KY3>
__global__ void __launch_bounds__(kThreads, 2) fused_block_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TX = p.TX;
  const int NX0 = TX + 4, NX1 = TX + 2;
  const int plane0 = NX0 * kNZ0, plane1 = NX1 * kNZ1, plane2 = TX * kTZ;
  T* s_in = reinterpret_cast<T*>(smem_raw);     // [ci][NX0][kNZ0]
  T* s_mid = s_in + p.ci * plane0;              // [co][NX1][kNZ1]
  T* ring = s_mid + p.co * plane1;              // [3][co][TX][kTZ] (KY3)

  const int x0 = (blockIdx.x % p.n_xt) * TX;
  const int z0 = (blockIdx.x / p.n_xt) * kTZ;
  const int yc0 = blockIdx.y * p.G;
  const int yc1 = min(p.Y, yc0 + p.G);
  const int b = blockIdx.z;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const T* sc_in = static_cast<const T*>(p.s_in);
  const T* bc_in = static_cast<const T*>(p.b_in);
  const int last = KY3 ? 2 : 1;
  const T* s_last = static_cast<const T*>(p.s[last]);
  const T* b_last = static_cast<const T*>(p.b[last]);
  const int n_g = p.co / kCO;

  // the output row yo from the last conv's sums, over the window
  auto emit = [&](int yo) {
    return [&, yo](int g, int xo, int zo, const float(&acc)[kCO]) {
      const int gx = x0 + xo, gz = z0 + zo;
      if (gx >= p.X || gz >= p.Z) return;
      const bool valid = yo < p.yt && gx < p.xt && gz < p.zt;
      const int64_t pix = (((int64_t)b * p.Y + yo) * p.X + gx) * p.Z + gz;
      float r[kCO];
      finish<T>(p, x, s_last, b_last, pix, g, valid, acc, r);
      store16(out + pix * p.co + g * kCO, r);
    };
  };
  // a row of the output that is 0 (at or beyond yt: every t_j reads 0 there)
  auto zero_row = [&](int yo) {
    for (int item = threadIdx.x; item < plane2 * n_g; item += kThreads) {
      const int g = item / plane2, pos = item - g * plane2;
      const int gx = x0 + pos / kTZ, gz = z0 + pos % kTZ;
      if (gx >= p.X || gz >= p.Z) continue;
      float r[kCO];
#pragma unroll
      for (int o = 0; o < kCO; ++o) r[o] = 0.f;
      const int64_t pix = (((int64_t)b * p.Y + yo) * p.X + gx) * p.Z + gz;
      store16(out + pix * p.co + g * kCO, r);
    }
  };
  // conv j's rounded, affine, ReLU'd output into a [co][NXd][NZd] tile whose
  // (0, 0) lies at (gx0, gz0); 0 outside the volume and the extents
  auto to_tile = [&](int j, T* dst, int NXd, int NZd, int gx0, int gz0) {
    const T* sj = static_cast<const T*>(p.s[j]);
    const T* bj = static_cast<const T*>(p.b[j]);
    return [=, &p](int g, int xo, int zo, const float(&acc)[kCO]) {
      const int gx = gx0 + xo, gz = gz0 + zo;
      const bool in = gx >= 0 && gx < p.xt && gz >= 0 && gz < p.zt;
#pragma unroll
      for (int o = 0; o < kCO; ++o) {
        const int ch = g * kCO + o;
        const float v = in ? fmaxf(affine(from_f<T>(acc[o]), sj[ch], bj[ch]), 0.f) : 0.f;
        dst[(ch * NXd + xo) * NZd + zo] = from_f<T>(v);
      }
    };
  };

  const int y_begin = KY3 ? yc0 - 1 : yc0;
  const int y_end = KY3 ? yc1 + 1 : yc1;
  for (int yy = y_begin; yy < y_end; ++yy) {
    const bool live = yy >= 0 && yy < p.yt;
    __syncthreads();  // the previous row's readers of the tiles are done
    if (live) {
      // the activated input row with its halo
      const int64_t x_row = ((int64_t)b * p.Y + yy) * p.X;
      for (int idx = threadIdx.x; idx < p.ci * plane0; idx += kThreads) {
        const int c = idx % p.ci, pos = idx / p.ci;
        const int xr = pos / kNZ0, zr = pos - xr * kNZ0;
        const int gx = x0 - 2 + xr, gz = z0 - 2 + zr;
        float v = 0.f;
        if (gx >= 0 && gx < p.xt && gz >= 0 && gz < p.zt)
          v = activate(x, sc_in, bc_in, ((x_row + gx) * p.Z + gz) * p.ci + c, c, p.relu0);
        s_in[(c * NX0 + xr) * kNZ0 + zr] = from_f<T>(v);
      }
      __syncthreads();
      conv133<T>(s_in, p.ci, NX0, kNZ0, p.w[0], p.co, NX1, kNZ1,
                 to_tile(0, s_mid, NX1, kNZ1, x0 - 1, z0 - 1));
      __syncthreads();
      if (KY3)
        conv133<T>(s_mid, p.co, NX1, kNZ1, p.w[1], p.co, TX, kTZ,
                   to_tile(1, ring + mod3(yy) * p.co * plane2, TX, kTZ, x0, z0));
      else
        conv133<T>(s_mid, p.co, NX1, kNZ1, p.w[1], p.co, TX, kTZ, emit(yy));
    } else if (KY3) {
      T* r = ring + mod3(yy) * p.co * plane2;
      for (int idx = threadIdx.x; idx < p.co * plane2; idx += kThreads) r[idx] = from_f<T>(0.f);
    } else {
      zero_row(yy);
    }
    if (KY3 && yy > yc0) {
      // the (3,1,1) conv of rows yo - 1, yo, yo + 1 of the ring
      const int yo = yy - 1;
      __syncthreads();
      if (yo >= p.yt) {
        zero_row(yo);
        continue;
      }
      // ring rows yo - 1, yo, yo + 1 are taps 0, 1, 2
      const T* rows[3] = {ring + mod3(yo - 1) * p.co * plane2, ring + mod3(yo) * p.co * plane2,
                          ring + mod3(yo + 1) * p.co * plane2};
      auto epi = emit(yo);
      conv<3>(
          plane2, p.co, p.co, [](int pos) { return pos; },
          [&](int off, int c, int t) { return to_f(rows[t][c * plane2 + off]); },
          [&](int c, int t) { return p.w[2] + ((size_t)t * p.co + c) * p.co; },
          [&](int g, int pos, const float(&acc)[kCO]) { epi(g, pos / kTZ, pos % kTZ, acc); });
    }
  }
}

size_t smem_bytes(int esize, bool ky3, int TX, int ci, int co) {
  return (size_t)esize * ((size_t)ci * (TX + 4) * kNZ0 + (size_t)co * (TX + 2) * kNZ1 +
                          (ky3 ? (size_t)3 * co * TX * kTZ : 0));
}

struct Plan {
  int TX, G, n_xt, n_zt, n_yc;
  size_t smem;
};

// TX: the widest of 16, 8, 4, 2, 1 (at most X rounded up to a power of two)
// whose tiles leave room for two blocks per SM, if that is at least 4; else
// the widest that fits.  G: of Y, Y/2, Y/4, ... (down to 4 rows with a
// (3,1,1) conv, 1 without), the chunk that minimises the waves of blocks
// times the rows each block computes (its G rows, plus the two halo rows
// that a (3,1,1) conv recomputes): fewer chunks recompute less, more fill
// the card.  At most two blocks run on an SM (`__launch_bounds__`, 128
// registers).  TX = 0 when nothing fits.
Plan make_plan(int esize, bool ky3, int B, int Y, int X, int Z, int ci, int co) {
  Plan pl{0, 0, 0, 0, 0, 0};
  int tx_max = 1;
  while (tx_max < kMaxTX && tx_max < X) tx_max *= 2;
  int fit = 0, half = 0;
  for (int tx = tx_max; tx >= 1; tx /= 2) {
    const size_t s = smem_bytes(esize, ky3, tx, ci, co);
    if (fit == 0 && s <= kMaxSmem) fit = tx;
    if (half == 0 && s <= kMaxSmem / 2) half = tx;
  }
  pl.TX = half >= 4 || half == tx_max ? half : fit;
  if (pl.TX == 0) return pl;
  pl.smem = smem_bytes(esize, ky3, pl.TX, ci, co);
  pl.n_xt = (X + pl.TX - 1) / pl.TX;
  pl.n_zt = (Z + kTZ - 1) / kTZ;
  const long slots = 132L * (pl.smem <= kMaxSmem / 2 ? 2 : 1);
  const long tiles = (long)pl.n_xt * pl.n_zt * B;
  const int g_min = ky3 ? 4 : 1;
  long best = -1;
  for (int G = Y;; G = (G + 1) / 2) {
    const long waves = (tiles * ((Y + G - 1) / G) + slots - 1) / slots;
    const long cost = waves * (G + (ky3 ? 2 : 0));
    if (best < 0 || cost < best) {
      best = cost;
      pl.G = G;
    }
    if (G <= g_min) break;
  }
  pl.n_yc = (Y + pl.G - 1) / pl.G;
  return pl;
}

template <typename T, bool KY3>
int launch(Params p, int B, cudaStream_t stream) {
  const Plan pl = make_plan(sizeof(T), KY3, B, p.Y, p.X, p.Z, p.ci, p.co);
  if (pl.TX == 0) return (int)cudaErrorInvalidValue;
  p.TX = pl.TX;
  p.G = pl.G;
  p.n_xt = pl.n_xt;
  int rc = (int)cudaFuncSetAttribute(fused_block_kernel<T, KY3>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)kMaxSmem);
  if (rc != 0) return rc;
  const dim3 grid(pl.n_xt * pl.n_zt, pl.n_yc, B);
  fused_block_kernel<T, KY3><<<grid, kThreads, pl.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiling a call would take: out[0] = TX, out[1] = G, out[2] = shared
// memory bytes per block, out[3] = blocks; returns 0, or 1 when the tiles of
// these channel counts do not fit in shared memory.  dtype as below.
extern "C" int mmf_fused_block_plan(int dtype, int n_conv, int B, int Y, int X, int Z,
                                    int ci, int co, long long* out) {
  const Plan pl = make_plan(dtype == 0 ? 4 : 2, n_conv == 3, B, Y, X, Z, ci, co);
  out[0] = pl.TX;
  out[1] = pl.G;
  out[2] = (long long)pl.smem;
  out[3] = (long long)pl.n_xt * pl.n_zt * pl.n_yc * B;
  return pl.TX == 0 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  n_conv 2: two (1,3,3) convs; 3: (1,3,3),
// (1,3,3), (3,1,1).  final_mode: 0 raw, 1 affine, 2 relu, 3 res_id (ci ==
// co), 4 res_conv (wd, sd, bd given).  x (B, Y, X, Z, ci) and out (B, Y, X,
// Z, co) in the storage type, contiguous; s_in / b_in (ci) both null or both
// given; w_j fp32 contiguous (kY, kX, kz, c_in, co); s_j / b_j (co) in the
// storage type, the last conv's null for raw; wd fp32 (1, 1, 1, ci, co), sd /
// bd (co).  ci % 8 == 0, co % 16 == 0.  ext: null, or host memory holding
// the true extents {yt, xt, zt} (1 <= yt <= Y, ...).  Returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int mmf_fused_block(int dtype, int n_conv, int final_mode, int relu0,
                               const void* x, const void* s_in, const void* b_in,
                               const void* w0, const void* s0, const void* b0,
                               const void* w1, const void* s1, const void* b1,
                               const void* w2, const void* s2, const void* b2,
                               const void* wd, const void* sd, const void* bd, void* out,
                               const int* ext, int B, int Y, int X, int Z, int ci, int co,
                               void* stream) {
  if (ci % kCI != 0 || co % kCO != 0 || (n_conv != 2 && n_conv != 3) || final_mode < kRaw ||
      final_mode > kResConv)
    return (int)cudaErrorInvalidValue;
  if ((s_in == nullptr) != (b_in == nullptr)) return (int)cudaErrorInvalidValue;
  if (final_mode == kResId && ci != co) return (int)cudaErrorInvalidValue;
  if (final_mode == kResConv && (wd == nullptr || sd == nullptr || bd == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* s_last = n_conv == 3 ? s2 : s1;
  if (final_mode != kRaw && s_last == nullptr) return (int)cudaErrorInvalidValue;
  if (ext != nullptr && (ext[0] < 1 || ext[0] > Y || ext[1] < 1 || ext[1] > X || ext[2] < 1 ||
                         ext[2] > Z))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.s_in = s_in;
  p.b_in = b_in;
  p.w[0] = static_cast<const float*>(w0);
  p.w[1] = static_cast<const float*>(w1);
  p.w[2] = static_cast<const float*>(w2);
  p.s[0] = s0;
  p.s[1] = s1;
  p.s[2] = s2;
  p.b[0] = b0;
  p.b[1] = b1;
  p.b[2] = b2;
  p.wd = static_cast<const float*>(wd);
  p.sd = sd;
  p.bd = bd;
  p.out = out;
  p.Y = Y;
  p.X = X;
  p.Z = Z;
  p.ci = ci;
  p.co = co;
  p.yt = ext != nullptr ? ext[0] : Y;
  p.xt = ext != nullptr ? ext[1] : X;
  p.zt = ext != nullptr ? ext[2] : Z;
  p.relu0 = relu0;
  p.final_mode = final_mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return n_conv == 3 ? launch<float, true>(p, B, s) : launch<float, false>(p, B, s);
  if (dtype == 1)
    return n_conv == 3 ? launch<__nv_bfloat16, true>(p, B, s)
                       : launch<__nv_bfloat16, false>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
