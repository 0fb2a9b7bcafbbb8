// Narrow-entry convolution (K10) on channels-last volumes, and its weight
// gradient (Hopper, sm_90a).
//
//   y[b,p,o]    = sum_{tap,i} xin[b, p + tap - k/2, i] * w[tap, i, o]
//   dw[tap,i,o] = sum_{b,p}   xin[b, p + tap - k/2, i] * g[b, p, o]
//
// x (B, Y, X, Z, ci), w (kY, kX, kz, ci, co), y and g (B, Y, X, Z, co), all
// contiguous; stride 1, SAME padding, every tap in {1, 3}.  xin reads 0
// outside the volume and, with extents (yt, xt, zt), at or beyond them.  No
// affine and no ReLU: the identity prologue.  fp32 or bf16 in and out, fp32
// accumulation, one rounding per output.  The data gradient is this same
// forward on g with the flipped, (ci, co)-transposed kernel (the wrapper
// builds it), as the JAX package's `_bcb_bwd` computes it.
//
// Replaces multimodal_fusion_fpn_tpu/ops/pallas/banded_conv.py `_kernel`
// (launched by `banded_conv_blocked_pallas`): the same conv as band and wrap
// matmuls over z-blocked rows with row rolls, a TPU layout that a
// contiguous channels-last tensor makes unnecessary.
//
// Bound on the H100: memory.  At the port's shapes (ci = 1 -> co = 16, or
// the data gradient's ci = 16 -> co = 1) a call does 2 * taps FLOP per byte
// of output or input at most, far below the card's 20 FLOP/B of fp32 CUDA
// cores against HBM, so the least time is the bytes of x, w and y (x and g
// for the weight gradient) at 3.35 TB/s.
//
// Design.  Forward, the entry kernel (narrow_fwd_kernel): ci = 1 -> co = 16
// with at most 9 taps, the model's entry convs and 1x1x1 downsamples; it
// stages x in shared memory by tiles of whole output rows, keeps its taps'
// weights in registers and stores each warp's output as whole lines (see
// the note above it).  Forward, the generic kernel (banded_fwd_kernel), for
// every other call (the data gradient, ci > 1, co != 16, 27 taps): one
// thread per output position, consecutive threads on consecutive z, all co
// accumulators in registers; the weights (as fp32, in chunks of taps when
// they do not fit in 48 KB) and a table of the taps' offsets in shared
// memory, read as broadcasts; x read through the read-only cache
// (neighbouring taps of a warp hit the same lines); the co-wide output row
// stored as 16-byte vectors.  Both add the taps in the same order, so the
// entry kernel gives the generic kernel's bits (mmf_banded_conv_generic
// runs the generic kernel on any call, for that comparison).  Weight
// gradient: block (position chunk, tap group) with threads
// as (position lane, input channel); each thread loads a g row once per
// position and adds it, times the shifted x, into every tap of its group;
// the lanes are summed in shared memory in a fixed order, one partial per
// chunk goes to a workspace, and a second kernel adds the partials in chunk
// order.  No float atomics: two runs give bitwise equal results.

#include <algorithm>

#include "fused_conv_common.cuh"

namespace {

using mmf::FastDiv;
using mmf::fast_div;
using mmf::to_f;

constexpr int kFwdThreads = 256;
constexpr int kWgradThreads = 128;
// fp32 weights in shared memory: 48 KB, less the static tap table
constexpr int kWBudget = (48 * 1024 - 27 * 16) / 4;
constexpr int kMaxWgradAcc = 144;           // accumulators per wgrad thread
constexpr long long kMaxWork = 1 << 22;     // floats of wgrad partials (16 MB)

// 8 consecutive values of x as floats (16-byte aligned p).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

// acc[o] += v * w[o], w in shared memory (16-byte aligned when CO % 4 == 0).
template <int CO>
__device__ __forceinline__ void fma_row(float* acc, float v, const float* w) {
  if constexpr (CO % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CO / 4; ++q) {
      const float4 wq = reinterpret_cast<const float4*>(w)[q];
      acc[4 * q] = fmaf(v, wq.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = fmaf(v, w[o], acc[o]);
  }
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// The CO-wide row, rounded once (16-byte stores for CO % 16 == 0).
template <int CO, typename T>
__device__ __forceinline__ void store_row(T* dst, const float* acc) {
  if constexpr (CO % 16 == 0) {
#pragma unroll
    for (int q = 0; q < CO / 16; ++q) mmf::store16(dst + 16 * q, acc + 16 * q);
  } else {
#pragma unroll
    for (int o = 0; o < CO; ++o) store1(dst + o, acc[o]);
  }
}

// The CO-wide row of g as floats (vector loads when vec and CO % 8 == 0).
template <int CO, typename T>
__device__ __forceinline__ void load_row(const T* src, float* v, int vec) {
  if constexpr (CO % 8 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < CO / 8; ++q) load8(src + 8 * q, v + 8 * q);
      return;
    }
  }
#pragma unroll
  for (int o = 0; o < CO; ++o) v[o] = to_f(src[o]);
}

struct Geom {
  int B, Y, X, Z, ci, ky, kx, kz;
  int ly, lx, lz;  // read limits: the extents, or (Y, X, Z)
};

// Tap t's offsets (dy, dx, dz) from the output position and the distance
// of its x row from the position's own, in elements; a block fills the
// table for its taps once, so no tap index is divided per position.
__device__ __forceinline__ int4 tap_offsets(const Geom& g, int t) {
  const int dz = t % g.kz, dxy = t / g.kz;
  const int oy = dxy / g.kx - g.ky / 2, ox = dxy % g.kx - g.kx / 2;
  const int oz = dz - g.kz / 2;
  return make_int4(oy, ox, oz, ((oy * g.X + ox) * g.Z + oz) * g.ci);
}

// The x row that a tap with offsets o reads from position p = (y, x, z), or
// null where xin is 0.
template <typename T>
__device__ __forceinline__ const T* tap_row(const T* x, const Geom& g, int p,
                                            int yy, int xx, int zz, int4 o) {
  if ((unsigned)(yy + o.x) >= (unsigned)g.ly ||
      (unsigned)(xx + o.y) >= (unsigned)g.lx ||
      (unsigned)(zz + o.z) >= (unsigned)g.lz)
    return nullptr;
  return x + (int64_t)p * g.ci + o.w;
}

// (y, x, z) of position p = ((b * Y + y) * X + x) * Z + z.
__device__ __forceinline__ void decode(const Geom& g, int p, int* yy, int* xx,
                                       int* zz) {
  *zz = p % g.Z;
  p /= g.Z;
  *xx = p % g.X;
  *yy = (p / g.X) % g.Y;
}

template <typename T, int CO>
__global__ void __launch_bounds__(kFwdThreads)
banded_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, Geom g, int tchunk, int vec) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // tchunk taps of (ci, CO)
  __shared__ int4 offs[27];
  const int ntap = g.ky * g.kx * g.kz;
  const int per_tap = g.ci * CO;
  const int npos = g.B * g.Y * g.X * g.Z;
  const bool whole = tchunk >= ntap;
  if (threadIdx.x < ntap) offs[threadIdx.x] = tap_offsets(g, threadIdx.x);
  if (whole)
    for (int k = threadIdx.x; k < ntap * per_tap; k += blockDim.x) ws[k] = to_f(w[k]);
  __syncthreads();
  for (int base = blockIdx.x * blockDim.x; base < npos;
       base += gridDim.x * blockDim.x) {
    const int p = base + threadIdx.x;
    const bool active = p < npos;
    int yy = 0, xx = 0, zz = 0;
    if (active) decode(g, p, &yy, &xx, &zz);
    float acc[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = 0.f;
    for (int t0 = 0; t0 < ntap; t0 += tchunk) {
      const int t1 = min(ntap, t0 + tchunk);
      if (!whole) {
        __syncthreads();
        for (int k = threadIdx.x; k < (t1 - t0) * per_tap; k += blockDim.x)
          ws[k] = to_f(w[(int64_t)t0 * per_tap + k]);
        __syncthreads();
      }
      if (!active) continue;
      for (int t = t0; t < t1; ++t) {
        const T* xr = tap_row(x, g, p, yy, xx, zz, offs[t]);
        if (xr == nullptr) continue;
        const float* wt = ws + (t - t0) * per_tap;
        if (vec) {
          for (int i = 0; i < g.ci; i += 8) {
            float v[8];
            load8(xr + i, v);
#pragma unroll
            for (int j = 0; j < 8; ++j) fma_row<CO>(acc, v[j], wt + (i + j) * CO);
          }
        } else {
          for (int i = 0; i < g.ci; ++i) fma_row<CO>(acc, to_f(__ldg(xr + i)), wt + i * CO);
        }
      }
    }
    if (active) store_row<CO>(y + (int64_t)p * CO, acc);
  }
}

// One partial of dw per (position chunk, tap): part[chunk][tap][i][o].
template <typename T, int CO, int TT>
__global__ void __launch_bounds__(kWgradThreads)
banded_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                    float* __restrict__ part, Geom g, int chunk, int vec) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // (lanes, ci, CO)
  __shared__ int4 offs[TT];
  const int ntap = g.ky * g.kx * g.kz;
  const int npos = g.B * g.Y * g.X * g.Z;
  const int lanes = blockDim.x / g.ci;
  const int i = threadIdx.x % g.ci, lane = threadIdx.x / g.ci;
  const bool on = lane < lanes;
  const int tb = blockIdx.y * TT;
  if (threadIdx.x < TT) offs[threadIdx.x] = tap_offsets(g, tb + threadIdx.x);
  __syncthreads();
  float acc[TT][CO];
#pragma unroll
  for (int tt = 0; tt < TT; ++tt)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[tt][o] = 0.f;
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(npos, p0 + chunk);
  if (on) {
    for (int p = p0 + lane; p < p1; p += lanes) {
      int yy, xx, zz;
      decode(g, p, &yy, &xx, &zz);
      float gv[CO];
      load_row<CO>(gr + (int64_t)p * CO, gv, vec);
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        const T* xr = tap_row(x, g, p, yy, xx, zz, offs[tt]);
        if (xr == nullptr) continue;
        const float xv = to_f(__ldg(xr + i));
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[tt][o] = fmaf(xv, gv[o], acc[tt][o]);
      }
    }
  }
  const int nout = g.ci * CO;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    __syncthreads();
    if (on) {
#pragma unroll
      for (int o = 0; o < CO; ++o) red[(lane * g.ci + i) * CO + o] = acc[tt][o];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nout; k += blockDim.x) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[l * nout + k];
      part[((int64_t)blockIdx.x * ntap + tb + tt) * nout + k] = s;
    }
  }
}

// dw[k] = the chunks' partials added in chunk order, rounded once.
template <typename T>
__global__ void banded_wgrad_finish(const float* __restrict__ part,
                                    T* __restrict__ dw, int nchunks, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += part[(int64_t)c * n + k];
  store1(dw + k, s);
}

bool taps_ok(int ky, int kx, int kz) {
  auto ok = [](int k) { return k == 1 || k == 3; };
  return ok(ky) && ok(kx) && ok(kz);
}

bool co_ok(int co) { return co == 1 || co == 16 || co == 32 || co == 64; }

// Fills g; false where the kernels take no such call.
bool geometry(int ky, int kx, int kz, const int* dyn, int B, int Y, int X,
              int Z, int ci, int co, Geom* g) {
  if (!taps_ok(ky, kx, kz) || ci < 1 || ci > 64 || !co_ok(co)) return false;
  if (B < 1 || Y < 1 || X < 1 || Z < 1) return false;
  if ((long long)B * Y * X * Z >= (1LL << 30)) return false;
  *g = Geom{B, Y, X, Z, ci, ky, kx, kz, Y, X, Z};
  if (dyn != nullptr) {
    if (dyn[0] < 1 || dyn[0] > Y || dyn[1] < 1 || dyn[1] > X || dyn[2] < 1 ||
        dyn[2] > Z)
      return false;
    g->ly = dyn[0];
    g->lx = dyn[1];
    g->lz = dyn[2];
  }
  return true;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- The entry forward: ci = 1 -> co = 16, at most 9 taps (the model's) --
//
// A block owns tiles of R whole output rows (b, y, x) over a z range of at
// most kMaxZB; in channels-last order a tile of y that spans all of Z (the
// model's) is one contiguous run of R * Z * 16 values.  For each tile row and each (dy, dx) tap row it
// stages the x row that tap reads, with a z halo of kz / 2, in shared
// memory as fp32, zero outside the volume and at or beyond the extents;
// the inner loop then has no bounds checks and no per-tap address math.  A
// thread owns one 16-byte chunk of every position it computes (8 channels
// in bf16, 4 in fp32), so consecutive lanes store consecutive chunks and a
// warp store fills whole 128-byte lines; its taps' weights for those
// channels sit in registers as fp32.  Blocks loop over tiles; the x of the
// next tile is loaded into registers (16-byte vectors, kSlots a thread)
// while the current tile computes.  Z % (16 / sizeof(T)) != 0, or an x that
// is not 16-byte aligned, stages with scalar loads instead.  The sum is the
// generic kernel's: fp32 fmaf over the taps in (dy, dx, dz) order, one
// rounding per output; a tap outside the volume adds 0 * w where the
// generic kernel skips it, which gives the same bits unless a partial sum
// has underflowed to -0 or a weight is not finite.
constexpr int kNarrowCO = 16;
constexpr int kNarrowThreads = 256;
constexpr int kSlots = 4;        // 16-byte x vectors a thread prefetches
constexpr int kTilePos = 2048;   // output positions per tile, about
constexpr int kMaxZB = 1024;     // z positions per tile, at most

struct Narrow {
  Geom g;
  int R;       // output rows per tile
  int ZB;      // z positions per tile (the last z block may be shorter)
  int nzb;     // z blocks per row
  int ntiles;
  int ZS;      // floats per staged row: z0 - 1 at 3, z0 at 4, z0 + ZBt at 4 + ZBt
  FastDiv by_X, by_Y, by_nzb, by_nv, by_nv_last;  // nv: vectors per z block
};

struct Tile {
  int r0, Rt, z0, ZBt, last;
};
__device__ __forceinline__ Tile tile_at(const Narrow& n, int tile) {
  const int rb = n.by_nzb.div(tile), zb = tile - rb * n.nzb;
  const int rows = n.g.B * n.g.Y * n.g.X;
  Tile t;
  t.r0 = rb * n.R;
  t.Rt = min(n.R, rows - t.r0);
  t.z0 = zb * n.ZB;
  t.ZBt = min(n.ZB, n.g.Z - t.z0);
  t.last = zb == n.nzb - 1;
  return t;
}

// Whether output row r's tap row (y + oy, x + ox) lies inside the read
// limits, and its offset in x (ci = 1).
__device__ __forceinline__ bool tap_source(const Narrow& n, int r, int oy, int ox, int* off) {
  const int q = n.by_X.div(r);
  const int xx = r - q * n.g.X;
  const int yy = q - n.by_Y.div(q) * n.g.Y;
  *off = (r + oy * n.g.X + ox) * n.g.Z;
  return (unsigned)(yy + oy) < (unsigned)n.g.ly && (unsigned)(xx + ox) < (unsigned)n.g.lx;
}

// What a thread carries from loading a tile's x to staging it.
struct Slots {
  uint4 v[kSlots];
  int info[kSlots];  // (shared-memory float offset << 4) | values in the volume, or -1
  float halo;
  int halo_at;       // shared-memory float offset, or -1
};

template <typename T, int KY, int KX, int KZ>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, const Narrow& n, int tile,
                                          Slots& s) {
  constexpr int VE = 16 / sizeof(T), KYX = KY * KX;
  const Tile t = tile_at(n, tile);
  const int nv = t.ZBt / VE;
  const FastDiv& by_nv = t.last ? n.by_nv_last : n.by_nv;
  const int nvec = t.Rt * KYX * nv;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int i = threadIdx.x + k * kNarrowThreads;
    s.info[k] = -1;
    s.v[k] = make_uint4(0, 0, 0, 0);
    if (i < nvec) {
      const int rc = by_nv.div(i), v = i - rc * nv;
      const int j = rc / KYX, dyx = rc - j * KYX;
      int off;
      const bool in = tap_source(n, t.r0 + j, dyx / KX - KY / 2, dyx % KX - KX / 2, &off);
      const int z = t.z0 + v * VE;
      const int valid = in ? max(0, min(VE, n.g.lz - z)) : 0;
      if (valid > 0) s.v[k] = __ldg(reinterpret_cast<const uint4*>(x + off + z));
      s.info[k] = ((rc * n.ZS + 4 + v * VE) << 4) | valid;
    }
  }
  s.halo_at = -1;
  s.halo = 0.f;
  if constexpr (KZ == 3) {
    if ((int)threadIdx.x < t.Rt * KYX * 2) {
      const int rc = threadIdx.x >> 1, side = threadIdx.x & 1;
      const int j = rc / KYX, dyx = rc - j * KYX;
      int off;
      const bool in = tap_source(n, t.r0 + j, dyx / KX - KY / 2, dyx % KX - KX / 2, &off);
      const int z = side ? t.z0 + t.ZBt : t.z0 - 1;
      if (in && z >= 0 && z < n.g.lz) s.halo = to_f(__ldg(x + off + z));
      s.halo_at = rc * n.ZS + (side ? 4 + t.ZBt : 3);
    }
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float* f, const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 p = __bfloat1622float2(h[q]);
    f[2 * q] = p.x;
    f[2 * q + 1] = p.y;
  }
}

template <typename T>
__device__ __forceinline__ void stage_slots(const Slots& s, float* sm) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (s.info[k] < 0) continue;
    const int valid = s.info[k] & 15;
    float f[VE];
    unpack(s.v[k], f, static_cast<const T*>(nullptr));
#pragma unroll
    for (int e = 0; e < VE; ++e)
      if (e >= valid) f[e] = 0.f;
    float4* d = reinterpret_cast<float4*>(sm + (s.info[k] >> 4));
#pragma unroll
    for (int q = 0; q < VE / 4; ++q) d[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  }
  if (s.halo_at >= 0) sm[s.halo_at] = s.halo;
}

// The tile's x, staged with scalar loads (any Z, any alignment).
template <typename T, int KY, int KX, int KZ>
__device__ __forceinline__ void stage_scalar(const T* __restrict__ x, const Narrow& n, int tile,
                                             float* sm) {
  constexpr int KYX = KY * KX;
  const Tile t = tile_at(n, tile);
  const int span = t.ZBt + 2 * (KZ / 2);
  const int total = t.Rt * KYX * span;
  for (int i = threadIdx.x; i < total; i += kNarrowThreads) {
    const int rc = i / span, zi = i - rc * span;
    const int j = rc / KYX, dyx = rc - j * KYX;
    int off;
    const bool in = tap_source(n, t.r0 + j, dyx / KX - KY / 2, dyx % KX - KX / 2, &off);
    const int z = t.z0 - KZ / 2 + zi;
    sm[rc * n.ZS + 4 - KZ / 2 + zi] =
        in && z >= 0 && z < n.g.lz ? to_f(__ldg(x + off + z)) : 0.f;
  }
}

__device__ __forceinline__ void store_chunk(float* dst, const float* acc) {
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float* acc) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
  *reinterpret_cast<uint4*>(dst) = r;
}

template <typename T, int KY, int KX, int KZ>
__global__ void __launch_bounds__(kNarrowThreads, 2)
narrow_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                  const Narrow n, int vec) {
  constexpr int CH = 16 / sizeof(T);            // channels of a 16-byte chunk
  constexpr int NCH = kNarrowCO / CH;           // chunks per position
  constexpr int NT = KY * KX * KZ, KYX = KY * KX;
  constexpr int STEP = kNarrowThreads / NCH;    // positions per pass of the block
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = threadIdx.x % NCH;
  float wr[NT][CH];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < CH; ++c) wr[t][c] = to_f(w[t * kNarrowCO + h * CH + c]);
  Slots s;
  int tile = blockIdx.x;
  if (vec) load_tile<T, KY, KX, KZ>(x, n, tile, s);
  for (; tile < n.ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's reads are done
    if (vec)
      stage_slots<T>(s, sm);
    else
      stage_scalar<T, KY, KX, KZ>(x, n, tile, sm);
    __syncthreads();
    if (vec && tile + (int)gridDim.x < n.ntiles)
      load_tile<T, KY, KX, KZ>(x, n, tile + gridDim.x, s);
    const Tile t = tile_at(n, tile);
    T* yt = y + ((int64_t)t.r0 * n.g.Z + t.z0) * kNarrowCO + h * CH;
    int q = threadIdx.x / NCH;  // position in the tile, row-major
    int j = q / t.ZBt, zz = q - j * t.ZBt;
    while (j < t.Rt) {
      const float* sx = sm + j * KYX * n.ZS + 4 + zz - KZ / 2;
      float acc[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = 0.f;
#pragma unroll
      for (int dyx = 0; dyx < KYX; ++dyx)
#pragma unroll
        for (int dz = 0; dz < KZ; ++dz) {
          const float v = sx[dyx * n.ZS + dz];
#pragma unroll
          for (int c = 0; c < CH; ++c) acc[c] = fmaf(v, wr[dyx * KZ + dz][c], acc[c]);
        }
      store_chunk(yt + (int64_t)(j * n.g.Z + zz) * kNarrowCO, acc);
      q += STEP;
      if (zz + STEP < t.ZBt) {
        zz += STEP;
      } else {
        j = q / t.ZBt;
        zz = q - j * t.ZBt;
      }
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

template <typename T, int KY, int KX, int KZ>
int launch_narrow(const T* x, const T* w, T* out, const Geom& g, cudaStream_t s) {
  constexpr int VE = 16 / sizeof(T), KYX = KY * KX;
  static const int occupancy = [] {
    int blocks = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, narrow_fwd_kernel<T, KY, KX, KZ>, kNarrowThreads, 40 * 1024);
    return blocks < 1 ? 1 : blocks;
  }();
  Narrow n{};
  n.g = g;
  const int rows = g.B * g.Y * g.X;
  const int vec = g.Z % VE == 0 && aligned16(x);
  n.ZB = std::min(g.Z, kMaxZB);
  if (vec) n.ZB = std::min(n.ZB, kSlots * kNarrowThreads * VE / KYX / VE * VE);
  n.ZS = (n.ZB + 5 + 3) / 4 * 4;
  // rows per tile: about kTilePos positions, within the prefetch slots, the
  // halo threads (2 per staged row) and 48 KB of shared memory
  n.R = std::max(1, kTilePos / n.ZB);
  if (vec) n.R = std::min(n.R, kSlots * kNarrowThreads / (KYX * (n.ZB / VE)));
  n.R = std::min({n.R, kNarrowThreads / 2 / KYX, 48 * 1024 / 4 / (KYX * n.ZS), rows});
  n.R = std::max(1, n.R);
  n.nzb = (g.Z + n.ZB - 1) / n.ZB;
  n.ntiles = (rows + n.R - 1) / n.R * n.nzb;
  n.by_X = fast_div(g.X);
  n.by_Y = fast_div(g.Y);
  n.by_nzb = fast_div(n.nzb);
  n.by_nv = fast_div(std::max(1, n.ZB / VE));
  n.by_nv_last = fast_div(std::max(1, (g.Z - (n.nzb - 1) * n.ZB) / VE));
  const size_t smem = (size_t)n.R * KYX * n.ZS * sizeof(float);
  const int blocks = std::min(n.ntiles, sm_count() * occupancy);
  narrow_fwd_kernel<T, KY, KX, KZ><<<blocks, kNarrowThreads, smem, s>>>(x, w, out, n, vec);
  return (int)cudaGetLastError();
}

// The entry forward's instance for the taps, or -1 for 27 taps.
template <typename T>
int dispatch_narrow(const void* xv, const void* wv, void* ov, const Geom& g, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* o = static_cast<T*>(ov);
  switch (g.ky * 100 + g.kx * 10 + g.kz) {
    case 111: return launch_narrow<T, 1, 1, 1>(x, w, o, g, s);
    case 113: return launch_narrow<T, 1, 1, 3>(x, w, o, g, s);
    case 131: return launch_narrow<T, 1, 3, 1>(x, w, o, g, s);
    case 311: return launch_narrow<T, 3, 1, 1>(x, w, o, g, s);
    case 133: return launch_narrow<T, 1, 3, 3>(x, w, o, g, s);
    case 313: return launch_narrow<T, 3, 1, 3>(x, w, o, g, s);
    case 331: return launch_narrow<T, 3, 3, 1>(x, w, o, g, s);
  }
  return -1;
}

template <typename T, int CO>
int launch_fwd(const void* x, const void* w, void* out, const Geom& g,
               cudaStream_t s) {
  const int ntap = g.ky * g.kx * g.kz;
  const int tchunk = std::min(ntap, std::max(1, kWBudget / (g.ci * CO)));
  const int npos = g.B * g.Y * g.X * g.Z;
  const int vec = g.ci % 8 == 0 && aligned16(x);
  const int need = (npos + kFwdThreads - 1) / kFwdThreads;
  const int blocks = std::min(need, 132 * 16);
  banded_fwd_kernel<T, CO><<<blocks, kFwdThreads,
                             tchunk * g.ci * CO * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      g, tchunk, vec);
  return (int)cudaGetLastError();
}

// entry: the entry kernel where it takes the call (else the generic one)
template <typename T>
int dispatch_fwd(const void* x, const void* w, void* out, const Geom& g,
                 int co, bool entry, cudaStream_t s) {
  if (entry && g.ci == 1 && co == kNarrowCO) {
    const int rc = dispatch_narrow<T>(x, w, out, g, s);
    if (rc >= 0) return rc;
  }
  switch (co) {
    case 1: return launch_fwd<T, 1>(x, w, out, g, s);
    case 16: return launch_fwd<T, 16>(x, w, out, g, s);
    case 32: return launch_fwd<T, 32>(x, w, out, g, s);
    case 64: return launch_fwd<T, 64>(x, w, out, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Taps per wgrad thread: every tap of the conv where the accumulators fit.
int taps_per_thread(int ntap, int co) {
  int tt = ntap;
  while (tt > 1 && tt * co > kMaxWgradAcc) tt /= 3;
  return tt;
}

struct WgradPlan {
  int tt, nchunks, chunk;
};

WgradPlan wgrad_plan(const Geom& g, int co) {
  const int ntap = g.ky * g.kx * g.kz;
  const int tt = taps_per_thread(ntap, co);
  const long long npos = (long long)g.B * g.Y * g.X * g.Z;
  const long long n = (long long)ntap * g.ci * co;
  // about four blocks per SM, each with at least 1024 positions, within the
  // workspace cap
  long long nchunks = (132LL * 4 + ntap / tt - 1) / (ntap / tt);
  nchunks = std::min(nchunks, (npos + 1023) / 1024);
  nchunks = std::max(1LL, std::min(nchunks, kMaxWork / n));
  const int chunk = (int)((npos + nchunks - 1) / nchunks);
  return WgradPlan{tt, (int)((npos + chunk - 1) / chunk), chunk};
}

template <typename T, int CO, int TT>
int launch_wgrad(const void* x, const void* gr, void* dw, float* work,
                 const Geom& g, const WgradPlan& plan, cudaStream_t s) {
  const int ntap = g.ky * g.kx * g.kz;
  const int vec = aligned16(gr);
  const dim3 grid(plan.nchunks, ntap / TT);
  const int lanes = kWgradThreads / g.ci;
  banded_wgrad_kernel<T, CO, TT><<<grid, kWgradThreads,
                                   lanes * g.ci * CO * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr), work, g, plan.chunk,
      vec);
  const int n = ntap * g.ci * CO;
  banded_wgrad_finish<T><<<(n + 255) / 256, 256, 0, s>>>(
      work, static_cast<T*>(dw), plan.nchunks, n);
  return (int)cudaGetLastError();
}

template <typename T, int CO>
int wgrad_taps(const void* x, const void* gr, void* dw, float* work,
               const Geom& g, const WgradPlan& plan, cudaStream_t s) {
  switch (plan.tt) {
    case 1: return launch_wgrad<T, CO, 1>(x, gr, dw, work, g, plan, s);
    case 3:
      if constexpr (3 * CO <= kMaxWgradAcc)
        return launch_wgrad<T, CO, 3>(x, gr, dw, work, g, plan, s);
      break;
    case 9:
      if constexpr (9 * CO <= kMaxWgradAcc)
        return launch_wgrad<T, CO, 9>(x, gr, dw, work, g, plan, s);
      break;
    case 27:
      if constexpr (27 * CO <= kMaxWgradAcc)
        return launch_wgrad<T, CO, 27>(x, gr, dw, work, g, plan, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_wgrad(const void* x, const void* gr, void* dw, float* work,
                   const Geom& g, int co, cudaStream_t s) {
  const WgradPlan plan = wgrad_plan(g, co);
  switch (co) {
    case 1: return wgrad_taps<T, 1>(x, gr, dw, work, g, plan, s);
    case 16: return wgrad_taps<T, 16>(x, gr, dw, work, g, plan, s);
    case 32: return wgrad_taps<T, 32>(x, gr, dw, work, g, plan, s);
    case 64: return wgrad_taps<T, 64>(x, gr, dw, work, g, plan, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: x (B, Y, X, Z, ci), w (ky, kx,
// kz, ci, co), out (B, Y, X, Z, co), all contiguous; ky, kx, kz in {1, 3},
// 1 <= ci <= 64, co in {1, 16, 32, 64}.  dyn is NULL, or host memory holding
// x's true extents {yt, xt, zt} (1 <= yt <= Y, ...).  Returns the
// cudaGetLastError() of the launch (0 on success).
static int banded_conv(int dtype, int ky, int kx, int kz, const void* x,
                       const void* w, void* out, const int* dyn, int B, int Y,
                       int X, int Z, int ci, int co, bool entry, void* stream) {
  Geom g;
  if (!geometry(ky, kx, kz, dyn, B, Y, X, Z, ci, co, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fwd<float>(x, w, out, g, co, entry, s);
  if (dtype == 1) return dispatch_fwd<__nv_bfloat16>(x, w, out, g, co, entry, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mmf_banded_conv(int dtype, int ky, int kx, int kz, const void* x,
                               const void* w, void* out, const int* dyn, int B,
                               int Y, int X, int Z, int ci, int co,
                               void* stream) {
  return banded_conv(dtype, ky, kx, kz, x, w, out, dyn, B, Y, X, Z, ci, co, true,
                     stream);
}

// mmf_banded_conv on the generic kernel only, for comparing the entry
// kernel with it (the model never calls it).
extern "C" int mmf_banded_conv_generic(int dtype, int ky, int kx, int kz,
                                       const void* x, const void* w, void* out,
                                       const int* dyn, int B, int Y, int X,
                                       int Z, int ci, int co, void* stream) {
  return banded_conv(dtype, ky, kx, kz, x, w, out, dyn, B, Y, X, Z, ci, co,
                     false, stream);
}

// Bytes of the workspace mmf_banded_conv_wgrad needs (0 for a call it does
// not take).
extern "C" unsigned long long mmf_banded_conv_wgrad_work_bytes(
    int ky, int kx, int kz, int B, int Y, int X, int Z, int ci, int co) {
  Geom g;
  if (!geometry(ky, kx, kz, nullptr, B, Y, X, Z, ci, co, &g)) return 0;
  const WgradPlan plan = wgrad_plan(g, co);
  return (unsigned long long)plan.nchunks * ky * kx * kz * ci * co * sizeof(float);
}

// dw (ky, kx, kz, ci, co) in x's dtype from x (B, Y, X, Z, ci) and the output
// cotangent g (B, Y, X, Z, co); work as mmf_banded_conv_wgrad_work_bytes
// says.  dyn as for mmf_banded_conv.
extern "C" int mmf_banded_conv_wgrad(int dtype, int ky, int kx, int kz,
                                     const void* x, const void* g, void* dw,
                                     void* work, const int* dyn, int B, int Y,
                                     int X, int Z, int ci, int co,
                                     void* stream) {
  Geom geo;
  if (!geometry(ky, kx, kz, dyn, B, Y, X, Z, ci, co, &geo) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  if (dtype == 0) return dispatch_wgrad<float>(x, g, dw, wk, geo, co, s);
  if (dtype == 1)
    return dispatch_wgrad<__nv_bfloat16>(x, g, dw, wk, geo, co, s);
  return (int)cudaErrorInvalidValue;
}
