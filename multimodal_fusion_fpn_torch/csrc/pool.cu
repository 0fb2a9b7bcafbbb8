// Channels-last max pool with window == stride (Hopper, sm_90a).
//
//   out[b,y,x,z,c] = max over the (wy, wx, wz) window at (y*wy, x*wx, z*wz)
//   of in[b, ., ., ., c]; output extents are floor(n / w) per axis, as in
//   torch's MaxPool3d with its default stride.  A window that holds a NaN
//   gives NaN, as jnp.maximum does (the forward returns the canonical NaN
//   of the type, 0x7fff in bf16 and 0x7fffffff in fp32, whatever the
//   input's NaN was; the backward does not depend on which NaN it is).
//
// Replaces the TPU kernels multimodal_fusion_fpn_tpu/ops/pallas/pool.py
// `_pool_fwd_impl` (`_fwd_row_kernel`, and `_fwd_kernel` where the row kernel
// does not apply; K5f) and `_pool_vjp_bwd` (`_bwd_row_kernel` / `_bwd_kernel`,
// K5b: the cotangent goes to every tied max, `_tie_mask`).  The TPU kernels
// pool the packed (bs, nb) layout with z-slot pairs; on channels-last data
// this is a plain max pool.
//
// Bound on the H100: memory.  Each input byte is read once and each output
// byte written once (1 + 1/(wy*wx*wz) bytes per input byte), with no reuse;
// the backward reads x, out and g once and writes dx once.
// Both kernels run over a grid of row units: unit u < Yo of an image is
// pooled row u (its wy input rows), and, in the backward only, unit u >= Yo
// one input row beyond the floor-sized region.  A unit's offsets are 32-bit
// (its base is 64-bit, once per thread), with no 64-bit division per
// element.  A thread handles 8 channels: one 16-byte vector in bf16, two in
// fp32.  C % 8 != 0, or a tensor that is not 16-byte aligned, takes the
// scalar lane path (one channel a thread) of the same kernels.
// Forward design (max_pool_fwd_kernel): a thread owns ZT consecutive pooled
// z positions (2, or 4 for windows of 2) x 8 channels and loads every input
// of its windows as a vector before it reduces them, so it keeps 8 to 16
// independent 16-byte loads in flight; in channels-last order a pooled
// z run of one input row is one contiguous run, so a warp reads whole
// lines.  The max is taken in the storage type (__hmax2_nan on bf16x2,
// max.NaN.f32), which is exact.  The main path's windows (1,2,2), (2,2,2),
// (1,1,2) and (2,1,2) are compiled instances; others take a generic one.
// A unit's items are decoded with multiply-shift division.  A block is 256
// threads, or fewer (a multiple of 32) where a unit has fewer items, as
// the 2D stages' rows do.
// Backward design (max_pool_bwd_kernel): one thread per pooled position and
// 8 channels; it loads out and g once as vectors and each of its window's
// wy*wx*wz inputs as a vector, compares lane by lane and stores dx as
// vectors; the same threads zero the rows' remainder beyond Xo*wx and
// Zo*wz, and the rows beyond Yo*wy.

#include <type_traits>

#include "fused_conv_common.cuh"

namespace {

using mmf::FastDiv;
using mmf::fast_div;

using mmf::to_f;

// V channels of T: 8 (one 16-byte vector in bf16, two in fp32) or 1.
template <typename T, int V>
struct alignas(V == 1 ? sizeof(T) : 16) Pack {
  T v[V];
};
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ldv(const T* p) {
  Pack<T, V> r;
  if constexpr (V == 1) {
    r.v[0] = p[0];
  } else {
#pragma unroll
    for (int q = 0; q < (int)(sizeof(T) * V / 16); ++q)
      reinterpret_cast<uint4*>(&r)[q] = __ldg(reinterpret_cast<const uint4*>(p) + q);
  }
  return r;
}
template <typename T, int V>
__device__ __forceinline__ void stv(T* p, const Pack<T, V>& r) {
  if constexpr (V == 1) {
    p[0] = r.v[0];
  } else {
#pragma unroll
    for (int q = 0; q < (int)(sizeof(T) * V / 16); ++q)
      reinterpret_cast<uint4*>(p)[q] = reinterpret_cast<const uint4*>(&r)[q];
  }
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// max(a, b), NaN if either is NaN (the canonical NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ __nv_bfloat16 max_nan(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}

// m = max_nan(m, x) lane by lane, on bf16x2 pairs where V is even.
template <typename T, int V>
__device__ __forceinline__ void max_into(Pack<T, V>& m, const Pack<T, V>& x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 2 == 0) {
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(m.v);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(x.v);
#pragma unroll
    for (int q = 0; q < V / 2; ++q) a[q] = __hmax2_nan(a[q], b[q]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) m.v[e] = max_nan(m.v[e], x.v[e]);
  }
}

constexpr int kLanes = 8;      // channels per thread of the vector path
constexpr int kThreads = 256;  // largest block

struct FwdDims {
  int Y, X, Z, C, Yo, Xo, Zo, wy, wx, wz;
  int nzg;       // groups of ZT pooled z positions per pooled row
  int n_chunks;  // blocks per unit
  FastDiv cv, zg;  // by C / V and by nzg
};

// Pooled row oy of image b, this thread's share (items t0, t0 + stride, ...).
// W* = 0: the window's extent from d.
template <typename T, int V, int WY, int WX, int WZ, int ZT>
__device__ __forceinline__ void pool_fwd_unit(const T* __restrict__ in, T* __restrict__ out,
                                              const FwdDims& d, int b, int oy, int t0,
                                              int stride) {
  const int wy = WY ? WY : d.wy, wx = WX ? WX : d.wx, wz = WZ ? WZ : d.wz;
  const int CV = d.C / V;
  const T* xin = in + ((int64_t)b * d.Y + (int64_t)oy * wy) * d.X * d.Z * d.C;
  T* o = out + ((int64_t)b * d.Yo + oy) * d.Xo * d.Zo * d.C;
  const int n = d.Xo * d.nzg * CV;
  for (int i = t0; i < n; i += stride) {
    const int r = d.cv.div(i);
    const int cv = i - r * CV;
    const int ox = d.zg.div(r);
    const int oz0 = (r - ox * d.nzg) * ZT;
    const int nz = min(ZT, d.Zo - oz0);
    Pack<T, V> m[ZT];
    // every load first (a ragged group rereads its last window), then the
    // reduction, in window order
#pragma unroll
    for (int k = 0; k < ZT; ++k) {
      const int z0 = (oz0 + min(k, nz - 1)) * wz;
      bool first = true;
#pragma unroll
      for (int dy = 0; dy < wy; ++dy)
#pragma unroll
        for (int dx = 0; dx < wx; ++dx)
#pragma unroll
          for (int dz = 0; dz < wz; ++dz) {
            const Pack<T, V> v = ldv<T, V>(
                xin + ((dy * d.X + ox * wx + dx) * d.Z + z0 + dz) * d.C + cv * V);
            if (first)
              m[k] = v;
            else
              max_into<T, V>(m[k], v);
            first = false;
          }
    }
#pragma unroll
    for (int k = 0; k < ZT; ++k)
      if (k < nz) stv<T, V>(o + ((ox * d.Zo + oz0 + k) * d.C + cv * V), m[k]);
  }
}

template <typename T, int V, int WY, int WX, int WZ, int ZT>
__global__ void __launch_bounds__(kThreads)
max_pool_fwd_kernel(const T* __restrict__ in, T* __restrict__ out, const FwdDims d) {
  const int unit = blockIdx.x / d.n_chunks, chunk = blockIdx.x - unit * d.n_chunks;
  const int b = unit / d.Yo, oy = unit - b * d.Yo;
  pool_fwd_unit<T, V, WY, WX, WZ, ZT>(in, out, d, b, oy, chunk * blockDim.x + threadIdx.x,
                                      d.n_chunks * blockDim.x);
}

// Pooled z positions per thread of a window instance.
constexpr int z_per_thread(int wy, int wx, int wz) {
  return wy * wx * wz > 0 && wy * wx * wz <= 2 ? 4 : 2;
}

template <typename T, int V, int WY, int WX, int WZ>
int launch_fwd_window(const T* in, T* out, FwdDims d, int B, cudaStream_t stream) {
  constexpr int ZT = z_per_thread(WY, WX, WZ);
  d.nzg = (d.Zo + ZT - 1) / ZT;
  d.cv = fast_div((uint32_t)(d.C / V));
  d.zg = fast_div((uint32_t)d.nzg);
  const int64_t per_unit = (int64_t)d.Xo * d.nzg * (d.C / V);
  if (per_unit >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int threads = (int)(per_unit >= kThreads ? kThreads : (per_unit + 31) / 32 * 32);
  d.n_chunks = (int)((per_unit + threads - 1) / threads);
  const int64_t blocks = (int64_t)B * d.Yo * d.n_chunks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  max_pool_fwd_kernel<T, V, WY, WX, WZ, ZT><<<(unsigned)blocks, threads, 0, stream>>>(in, out, d);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_fwd_vec(const T* in, T* out, const FwdDims& d, int B, cudaStream_t s) {
  const auto is = [&](int wy, int wx, int wz) { return d.wy == wy && d.wx == wx && d.wz == wz; };
  if (is(1, 2, 2)) return launch_fwd_window<T, V, 1, 2, 2>(in, out, d, B, s);
  if (is(2, 2, 2)) return launch_fwd_window<T, V, 2, 2, 2>(in, out, d, B, s);
  if (is(1, 1, 2)) return launch_fwd_window<T, V, 1, 1, 2>(in, out, d, B, s);
  if (is(2, 1, 2)) return launch_fwd_window<T, V, 2, 1, 2>(in, out, d, B, s);
  return launch_fwd_window<T, V, 0, 0, 0>(in, out, d, B, s);
}

template <typename T>
int launch(const void* in, void* out, int B, int Y, int X, int Z, int C,
           int wy, int wx, int wz, cudaStream_t stream) {
  FwdDims d{Y, X, Z, C, Y / wy, X / wx, Z / wz, wy, wx, wz, 0, 0, {}, {}};
  if ((int64_t)B * d.Yo * d.Xo * d.Zo * C == 0) return 0;
  // a unit's offsets are 32-bit
  if ((int64_t)wy * X * Z * C >= (1LL << 31) || (int64_t)d.Xo * d.Zo * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const T* i = static_cast<const T*>(in);
  T* o = static_cast<T*>(out);
  if (aligned && C % kLanes == 0) return launch_fwd_vec<T, kLanes>(i, o, d, B, stream);
  return launch_fwd_vec<T, 1>(i, o, d, B, stream);
}

// Backward: dx = g at every input position that equals its window's max (all
// tied maxima get g; +0 == -0, as the float compare has it) and at every NaN
// input of a window whose max is NaN, 0 elsewhere and beyond the
// floor-sized pooled region (module header).  The NaN rule is the JAX
// backward's bit compare (`_tie_mask`) wherever a window's NaNs share one
// bit pattern, and does not depend on which NaN the forward returned.

struct PoolDims {
  int Y, X, Z, C, Yo, Xo, Zo, wy, wx, wz;
  int units;     // row units per image: Yo pooled rows, then Y - Yo*wy rows
  int n_chunks;  // blocks per unit
};

// Row unit u of image b, this block's share (block `chunk` of n_chunks).
template <typename T, int V>
__device__ __forceinline__ void pool_bwd_unit(const T* __restrict__ in, const T* __restrict__ out,
                                              const T* __restrict__ g, T* __restrict__ dx,
                                              const PoolDims& d, int b, int u, int chunk) {
  const int CV = d.C / V;
  const int stride = d.n_chunks * blockDim.x;
  const int t0 = chunk * blockDim.x + threadIdx.x;
  Pack<T, V> zeros;
#pragma unroll
  for (int e = 0; e < V; ++e) zeros.v[e] = zero_of<T>();
  if (u >= d.Yo) {
    // an input row beyond the pooled region
    T* row = dx + ((int64_t)b * d.Y + d.Yo * d.wy + (u - d.Yo)) * d.X * d.Z * d.C;
    const int n = d.X * d.Z * CV;
    for (int i = t0; i < n; i += stride) stv<T, V>(row + i * V, zeros);
    return;
  }
  const int64_t in_base = ((int64_t)b * d.Y + (int64_t)u * d.wy) * d.X * d.Z * d.C;
  const int64_t o_base = ((int64_t)b * d.Yo + u) * d.Xo * d.Zo * d.C;
  const T* xin = in + in_base;
  T* dxo = dx + in_base;
  const int n = d.Xo * d.Zo * CV;
  for (int i = t0; i < n; i += stride) {
    const int cv = i % CV, r = i / CV;
    const int oz = r % d.Zo, ox = r / d.Zo;
    const int oo = (ox * d.Zo + oz) * d.C + cv * V;
    const Pack<T, V> o = ldv<T, V>(out + o_base + oo);
    const Pack<T, V> gv = ldv<T, V>(g + o_base + oo);
    for (int dy = 0; dy < d.wy; ++dy)
      for (int dxx = 0; dxx < d.wx; ++dxx)
        for (int dz = 0; dz < d.wz; ++dz) {
          const int off =
              ((dy * d.X + ox * d.wx + dxx) * d.Z + oz * d.wz + dz) * d.C + cv * V;
          const Pack<T, V> xv = ldv<T, V>(xin + off);
          Pack<T, V> r2;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float a = to_f(xv.v[e]), m = to_f(o.v[e]);
            r2.v[e] = a == m || (a != a && m != m) ? gv.v[e] : zero_of<T>();
          }
          stv<T, V>(dxo + off, r2);
        }
  }
  // the unit's rows beyond Xo*wx (every z) or Zo*wz (x < Xo*wx)
  const int zr = d.Z - d.Zo * d.wz, x_in = d.Xo * d.wx;
  const int per_row = x_in * zr + (d.X - x_in) * d.Z;
  const int nr = d.wy * per_row * CV;
  for (int i = t0; i < nr; i += stride) {
    const int cv = i % CV, r = i / CV;
    const int dy = r / per_row;
    int k = r - dy * per_row, x, z;
    if (k < x_in * zr) {
      x = k / zr;
      z = d.Zo * d.wz + (k - x * zr);
    } else {
      k -= x_in * zr;
      x = x_in + k / d.Z;
      z = k % d.Z;
    }
    stv<T, V>(dxo + ((dy * d.X + x) * d.Z + z) * d.C + cv * V, zeros);
  }
}

template <typename T>
__global__ void max_pool_bwd_kernel(const T* __restrict__ in, const T* __restrict__ out,
                                    const T* __restrict__ g, T* __restrict__ dx,
                                    const PoolDims d, int vec) {
  const int unit = blockIdx.x / d.n_chunks, chunk = blockIdx.x - unit * d.n_chunks;
  const int b = unit / d.units, u = unit - b * d.units;
  if (vec)
    pool_bwd_unit<T, kLanes>(in, out, g, dx, d, b, u, chunk);
  else
    pool_bwd_unit<T, 1>(in, out, g, dx, d, b, u, chunk);
}

template <typename T>
int launch_bwd(const void* in, const void* out, const void* g, void* dx, int B,
               int Y, int X, int Z, int C, int wy, int wx, int wz,
               cudaStream_t stream) {
  if ((int64_t)B * Y * X * Z * C == 0) return 0;
  PoolDims d{Y, X, Z, C, Y / wy, X / wx, Z / wz, wy, wx, wz, 0, 0};
  // a unit's offsets are 32-bit
  if ((int64_t)wy * X * Z * C >= (1LL << 31) || (int64_t)X * Z * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  d.units = d.Yo + (Y - d.Yo * wy);
  const bool aligned = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx)) &
                        15) == 0;
  const int vec = aligned && C % kLanes == 0;
  const int threads = 256;
  const int64_t per_unit = (int64_t)d.Xo * d.Zo * (vec ? C / kLanes : C);
  d.n_chunks = (int)((per_unit + threads - 1) / threads);
  if (d.n_chunks < 1) d.n_chunks = 1;
  const int64_t blocks = (int64_t)B * d.units * d.n_chunks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  max_pool_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(out), static_cast<const T*>(g),
      static_cast<T*>(dx), d, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype as below.  in, dx (B, Y, X, Z, C); out, g (B, Y/wy, X/wx, Z/wz, C);
// out is the forward's result for `in`.  All contiguous.
extern "C" int mmf_max_pool3d_bwd(int dtype, const void* in, const void* out,
                                  const void* g, void* dx, int B, int Y, int X,
                                  int Z, int C, int wy, int wx, int wz,
                                  void* stream) {
  if (wy < 1 || wx < 1 || wz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(in, out, g, dx, B, Y, X, Z, C, wy, wx, wz, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(in, out, g, dx, B, Y, X, Z, C, wy, wx, wz, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  in (B, Y, X, Z, C) and
// out (B, Y/wy, X/wx, Z/wz, C), both contiguous.  Returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int mmf_max_pool3d(int dtype, const void* in, void* out, int B,
                              int Y, int X, int Z, int C, int wy, int wx,
                              int wz, void* stream) {
  if (wy < 1 || wx < 1 || wz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, B, Y, X, Z, C, wy, wx, wz, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, out, B, Y, X, Z, C, wy, wx, wz, s);
  return (int)cudaErrorInvalidValue;
}
