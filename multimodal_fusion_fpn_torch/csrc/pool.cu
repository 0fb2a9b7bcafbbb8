// Channels-last max pool with window == stride (Hopper, sm_90a).
//
//   out[b,y,x,z,c] = max over the (wy, wx, wz) window at (y*wy, x*wx, z*wz)
//   of in[b, ., ., ., c]; output extents are floor(n / w) per axis, as in
//   torch's MaxPool3d with its default stride.
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
// Forward design: one thread per output element, consecutive threads on
// consecutive channels so every window read is a coalesced run of C values;
// a grid-stride loop over the output keeps the launch small.
// Backward design (max_pool_bwd_kernel): one thread per pooled position and
// 8 channels (one 16-byte vector in bf16, two in fp32), from a grid over
// row units: unit u < Yo of an image is pooled row u (its wy input rows),
// unit u >= Yo one input row beyond the floor-sized region.  A thread loads
// out and g once as vectors and each of its window's wy*wx*wz inputs as a
// vector, compares lane by lane and stores dx as vectors; the same threads
// zero the rows' remainder beyond Xo*wx and Zo*wz, and the rows beyond
// Yo*wy.  A unit's offsets are 32-bit (its base is 64-bit, once per thread),
// with no 64-bit division per element.  C % 8 != 0, or a tensor that is not
// 16-byte aligned, takes the scalar lane path (one channel a thread) of the
// same kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16_rn(v); }

template <typename T>
__global__ void max_pool_kernel(const T* __restrict__ in, T* __restrict__ out,
                                int64_t n_out, int Y, int X, int Z, int C,
                                int Yo, int Xo, int Zo, int wy, int wx, int wz) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_out;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    int64_t r = i / C;
    const int oz = (int)(r % Zo);
    r /= Zo;
    const int ox = (int)(r % Xo);
    r /= Xo;
    const int oy = (int)(r % Yo);
    const int64_t b = r / Yo;
    float m = -INFINITY;
    for (int dy = 0; dy < wy; ++dy)
      for (int dx = 0; dx < wx; ++dx) {
        const int64_t row = ((b * Y + oy * wy + dy) * X + ox * wx + dx) * Z;
        for (int dz = 0; dz < wz; ++dz)
          m = fmaxf(m, to_f(in[(row + oz * wz + dz) * C + c]));
      }
    from_f(m, out + i);  // exact: m is one of the inputs
  }
}

template <typename T>
int launch(const void* in, void* out, int B, int Y, int X, int Z, int C,
           int wy, int wx, int wz, cudaStream_t stream) {
  const int Yo = Y / wy, Xo = X / wx, Zo = Z / wz;
  const int64_t n_out = (int64_t)B * Yo * Xo * Zo * C;
  if (n_out == 0) return 0;
  const int threads = 256;
  const int64_t need = (n_out + threads - 1) / threads;
  const int blocks = (int)(need < 132 * 64 ? need : 132 * 64);
  max_pool_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n_out, Y, X, Z, C, Yo,
      Xo, Zo, wy, wx, wz);
  return (int)cudaGetLastError();
}

// Backward: dx = g at every input position that equals its window's max (all
// tied maxima get g; +0 == -0, as the float compare has it), 0 elsewhere and
// beyond the floor-sized pooled region (module header).
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

constexpr int kLanes = 8;  // channels per thread of the backward's vector path

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
          for (int e = 0; e < V; ++e)
            r2.v[e] = to_f(xv.v[e]) == to_f(o.v[e]) ? gv.v[e] : zero_of<T>();
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
