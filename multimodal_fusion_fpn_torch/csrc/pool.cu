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
// Design: one thread per output element, consecutive threads on consecutive
// channels so every window read is a coalesced run of C values; a grid-stride
// loop over the output keeps the launch small.

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
// beyond the floor-sized pooled region.  One thread per input element,
// consecutive threads on consecutive channels: x and dx stream once, the
// pooled out and g are re-read by the window's elements from cache.
template <typename T>
__global__ void max_pool_bwd_kernel(const T* __restrict__ in, const T* __restrict__ out,
                                    const T* __restrict__ g, T* __restrict__ dx,
                                    int64_t n_in, int Y, int X, int Z, int C, int Yo,
                                    int Xo, int Zo, int wy, int wx, int wz) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_in;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    int64_t r = i / C;
    const int z = (int)(r % Z);
    r /= Z;
    const int x = (int)(r % X);
    r /= X;
    const int y = (int)(r % Y);
    const int64_t b = r / Y;
    const int oy = y / wy, ox = x / wx, oz = z / wz;
    float v = 0.f;
    if (oy < Yo && ox < Xo && oz < Zo) {
      const int64_t o = (((b * Yo + oy) * Xo + ox) * Zo + oz) * C + c;
      if (to_f(in[i]) == to_f(out[o])) v = to_f(g[o]);
    }
    from_f(v, dx + i);  // exact: v is 0 or one of g's values
  }
}

template <typename T>
int launch_bwd(const void* in, const void* out, const void* g, void* dx, int B,
               int Y, int X, int Z, int C, int wy, int wx, int wz,
               cudaStream_t stream) {
  const int64_t n_in = (int64_t)B * Y * X * Z * C;
  if (n_in == 0) return 0;
  const int threads = 256;
  const int64_t need = (n_in + threads - 1) / threads;
  const int blocks = (int)(need < 132 * 64 ? need : 132 * 64);
  max_pool_bwd_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(out),
      static_cast<const T*>(g), static_cast<T*>(dx), n_in, Y, X, Z, C, Y / wy,
      X / wx, Z / wz, wy, wx, wz);
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
