// Channels-last max pool with window == stride (Hopper, sm_90a).
//
//   out[b,y,x,z,c] = max over the (wy, wx, wz) window at (y*wy, x*wx, z*wz)
//   of in[b, ., ., ., c]; output extents are floor(n / w) per axis, as in
//   torch's MaxPool3d with its default stride.
//
// Replaces the TPU kernel multimodal_fusion_fpn_tpu/ops/pallas/pool.py
// `_pool_fwd_impl` (`_fwd_row_kernel`, and `_fwd_kernel` where the row kernel
// does not apply).  The TPU kernels pool the packed (bs, nb) layout with
// z-slot pairs; on channels-last data this is a plain max pool.
//
// Bound on the H100: memory.  Each input byte is read once and each output
// byte written once (1 + 1/(wy*wx*wz) bytes per input byte), with no reuse.
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

}  // namespace

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
