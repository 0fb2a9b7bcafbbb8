// Fused affine + ReLU + convolution on channels-last volumes (Hopper, sm_90a).
//
//   y[b,y,x,z,o] = sum_{dy,dx,dz,i} t[b, y+dy-kY/2, x+dx-kX/2, z*sz+dz-kz/2, i]
//                                   * w[dy,dx,dz,i,o]
//   t = relu?(x * scale + bias)      (per input channel; zero outside the volume)
//
// Replaces the TPU kernels multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py
// `_kernel` (K1, launched by `_fused_conv_pallas_mats`) and `_yck_kernel`
// (K2, the (3,1,1) conv, launched by `_fused_conv_pallas_yck`).  One template
// serves both: K2 is the instantiation with kY = 3.  What the TPU kernels
// compute is kept; their blocking is not: no band/wrap weight matrices, no
// (bs, nb) packing, no row rolls, no G-row slabs.  The second input of the
// TPU kernel (n_in = 2) is unused on every model path and is left out, as is
// the training-only BN-stats epilogue.
//
// Padding applies to the ACTIVATED input: an out-of-range tap reads 0, not
// relu(bias).  In bf16 the prologue rounds where the JAX bf16 prologue does
// (x*s rounded to bf16, then +b rounded to bf16); products are exact in fp32
// and accumulate in fp32; the output is rounded once to the storage type.
//
// Bound on the H100: at the stage 1-3 shapes a call does ~37 GFLOP on
// ~0.5 GB of bf16 traffic, so it is compute-bound (on tensor cores as well as
// on the fp32 CUDA cores this kernel uses).  Design: one 256-thread block
// computes an (8 rows of y or x) x 32 z output tile for 16 output channels;
// each thread owns one output position and 16 fp32 accumulators.  The input
// tile (with halo) is activated once into shared memory in chunks of 8 input
// channels, laid out [channel][row][z] so a warp reads 32 consecutive words;
// the 16 weights per (tap, channel) are a shared-memory broadcast read as four
// float4.  No tensor cores yet: wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTZ = 32;    // output z per tile (one warp)
constexpr int kTYX = 8;    // output rows per tile (TY * TX == 8)
constexpr int kCI = 8;     // input channels per shared-memory chunk
constexpr int kCO = 16;    // output channels per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// x*s+b with the storage type's rounding after each op (no fma contraction).
__device__ __forceinline__ float affine(float x, float s, float b) {
  return __fadd_rn(__fmul_rn(x, s), b);
}
__device__ __forceinline__ float affine(__nv_bfloat16 x, __nv_bfloat16 s, __nv_bfloat16 b) {
  float p = __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) * __bfloat162float(s)));
  return __bfloat162float(__float2bfloat16_rn(p + __bfloat162float(b)));
}

__device__ __forceinline__ void store16(float* dst, const float* acc) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    d[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* acc) {
  __align__(16) __nv_bfloat162 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(h);
  d[0] = s[0];
  d[1] = s[1];
}

// Largest (TY + KY - 1) * (TX + KX - 1) over the tile shapes TY * TX == 8.
__host__ __device__ constexpr int max_rows(int KY, int KX) {
  int m = 0;
  for (int tx = 1; tx <= kTYX; tx *= 2) {
    int r = (kTYX / tx + KY - 1) * (tx + KX - 1);
    m = r > m ? r : m;
  }
  return m;
}

template <typename T, int KY, int KX, int KZ, int SZ>
__global__ void __launch_bounds__(kThreads)
fused_conv_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, const T* __restrict__ w,
                  T* __restrict__ out, int Y, int X, int Z, int Zo, int ci,
                  int co, int TX, int relu) {
  constexpr int NZS = SZ * (kTZ - 1) + KZ;  // input z span of a tile
  constexpr int ROWS = max_rows(KY, KX);
  constexpr int TAPS = KY * KX * KZ;
  __shared__ float s_in[kCI * ROWS * NZS];
  __shared__ __align__(16) float s_w[TAPS * kCI * kCO];

  const int TY = kTYX / TX;
  const int NXS = TX + KX - 1;
  const int NYS = TY + KY - 1;
  const int rows = NYS * NXS;
  const int n_xt = (X + TX - 1) / TX;
  const int zt = blockIdx.x / n_xt;
  const int xt = blockIdx.x % n_xt;
  const int n_cg = co / kCO;
  const int b = blockIdx.z / n_cg;
  const int cg = blockIdx.z % n_cg;
  const int y0 = blockIdx.y * TY, x0 = xt * TX, z0 = zt * kTZ;

  const int tid = threadIdx.x;
  const int tz = tid % kTZ;
  const int tyx = tid / kTZ;
  const int ty = tyx / TX, tx = tyx % TX;

  const int64_t x_b = (int64_t)b * Y * X * Z * ci;
  float acc[kCO];
#pragma unroll
  for (int o = 0; o < kCO; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += kCI) {
    __syncthreads();
    // activated input tile, zero outside the volume
    const int n_in = kCI * rows * NZS;
    for (int idx = tid; idx < n_in; idx += kThreads) {
      const int c = idx % kCI;
      const int p = idx / kCI;
      const int zz = p % NZS;
      const int r = p / NZS;
      const int yy = r / NXS, xx = r % NXS;
      const int gy = y0 + yy - KY / 2, gx = x0 + xx - KX / 2;
      const int gz = z0 * SZ + zz - KZ / 2;
      float v = 0.f;
      if (gy >= 0 && gy < Y && gx >= 0 && gx < X && gz >= 0 && gz < Z) {
        const int ch = c0 + c;
        const T xv = x[x_b + (((int64_t)gy * X + gx) * Z + gz) * ci + ch];
        v = scale != nullptr ? affine(xv, scale[ch], bias[ch]) : to_f(xv);
        if (relu) v = fmaxf(v, 0.f);
      }
      s_in[(c * ROWS + r) * NZS + zz] = v;
    }
    // weights of this channel chunk and output-channel group: [tap][c][o]
    for (int idx = tid; idx < TAPS * kCI * kCO; idx += kThreads) {
      const int o = idx % kCO;
      const int c = (idx / kCO) % kCI;
      const int tap = idx / (kCO * kCI);
      s_w[idx] = to_f(w[((int64_t)tap * ci + c0 + c) * co + cg * kCO + o]);
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kCI; ++c) {
#pragma unroll
      for (int dy = 0; dy < KY; ++dy) {
#pragma unroll
        for (int dx = 0; dx < KX; ++dx) {
          const float* src = s_in + (c * ROWS + (ty + dy) * NXS + tx + dx) * NZS + tz * SZ;
#pragma unroll
          for (int dz = 0; dz < KZ; ++dz) {
            const float v = src[dz];
            const float4* wp = reinterpret_cast<const float4*>(
                s_w + (((dy * KX + dx) * KZ + dz) * kCI + c) * kCO);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 w4 = wp[q];
              acc[4 * q] = fmaf(v, w4.x, acc[4 * q]);
              acc[4 * q + 1] = fmaf(v, w4.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(v, w4.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(v, w4.w, acc[4 * q + 3]);
            }
          }
        }
      }
    }
  }

  const int oy = y0 + ty, ox = x0 + tx, oz = z0 + tz;
  if (oy < Y && ox < X && oz < Zo) {
    const int64_t o_off = ((((int64_t)b * Y + oy) * X + ox) * Zo + oz) * co + cg * kCO;
    store16(out + o_off, acc);
  }
}

template <typename T, int KY, int KX, int KZ, int SZ>
int launch(const void* x, const void* scale, const void* bias, const void* w,
           void* out, int B, int Y, int X, int Z, int Zo, int ci, int co,
           int relu, cudaStream_t stream) {
  int TX = 1;
  while (TX < kTYX && TX < X) TX *= 2;
  const int TY = kTYX / TX;
  dim3 grid(((Zo + kTZ - 1) / kTZ) * ((X + TX - 1) / TX), (Y + TY - 1) / TY,
            B * (co / kCO));
  fused_conv_kernel<T, KY, KX, KZ, SZ><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(w),
      static_cast<T*>(out), Y, X, Z, Zo, ci, co, TX, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int ky, int kx, int kz, int sz, const void* x, const void* scale,
             const void* bias, const void* w, void* out, int B, int Y, int X,
             int Z, int Zo, int ci, int co, int relu, cudaStream_t s) {
  const int key = ((ky * 4 + kx) * 4 + kz) * 4 + sz;
#define MMF_CASE(KY, KX, KZ, SZ)                                             \
  if (key == ((KY * 4 + KX) * 4 + KZ) * 4 + SZ)                              \
    return launch<T, KY, KX, KZ, SZ>(x, scale, bias, w, out, B, Y, X, Z, Zo, \
                                     ci, co, relu, s);
  MMF_CASE(1, 3, 3, 1)
  MMF_CASE(3, 1, 1, 1)
  MMF_CASE(1, 1, 1, 1)
  MMF_CASE(1, 1, 3, 1)
  MMF_CASE(1, 1, 3, 2)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scale and bias are both NULL (identity)
// or both per-input-channel vectors.
// Shapes: x (B, Y, X, Z, ci), w (ky, kx, kz, ci, co), out (B, Y, X, Zo, co),
// all contiguous.  Requires ci % 8 == 0 and co % 16 == 0.  Returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int mmf_fused_conv(int dtype, int ky, int kx, int kz, int sz,
                              const void* x, const void* scale,
                              const void* bias, const void* w, void* out,
                              int B, int Y, int X, int Z, int Zo, int ci,
                              int co, int relu, void* stream) {
  if (ci % kCI != 0 || co % kCO != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(ky, kx, kz, sz, x, scale, bias, w, out, B, Y, X, Z,
                           Zo, ci, co, relu, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(ky, kx, kz, sz, x, scale, bias, w, out, B,
                                   Y, X, Z, Zo, ci, co, relu, s);
  return (int)cudaErrorInvalidValue;
}
