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
// TPU kernel (n_in = 2) is unused on every model path and is left out.
//
// With `stats` (training, the TPU kernels' `with_stats`) the epilogue also
// returns the per-output-channel fp32 sums of y and y*y of the ROUNDED output
// (what the JAX `_stats_of` reads back from y), for the next BatchNorm: each
// block writes its 32 partial sums (16 channels x 2) and `reduce_sums32` adds
// them in a fixed order, so the sums are bitwise reproducible.
//
// Padding applies to the ACTIVATED input: an out-of-range tap reads 0, not
// relu(bias).  In bf16 the prologue rounds where the JAX bf16 prologue does
// (x*s rounded to bf16, then +b rounded to bf16); products are exact in fp32
// and accumulate in fp32; the output is rounded once to the storage type.
//
// With `dyn` (K7, the TPU kernels' `with_dyn`: eval under exact shape
// bucketing) the prologue also reads 0 at every tap whose (y, x, z) lies at
// or beyond the input's true extents (yt, xt, zt) inside the zero-padded
// buffer, where the affine would otherwise turn the padding (and the garbage
// that an earlier layer left there) into relu(bias).  The extents are three
// kernel arguments; the instances without them are compiled apart, so the
// check costs them nothing.  Eval only: no stats, no backward.
//
// Bound on the H100: at the stage 1-3 shapes a call does ~37 GFLOP on
// ~0.5 GB of bf16 traffic, so it is compute-bound (on tensor cores as well as
// on the fp32 CUDA cores this kernel uses).  Design: one 256-thread block
// computes an (8 rows of y or x) x 32 z output tile for 16 output channels;
// each thread owns one output position and 16 fp32 accumulators.  The input
// tile (with halo) is activated once into shared memory in chunks of 8 input
// channels, laid out [channel][row][z] so a warp reads 32 consecutive words;
// the 16 weights per (tap, channel) are a shared-memory broadcast read as four
// float4 (`conv_tile`, fused_conv_common.cuh, shared with the dgrad kernel).
// No tensor cores yet: wgmma/TMA are later work.

#include "fused_conv_common.cuh"

namespace {

using namespace mmf;

// Blocks per SM the compiler must fit: 4 (at most 64 registers a thread),
// or 3 (80) for the stats-free (1,3,3) instance.  Left to itself nvcc gives
// the (3,1,1) instance 68 registers and the (1,3,3) instances 91-98, one
// block per SM fewer and 8-13% slower (tools/forward_ab.py, chip_smoke.py).
__host__ __device__ constexpr int min_blocks(int KX, bool stats) {
  return KX == 3 && !stats ? 3 : 4;
}

// The true extents of the input of a DYN instance (the whole volume for the
// others, which never read them).
struct Extents {
  int y, x, z;
};

template <typename T, int KY, int KX, int KZ, int SZ, bool STATS, bool DYN>
__global__ void __launch_bounds__(kThreads, min_blocks(KX, STATS))
fused_conv_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, const T* __restrict__ w,
                  T* __restrict__ out, float* __restrict__ partial, int Y,
                  int X, int Z, int Zo, int ci, int co, int TX, int relu,
                  Extents ext) {
  const int TY = kTYX / TX;
  const int n_xt = (X + TX - 1) / TX;
  const int zt = blockIdx.x / n_xt;
  const int xt = blockIdx.x % n_xt;
  const int n_cg = co / kCO;
  const int b = blockIdx.z / n_cg;
  const int cg = blockIdx.z % n_cg;
  const int y0 = blockIdx.y * TY, x0 = xt * TX, z0 = zt * kTZ;
  const int tz = threadIdx.x % kTZ;
  const int ty = threadIdx.x / kTZ / TX, tx = threadIdx.x / kTZ % TX;

  // the activated input, zero outside the volume (and, for DYN, at or
  // beyond the true extents); w[tap][ch][cg*16 + o]
  const int64_t x_b = (int64_t)b * Y * X * Z * ci;
  const int z_end = DYN ? ext.z : Z;
  float acc[kCO];
  conv_tile<KY, KX, KZ, SZ>(
      acc, ci, Y, X, TX, y0, x0,
      [&](int ch, int gy, int gx, int zz) {
        const int gz = z0 * SZ + zz - KZ / 2;
        const bool in = gz >= 0 && gz < z_end && (!DYN || (gy < ext.y && gx < ext.x));
        return in ? activate(x, scale, bias,
                             x_b + (((int64_t)gy * X + gx) * Z + gz) * ci + ch, ch, relu)
                  : 0.f;
      },
      [&](int tap, int ch, int o) {
        return to_f(w[((int64_t)tap * ci + ch) * co + cg * kCO + o]);
      });

  const int oy = y0 + ty, ox = x0 + tx, oz = z0 + tz;
  const bool valid = oy < Y && ox < X && oz < Zo;
  if (valid) {
    const int64_t o_off = ((((int64_t)b * Y + oy) * X + ox) * Zo + oz) * co + cg * kCO;
    store16(out + o_off, acc);
  }
  if (STATS) {
    __shared__ float s_red[kThreads];
    float v[2 * kCO];
#pragma unroll
    for (int o = 0; o < kCO; ++o) {
      const float r = valid ? round_to<T>(acc[o]) : 0.f;
      v[o] = r;
      v[kCO + o] = r * r;
    }
    const int64_t n_tiles = (int64_t)gridDim.x * gridDim.y * (gridDim.z / n_cg);
    const int64_t tile = ((int64_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    block_sums32(v, s_red, partial + (cg * n_tiles + tile) * 32);
  }
}

dim3 conv_grid(int B, int Y, int X, int Zo, int co, int* TX) {
  *TX = tile_x(X);
  const int TY = kTYX / *TX;
  return dim3(((Zo + kTZ - 1) / kTZ) * ((X + *TX - 1) / *TX), (Y + TY - 1) / TY,
              B * (co / kCO));
}

template <typename T, int KY, int KX, int KZ, int SZ>
int launch(const void* x, const void* scale, const void* bias, const void* w,
           void* out, float* s1, float* s2, float* work, const int* dyn, int B,
           int Y, int X, int Z, int Zo, int ci, int co, int relu,
           cudaStream_t stream) {
  int TX;
  const dim3 grid = conv_grid(B, Y, X, Zo, co, &TX);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* bp = static_cast<const T*>(bias);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (dyn != nullptr) {
    const Extents ext{dyn[0], dyn[1], dyn[2]};
    fused_conv_kernel<T, KY, KX, KZ, SZ, false, true><<<grid, kThreads, 0, stream>>>(
        xp, sp, bp, wp, op, nullptr, Y, X, Z, Zo, ci, co, TX, relu, ext);
    return (int)cudaGetLastError();
  }
  const Extents whole{Y, X, Z};
  if (s1 == nullptr) {
    fused_conv_kernel<T, KY, KX, KZ, SZ, false, false><<<grid, kThreads, 0, stream>>>(
        xp, sp, bp, wp, op, nullptr, Y, X, Z, Zo, ci, co, TX, relu, whole);
    return (int)cudaGetLastError();
  }
  fused_conv_kernel<T, KY, KX, KZ, SZ, true, false><<<grid, kThreads, 0, stream>>>(
      xp, sp, bp, wp, op, work, Y, X, Z, Zo, ci, co, TX, relu, whole);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int n_tiles = grid.x * grid.y * B;
  reduce_sums32<<<co / kCO, kReduceThreads, 0, stream>>>(work, n_tiles, s1, s2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int ky, int kx, int kz, int sz, const void* x, const void* scale,
             const void* bias, const void* w, void* out, float* s1, float* s2,
             float* work, const int* dyn, int B, int Y, int X, int Z, int Zo,
             int ci, int co, int relu, cudaStream_t s) {
  const int key = ((ky * 4 + kx) * 4 + kz) * 4 + sz;
#define MMF_CASE(KY, KX, KZ, SZ)                                             \
  if (key == ((KY * 4 + KX) * 4 + KZ) * 4 + SZ)                              \
    return launch<T, KY, KX, KZ, SZ>(x, scale, bias, w, out, s1, s2, work,   \
                                     dyn, B, Y, X, Z, Zo, ci, co, relu, s);
  MMF_CASE(1, 3, 3, 1)
  MMF_CASE(3, 1, 1, 1)
  MMF_CASE(1, 1, 1, 1)
  MMF_CASE(1, 1, 3, 1)
  MMF_CASE(1, 1, 3, 2)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of scratch that mmf_fused_conv needs for its stats partials.
extern "C" unsigned long long mmf_fused_conv_work_bytes(int B, int Y, int X,
                                                       int Zo, int co) {
  int TX;
  const dim3 grid = conv_grid(B, Y, X, Zo, co, &TX);
  return (unsigned long long)grid.x * grid.y * grid.z * 32 * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16.  scale and bias are both NULL (identity)
// or both per-input-channel vectors.
// Shapes: x (B, Y, X, Z, ci), w (ky, kx, kz, ci, co), out (B, Y, X, Zo, co),
// all contiguous.  Requires ci % 8 == 0 and co % 16 == 0.  s1, s2 (fp32, co)
// and work (mmf_fused_conv_work_bytes) are all NULL, or all given for the
// stats instance.  dyn is NULL, or host memory holding the input's true
// extents {yt, xt, zt} (1 <= yt <= Y, 1 <= xt <= X, 1 <= zt <= Z) for the
// extents instance, which takes no stats.  Returns the cudaGetLastError() of
// the launches (0 on success).
extern "C" int mmf_fused_conv(int dtype, int ky, int kx, int kz, int sz,
                              const void* x, const void* scale,
                              const void* bias, const void* w, void* out,
                              void* s1, void* s2, void* work, const int* dyn,
                              int B, int Y, int X, int Z, int Zo, int ci,
                              int co, int relu, void* stream) {
  if (ci % kCI != 0 || co % kCO != 0) return (int)cudaErrorInvalidValue;
  if ((s1 == nullptr) != (s2 == nullptr) || (s1 == nullptr) != (work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dyn != nullptr &&
      (s1 != nullptr || dyn[0] < 1 || dyn[0] > Y || dyn[1] < 1 || dyn[1] > X ||
       dyn[2] < 1 || dyn[2] > Z))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f1 = static_cast<float*>(s1);
  float* f2 = static_cast<float*>(s2);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return dispatch<float>(ky, kx, kz, sz, x, scale, bias, w, out, f1, f2, wk,
                           dyn, B, Y, X, Z, Zo, ci, co, relu, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(ky, kx, kz, sz, x, scale, bias, w, out, f1,
                                   f2, wk, dyn, B, Y, X, Z, Zo, ci, co, relu, s);
  return (int)cudaErrorInvalidValue;
}
