// Backward of the fused affine + ReLU + convolution (Hopper, sm_90a).
//
// Forward (fused_conv.cu):  y = conv(t, w),  t = relu?(x * s + b),  SAME
// padding, z stride 1 or 2.  Given the output cotangent g (and optionally the
// BN-stats cotangent (gs1, gs2) of the stats instance, folded in as
// g + gs1 + 2*y*gs2 wherever g is read), the two kernels compute
//
//   dgrad:  dt = conv_transpose(g, w),  dtm = dt * [pre > 0] (relu),
//           dx = dtm * s,  ds = sum dtm * x,  db = sum dtm
//   wgrad:  dw[dy,dx,dz,i,o] = sum_p t[p + tap shift, i] * g[p, o]
//
// where pre = x*s+b is recomputed with the forward's rounding (bf16: x*s and
// then +b each rounded), so the relu mask is the forward's exactly.
//
// Replaces multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py `_dx_kernel`
// launched by `_dx_pallas(..., want_band=True)` (K3, the merged dx + band
// cotangent backward, kY = 1) and `_yck_dx_kernel` launched by
// `_dx_pallas_yck` (K4, kY = 3); the wgrad kernel computes what the split
// path's `_dband_kernel` / `_yck_dband_kernel` (K6) compute.  The TPU kernel's
// band/wrap matrices, head/tail block bookkeeping and row rolls have no
// counterpart: the transposed conv is the forward's direct tap loop with
// flipped, transposed weights, and the stride-2 cascade conv reads its g as
// the zero-interleaved u[2 zo] = g[zo] (z_in = 2 z_out + dz - 1).
//
// Bound on the H100: like the forward, about 2 x the forward's FLOPs (dgrad
// and wgrad each do one forward's worth) against ~4 activation passes of
// bytes (x, g, [y], dx), so compute-bound.  Both kernels run on the fp32 CUDA
// cores:
//  * dgrad is the forward's main loop (`conv_tile`, shared header) over g
//    with flipped, transposed weights: a 256-thread block computes an 8-row
//    x 32-z tile of dt for 16 input channels, reading 8 output channels of g
//    at a time (with halo) into shared memory; its epilogue applies the relu mask
//    and writes dx, and the block's 32 partial sums (ds, db per channel) go
//    through the same fixed-order reduction as the forward's stats.
//  * wgrad splits the positions over blocks: block (split, i-group, o-group)
//    walks every n_split-th tile (4 rows x 32 z), with the activated input
//    tile (channel innermost) and the g tile in shared memory; each thread
//    owns one input channel x 4 output channels for every tap; the four row
//    groups of the block add up in a fixed order, each block writes its
//    partial dw, and `reduce_dw` adds the partials over splits in order.
// No float atomics anywhere: two runs give bitwise equal results.

#include "fused_conv_common.cuh"

namespace {

using namespace mmf;

constexpr int kWRows = 4;       // rows (y, x) per wgrad tile
constexpr int kWBlocks = 2048;  // target number of wgrad blocks

// ---- dgrad ---------------------------------------------------------------

template <typename T, int KY, int KX, int KZ, int SZ>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const T* __restrict__ x, const T* __restrict__ scale,
             const T* __restrict__ bias, const T* __restrict__ w,
             const T* __restrict__ g, const T* __restrict__ yo,
             const float* __restrict__ gs1, const float* __restrict__ gs2,
             T* __restrict__ dx, float* __restrict__ partial, int Y, int X,
             int Z, int Zo, int ci, int co, int TX, int relu) {
  constexpr int TAPS = KY * KX * KZ;
  const int TY = kTYX / TX;
  const int n_xt = (X + TX - 1) / TX;
  const int zt = blockIdx.x / n_xt;
  const int xt = blockIdx.x % n_xt;
  const int n_ig = ci / kCO;
  const int b = blockIdx.z / n_ig;
  const int ig = blockIdx.z % n_ig;
  const int y0 = blockIdx.y * TY, x0 = xt * TX, z0 = zt * kTZ;
  const int tz = threadIdx.x % kTZ;
  const int ty = threadIdx.x / kTZ / TX, tx = threadIdx.x / kTZ % TX;

  // the forward's tap loop at stride 1 over u (u = g for SZ = 1, the
  // zero-interleaved u[2 zo] = g[zo] for SZ = 2) with the stats cotangent
  // folded in; flipped, transposed weights w[TAPS-1-tap][ig*16 + i][c]
  const int64_t g_b = (int64_t)b * Y * X * Zo * co;
  float acc[kCO];
  conv_tile<KY, KX, KZ, 1>(
      acc, co, Y, X, TX, y0, x0,
      [&](int c, int gy, int gx, int zz) {
        const int zu = z0 + zz - KZ / 2;
        return zu >= 0 && zu % SZ == 0 && zu / SZ < Zo
                   ? load_g(g, yo, gs1, gs2,
                            g_b + (((int64_t)gy * X + gx) * Zo + zu / SZ) * co + c, c)
                   : 0.f;
      },
      [&](int tap, int c, int i) {
        return to_f(w[((int64_t)(TAPS - 1 - tap) * ci + ig * kCO + i) * co + c]);
      });

  // epilogue: relu mask from the recomputed pre-activation, dx, ds/db sums
  const int oy = y0 + ty, ox = x0 + tx, oz = z0 + tz;
  const bool valid = oy < Y && ox < X && oz < Z;
  float v[2 * kCO];
  if (valid) {
    const int64_t off = ((((int64_t)b * Y + oy) * X + ox) * Z + oz) * ci + ig * kCO;
#pragma unroll
    for (int i = 0; i < kCO; ++i) {
      const int ch = ig * kCO + i;
      const T xv = x[off + i];
      const float pre = scale != nullptr ? affine(xv, scale[ch], bias[ch]) : to_f(xv);
      const float dtm = (!relu || pre > 0.f) ? acc[i] : 0.f;
      v[i] = dtm * to_f(xv);
      v[kCO + i] = dtm;
      acc[i] = scale != nullptr ? __fmul_rn(dtm, to_f(scale[ch])) : dtm;
    }
    store16(dx + off, acc);
  } else {
#pragma unroll
    for (int i = 0; i < 2 * kCO; ++i) v[i] = 0.f;
  }
  if (partial != nullptr) {
    __shared__ float s_red[kThreads];
    const int64_t n_tiles = (int64_t)gridDim.x * gridDim.y * (gridDim.z / n_ig);
    const int64_t tile = ((int64_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    block_sums32(v, s_red, partial + (ig * n_tiles + tile) * 32);
  }
}

// ---- wgrad ---------------------------------------------------------------

template <typename T, int KY, int KX, int KZ, int SZ>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ scale,
             const T* __restrict__ bias, const T* __restrict__ g,
             const T* __restrict__ yo, const float* __restrict__ gs1,
             const float* __restrict__ gs2, float* __restrict__ partial,
             int B, int Y, int X, int Z, int Zo, int ci, int co, int TX,
             int relu, int n_split) {
  constexpr int NZS = SZ * (kTZ - 1) + KZ;  // input z span of a tile
  constexpr int ROWS = max_rows(KY, KX, kWRows);
  constexpr int TAPS = KY * KX * KZ;
  constexpr int NE = TAPS * kCO * kCO;      // dw entries of one block
  __shared__ float s_t[ROWS * NZS * kCO];   // [row][z][i]
  __shared__ __align__(16) float s_g[kWRows * kTZ * kCO];  // [row][z][o]
  __shared__ float s_acc[NE];

  const int TY = kWRows / TX;
  const int NXS = TX + KX - 1;
  const int NYS = TY + KY - 1;
  const int rows = NYS * NXS;
  const int n_xt = (X + TX - 1) / TX;
  const int n_zt = (Zo + kTZ - 1) / kTZ;
  const int n_yt = (Y + TY - 1) / TY;
  const int n_tiles = B * n_yt * n_xt * n_zt;
  const int split = blockIdx.x, ig = blockIdx.y, og = blockIdx.z;

  const int tid = threadIdx.x;
  const int grp = tid / 64;           // row of the tile this thread walks
  const int il = (tid % 64) / 4;      // input channel (local)
  const int oq = tid % 4;             // output channels 4*oq .. 4*oq+3
  const int ty = grp / TX, tx = grp % TX;

  float acc[TAPS][4];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[t][k] = 0.f;

  for (int tile = split; tile < n_tiles; tile += n_split) {
    int r_ = tile;
    const int zt = r_ % n_zt; r_ /= n_zt;
    const int xt = r_ % n_xt; r_ /= n_xt;
    const int yt = r_ % n_yt;
    const int b = r_ / n_yt;
    const int y0 = yt * TY, x0 = xt * TX, z0 = zt * kTZ;
    const int64_t x_b = (int64_t)b * Y * X * Z * ci;
    const int64_t g_b = (int64_t)b * Y * X * Zo * co;

    __syncthreads();
    const int n_t = rows * NZS * kCO;
    for (int idx = tid; idx < n_t; idx += kThreads) {
      const int c = idx % kCO;
      const int p = idx / kCO;
      const int zz = p % NZS;
      const int r = p / NZS;
      const int yy = r / NXS, xx = r % NXS;
      const int gy = y0 + yy - KY / 2, gx = x0 + xx - KX / 2;
      const int gz = z0 * SZ + zz - KZ / 2;
      float v = 0.f;
      if (gy >= 0 && gy < Y && gx >= 0 && gx < X && gz >= 0 && gz < Z)
        v = activate(x, scale, bias,
                     x_b + (((int64_t)gy * X + gx) * Z + gz) * ci + ig * kCO + c,
                     ig * kCO + c, relu);
      s_t[(r * NZS + zz) * kCO + c] = v;
    }
    for (int idx = tid; idx < kWRows * kTZ * kCO; idx += kThreads) {
      const int o = idx % kCO;
      const int zz = (idx / kCO) % kTZ;
      const int r = idx / (kCO * kTZ);
      const int gy = y0 + r / TX, gx = x0 + r % TX, gz = z0 + zz;
      float v = 0.f;
      if (gy < Y && gx < X && gz < Zo) {
        const int64_t gi = g_b + (((int64_t)gy * X + gx) * Zo + gz) * co + og * kCO + o;
        v = load_g(g, yo, gs1, gs2, gi, og * kCO + o);
      }
      s_g[idx] = v;
    }
    __syncthreads();

    for (int tz = 0; tz < kTZ; ++tz) {
      const float4 g4 = reinterpret_cast<const float4*>(
          s_g + (grp * kTZ + tz) * kCO)[oq];
#pragma unroll
      for (int dy = 0; dy < KY; ++dy) {
#pragma unroll
        for (int dx_ = 0; dx_ < KX; ++dx_) {
          const float* src = s_t + (((ty + dy) * NXS + tx + dx_) * NZS + tz * SZ) * kCO + il;
#pragma unroll
          for (int dz = 0; dz < KZ; ++dz) {
            const float t = src[dz * kCO];
            const int tap = (dy * KX + dx_) * KZ + dz;
            acc[tap][0] = fmaf(t, g4.x, acc[tap][0]);
            acc[tap][1] = fmaf(t, g4.y, acc[tap][1]);
            acc[tap][2] = fmaf(t, g4.z, acc[tap][2]);
            acc[tap][3] = fmaf(t, g4.w, acc[tap][3]);
          }
        }
      }
    }
  }

  // the four row groups add up in order, then the block writes its partial:
  // partial[(split, ig, og)][tap][i][o] (local channels)
  for (int gi = 0; gi < kThreads / 64; ++gi) {
    __syncthreads();
    if (grp == gi) {
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = (t * kCO + il) * kCO + 4 * oq + k;
          s_acc[e] = gi == 0 ? acc[t][k] : s_acc[e] + acc[t][k];
        }
    }
  }
  __syncthreads();
  float* out = partial + (((int64_t)split * gridDim.y + ig) * gridDim.z + og) * NE;
  for (int e = tid; e < NE; e += kThreads) out[e] = s_acc[e];
}

// dw[tap][i][o] = sum over splits (in order) of the blocks' partials,
// rounded to the storage type.
template <typename T>
__global__ void reduce_dw(const float* __restrict__ partial, T* __restrict__ dw,
                          int taps, int ci, int co, int n_split) {
  const int64_t n = (int64_t)taps * ci * co;
  const int n_ig = ci / kCO, n_og = co / kCO;
  const int64_t ne = (int64_t)taps * kCO * kCO;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int o = (int)(e % co);
    const int i = (int)((e / co) % ci);
    const int t = (int)(e / ((int64_t)co * ci));
    const int64_t local = ((int64_t)t * kCO + i % kCO) * kCO + o % kCO;
    const int64_t grp = (int64_t)(i / kCO) * n_og + o / kCO;
    float s = 0.f;
    for (int sp = 0; sp < n_split; ++sp)
      s += partial[((int64_t)sp * n_ig * n_og + grp) * ne + local];
    if constexpr (sizeof(T) == 4) dw[e] = s;
    else dw[e] = __float2bfloat16_rn(s);
  }
}

int wgrad_split(int B, int Y, int X, int Zo, int ci, int co) {
  const int TX = X < kWRows ? tile_x(X) : kWRows;
  const int TY = kWRows / TX;
  const int64_t n_tiles = (int64_t)B * ((Y + TY - 1) / TY) * ((X + TX - 1) / TX) *
                          ((Zo + kTZ - 1) / kTZ);
  const int groups = (ci / kCO) * (co / kCO);
  int64_t n = (kWBlocks + groups - 1) / groups;
  return (int)(n < n_tiles ? n : n_tiles);
}

template <typename T, int KY, int KX, int KZ, int SZ>
int launch_dgrad(const void* x, const void* scale, const void* bias, const void* w,
                 const void* g, const void* y, const float* gs1, const float* gs2,
                 void* dx, float* ds, float* db, float* work, int B, int Y,
                 int X, int Z, int Zo, int ci, int co, int relu, cudaStream_t s) {
  const int TX = tile_x(X);
  const int TY = kTYX / TX;
  const dim3 grid(((Z + kTZ - 1) / kTZ) * ((X + TX - 1) / TX), (Y + TY - 1) / TY,
                  B * (ci / kCO));
  dgrad_kernel<T, KY, KX, KZ, SZ><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<const T*>(y), gs1, gs2,
      static_cast<T*>(dx), ds != nullptr ? work : nullptr, Y, X, Z, Zo, ci, co,
      TX, relu);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || ds == nullptr) return rc;
  reduce_sums32<<<ci / kCO, kReduceThreads, 0, s>>>(work, grid.x * grid.y * B, ds, db);
  return (int)cudaGetLastError();
}

template <typename T, int KY, int KX, int KZ, int SZ>
int launch_wgrad(const void* x, const void* scale, const void* bias,
                 const void* g, const void* y, const float* gs1, const float* gs2,
                 void* dw, float* work, int B, int Y, int X, int Z, int Zo,
                 int ci, int co, int relu, cudaStream_t s) {
  const int TX = X < kWRows ? tile_x(X) : kWRows;
  const int n_split = wgrad_split(B, Y, X, Zo, ci, co);
  const dim3 grid(n_split, ci / kCO, co / kCO);
  wgrad_kernel<T, KY, KX, KZ, SZ><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(g),
      static_cast<const T*>(y), gs1, gs2, work, B, Y, X, Z, Zo, ci, co, TX,
      relu, n_split);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t n = (int64_t)KY * KX * KZ * ci * co;
  const int blocks = (int)((n + 255) / 256);
  reduce_dw<T><<<blocks, 256, 0, s>>>(work, static_cast<T*>(dw), KY * KX * KZ,
                                      ci, co, n_split);
  return (int)cudaGetLastError();
}

#define MMF_TAPS(M)  \
  M(1, 3, 3, 1)      \
  M(3, 1, 1, 1)      \
  M(1, 1, 1, 1)      \
  M(1, 1, 3, 1)      \
  M(1, 1, 3, 2)

inline int tap_key(int ky, int kx, int kz, int sz) {
  return ((ky * 4 + kx) * 4 + kz) * 4 + sz;
}

template <typename T>
int dispatch_dgrad(int ky, int kx, int kz, int sz, const void* x,
                   const void* scale, const void* bias, const void* w,
                   const void* g, const void* y, const float* gs1,
                   const float* gs2, void* dx, float* ds, float* db,
                   float* work, int B, int Y, int X, int Z, int Zo, int ci,
                   int co, int relu, cudaStream_t s) {
  const int key = tap_key(ky, kx, kz, sz);
#define MMF_CASE(KY, KX, KZ, SZ)                                               \
  if (key == tap_key(KY, KX, KZ, SZ))                                          \
    return launch_dgrad<T, KY, KX, KZ, SZ>(x, scale, bias, w, g, y, gs1, gs2,  \
                                           dx, ds, db, work, B, Y, X, Z, Zo,   \
                                           ci, co, relu, s);
  MMF_TAPS(MMF_CASE)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_wgrad(int ky, int kx, int kz, int sz, const void* x,
                   const void* scale, const void* bias, const void* g,
                   const void* y, const float* gs1, const float* gs2, void* dw,
                   float* work, int B, int Y, int X, int Z, int Zo, int ci,
                   int co, int relu, cudaStream_t s) {
  const int key = tap_key(ky, kx, kz, sz);
#define MMF_CASE(KY, KX, KZ, SZ)                                              \
  if (key == tap_key(KY, KX, KZ, SZ))                                         \
    return launch_wgrad<T, KY, KX, KZ, SZ>(x, scale, bias, g, y, gs1, gs2,    \
                                           dw, work, B, Y, X, Z, Zo, ci, co,  \
                                           relu, s);
  MMF_TAPS(MMF_CASE)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int ci, int co) { return ci % kCO == 0 && co % kCO == 0; }

}  // namespace

// Bytes of scratch for the partial sums of mmf_fused_conv_dgrad (ds, db) and
// of mmf_fused_conv_wgrad (dw).
extern "C" unsigned long long mmf_fused_conv_dgrad_work_bytes(int B, int Y, int X,
                                                             int Z, int ci) {
  const int TX = tile_x(X);
  const int TY = kTYX / TX;
  const unsigned long long tiles =
      (unsigned long long)((Z + kTZ - 1) / kTZ) * ((X + TX - 1) / TX) *
      ((Y + TY - 1) / TY) * B;
  return tiles * (ci / kCO) * 32 * sizeof(float);
}

extern "C" unsigned long long mmf_fused_conv_wgrad_work_bytes(
    int ky, int kx, int kz, int B, int Y, int X, int Zo, int ci, int co) {
  const int n_split = wgrad_split(B, Y, X, Zo, ci, co);
  return (unsigned long long)n_split * (ci / kCO) * (co / kCO) * ky * kx * kz *
         kCO * kCO * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16.  x (B, Y, X, Z, ci), w (ky, kx, kz, ci,
// co), g and y (B, Y, X, Zo, co), dx like x, all contiguous, all of the
// storage type; scale/bias (ci) both NULL or both given; y, gs1, gs2 (fp32,
// co) all NULL or all given (the stats cotangent).  ds/db (fp32, ci) are
// written when scale is given.  Requires ci % 16 == 0 and co % 16 == 0.
// Returns the cudaGetLastError() of the launches (0 on success).
extern "C" int mmf_fused_conv_dgrad(int dtype, int ky, int kx, int kz, int sz,
                                    const void* x, const void* scale,
                                    const void* bias, const void* w,
                                    const void* g, const void* y,
                                    const void* gs1, const void* gs2, void* dx,
                                    void* ds, void* db, void* work, int B,
                                    int Y, int X, int Z, int Zo, int ci, int co,
                                    int relu, void* stream) {
  if (!shapes_ok(ci, co) || (scale == nullptr) != (ds == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(gs1);
  const float* f2 = static_cast<const float*>(gs2);
  float* fds = static_cast<float*>(ds);
  float* fdb = static_cast<float*>(db);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return dispatch_dgrad<float>(ky, kx, kz, sz, x, scale, bias, w, g, y, f1, f2,
                                 dx, fds, fdb, wk, B, Y, X, Z, Zo, ci, co, relu, s);
  if (dtype == 1)
    return dispatch_dgrad<__nv_bfloat16>(ky, kx, kz, sz, x, scale, bias, w, g, y,
                                         f1, f2, dx, fds, fdb, wk, B, Y, X, Z,
                                         Zo, ci, co, relu, s);
  return (int)cudaErrorInvalidValue;
}

// dw (ky, kx, kz, ci, co) of the storage type; other arguments as for
// mmf_fused_conv_dgrad.
extern "C" int mmf_fused_conv_wgrad(int dtype, int ky, int kx, int kz, int sz,
                                    const void* x, const void* scale,
                                    const void* bias, const void* g,
                                    const void* y, const void* gs1,
                                    const void* gs2, void* dw, void* work,
                                    int B, int Y, int X, int Z, int Zo, int ci,
                                    int co, int relu, void* stream) {
  if (!shapes_ok(ci, co)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(gs1);
  const float* f2 = static_cast<const float*>(gs2);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return dispatch_wgrad<float>(ky, kx, kz, sz, x, scale, bias, g, y, f1, f2,
                                 dw, wk, B, Y, X, Z, Zo, ci, co, relu, s);
  if (dtype == 1)
    return dispatch_wgrad<__nv_bfloat16>(ky, kx, kz, sz, x, scale, bias, g, y,
                                         f1, f2, dw, wk, B, Y, X, Z, Zo, ci, co,
                                         relu, s);
  return (int)cudaErrorInvalidValue;
}
