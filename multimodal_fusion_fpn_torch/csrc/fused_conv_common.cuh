// Shared pieces of the fused-conv kernels (fused_conv.cu, fused_conv_bwd.cu).
//
// Layouts are channels-last: x (B, Y, X, Z, ci), y (B, Y, X, Zo, co), the
// logical weight (kY, kX, kz, ci, co).  Sums across blocks never use float
// atomics: each block writes its partial sums, and a second kernel adds the
// partials in a fixed order, so two runs give bitwise equal results.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mmf {

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1; fast_div
// computes m and s on the host).
struct FastDiv {
  uint32_t m;
  int s;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};
inline FastDiv fast_div(uint32_t d) {
  int s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{(uint32_t)m, s};
}

constexpr int kThreads = 256;
constexpr int kTZ = 32;    // z positions per tile (one warp)
constexpr int kTYX = 8;    // rows (y, x) per tile of the forward / dgrad kernels
constexpr int kCI = 8;     // channels per shared-memory chunk
constexpr int kCO = 16;    // channels written per block
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The value of `v` after a round trip through the storage type T.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x*s+b with the storage type's rounding after each op (no fma contraction):
// the rounding of the JAX prologue, in the forward and in the backward's
// recompute of the pre-activation alike.
__device__ __forceinline__ float affine(float x, float s, float b) {
  return __fadd_rn(__fmul_rn(x, s), b);
}
__device__ __forceinline__ float affine(__nv_bfloat16 x, __nv_bfloat16 s, __nv_bfloat16 b) {
  float p = __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) * __bfloat162float(s)));
  return __bfloat162float(__float2bfloat16_rn(p + __bfloat162float(b)));
}

// The activated input relu?(x*s+b) (identity prologue when scale is null).
template <typename T>
__device__ __forceinline__ float activate(const T* x, const T* scale, const T* bias,
                                          int64_t idx, int ch, int relu) {
  const T xv = x[idx];
  float v = scale != nullptr ? affine(xv, scale[ch], bias[ch]) : to_f(xv);
  return relu ? fmaxf(v, 0.f) : v;
}

// The output cotangent with the BN-stats cotangent folded in,
// g + gs1 + 2*y*gs2, rounded to the storage type (as the JAX backward rounds
// it); plain g when y is null.
template <typename T>
__device__ __forceinline__ float load_g(const T* g, const T* y, const float* gs1,
                                        const float* gs2, int64_t idx, int o) {
  const float v = to_f(g[idx]);
  if (y == nullptr) return v;
  return round_to<T>(__fadd_rn(__fadd_rn(v, gs1[o]), __fmul_rn(2.f * to_f(y[idx]), gs2[o])));
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

// Largest (TY + KY - 1) * (TX + KX - 1) over the tile shapes TY * TX == tyx.
__host__ __device__ constexpr int max_rows(int KY, int KX, int tyx = kTYX) {
  int m = 0;
  for (int tx = 1; tx <= tyx; tx *= 2) {
    int r = (tyx / tx + KY - 1) * (tx + KX - 1);
    m = r > m ? r : m;
  }
  return m;
}

// Tile width along x: the smallest power of two >= X, at most kTYX.
__host__ __device__ inline int tile_x(int X) {
  int tx = 1;
  while (tx < kTYX && tx < X) tx *= 2;
  return tx;
}

// The direct-conv main loop of the forward and dgrad kernels.  A 256-thread
// block accumulates into acc[16], for each of its 8 rows (TY x TX) x 32 z and
// 16 output channels, the sum over n_red reduction channels and the KY*KX*KZ
// taps of tile value x weight.  Per chunk of kCI reduction channels, the tile
// with its halo (rows outside the Y x X plane read 0) and the [tap][c][16]
// weights are staged in shared memory:
//   tile(ch, gy, gx, zz): the value of reduction channel ch at row (gy, gx)
//     and tile z position zz (0 <= zz < SZ*31 + KZ; the loader checks z);
//   weight(tap, ch, o): the weight of tap, reduction channel ch and the
//     block's output channel o.
// A thread reads the tile at z stride SZ; the weights are a shared-memory
// broadcast read as four float4.
template <int KY, int KX, int KZ, int SZ, typename Tile, typename Weight>
__device__ __forceinline__ void conv_tile(float (&acc)[kCO], int n_red, int Y, int X,
                                          int TX, int y0, int x0, Tile tile,
                                          Weight weight) {
  constexpr int NZS = SZ * (kTZ - 1) + KZ;  // tile z span
  constexpr int ROWS = max_rows(KY, KX);
  constexpr int TAPS = KY * KX * KZ;
  __shared__ float s_in[kCI * ROWS * NZS];
  __shared__ __align__(16) float s_w[TAPS * kCI * kCO];

  const int NXS = TX + KX - 1;
  const int rows = (kTYX / TX + KY - 1) * NXS;
  const int tz = threadIdx.x % kTZ, tyx = threadIdx.x / kTZ;
  const int ty = tyx / TX, tx = tyx % TX;
#pragma unroll
  for (int o = 0; o < kCO; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < n_red; c0 += kCI) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kCI * rows * NZS; idx += kThreads) {
      const int c = idx % kCI;
      const int p = idx / kCI;
      const int zz = p % NZS;
      const int r = p / NZS;
      const int gy = y0 + r / NXS - KY / 2, gx = x0 + r % NXS - KX / 2;
      s_in[(c * ROWS + r) * NZS + zz] =
          gy >= 0 && gy < Y && gx >= 0 && gx < X ? tile(c0 + c, gy, gx, zz) : 0.f;
    }
    for (int idx = threadIdx.x; idx < TAPS * kCI * kCO; idx += kThreads)
      s_w[idx] = weight(idx / (kCO * kCI), c0 + (idx / kCO) % kCI, idx % kCO);
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
}

// Sums of v[0..31] over the 256 threads of a block, in a fixed order:
// a butterfly across each warp (after it lane l holds the warp's sum of
// v[l]), then the 8 warps in order.  Thread l < 32 writes sum l to out[l].
// `red` is 256 floats of shared memory; v is clobbered.
__device__ __forceinline__ void block_sums32(float* v, float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  __syncthreads();
  red[warp * 32 + lane] = v[0];
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w * 32 + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// ---- tensor-core fragments (fused_conv_bwd_mma.cu) ------------------------
//
// mma.sync m16n8k16, bf16 operands, fp32 accumulators.  Fragments come from
// shared memory by ldmatrix, each lane giving the address of one 16-byte row
// of an 8x8 matrix, so a row can start anywhere (a tap's shift is an address
// offset).  Lane l gives, for the four matrices of an x4 load:
//   rows_a: row l & 15, column 8 * (l >> 4): an A fragment (m16 x k16) of a
//     row-major [m][k] tile, or (with .trans) a B fragment pair (k16 x n16)
//     of a row-major [k][n] tile;
//   rows_b: row (l & 7) + 8 * (l >> 4), column 8 * ((l >> 3) & 1): a B
//     fragment pair (k16 x n16) of an [n][k] tile, or (with .trans) an A
//     fragment of a [k][m] tile.
// A B pair's registers {0, 1} are the first n8 tile's, {2, 3} the second's.
__device__ __forceinline__ int frag_row_a(int lane) { return lane & 15; }
__device__ __forceinline__ int frag_col_a(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int frag_row_b(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int frag_col_b(int lane) { return ((lane >> 3) & 1) * 8; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a * b on one m16n8k16 tile (fp32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// partial: (groups, n_tiles, 32) per-block sums.  One block per group adds
// its n_tiles rows in a fixed order; sums 0..15 go to a[group*16 + k] and
// 16..31 to b[group*16 + k].
__global__ void __launch_bounds__(kReduceThreads)
reduce_sums32(const float* __restrict__ partial, int n_tiles, float* __restrict__ a,
              float* __restrict__ b) {
  __shared__ float red[kReduceThreads];
  const int k = threadIdx.x & 31, row = threadIdx.x >> 5;
  constexpr int kRows = kReduceThreads / 32;
  const float* p = partial + (int64_t)blockIdx.x * n_tiles * 32;
  float s = 0.f;
  for (int t = row; t < n_tiles; t += kRows) s += p[(int64_t)t * 32 + k];
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float acc = 0.f;
    for (int r = 0; r < kRows; ++r) acc += red[r * 32 + k];
    if (k < 16) a[blockIdx.x * 16 + k] = acc;
    else b[blockIdx.x * 16 + k - 16] = acc;
  }
}

}  // namespace mmf
