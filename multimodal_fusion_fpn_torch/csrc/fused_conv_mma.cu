// Fused affine + ReLU + convolution in bf16 on the tensor cores (Hopper,
// sm_90a): the bf16 instances of fused_conv.cu, computing exactly their
// function (see that file's header):
//
//   y[b,y,x,z,o] = sum_{dy,dx,dz,i} t[b, y+dy-kY/2, x+dx-kX/2, z*sz+dz-kz/2, i]
//                                   * w[dy,dx,dz,i,o]
//   t = relu?(round(round(x * scale) + bias))   (zero outside the volume)
//
// fp32 accumulation, y rounded once to bf16; with `stats` also the fp32
// per-output-channel sums of the rounded y and y*y; with extents (dyn)
// every tap at or beyond the input's true (yt, xt, zt) reads 0.
//
// Replaces, as fused_conv.cu does for fp32, the TPU kernels of
// multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py: `_kernel` (:375, K1)
// with its `with_stats` epilogue (:407-426) and `with_dyn` prologue
// (:445-491, K7), `_yck_kernel` (:2580, K2, the (3,1,1) conv) with the same
// parts (:2594-2636), and the roll-free `_rf_kernel` (:532, K9's forward
// under MMF_ROLLFREE=1: the same function, its taps read as offset slices,
// as here).
//
// Operands are exact in bf16: t is rounded as the JAX bf16 prologue rounds
// it and w is bf16, so the tensor cores multiply the same values as the
// CUDA-core kernel and only the order of the fp32 sums differs.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3): a (1,3,3) call of the eval
// stages (x 4x32x128x496x16, 4x32x64x248x32 or 4x32x32x124x64, co = ci) is
// 37 GFLOP, 0.038 ms at 989 TFLOP/s, against its bytes (x read, y written)
// at 3.35 TB/s: 0.155 ms at 16 channels, 0.078 at 32, 0.039 at 64.  So the
// narrow stages are bound by bytes and stage 3 by both; the CUDA-core
// kernel was bound by its fp32 FMA rate (0.56 ms).  What the design does:
//  * implicit GEMM, no im2col copy: M = output positions (8 rows (y, or x
//    where the conv has an x halo) x 32 z per tile, one row per warp, two
//    m16 tiles each), N = the block's output channels (NO = 64, 32 or 16,
//    the widest dividing co: all of them on the model's paths), K = ci per
//    tap.  The input tile with its halo is copied with cp.async and
//    activated once in shared memory as bf16 (bf16x2 ops, channels
//    innermost, rows padded by 8 elements so the 8 rows of an ldmatrix fall
//    on distinct banks); a tap's shift is an offset of each lane's row
//    address.  A fragments come by ldmatrix from the tile, B fragments by
//    ldmatrix.trans from the [tap][ci][co] weights.
//  * the tile is read from device memory once for all of the block's
//    output channels: re-read factor co / 64 beyond 64 channels, 1 on the
//    model's paths (the CUDA-core kernel re-read it co / 16 times).  A
//    stage-1 tile re-reads 25% halo (10 x 34 for 8 x 32 positions), from
//    L2.
//  * persistent blocks (as many as the card holds, each walking every
//    gridDim.x-th tile) keep all taps' weights resident when ci <= 64 (72
//    KB at 64 -> 64 channels) and double-buffer the input tile: the next
//    tile's copy is in flight while the warps multiply.  At 64 channels one
//    block of 213 KB fits on an SM; at 32 two, at 16 four.  Beyond 64 input
//    channels the weights go through shared memory in chunks of 64, and
//    copies do not overlap the MMAs.
//  * ci % 16 == 8 (ci = 8, 24, ...): the second half of the last k16 chunk
//    is zero-filled in the tile (its scale and bias read 0) and in the
//    weights, so one kernel takes every ci % 8 == 0.
//  * z stride 2: an output tile of 32 zo reads 65 input z, stored by z
//    parity, so each tap's ldmatrix rows stay consecutive: dz = 0 and 2
//    read the even plane at m and m + 1, dz = 1 the odd plane at m.
//  * epilogue: each warp rounds its fragments to bf16, stages its row in
//    shared memory and stores it as 16-byte vectors (channels-last y),
//    masked at the ragged Y, X and Zo edges.  Stats: each lane adds the
//    rounded values (and their squares) of its 2 channels per n8 tile over
//    its rows and the block's tiles, then a fixed-order butterfly over the
//    lanes of one channel pair (xor 4, 8, 16) and the warps in order give
//    one 32-float partial per block per 16 channels, added in a fixed order
//    by `reduce_sums32`.  No float atomics: two runs give bitwise equal y,
//    s1 and s2.
// At the bf16 B=4 eval shapes on an H100 (chip_smoke.py, tools/forward_ab.py)
// the (1,3,3) calls take 2.2-2.7x their bytes bound at 16 channels (0.34
// ms without the affine, 0.42 with it) and 3.5-4.1x at 64 (0.14-0.16 ms;
// cuDNN 0.11); the stride-2 cascades 1.5-2.6x.  At 16 channels the
// per-element work (copies, the activation pass, which costs 15-20%, the
// epilogue) bounds the issue rate.  At 64 channels one block per SM runs
// its activation and epilogue between MMAs, and every warp reads all the
// B fragments through ldmatrix: shared-memory traffic of about the MMAs'
// own time (wgmma, with B read by the tensor cores from shared memory, is
// the next step).

#include "fused_conv_mma.cuh"

namespace {

using namespace mmf;

// The true extents of the input (the whole volume without dyn).
struct Extents {
  int y, x, z;
};

// Shared memory of one block, in elements: the weights [TAPS][KC][NO +
// pad], two input tiles [rows][TZS][KC + pad], each warp's output row
// [kZT][NO + pad] and the scale then bias of every input channel (CI: ci
// padded to chunks of KC, 0 beyond ci).  After the tile loop the output
// rows hold the stats reduction [kWarps][2][NO] (floats).
template <int KY, int KX, int KZ, int SZ>
struct Geom {
  static constexpr int TAPS = KY * KX * KZ;
  static constexpr int TX = mma_tile_x(KX), TY = kRows / TX;
  static constexpr int NXS = TX + KX - 1, NROWS = (TY + KY - 1) * NXS;
  static constexpr int HZ = kZT + 1;  // SZ 2: entries per z-parity plane
  static constexpr int TZ = SZ == 1 ? kZT + KZ - 1 : 2 * kZT + 1;  // input z span
  static constexpr int TZS = SZ == 1 ? TZ : 2 * HZ;                // its rows
  __host__ __device__ static size_t w_elems(int KC, int NO) {
    return (size_t)TAPS * KC * (NO + kPad);
  }
  __host__ __device__ static size_t x_elems(int KC) {
    return (size_t)NROWS * TZS * (KC + kPad);
  }
  __host__ __device__ static size_t o_elems(int NO) {
    return (size_t)kWarps * kZT * (NO + kPad);
  }
  static size_t smem(int KC, int NO, int CI) {
    return (w_elems(KC, NO) + 2 * x_elems(KC) + o_elems(NO) + 2 * (size_t)CI) * sizeof(bf16);
  }
};

// Resident blocks per SM the kernel is built for (the register cap): the
// shared memory of the model's shapes holds 1 block at 64 channels, 2 at
// 32 and 4 at 16.
constexpr int min_blocks(int NO) { return NO <= 16 ? 4 : NO <= 32 ? 2 : 1; }

// The K chunk: ci rounded up to 16, 32 or 64 (chunks of 64 beyond that).
inline int k_chunk(int ci) { return ci <= 16 ? 16 : ci <= 32 ? 32 : 64; }

// A persistent block: for the output channel group blockIdx.y (NO channels)
// it walks the spatial tiles blockIdx.x, blockIdx.x + gridDim.x, ..., each
// in chunks of KC input channels; with STATS the sums accumulate over its
// tiles and go out as one partial per block per 16 channels.
template <int KY, int KX, int KZ, int SZ, int NO, bool STATS>
__global__ void __launch_bounds__(kThreads, min_blocks(NO))
fused_conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                      const bf16* __restrict__ bias, const bf16* __restrict__ w,
                      bf16* __restrict__ out, float* __restrict__ partial, int B,
                      int Y, int X, int Z, int Zo, int ci, int co, int KC, int relu,
                      Extents ext) {
  static_assert(SZ == 1 || (KY == 1 && KX == 1 && KZ == 3), "z stride 2: (1,1,3) only");
  using G = Geom<KY, KX, KZ, SZ>;
  using XRows = Rows<G::NXS, G::NROWS, G::TZ, SZ == 2 ? G::HZ : 0>;
  constexpr int TX = G::TX, NXS = G::NXS, TZS = G::TZS, HZ = G::HZ;
  constexpr int NT = NO / 8;  // n8 tiles
  constexpr int OS = NO + kPad;
  constexpr int NV = NO / 8;  // 16-byte vectors of an output position
  extern __shared__ __align__(16) unsigned char smem[];
  const int TS = KC + kPad;
  const int lg_k = lg_vectors(KC);
  const int n_kc = (ci + KC - 1) / KC, CI = n_kc * KC;
  const size_t x_elems = G::x_elems(KC);
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  bf16* s_x = s_w + G::w_elems(KC, NO);
  bf16* s_o = s_x + 2 * x_elems;
  bf16* s_sb = s_o + G::o_elems(NO);

  const int cg = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = warp / TX, tx = warp % TX;
  const int ar = frag_row_a(lane), ac = frag_col_a(lane);
  const int n_tiles = (int)n_tiles_of(B, Y, X, Zo, TX);
  const bool w_resident = n_kc == 1;
  bf16* so = s_o + (size_t)warp * kZT * OS;

  // scale and bias, 0 beyond ci: a zero-filled pad channel activates to 0
  if (scale != nullptr)
    for (int i = threadIdx.x; i < 2 * CI; i += kThreads) {
      const int c = i < CI ? i : i - CI;
      s_sb[i] = c < ci ? (i < CI ? scale[c] : bias[c]) : __float2bfloat16_rn(0.f);
    }

  // s_w[tap][k][o] = w[tap][c0 + k][cg * NO + o], 0 beyond ci
  auto load_w = [&](int c0) {
    constexpr int LGO = NO == 16 ? 1 : NO == 32 ? 2 : 3;
    const int lg_kc = lg_k + 3;
    for (int idx = threadIdx.x; idx < (G::TAPS * KC) << LGO; idx += kThreads) {
      const int v = idx & (NV - 1), p = idx >> LGO;
      const int k = p & (KC - 1), tap = p >> lg_kc;
      const bool ok = c0 + k < ci;
      cp_async16(s_w + ((size_t)tap * KC + k) * OS + 8 * v,
                 ok ? w + ((int64_t)tap * ci + c0 + k) * co + cg * NO + 8 * v : w, ok);
    }
  };
  // the input rows of a tile (z at stride SZ, with the halo)
  auto x_rows = [&](const TileAt& at) {
    return XRows{at.y0 - KY / 2, at.x0 - KX / 2, SZ * at.z0 - KZ / 2};
  };
  // channels [c0, c0 + KC) of the tile's input into dst; 0 beyond ci and
  // outside the extents
  auto load_x = [&](int tile, int c0, bf16* dst) {
    const TileAt at = tile_at(tile, Y, X, Zo, TX);
    const XRows rows = x_rows(at);
    const bf16* xb = x + (int64_t)at.b * Y * X * Z * ci + c0;
    const int nv = min(KC, ci - c0) / 8;
    for_vectors<XRows>(lg_k, [&](int r, int zz, int v) {
      const bool ok = v < nv && rows.inside(r, zz, ext.y, ext.x, ext.z);
      cp_async16(dst + (size_t)XRows::at(r, zz) * TS + 8 * v,
                 ok ? xb + rows.at_volume(r, zz, X, Z) * ci + 8 * v : x, ok);
    });
  };

  float acc[2][NT][4];
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.f;
  }

  int tile = blockIdx.x, kc = 0, buf = 0;
  if (tile < n_tiles) {
    load_x(tile, 0, s_x);
    load_w(0);
    cp_async_commit();
  }
  while (tile < n_tiles) {
    bf16* sx = s_x + buf * x_elems;
    const int c0 = kc * KC;
    const TileAt at = tile_at(tile, Y, X, Zo, TX);
    cp_async_wait_all();
    __syncthreads();  // this stage's tile (and weights) are in; the last MMAs are done
    if (scale != nullptr || relu) {
      activate_tile(sx, sx, TS, scale != nullptr ? s_sb + c0 : nullptr, CI, relu, lg_k,
                    ext.y, ext.x, ext.z, x_rows(at));
      __syncthreads();
    }
    int next = tile, next_kc = kc + 1;
    if (next_kc == n_kc) {
      next_kc = 0;
      next += gridDim.x;
    }
    if (next < n_tiles && w_resident) {  // the next tile's copy overlaps the MMAs
      load_x(next, 0, s_x + (buf ^ 1) * x_elems);
      cp_async_commit();
    }

    // k outside, the taps unrolled inside: one straight run of ldmatrix and
    // mma per k16 step, which the compiler can interleave
    const int klen = min(KC, (ci - c0 + 15) / 16 * 16);
    for (int k0 = 0; k0 < klen; k0 += 16) {
#pragma unroll
      for (int dy = 0; dy < KY; ++dy) {
#pragma unroll
        for (int dx = 0; dx < KX; ++dx) {
          const bf16* a_row = sx + (size_t)((ty + dy) * NXS + tx + dx) * TZS * TS + k0 + ac;
#pragma unroll
          for (int dz = 0; dz < KZ; ++dz) {
            // zo = z0 + j reads input row j + dz (SZ 1), or 2 j + dz: the
            // parity plane dz & 1 at j + dz / 2 (SZ 2)
            const int zi = SZ == 1 ? dz : (dz & 1) * HZ + (dz >> 1);
            const bf16* b_base =
                s_w + ((size_t)((dy * KX + dx) * KZ + dz) * KC + k0 + ar) * OS + ac;
            uint32_t bfr[NO / 16][4];
#pragma unroll
            for (int q = 0; q < NO / 16; ++q) ldsm_x4_trans(bfr[q], b_base + 16 * q);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              uint32_t af[4];
              ldsm_x4(af, a_row + (size_t)(zi + 16 * mt + ar) * TS);
#pragma unroll
              for (int n = 0; n < NT; ++n)
                mma_bf16(acc[mt][n], af, bfr[n / 2][2 * (n & 1)], bfr[n / 2][2 * (n & 1) + 1]);
            }
          }
        }
      }
    }

    if (kc == n_kc - 1) {
      // epilogue: round, stage this warp's row, store 16-byte vectors
      const int oy = at.y0 + ty, ox = at.x0 + tx;
      const bool row_ok = oy < Y && ox < X;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 16 * mt + 8 * h + (lane >> 2);
          const bool ok = row_ok && at.z0 + j < Zo;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const bf162 v = __floats2bfloat162_rn(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
            *reinterpret_cast<bf162*>(so + j * OS + n * 8 + 2 * (lane & 3)) = v;
            if (STATS && ok) {
              const float2 f = __bfloat1622float2(v);
              s1[n][0] += f.x;
              s1[n][1] += f.y;
              s2[n][0] += __fmul_rn(f.x, f.x);
              s2[n][1] += __fmul_rn(f.y, f.y);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[mt][n][2 * h + e] = 0.f;
          }
        }
      }
      __syncwarp();
      if (row_ok) {
        bf16* yrow = out + (((int64_t)at.b * Y + oy) * X + ox) * Zo * co + cg * NO;
        for (int i = lane; i < kZT * NV; i += 32) {
          const int p = i / NV, v = i % NV;
          if (at.z0 + p < Zo)
            *reinterpret_cast<uint4*>(yrow + (int64_t)(at.z0 + p) * co + 8 * v) =
                *reinterpret_cast<const uint4*>(so + p * OS + 8 * v);
        }
      }
      __syncwarp();
    }
    if (next < n_tiles && !w_resident) {  // the weights are in use until here
      __syncthreads();
      load_x(next, next_kc * KC, s_x + (buf ^ 1) * x_elems);
      load_w(next_kc * KC);
      cp_async_commit();
    }
    tile = next;
    kc = next_kc;
    buf ^= 1;
  }
  if constexpr (STATS) {
    // the lanes of equal lane % 4 hold the same channels: a butterfly over
    // them, then the warps in order
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o <= 16; o <<= 1) {
          s1[n][e] += __shfl_xor_sync(0xffffffffu, s1[n][e], o);
          s2[n][e] += __shfl_xor_sync(0xffffffffu, s2[n][e], o);
        }
      }
    }
    __syncthreads();  // every warp is done with its output row (s_red)
    float* s_red = reinterpret_cast<float*>(s_o);
    if (lane < 4) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = n * 8 + 2 * lane + e;
          s_red[(warp * 2) * NO + ch] = s1[n][e];
          s_red[(warp * 2 + 1) * NO + ch] = s2[n][e];
        }
    }
    __syncthreads();
    if (threadIdx.x < 2 * NO) {
      const int which = threadIdx.x / NO, ch = threadIdx.x % NO;
      float s = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) s += s_red[(wp * 2 + which) * NO + ch];
      const int gch = cg * NO + ch;
      partial[((int64_t)(gch / 16) * gridDim.x + blockIdx.x) * 32 + which * 16 + gch % 16] = s;
    }
  }
}

// ---- launchers -----------------------------------------------------------

struct Args {
  const void *x, *scale, *bias, *w;
  void* out;
  float *s1, *s2, *work;
  bool stats;
  Extents ext;
  int B, Y, X, Z, Zo, ci, co, relu;
  cudaStream_t s;
};

// grid (resident blocks, co / NO).  With n_blocks set, only plans: stores
// the grid's x extent there.  Returns a CUDA error (0 on success).
template <int KY, int KX, int KZ, int SZ, int NO, bool STATS>
int run(const Args& a, int* n_blocks) {
  using G = Geom<KY, KX, KZ, SZ>;
  auto kern = fused_conv_mma_kernel<KY, KX, KZ, SZ, NO, STATS>;
  const int KC = k_chunk(a.ci);
  const size_t smem = G::smem(KC, NO, (a.ci + KC - 1) / KC * KC);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int groups = a.co / NO;
  const int n = resident_blocks(kern, smem, groups, n_tiles_of(a.B, a.Y, a.X, a.Zo, G::TX));
  if (n < 0) return -n;
  if (n_blocks != nullptr) {
    *n_blocks = n;
    return 0;
  }
  kern<<<dim3(n, groups), kThreads, smem, a.s>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.scale),
      static_cast<const bf16*>(a.bias), static_cast<const bf16*>(a.w),
      static_cast<bf16*>(a.out), a.work, a.B, a.Y, a.X, a.Z, a.Zo, a.ci, a.co, KC, a.relu,
      a.ext);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || !STATS) return rc;
  reduce_sums32<<<a.co / 16, kReduceThreads, 0, a.s>>>(a.work, n, a.s1, a.s2);
  return (int)cudaGetLastError();
}

template <int KY, int KX, int KZ, int SZ, int NO>
int run_stats(const Args& a, int* n_blocks) {
  return a.stats ? run<KY, KX, KZ, SZ, NO, true>(a, n_blocks)
                 : run<KY, KX, KZ, SZ, NO, false>(a, n_blocks);
}

template <int KY, int KX, int KZ, int SZ>
int run_taps(const Args& a, int* n_blocks) {
  const int NO = chunk(a.co);
  if (NO == 16) return run_stats<KY, KX, KZ, SZ, 16>(a, n_blocks);
  if (NO == 32) return run_stats<KY, KX, KZ, SZ, 32>(a, n_blocks);
  return run_stats<KY, KX, KZ, SZ, 64>(a, n_blocks);
}

int dispatch(int ky, int kx, int kz, int sz, const Args& a, int* n_blocks) {
  const int key = tap_key(ky, kx, kz, sz);
#define MMF_CASE(KY, KX, KZ, SZ) \
  if (key == tap_key(KY, KX, KZ, SZ)) return run_taps<KY, KX, KZ, SZ>(a, n_blocks);
  MMF_TAPS(MMF_CASE)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int ci, int co) { return ci > 0 && co > 0 && ci % 8 == 0 && co % 16 == 0; }

}  // namespace

// Bytes of scratch for the stats partials of mmf_fused_conv_mma (0 on a
// CUDA error, which the launch then reports).
extern "C" unsigned long long mmf_fused_conv_mma_work_bytes(int ky, int kx, int kz, int sz,
                                                           int B, int Y, int X, int Z,
                                                           int Zo, int ci, int co) {
  Args a{};
  a.stats = true;
  a.B = B, a.Y = Y, a.X = X, a.Z = Z, a.Zo = Zo, a.ci = ci, a.co = co;
  int n = 0;
  if (!shapes_ok(ci, co) || dispatch(ky, kx, kz, sz, a, &n) != 0) return 0;
  return (unsigned long long)n * (co / 16) * 32 * sizeof(float);
}

// bf16 only.  x (B, Y, X, Z, ci), w (ky, kx, kz, ci, co), out (B, Y, X, Zo,
// co), all contiguous bf16; scale and bias (ci) both NULL (identity) or
// both given.  Requires ci % 8 == 0 and co % 16 == 0.  s1, s2 (fp32, co)
// and work (mmf_fused_conv_mma_work_bytes) are all NULL, or all given for
// the stats instance.  dyn is NULL, or host memory holding the input's true
// extents {yt, xt, zt} (1 <= yt <= Y, 1 <= xt <= X, 1 <= zt <= Z), which
// take no stats.  Returns the cudaGetLastError() of the launches (0 on
// success).
extern "C" int mmf_fused_conv_mma(int ky, int kx, int kz, int sz, const void* x,
                                  const void* scale, const void* bias, const void* w,
                                  void* out, void* s1, void* s2, void* work, const int* dyn,
                                  int B, int Y, int X, int Z, int Zo, int ci, int co,
                                  int relu, void* stream) {
  if (!shapes_ok(ci, co) || (scale == nullptr) != (bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((s1 == nullptr) != (s2 == nullptr) || (s1 == nullptr) != (work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dyn != nullptr &&
      (s1 != nullptr || dyn[0] < 1 || dyn[0] > Y || dyn[1] < 1 || dyn[1] > X ||
       dyn[2] < 1 || dyn[2] > Z))
    return (int)cudaErrorInvalidValue;
  const Extents ext = dyn != nullptr ? Extents{dyn[0], dyn[1], dyn[2]} : Extents{Y, X, Z};
  const Args a{x,     scale, bias, w,  out, static_cast<float*>(s1), static_cast<float*>(s2),
               static_cast<float*>(work), s1 != nullptr, ext, B, Y, X, Z, Zo, ci, co, relu,
               static_cast<cudaStream_t>(stream)};
  return dispatch(ky, kx, kz, sz, a, nullptr);
}
