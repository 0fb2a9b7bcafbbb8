// Backward of the fused affine + ReLU + convolution in bf16 on the tensor
// cores (Hopper, sm_90a): the bf16 instances of fused_conv_bwd.cu's dgrad and
// wgrad, computing exactly their function (see that file's header):
//
//   dgrad:  dt = conv_transpose(g, w),  dtm = dt * [pre > 0] (relu),
//           dx = dtm * s,  ds = sum dtm * x,  db = sum dtm
//   wgrad:  dw[dy,dx,dz,i,o] = sum_p t[p + tap shift, i] * g[p, o]
//
// with g + gs1 + 2*y*gs2 folded in (the stats cotangent) and pre = x*s+b and
// t = relu?(x*s+b) recomputed with the forward's bf16 rounding.
//
// Replaces, as fused_conv_bwd.cu does for fp32, the TPU kernels of
// multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py: `_dx_kernel` (:2034,
// K3, the merged dx + band cotangent), `_yck_dx_kernel` (:2721, K4),
// `_dband_kernel` (:1855) and `_yck_dband_kernel` (:2880) (K6, the weight
// cotangent of the split path) and the roll-free `_rf_dx_kernel` (:2204,
// K9, the merged backward of MMF_ROLLFREE=1: the same function as K3, its
// taps read as offset slices, as here).
//
// Operands are exact in bf16: the folded g is rounded to bf16 as the JAX
// backward rounds it (load_g), the activated t is the forward's bf16 t and
// the weights are bf16, so the tensor cores multiply the same values as the
// CUDA-core kernels and only the order of the fp32 sums differs.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3): a 64-channel stage-3 call
// (x 4x32x32x124x64, 9 taps) is 37 GFLOP, 0.038 ms at 989 TFLOP/s, against
// 0.06-0.08 ms for its bytes at 3.35 TB/s; a 16-channel stage-1 call is the
// same 37 GFLOP against 0.23-0.31 ms of bytes.  Both are bound by bytes on
// the tensor cores (the CUDA-core kernels were bound by their 67 TFLOP/s fp32
// FMA rate, 0.56 ms).  What the design does about it:
//  * implicit GEMM with no im2col copy: an activation tile (with its halo)
//    sits in shared memory once, channels innermost, rows padded by 8
//    elements so the 8 rows of an ldmatrix fall on distinct banks; a tap's
//    shift is an offset of each lane's row address.  Tiles are copied with
//    cp.async, all of a tile's copies in flight at once (a thread that
//    loads, folds and stores one vector at a time waits a full memory round
//    trip per vector).
//  * dgrad: M = positions (8 rows (y, x) x 32 z per tile, one row per warp,
//    two m16 tiles each), N = the block's ci (<= 64: all of them on the
//    model's paths), K = co per tap.  Blocks are persistent (as many as the
//    card holds, each walking every gridDim.x-th tile), so all taps' weights
//    are copied to shared memory once per block.  The g tile (and y, for the
//    stats fold) is read from device memory once for all input channels
//    (re-read factor ci / 64 beyond 64 channels, 1 on the model's paths; the
//    CUDA-core dgrad re-read it ci / 16 times); the x tile for the epilogue
//    is copied with them.  At z stride 2 the input z is split
//    by parity (one m16 tile each): even z = 2m reads tap dz = 1 at zo = m,
//    odd z = 2m+1 reads dz = 0 at zo = m+1 and dz = 2 at zo = m, so no
//    interleaved zero is multiplied.  The epilogue runs on the accumulator
//    fragments: pre and the relu mask are recomputed, dx = dtm*s is rounded
//    once to bf16 into the x tile and stored as 16-byte rows; ds/db add up
//    per lane over the block's tiles, then through a fixed-order butterfly
//    into one partial per block for `reduce_sums32`.
//  * wgrad: M = ci, N = co, K = positions.  Each tile of 8 x 32 positions
//    is copied raw (x with its halo, g, y), then activated (t) and folded
//    (g) into the tiles the warps read, and the next tile's raw copy starts
//    before the warps multiply, so copies overlap the MMAs.  A fragments
//    come by ldmatrix.trans from the channels-last t tile, B fragments (the
//    same for every tap) by ldmatrix.trans from the g tile.  Each warp owns
//    16 input x 32 (or 16) output channels for every tap (9 x 4 m16n8
//    tiles: 144 accumulators); a block covers up to 64 x 64 channels, so at
//    ci, co <= 64 every staged t and g tile serves every (tap, i, o) and
//    neither is re-read (beyond 64 channels: t co/64 times, g ci/64 times).
//    Where a block's channels need fewer than its 8 warps, the spare warps
//    split the positions.  The t tile of a stride-2 conv is stored by z
//    parity, so ldmatrix rows stay conflict-free.
//  * Blocks write partial sums (dw: one per block, the positions split over
//    the resident blocks; ds/db: one per block) that a second kernel adds
//    in a fixed order.  No float atomics: two runs give bitwise equal
//    results.
// At the train step's shapes on an H100 the calls take 2.1-3.8x their
// bytes bound: at 16 channels the per-element work (copies, fold, epilogue)
// bounds the issue rate; at 64 channels dgrad's resident weights leave one
// block per SM, so its copies do not overlap its MMAs.

#include "fused_conv_mma.cuh"

namespace {

using namespace mmf;

// ---- staging ---------------------------------------------------------------

// dst = g + gs1 + 2*y*gs2 of the staged g and y, rounded to bf16 as load_g
// rounds it (a copy of g where y is null), zero outside the volume; dst may
// be g.  gs: the block's gs1 then gs2 channels (fp32).
template <class R>
__device__ __forceinline__ void fold_tile(bf16* dst, const bf16* g, const bf16* y, int LD,
                                          const float* gs, int NC, int lg, int Y, int X,
                                          int Zo, const R& rows) {
  for_vectors<R>(lg, [&](int r, int zz, int v) {
    const size_t at = (size_t)R::at(r, zz) * LD + 8 * v;
    uint4 val = *reinterpret_cast<const uint4*>(g + at);
    if (rows.offset(r, zz, Y, X, Zo) < 0) {
      val = make_uint4(0u, 0u, 0u, 0u);
    } else if (y != nullptr) {
      const uint4 y4 = *reinterpret_cast<const uint4*>(y + at);
      bf162* h = reinterpret_cast<bf162*>(&val);
      const bf162* yh = reinterpret_cast<const bf162*>(&y4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = 8 * v + 2 * q;
        const float v0 = __fadd_rn(__fadd_rn(to_f(h[q].x), gs[o]),
                                   __fmul_rn(2.f * to_f(yh[q].x), gs[NC + o]));
        const float v1 = __fadd_rn(__fadd_rn(to_f(h[q].y), gs[o + 1]),
                                   __fmul_rn(2.f * to_f(yh[q].y), gs[NC + o + 1]));
        h[q] = __floats2bfloat162_rn(v0, v1);
      }
    }
    *reinterpret_cast<uint4*>(dst + at) = val;
  });
}

// ---- dgrad ---------------------------------------------------------------

// Shared memory of one dgrad block, in elements: the weights [TAPS][NI][KC +
// pad], the g and y tiles [rows][GZ][KC + pad], the x / dx tile
// [kRows][kZT][NI + pad] and the block's scale and bias; then floats: the
// ds/db reduction [kWarps][2][NI] and gs1, gs2 of the co chunk.
template <int KY, int KX, int KZ, int SZ>
struct DgradGeom {
  static constexpr int TAPS = KY * KX * KZ;
  static constexpr int TX = mma_tile_x(KX), TY = kRows / TX;
  static constexpr int NXS = TX + KX - 1, NROWS = (TY + KY - 1) * NXS;
  static constexpr int GZ = SZ == 1 ? kZT + KZ - 1 : kZT / 2 + 1;
  __host__ __device__ static size_t w_elems(int NI, int KC) {
    return (size_t)TAPS * NI * (KC + kPad);
  }
  __host__ __device__ static size_t g_elems(int KC) {
    return (size_t)NROWS * GZ * (KC + kPad);
  }
  __host__ __device__ static size_t x_elems(int NI) {
    return (size_t)kRows * kZT * (NI + kPad);
  }
  static size_t smem(int NI, int KC) {
    return (w_elems(NI, KC) + 2 * g_elems(KC) + x_elems(NI) + 2 * NI) * sizeof(bf16) +
           ((size_t)kWarps * 2 * NI + 2 * KC) * sizeof(float);
  }
};

// Resident blocks per SM the kernel is built for: narrow channels keep
// fewer accumulators, so more blocks hide each other's copies.
constexpr int dgrad_min_blocks(int NI) { return NI <= 16 ? 3 : NI <= 32 ? 2 : 1; }

// A persistent block: for the block's ci group (blockIdx.y) it walks the
// spatial tiles blockIdx.x, blockIdx.x + gridDim.x, ...; ds/db accumulate
// over its tiles and go out as one partial per block.
template <int KY, int KX, int KZ, int SZ, int NI>
__global__ void __launch_bounds__(kThreads, dgrad_min_blocks(NI))
dgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                 const bf16* __restrict__ bias, const bf16* __restrict__ w,
                 const bf16* __restrict__ g, const bf16* __restrict__ yo,
                 const float* __restrict__ gs1, const float* __restrict__ gs2,
                 bf16* __restrict__ dx, float* __restrict__ partial, int B, int Y,
                 int X, int Z, int Zo, int ci, int co, int KC, int relu) {
  static_assert(SZ == 1 || (KY == 1 && KX == 1 && KZ == 3), "z stride 2: (1,1,3) only");
  using Geom = DgradGeom<KY, KX, KZ, SZ>;
  using GRows = Rows<Geom::NXS, Geom::NROWS, Geom::GZ>;
  using XRows = Rows<Geom::TX, kRows, kZT>;
  constexpr int TAPS = Geom::TAPS;
  constexpr int TX = Geom::TX, NXS = Geom::NXS, GZ = Geom::GZ;
  constexpr int NT = NI / 8;  // n8 tiles
  constexpr int XS = NI + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  const int GS = KC + kPad;
  const int lg_k = lg_vectors(KC);
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  bf16* s_g = s_w + Geom::w_elems(NI, KC);
  bf16* s_y = s_g + Geom::g_elems(KC);
  bf16* s_x = s_y + Geom::g_elems(KC);
  bf16* s_sb = s_x + Geom::x_elems(NI);
  float* s_red = reinterpret_cast<float*>(s_sb + 2 * NI);
  float* s_gs = s_red + kWarps * 2 * NI;

  const int ig = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = warp / TX, tx = warp % TX;
  const int ar = frag_row_a(lane), ac = frag_col_a(lane);
  const int br = frag_row_b(lane), bc = frag_col_b(lane);
  const int n_tiles = (int)n_tiles_of(B, Y, X, Z, TX);
  const bool w_resident = KC == co;  // all of co in one chunk: load once

  auto load_w = [&](int kc) {
    for (int idx = threadIdx.x; idx < (TAPS * NI) << lg_k; idx += kThreads) {
      const int v = idx & ((1 << lg_k) - 1), p = idx >> lg_k;
      const int i = p % NI, tap = p / NI;
      cp_async16(s_w + ((size_t)tap * NI + i) * GS + 8 * v,
                 w + ((int64_t)tap * ci + ig * NI + i) * co + kc + 8 * v, true);
    }
  };
  if (w_resident) load_w(0);
  if (scale != nullptr && threadIdx.x < 2 * NI)
    s_sb[threadIdx.x] = threadIdx.x < NI ? scale[ig * NI + threadIdx.x]
                                         : bias[ig * NI + threadIdx.x - NI];

  float ds[2 * NT], db[2 * NT];
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) ds[q] = db[q] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileAt at = tile_at(tile, Y, X, Z, TX);
    const int64_t x_b = (int64_t)at.b * Y * X * Z * ci;
    const int64_t g_b = (int64_t)at.b * Y * X * Zo * co;
    const XRows xr{at.y0, at.x0, at.z0};
    const GRows gr{at.y0 - KY / 2, at.x0 - KX / 2, SZ == 1 ? at.z0 - KZ / 2 : at.z0 / 2};
    __syncthreads();  // the last tile's dx is out of s_x
    load_tile(s_x, XS, x, x_b, Y, X, Z, ci, ig * NI, lg_vectors(NI), xr);

    float acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    for (int kc = 0; kc < co; kc += KC) {
      if (!w_resident) load_w(kc);
      load_tile(s_g, GS, g, g_b, Y, X, Zo, co, kc, lg_k, gr);
      if (yo != nullptr) {
        load_tile(s_y, GS, yo, g_b, Y, X, Zo, co, kc, lg_k, gr);
        if (threadIdx.x < 2 * KC)
          s_gs[threadIdx.x] = threadIdx.x < KC ? gs1[kc + threadIdx.x]
                                               : gs2[kc + threadIdx.x - KC];
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (yo != nullptr) {
        fold_tile(s_g, s_g, s_y, GS, s_gs, KC, lg_k, Y, X, Zo, gr);
        __syncthreads();
      }

#pragma unroll
      for (int dy = 0; dy < KY; ++dy) {
#pragma unroll
        for (int dx_ = 0; dx_ < KX; ++dx_) {
          // dt[p] reads g[p - (tap offset)]: this warp's row in the g tile
          const bf16* a_row =
              s_g + (size_t)((ty + KY - 1 - dy) * NXS + tx + KX - 1 - dx_) * GZ * GS;
#pragma unroll
          for (int dz = 0; dz < KZ; ++dz) {
            const bf16* b_base =
                s_w + ((size_t)((dy * KX + dx_) * KZ + dz) * NI + br) * GS + bc;
            for (int k0 = 0; k0 < KC; k0 += 16) {
              uint32_t bf[NI / 16][4];
#pragma unroll
              for (int q = 0; q < NI / 16; ++q) ldsm_x4(bf[q], b_base + q * 16 * GS + k0);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                // SZ 1: z = z0 + 16 mt + j reads zo = z + KZ/2 - dz;
                // SZ 2: z = z0 + 2 j + mt reads zo = z0/2 + j + (mt + 1 - dz)/2
                // where mt + 1 - dz is even
                if (SZ == 2 && ((mt + 1 - dz) & 1)) continue;
                const int zoff = SZ == 1 ? 16 * mt + KZ - 1 - dz : (mt + 1 - dz) / 2;
                uint32_t af[4];
                ldsm_x4(af, a_row + (size_t)(zoff + ar) * GS + k0 + ac);
#pragma unroll
                for (int n = 0; n < NT; ++n)
                  mma_bf16(acc[mt][n], af, bf[n / 2][2 * (n & 1)], bf[n / 2][2 * (n & 1) + 1]);
              }
            }
          }
        }
      }
      if (kc + KC < co) __syncthreads();  // before the next chunk's copies
    }

    // epilogue on the fragments: the relu mask from the recomputed
    // pre-activation, dx = dtm * s rounded once, in place in the x tile
    const bool row_ok = at.y0 + ty < Y && at.x0 + tx < X;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = (lane >> 2) + 8 * h;
        const int zz = SZ == 1 ? 16 * mt + j : 2 * j + mt;
        const bool ok = row_ok && at.z0 + zz < Z;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int i = n * 8 + 2 * (lane & 3);
          bf162* px = reinterpret_cast<bf162*>(s_x + (size_t)(warp * kZT + zz) * XS + i);
          const bf162 xv = *px;
          const bf162 sv = scale != nullptr ? *reinterpret_cast<const bf162*>(s_sb + i)
                                            : __float2bfloat162_rn(1.f);
          const bf162 pre =
              scale != nullptr
                  ? affine2(xv, sv, *reinterpret_cast<const bf162*>(s_sb + NI + i))
                  : xv;
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xe = to_f(e ? xv.y : xv.x);
            const float dtm = ok && (!relu || to_f(e ? pre.y : pre.x) > 0.f)
                                  ? acc[mt][n][2 * h + e]
                                  : 0.f;
            ds[2 * n + e] += dtm * xe;
            db[2 * n + e] += dtm;
            out[e] = scale != nullptr ? __fmul_rn(dtm, to_f(e ? sv.y : sv.x)) : dtm;
          }
          *px = __floats2bfloat162_rn(out[0], out[1]);
        }
      }
    }
    __syncthreads();
    for_vectors<XRows>(lg_vectors(NI), [&](int r, int zz, int v) {
      const int64_t off = xr.offset(r, zz, Y, X, Z);
      if (off >= 0)
        *reinterpret_cast<uint4*>(dx + x_b + off * ci + ig * NI + 8 * v) =
            *reinterpret_cast<const uint4*>(s_x + (size_t)XRows::at(r, zz) * XS + 8 * v);
    });
  }
  if (partial == nullptr) return;
  // ds/db: the lanes of equal lane % 4 hold the same channels; a butterfly
  // over them, then the warps in order
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) {
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) {
      ds[q] += __shfl_xor_sync(0xffffffffu, ds[q], o);
      db[q] += __shfl_xor_sync(0xffffffffu, db[q], o);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = n * 8 + 2 * lane + e;
        s_red[(warp * 2) * NI + ch] = ds[2 * n + e];
        s_red[(warp * 2 + 1) * NI + ch] = db[2 * n + e];
      }
  }
  __syncthreads();
  if (threadIdx.x < 2 * NI) {
    const int which = threadIdx.x / NI, ch = threadIdx.x % NI;
    float s = 0.f;
    for (int wp = 0; wp < kWarps; ++wp) s += s_red[(wp * 2 + which) * NI + ch];
    const int gch = ig * NI + ch;
    partial[((int64_t)(gch / 16) * gridDim.x + blockIdx.x) * 32 + which * 16 + gch % 16] = s;
  }
}

// ---- wgrad ---------------------------------------------------------------

// Shared memory of one wgrad block, in elements: the raw x tile [rows][TZS]
// [IC + pad], the raw g and y tiles [kRows][kZT][OC + pad] (the next tile's,
// copied while the warps compute), the activated t and folded g tiles the
// warps read, and the block's scale and bias; then floats: gs1, gs2 of the
// block's output channels.  After the tile loop, the first bytes hold the
// partial sums [IC][OC] of one tap.
template <int KY, int KX, int KZ, int SZ>
struct WgradGeom {
  static constexpr int TAPS = KY * KX * KZ;
  static constexpr int TX = mma_tile_x(KX), TY = kRows / TX;
  static constexpr int NXS = TX + KX - 1, NROWS = (TY + KY - 1) * NXS;
  static constexpr int HZ = kZT + 1;  // SZ 2: entries per z-parity plane
  static constexpr int TZ = SZ == 1 ? kZT + KZ - 1 : 2 * kZT + 1;  // input z span
  static constexpr int TZS = SZ == 1 ? TZ : 2 * HZ;                // its rows
  __host__ __device__ static size_t t_elems(int IC) {
    return (size_t)NROWS * TZS * (IC + kPad);
  }
  __host__ __device__ static size_t g_elems(int OC) {
    return (size_t)kRows * kZT * (OC + kPad);
  }
  static size_t smem(int IC, int OC) {
    const size_t tiles =
        (2 * t_elems(IC) + 3 * g_elems(OC) + 2 * IC) * sizeof(bf16) + 2 * OC * sizeof(float);
    const size_t red = (size_t)IC * OC * sizeof(float);
    return tiles > red ? tiles : red;
  }
};

template <int KY, int KX, int KZ, int SZ, int NN>
__global__ void __launch_bounds__(kThreads, NN == 2 ? 2 : 1)
wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                 const bf16* __restrict__ bias, const bf16* __restrict__ g,
                 const bf16* __restrict__ yo, const float* __restrict__ gs1,
                 const float* __restrict__ gs2, float* __restrict__ partial,
                 int B, int Y, int X, int Z, int Zo, int ci, int co, int IC,
                 int OC, int relu) {
  static_assert(SZ == 1 || (KY == 1 && KX == 1 && KZ == 3), "z stride 2: (1,1,3) only");
  using Geom = WgradGeom<KY, KX, KZ, SZ>;
  using TRows = Rows<Geom::NXS, Geom::NROWS, Geom::TZ, SZ == 2 ? Geom::HZ : 0>;
  using GRows = Rows<Geom::TX, kRows, kZT>;
  constexpr int TAPS = Geom::TAPS;
  constexpr int TX = Geom::TX, NXS = Geom::NXS, HZ = Geom::HZ, TZS = Geom::TZS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TS = IC + kPad, GS = OC + kPad;
  const int lg_i = lg_vectors(IC), lg_o = lg_vectors(OC);
  bf16* raw_x = reinterpret_cast<bf16*>(smem);
  bf16* raw_g = raw_x + Geom::t_elems(IC);
  bf16* raw_y = raw_g + Geom::g_elems(OC);
  bf16* s_t = raw_y + Geom::g_elems(OC);
  bf16* s_g = s_t + Geom::t_elems(IC);
  bf16* s_sb = s_g + Geom::g_elems(OC);
  float* s_gs = reinterpret_cast<float*>(s_sb + 2 * IC);
  float* s_red = reinterpret_cast<float*>(smem);

  const int n_oc = co / OC;
  const int ic = blockIdx.y / n_oc, oc = blockIdx.y % n_oc;
  // warp tiles: 16 input x 8*NN output channels; spare warps split K
  const int WTo = OC / (8 * NN);
  const int WT = (IC / 16) * WTo;
  const int WK = kWarps / WT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wt = warp % WT, ks = warp / WT;
  const int wi = wt / WTo, wo = wt % WTo;
  const int ar = frag_row_a(lane), ac = frag_col_a(lane);
  const int br = frag_row_b(lane), bc = frag_col_b(lane);
  const int n_tiles = (int)n_tiles_of(B, Y, X, Zo, TX);

  if (scale != nullptr && threadIdx.x < 2 * IC)
    s_sb[threadIdx.x] = threadIdx.x < IC ? scale[ic * IC + threadIdx.x]
                                         : bias[ic * IC + threadIdx.x - IC];
  if (yo != nullptr && threadIdx.x < 2 * OC)
    s_gs[threadIdx.x] = threadIdx.x < OC ? gs1[oc * OC + threadIdx.x]
                                         : gs2[oc * OC + threadIdx.x - OC];

  // the t tile (input z = SZ * zo + dz - KZ/2, with halo) and the g tile
  auto t_rows = [&](const TileAt& at) {
    return TRows{at.y0 - KY / 2, at.x0 - KX / 2, SZ * at.z0 - KZ / 2};
  };
  auto g_rows = [&](const TileAt& at) { return GRows{at.y0, at.x0, at.z0}; };
  auto load = [&](int tile) {
    const TileAt at = tile_at(tile, Y, X, Zo, TX);
    const int64_t g_b = (int64_t)at.b * Y * X * Zo * co;
    load_tile(raw_x, TS, x, (int64_t)at.b * Y * X * Z * ci, Y, X, Z, ci, ic * IC, lg_i,
              t_rows(at));
    load_tile(raw_g, GS, g, g_b, Y, X, Zo, co, oc * OC, lg_o, g_rows(at));
    if (yo != nullptr) load_tile(raw_y, GS, yo, g_b, Y, X, Zo, co, oc * OC, lg_o, g_rows(at));
    cp_async_commit();
  };

  float acc[TAPS][NN][4];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;

  if ((int)blockIdx.x < n_tiles) load(blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this tile's raw data is in; the last tile's MMAs are done
    {
      const TileAt at = tile_at(tile, Y, X, Zo, TX);
      activate_tile(s_t, raw_x, TS, scale != nullptr ? s_sb : nullptr, IC, relu, lg_i, Y,
                    X, Z, t_rows(at));
      fold_tile(s_g, raw_g, yo != nullptr ? raw_y : nullptr, GS, s_gs, OC, lg_o, Y, X, Zo,
                g_rows(at));
    }
    __syncthreads();
    if (tile + (int)gridDim.x < n_tiles) load(tile + gridDim.x);  // overlaps the MMAs

    // k-step s: 16 positions of row s / 2, z half s % 2
    for (int s = ks; s < 2 * kRows; s += WK) {
      const int r = s >> 1, h = s & 1;
      const int ty = r / TX, tx = r % TX;
      uint32_t bf[NN / 2][4];
#pragma unroll
      for (int q = 0; q < NN / 2; ++q)
        ldsm_x4_trans(bf[q], s_g + (size_t)(r * kZT + 16 * h + ar) * GS +
                                 wo * 8 * NN + 16 * q + ac);
#pragma unroll
      for (int dy = 0; dy < KY; ++dy) {
#pragma unroll
        for (int dx_ = 0; dx_ < KX; ++dx_) {
          const bf16* t_row = s_t + (size_t)((ty + dy) * NXS + tx + dx_) * TZS * TS;
#pragma unroll
          for (int dz = 0; dz < KZ; ++dz) {
            // t at z_in = SZ * zo + dz - KZ/2 for the position zo0 + 16 h + br
            const int zi = SZ == 1 ? 16 * h + br + dz
                                   : (dz & 1) * HZ + 16 * h + br + (dz >> 1);
            uint32_t af[4];
            ldsm_x4_trans(af, t_row + (size_t)zi * TS + wi * 16 + bc);
            const int tap = (dy * KX + dx_) * KZ + dz;
#pragma unroll
            for (int n = 0; n < NN; ++n)
              mma_bf16(acc[tap][n], af, bf[n / 2][2 * (n & 1)], bf[n / 2][2 * (n & 1) + 1]);
          }
        }
      }
    }
  }

  // per tap: the K-split warps add up in order, then the block writes its
  // partial[split][tap][i][o]
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    for (int k = 0; k < WK; ++k) {
      __syncthreads();
      if (ks == k) {
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = wi * 16 + (lane >> 2) + 8 * (e >> 1);
            const int o = wo * 8 * NN + n * 8 + 2 * (lane & 3) + (e & 1);
            float* p = s_red + i * OC + o;
            *p = k == 0 ? acc[tap][n][e] : *p + acc[tap][n][e];
          }
      }
    }
    __syncthreads();
    float* out = partial + ((int64_t)blockIdx.x * TAPS + tap) * ci * co;
    for (int e = threadIdx.x; e < IC * OC; e += kThreads)
      out[(int64_t)(ic * IC + e / OC) * co + oc * OC + e % OC] = s_red[e];
  }
}

// dw[e] = sum over splits (in order) of partial[split][e], rounded to bf16.
__global__ void reduce_dw_splits(const float* __restrict__ partial,
                                 bf16* __restrict__ dw, int64_t n, int n_split) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < n_split; ++sp) s += partial[sp * n + e];
    dw[e] = __float2bfloat16_rn(s);
  }
}

// ---- launchers -----------------------------------------------------------

struct Args {
  const void *x, *scale, *bias, *w, *g, *y;
  const float *gs1, *gs2;
  void* out;  // dx or dw
  float *ds, *db, *work;
  int B, Y, X, Z, Zo, ci, co, relu;
  cudaStream_t s;
};

// dgrad: grid (resident blocks, ci / NI), NI the widest of 64/32/16
// dividing ci, co in chunks of KC.  With n_blocks set, only plans: stores
// the grid's x extent there.  Returns a CUDA error (0 on success).
template <int KY, int KX, int KZ, int SZ, int NI>
int dgrad_run(const Args& a, int KC, int* n_blocks) {
  using Geom = DgradGeom<KY, KX, KZ, SZ>;
  auto kern = dgrad_mma_kernel<KY, KX, KZ, SZ, NI>;
  const size_t smem = Geom::smem(NI, KC);
  const int n = resident_blocks(kern, smem, a.ci / NI,
                                n_tiles_of(a.B, a.Y, a.X, a.Z, Geom::TX));
  if (n < 0) return -n;
  if (n_blocks != nullptr) {
    *n_blocks = n;
    return 0;
  }
  kern<<<dim3(n, a.ci / NI), kThreads, smem, a.s>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.scale),
      static_cast<const bf16*>(a.bias), static_cast<const bf16*>(a.w),
      static_cast<const bf16*>(a.g), static_cast<const bf16*>(a.y), a.gs1, a.gs2,
      static_cast<bf16*>(a.out), a.ds != nullptr ? a.work : nullptr, a.B, a.Y, a.X,
      a.Z, a.Zo, a.ci, a.co, KC, a.relu);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || a.ds == nullptr) return rc;
  reduce_sums32<<<a.ci / 16, kReduceThreads, 0, a.s>>>(a.work, n, a.ds, a.db);
  return (int)cudaGetLastError();
}

template <int KY, int KX, int KZ, int SZ>
int dgrad_taps(const Args& a, int* n_blocks) {
  const int NI = chunk(a.ci), KC = chunk(a.co);
  if (NI == 16) return dgrad_run<KY, KX, KZ, SZ, 16>(a, KC, n_blocks);
  if (NI == 32) return dgrad_run<KY, KX, KZ, SZ, 32>(a, KC, n_blocks);
  return dgrad_run<KY, KX, KZ, SZ, 64>(a, KC, n_blocks);
}

// wgrad: grid (resident blocks, channel blocks IC x OC), NN n8 tiles per
// warp; IC halves while the tiles do not fit in shared memory.  With n_split
// set, only plans.  Returns a CUDA error (0 on success).
template <int KY, int KX, int KZ, int SZ, int NN>
int wgrad_run(const Args& a, int IC, int OC, int* n_split) {
  using Geom = WgradGeom<KY, KX, KZ, SZ>;
  auto kern = wgrad_mma_kernel<KY, KX, KZ, SZ, NN>;
  const size_t smem = Geom::smem(IC, OC);
  const int groups = (a.ci / IC) * (a.co / OC);
  const int n = resident_blocks(kern, smem, groups, n_tiles_of(a.B, a.Y, a.X, a.Zo, Geom::TX));
  if (n < 0) return -n;
  if (n_split != nullptr) {
    *n_split = n;
    return 0;
  }
  kern<<<dim3(n, groups), kThreads, smem, a.s>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.scale),
      static_cast<const bf16*>(a.bias), static_cast<const bf16*>(a.g),
      static_cast<const bf16*>(a.y), a.gs1, a.gs2, a.work, a.B, a.Y, a.X, a.Z, a.Zo,
      a.ci, a.co, IC, OC, a.relu);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int64_t ne = (int64_t)KY * KX * KZ * a.ci * a.co;
  reduce_dw_splits<<<(int)((ne + 255) / 256), 256, 0, a.s>>>(
      a.work, static_cast<bf16*>(a.out), ne, n);
  return (int)cudaGetLastError();
}

template <int KY, int KX, int KZ, int SZ>
int wgrad_taps(const Args& a, int* n_split) {
  int IC = chunk(a.ci);
  const int OC = chunk(a.co);
  while (IC > 16 && WgradGeom<KY, KX, KZ, SZ>::smem(IC, OC) > kMaxSmem) IC /= 2;
  if (OC >= 32) return wgrad_run<KY, KX, KZ, SZ, 4>(a, IC, OC, n_split);
  return wgrad_run<KY, KX, KZ, SZ, 2>(a, IC, OC, n_split);
}

int dispatch_dgrad(int ky, int kx, int kz, int sz, const Args& a, int* n_blocks) {
  const int key = tap_key(ky, kx, kz, sz);
#define MMF_CASE(KY, KX, KZ, SZ) \
  if (key == tap_key(KY, KX, KZ, SZ)) return dgrad_taps<KY, KX, KZ, SZ>(a, n_blocks);
  MMF_TAPS(MMF_CASE)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
}

int dispatch_wgrad(int ky, int kx, int kz, int sz, const Args& a, int* n_split) {
  const int key = tap_key(ky, kx, kz, sz);
#define MMF_CASE(KY, KX, KZ, SZ) \
  if (key == tap_key(KY, KX, KZ, SZ)) return wgrad_taps<KY, KX, KZ, SZ>(a, n_split);
  MMF_TAPS(MMF_CASE)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int ci, int co) { return ci % 16 == 0 && co % 16 == 0; }

Args shape_args(int B, int Y, int X, int Z, int Zo, int ci, int co) {
  Args a{};
  a.B = B, a.Y = Y, a.X = X, a.Z = Z, a.Zo = Zo, a.ci = ci, a.co = co;
  return a;
}

}  // namespace

// Bytes of scratch for the ds/db partial sums of mmf_fused_conv_dgrad_mma
// (0 on a CUDA error, which the launch then reports).
extern "C" unsigned long long mmf_fused_conv_dgrad_mma_work_bytes(
    int ky, int kx, int kz, int sz, int B, int Y, int X, int Z, int ci, int co) {
  int n = 0;
  if (!shapes_ok(ci, co) ||
      dispatch_dgrad(ky, kx, kz, sz, shape_args(B, Y, X, Z, Z, ci, co), &n) != 0)
    return 0;
  return (unsigned long long)n * (ci / 16) * 32 * sizeof(float);
}

// Bytes of scratch for the dw partial sums of mmf_fused_conv_wgrad_mma (0
// on a CUDA error, which the launch then reports).
extern "C" unsigned long long mmf_fused_conv_wgrad_mma_work_bytes(
    int ky, int kx, int kz, int sz, int B, int Y, int X, int Zo, int ci, int co) {
  int n = 0;
  if (!shapes_ok(ci, co) ||
      dispatch_wgrad(ky, kx, kz, sz, shape_args(B, Y, X, Zo, Zo, ci, co), &n) != 0)
    return 0;
  return (unsigned long long)n * ky * kx * kz * ci * co * sizeof(float);
}

// bf16 only.  x (B, Y, X, Z, ci), w (ky, kx, kz, ci, co), g and y (B, Y, X,
// Zo, co), dx like x, all contiguous bf16; scale/bias (ci) both NULL or both
// given; y, gs1, gs2 (fp32, co) all NULL or all given (the stats cotangent).
// ds/db (fp32, ci) are written when scale is given.  Requires ci % 16 == 0
// and co % 16 == 0.  Returns the cudaGetLastError() of the launches (0 on
// success).
extern "C" int mmf_fused_conv_dgrad_mma(int ky, int kx, int kz, int sz,
                                        const void* x, const void* scale,
                                        const void* bias, const void* w,
                                        const void* g, const void* y,
                                        const void* gs1, const void* gs2,
                                        void* dx, void* ds, void* db, void* work,
                                        int B, int Y, int X, int Z, int Zo,
                                        int ci, int co, int relu, void* stream) {
  if (!shapes_ok(ci, co) || (scale == nullptr) != (ds == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, scale, bias, w, g, y, static_cast<const float*>(gs1),
               static_cast<const float*>(gs2), dx, static_cast<float*>(ds),
               static_cast<float*>(db), static_cast<float*>(work), B, Y, X, Z, Zo,
               ci, co, relu, static_cast<cudaStream_t>(stream)};
  return dispatch_dgrad(ky, kx, kz, sz, a, nullptr);
}

// dw (ky, kx, kz, ci, co) bf16; other arguments as for
// mmf_fused_conv_dgrad_mma.
extern "C" int mmf_fused_conv_wgrad_mma(int ky, int kx, int kz, int sz,
                                        const void* x, const void* scale,
                                        const void* bias, const void* g,
                                        const void* y, const void* gs1,
                                        const void* gs2, void* dw, void* work,
                                        int B, int Y, int X, int Z, int Zo, int ci,
                                        int co, int relu, void* stream) {
  if (!shapes_ok(ci, co)) return (int)cudaErrorInvalidValue;
  const Args a{x, scale, bias, nullptr, g, y, static_cast<const float*>(gs1),
               static_cast<const float*>(gs2), dw, nullptr, nullptr,
               static_cast<float*>(work), B, Y, X, Z, Zo, ci, co, relu,
               static_cast<cudaStream_t>(stream)};
  return dispatch_wgrad(ky, kx, kz, sz, a, nullptr);
}
