// Whole-block eval fusion in bf16 on the tensor cores (Hopper, sm_90a): the
// bf16 instances of fused_block.cu, computing exactly its function (see that
// file's header):
//
//   t_0 = relu0?(x * s_in + b_in)                    (identity when s_in is null)
//   m_j = relu(round(conv_j(t_j)) * s_j + b_j)       t_{j+1} = m_j, j < n - 1
//   y   = round(conv_{n-1}(t_{n-1}))
//   out = y | y*s+b | relu(y*s+b) | relu((y*s+b)+x) | relu(((y*s+b)+yd*sd)+bd)
//
// raw, affine, relu, res_id and res_conv (yd = round(conv_1x1(x, wd))), every
// t_j reading 0 outside the volume and at or beyond the true extents, the
// block output (all but raw) 0 at or beyond them; n = 2: two (1,3,3) convs,
// n = 3: (1,3,3), (1,3,3), (3,1,1).
//
// Replaces, as fused_block.cu does for fp32, the TPU kernels of
// multimodal_fusion_fpn_tpu/ops/pallas/fused_conv.py `_kernel2` (:1294, the
// pair, launched by `fused_conv2_eval`) and `_chain_kernel` (:1445, the
// chain, launched by `fused_chain_eval`), both with `with_dyn`.
//
// Numerics: bitwise equal to the tensor-core per-conv path (fused_conv_mma.cu
// for each conv, torch's bf16 elementwise ops between them).  The operands
// are the same bf16 values: the activated input and every intermediate
// rounded to bf16 as the HBM round trip rounds them, the affine by affine2
// (_rn mul, then _rn add), then __hmax2 with 0, out-of-range and
// beyond-extents taps 0.  The instruction is the same (mma.sync m16n8k16,
// fp32 sums), and so is the order of the sums: k16 chunks outside, the taps
// unrolled inside in (dy, dx, dz) order, ci % 16 == 8 zero-filled in the
// last chunk; the (3,1,1) conv takes its taps over the ring rows in that
// order; the res_conv downsample sums as the (1,1,1) instance does.  The
// final modes round as `finish` of fused_block.cu does.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3): the 3-conv block does 2 * 21 *
// C^2 flops per voxel against 4 C bytes (bf16 in and out): 168 flops per
// byte at C = 16, 336 at 32, 672 at 64, against 295 at the bf16 tensor-core
// peak (989 TFLOP/s over 3.35 TB/s): stage 1 is bound by bytes, stages 2-3
// by operations.  fused_block.cu ran the same sums as fp32 FMAs on the CUDA
// cores (about 20 flops per byte there), so every stage was operation-bound.
//
// Design, from fused_conv_mma.cu's machinery (fused_conv_mma.cuh):
//  * implicit GEMM per conv: M = window positions, N = co (16, 32 or 64, one
//    instance each, per n), K = c_in per tap.  A block owns a TX x TZ (x, z)
//    window and walks a chunk of G rows along y; per row it copies the input
//    with a halo of 2 by cp.async (16 bytes a lane, bounded by the extents,
//    so the padding's garbage is never read; zero-filled beyond them),
//    activates it once in place, then runs conv 0 over the window with a
//    halo of 1 into a bf16 tile (rounded, affine, ReLU, masked), then conv 1
//    over the window.  A trailing (3,1,1) conv keeps conv 1's activated
//    output of the last three rows in a bf16 ring and emits row y - 1 once
//    row y + 1 is in.  All tiles are bf16, channels innermost, rows padded
//    by 8 elements so an ldmatrix's 8 rows fall on distinct banks.
//  * M is the window's positions flattened: each lane gives ldmatrix the
//    row address of its own position, so a window of any TX x TZ tiles into
//    m16 tiles with at most 15 positions of overhang, and a tap's shift is
//    an address offset.  A fragments by ldmatrix, B by ldmatrix.trans from
//    [tap][k][co] weights.  Each warp keeps the sums of up to MT = 3 m16
//    tiles (all co; 2 for three 64-channel convs) in registers; the k16
//    chunks run outside, the taps inside.  No more: with 6 (16 channels)
//    the sums took the registers the compiler needs to overlap one tap's
//    ldmatrix with another's MMAs, and the stage-1 chain ran a third
//    slower.  The plan prefers windows whose conv 0 takes one pass of 8
//    warps x MT tiles.
//  * persistent blocks: as many as the card holds, each walking every
//    gridDim.x-th (window, y chunk); the next row's input copy is in flight
//    during conv 1 and conv 2.
//  * the block output: at the row's start the raw x of the row it emits
//    (res_id, res_conv) is copied into a residual tile by cp.async, its own
//    group, waited (wait_group 1) just before the barrier ahead of the
//    output, so its latency hides behind the convs.  Each warp rounds its
//    fragments into the free conv-0 tile, applies the final mode on its own
//    positions in bf16x2 ops (affine2, __hadd2_rn, __hmul2_rn: the rounding
//    of torch's bf16 ops, fused_conv_mma.cuh), with res_conv's 1x1
//    downsample on the tensor cores (A from the residual tile, B from its
//    weights in shared memory), and stores 16-byte vectors, masked at the
//    ragged X and Z edges.  (With fused_block.cu's scalar fp32 rounding
//    and the residual read from device memory this output stage was the
//    largest share of a call.)
//  * extents: taps read 0 at or beyond them; rows at or beyond yt are
//    computed on zeros (their tiles masked), so every row follows the same
//    schedule.
//
// Shared memory (bf16 elements, rows padded by 8; 227 KB a block):
//
//   weights: resident [9][ci16][co+8] + [9][co][co+8] (+ [3][co][co+8]);
//            streamed (64 channels): two k16 slots [9][16][72] (2 x 20.25 KB)
//   input:   (TX+4) (TZ+4) [ci16+8]     conv 0: (TX+2) (TZ+2) [co+8]
//   ring:    3 TX TZ [co+8] (n = 3)     1x1 weights: [ci16][co+8] (res_conv)
//   residual: TX TZ [ci16+8] (res_id, res_conv)
//
//   The model's bf16 B=4 blocks (KB = 1024 bytes, the plan of make_plan):
//
//   | stage | block            | weights           | window | tiles (in, conv 0, ring, residual) | total |
//   | 1     | B 16 ch, 3 convs | 15.8 resident     | 8 x 32 | 20.3 + 15.9 + 36.0 + 12.0          | 100.3 |
//   | 2     | A 16->32 res_conv| 35.0 resident     | 8 x 32 | 20.3 + 26.6 + 12.0                 |  94.4 |
//   | 2     | B 32 ch, 3 convs | 52.5 resident     | 8 x 32 | 33.8 + 26.6 + 60.0 + 20.0          | 193.4 |
//   | 3     | A 32->64 res_conv| 126.0 resident    | 8 x 24 | 26.3 + 36.6 + 15.0                 | 204.9 |
//   | 3     | B 64 ch, 3 convs | 40.5 streamed     | 8 x 22 | 43.9 + 33.8 + 74.3 + 24.8          | 218.4 |
//   | 3     | pair 64->64      | 162.0 resident    | 8 x 16 | 33.8 + 25.3                        | 222.3 |
//
// At 64 channels the three convs' weights (193.5 KB padded) and a 4 x 32
// window's tiles (125 KB) do not fit together.  Of the three ways out this
// takes (b), one conv's weights at a time, at k16-chunk grain: two slots of
// one k16 chunk of every tap (20.25 KB each), the next chunk's cp.async in
// flight while the warps multiply the current one, a __syncthreads per
// chunk.  Whole-conv slots (2 x 81 KB) would leave 65 KB for the tiles, a 2
// x 8 window; a 2-CTA cluster (a) still needs the full-width tiles in each
// CTA (107 + 125 KB at 4 x 32); weights read by every warp from L2 (c) cost
// each warp all the weights per row, several times the L2's rate.  The
// streamed weights are read from L2 once per block and row (193 KB per 176
// positions at 8 x 22), about 140 flops per L2 byte.  The window widens from
// 4 x 32 (fused_block.cu) to 8 x 22, and the conv-0 halo from 59% of the
// window to 36%.  Warps 0-3 stream the weights and warps 4-7 copy the input
// rows, so each thread's cp.async groups hold one kind only and a wait for
// one never waits for the other.  Two 64-channel convs keep their weights
// resident where they fit (the pairs, stage 3's first block; timed faster
// than streaming at 8 x 30); the 16- and 32-channel instances always do,
// loaded once per block.

#include <type_traits>

#include "fused_conv_mma.cuh"

namespace {

using namespace mmf;

#ifdef MMF_K8_PROFILE
// Profiled builds only (tools/block_ab.py): clock64 cycles per phase of a
// call, summed over its blocks, as thread 0 sees them (mmf_k8_profile).
__device__ unsigned long long g_prof[16];
#define PROF(k)                                          \
  if (threadIdx.x == 0) {                                \
    const long long t_ = clock64();                      \
    atomicAdd(&g_prof[k], (unsigned long long)(t_ - t_prof)); \
    t_prof = t_;                                         \
  }
#else
#define PROF(k)
#endif

enum Final : int { kRaw = 0, kAffine = 1, kRelu = 2, kResId = 3, kResConv = 4 };

template <int CO>
struct Cfg {
  static constexpr int NT = CO / 8;  // n8 tiles
  static constexpr int LDO = CO + kPad;
  static constexpr int SLOT = 9 * 16 * LDO;  // one streamed k16 chunk, all taps
};
// m16 tiles whose sums a warp keeps per pass (the fastest count at the
// model's shapes on the H100: 3, or 2 for the 64-channel chain of three
// convs), and the resident blocks per SM the registers are capped for.
template <int CO, bool KY3>
__host__ __device__ constexpr int m_tiles() {
  return CO == 64 && KY3 ? 2 : 3;
}
template <int CO, bool KY3>
constexpr int min_blocks() {
  return CO == 16 ? (KY3 ? 2 : 3) : CO == 32 && !KY3 ? 2 : 1;
}

struct Params {
  const bf16* x;                    // (B, Y, X, Z, ci)
  const bf16* s_in;                 // entry affine (ci), or null
  const bf16* b_in;
  const bf16* w[3];                 // (kY, kX, kz, c_in, co) per conv
  const bf16* s[3];                 // post-conv affines (co); the last null for raw
  const bf16* b[3];
  const bf16* wd;                   // res_conv: (1, 1, 1, ci, co) and its affine
  const bf16* sd;
  const bf16* bd;
  bf16* out;                        // (B, Y, X, Z, co)
  int B, Y, X, Z, ci;
  int yt, xt, zt;                   // true extents (the whole volume without bucketing)
  int TX, TZ, G, n_xt, n_zt, n_yc, n_items;
  int stream;                       // weights streamed through two k16 slots
  int relu0, final_mode;
};

// Element offsets of one block's shared memory (each a multiple of 8).
struct Layout {
  int CI16, LDI;                    // ci rounded up to 16; the input tile's row
  size_t vec, w, wd, res, in, mid, ring, total;
};

// The final modes that read the raw x at the emitted row (the residual
// tile).
__host__ __device__ inline bool reads_x(int mode) { return mode == kResId || mode == kResConv; }

template <int CO, bool KY3>
__host__ __device__ Layout layout(int ci, int TX, int TZ, int mode, bool stream) {
  constexpr int LDO = Cfg<CO>::LDO;
  Layout l;
  l.CI16 = (ci + 15) / 16 * 16;
  l.LDI = l.CI16 + kPad;
  size_t at = 0;
  l.vec = at;  // s_in, b_in (CI16 each), s_j, b_j (j < 3), sd, bd (CO each)
  at += 2 * (size_t)l.CI16 + 8 * CO;
  l.w = at;
  at += stream ? 2 * (size_t)Cfg<CO>::SLOT
               : (size_t)(9 * l.CI16 + 9 * CO + (KY3 ? 3 * CO : 0)) * LDO;
  l.wd = at;
  if (mode == kResConv) at += (size_t)l.CI16 * LDO;
  l.res = at;
  if (reads_x(mode)) at += (size_t)TX * TZ * l.LDI;
  l.in = at;
  at += (size_t)(TX + 4) * (TZ + 4) * l.LDI;
  l.mid = at;
  at += (size_t)(TX + 2) * (TZ + 2) * LDO;
  l.ring = at;
  if (KY3) at += (size_t)3 * TX * TZ * LDO;
  l.total = at;
  return l;
}

__device__ __forceinline__ int mod3(int v) { return ((v % 3) + 3) % 3; }

// rows [k0, k0 + nk) of every tap of w (taps x c_in x CO, bf16) into dst
// ([tap][rows][CO + 8]), 0 beyond c_in; thread threadIdx.x - t0 of nt.
template <int CO>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* w, int taps, int c_in, int k0,
                                          int nk, int rows, int t0, int nt) {
  constexpr int NV = CO / 8, LDO = Cfg<CO>::LDO;
  const int total = taps * nk * NV;
  for (int i = threadIdx.x - t0; i < total; i += nt) {
    const int v = i % NV, r = i / NV, k = r % nk, tap = r / nk;
    const bool ok = k0 + k < c_in;
    cp_async16(dst + ((size_t)tap * rows + k) * LDO + 8 * v,
               ok ? w + ((size_t)tap * c_in + k0 + k) * CO + 8 * v : w, ok);
  }
}

// acc[mt] += one k16 chunk (column k0 of the A rows) of the warp's nmt m16
// tiles, A rows at src + a_off[mt] + toff[t] + k0, times the chunk's
// weights (tap t's 16 rows at wc + t * tap_stride): the taps unrolled inside
// one k16 step, as fused_conv_mma.cu sums them.
template <int CO, int TAPS, int MT>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][CO / 8][4], const bf16* wc,
                                          int tap_stride, const bf16* src,
                                          const int (&a_off)[MT], const int (&toff)[TAPS], int k0,
                                          int nmt, int lane) {
  constexpr int LDO = Cfg<CO>::LDO;
  const bf16* b_row = wc + frag_row_a(lane) * LDO + frag_col_a(lane);
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    uint32_t bfr[CO / 16][4];
#pragma unroll
    for (int q = 0; q < CO / 16; ++q)
      ldsm_x4_trans(bfr[q], b_row + (size_t)t * tap_stride + 16 * q);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < nmt) {
        uint32_t af[4];
        ldsm_x4(af, src + a_off[mt] + toff[t] + k0);
#pragma unroll
        for (int n = 0; n < CO / 8; ++n)
          mma_bf16(acc[mt][n], af, bfr[n / 2][2 * (n & 1)], bfr[n / 2][2 * (n & 1) + 1]);
      }
    }
  }
}

// Waits for all but the most recent cp.async group of this thread.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// cp.async of an NR x NC window of positions (channels [0, 8 nvi)) into dst
// (position r NC + c at row (r NC + c) ld): position (r, c) from `plane`
// (one (X, Z, ci) row of x) at (gx0 + r, gz0 + c); zero-filled where !live,
// outside [0, xt) x [0, zt) or at v >= nv.  Thread t of nt; the indices step
// without divisions (X Z ci < 2^31, checked by the host).
__device__ __forceinline__ void copy_window(bf16* dst, int ld, const bf16* x, const bf16* plane,
                                            int NR, int NC, int gx0, int gz0, int nvi, int nv,
                                            bool live, int Z, int ci, int xt, int zt, int t,
                                            int nt) {
  const int total = NR * NC * nvi;
  if (t >= total) return;
  int v = t % nvi, pos = t / nvi;
  int c = pos % NC, r = pos / NC;
  const int dv = nt % nvi, dpos = nt / nvi, dc = dpos % NC, dr = dpos / NC;
  for (int i = t; i < total; i += nt) {
    const int gx = gx0 + r, gz = gz0 + c;
    const bool ok = live && v < nv && gx >= 0 && gx < xt && gz >= 0 && gz < zt;
    cp_async16(dst + (size_t)(r * NC + c) * ld + 8 * v, ok ? plane + (gx * Z + gz) * ci + 8 * v : x,
               ok);
    v += dv;
    c += dc;
    r += dr;
    if (v >= nvi) {
      v -= nvi;
      ++c;
    }
    if (c >= NC) {
      c -= NC;
      ++r;
    }
  }
}

// q / n for 0 <= q < 2^20, 1 <= n < 2^10, from inv = 1.f / n
__device__ __forceinline__ int fdiv(int q, float inv) {
  return __float2int_rz((q + 0.5f) * inv);
}

__device__ __forceinline__ bf162 ld2(const bf16* p) { return *reinterpret_cast<const bf162*>(p); }
__device__ __forceinline__ void st2(bf16* p, bf162 v) { *reinterpret_cast<bf162*>(p) = v; }

template <int CO, bool KY3>
__global__ void __launch_bounds__(kThreads, (min_blocks<CO, KY3>()))
fused_block_mma_kernel(const Params p) {
  using C = Cfg<CO>;
  constexpr int LDO = C::LDO, NT = C::NT, MT = m_tiles<CO, KY3>(), NV = CO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const bool res_conv = p.final_mode == kResConv;
  const bool stream = CO == 64 && p.stream != 0;  // 16, 32: always resident
  const Layout L = layout<CO, KY3>(p.ci, p.TX, p.TZ, p.final_mode, stream);
  bf16* s_vec = sm + L.vec;
  bf16* s_w = sm + L.w;
  bf16* s_wd = sm + L.wd;
  bf16* s_res = sm + L.res;
  bf16* s_in = sm + L.in;
  bf16* s_mid = sm + L.mid;
  bf16* s_ring = sm + L.ring;
  const int TX = p.TX, TZ = p.TZ;
  const int NZ0 = TZ + 4, NZ1 = TZ + 2;  // z spans of the input and conv-0 tiles
  const float inv_tz = 1.f / TZ, inv_nz1 = 1.f / NZ1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ring_slot = TX * TZ * LDO;
  const bf162 zero2 = __float2bfloat162_rn(0.f);
  // streamed weights: warps 0-3 copy them, warps 4-7 the input rows
  constexpr int kHalf = kThreads / 2;
  const bool w_loader = stream && threadIdx.x < kHalf;
  const bool in_loader = !stream || threadIdx.x >= kHalf;
  const int in_t0 = stream ? kHalf : 0, in_nt = stream ? kHalf : kThreads;
  const int CI16 = L.CI16;
  const bf16* sv_in = s_vec;
  const bf16* bv_in = s_vec + CI16;
  auto sv = [&](int j) { return s_vec + 2 * CI16 + 2 * j * CO; };  // s_j, then b_j
  const bf16* s_sd = s_vec + 2 * CI16 + 6 * CO;
  const bf16* s_bd = s_sd + CO;
  const int last = KY3 ? 2 : 1;
#ifdef MMF_K8_PROFILE
  long long t_prof = clock64();
#endif

  // the per-channel vectors, 0 where absent or beyond ci
  for (int i = threadIdx.x; i < 2 * CI16 + 8 * CO; i += kThreads) {
    const bf16* src;
    int c, n = CO;
    if (i < 2 * CI16) {
      src = i < CI16 ? p.s_in : p.b_in;
      c = i % CI16;
      n = p.ci;
    } else {
      const int k = i - 2 * CI16, slot = k / CO;
      c = k % CO;
      src = slot < 6 ? ((slot & 1) ? p.b[slot >> 1] : p.s[slot >> 1]) : slot == 6 ? p.sd : p.bd;
    }
    s_vec[i] = src != nullptr && c < n ? src[c] : __float2bfloat16_rn(0.f);
  }
  // resident weights (and the 1x1 weights) once per block
  if (res_conv) load_rows<CO>(s_wd, p.wd, 1, p.ci, 0, CI16, CI16, 0, kThreads);
  int w_off[3] = {0, 9 * CI16 * LDO, 9 * (CI16 + CO) * LDO};
  if (!stream)
    for (int j = 0; j <= last; ++j)
      load_rows<CO>(s_w + w_off[j], p.w[j], j == 2 ? 3 : 9, j == 0 ? p.ci : CO, 0,
                    j == 0 ? CI16 : CO, j == 0 ? CI16 : CO, 0, kThreads);
  cp_async_commit();
  cp_async_wait_all();
  // streamed: chunk kc of conv j into slot s
  int wseq = 0;
  auto load_chunk = [&](int s, int j, int kc) {
    load_rows<CO>(s_w + s * C::SLOT, p.w[j], j == 2 ? 3 : 9, j == 0 ? p.ci : CO, 16 * kc, 16, 16,
                  0, kHalf);
    cp_async_commit();
  };
  if (w_loader) load_chunk(0, 0, 0);

  struct Item {
    int b, x0, z0, y0, y1;
  };
  auto item_at = [&](int it) {
    Item r;
    r.z0 = it % p.n_zt * TZ;
    it /= p.n_zt;
    r.x0 = it % p.n_xt * TX;
    it /= p.n_xt;
    r.y0 = it % p.n_yc * p.G;
    r.b = it / p.n_yc;
    r.y1 = min(p.Y, r.y0 + p.G);
    return r;
  };
  // row y of x ((X, Z, ci)), or row 0 where y is dead (nothing is read)
  auto plane = [&](const Item& it, int y, bool live) {
    return p.x + ((int64_t)it.b * p.Y + (live ? y : 0)) * p.X * p.Z * p.ci;
  };
  // the input row yy of the window with its halo of 2, 0 outside the extents
  auto load_input = [&](const Item& it, int yy) {
    const bool live = yy >= 0 && yy < p.yt;
    copy_window(s_in, L.LDI, p.x, plane(it, yy, live), TX + 4, NZ0, it.x0 - 2, it.z0 - 2,
                CI16 / 8, p.ci / 8, live, p.Z, p.ci, p.xt, p.zt, threadIdx.x - in_t0, in_nt);
    cp_async_commit();
  };
  // the raw x of output row yo over the window (res_id, res_conv)
  auto load_res = [&](const Item& it, int yo) {
    const bool live = yo < p.yt;
    copy_window(s_res, L.LDI, p.x, plane(it, yo, live), TX, TZ, it.x0, it.z0, CI16 / 8,
                p.ci / 8, live, p.Z, p.ci, p.xt, p.zt, threadIdx.x - in_t0, in_nt);
    cp_async_commit();
  };

  // One conv over the n_pos positions of a window: A rows of position q at
  // src + a_base(q) (+ toff[t] for tap t), conv j's weights; the sums of
  // the warp's m16 tiles go to epi(t0, nmt, acc) pass by pass (the warp's
  // tiles are t0 + 8 mt, mt < nmt).  Streamed weights: chunk by chunk
  // through the two slots, the next one (of this conv, or the first of
  // conv next_j, or none when next_j < 0) in flight.  sync_epi: a
  // __syncthreads between the sums and epi (every warp done reading src).
  auto stage = [&](auto taps_c, int j, const bf16* src, int n_pos, auto a_base,
                   const auto& toff, int next_j, bool sync_epi, auto epi) {
    constexpr int TAPS = decltype(taps_c)::value;
    const int cin16 = j == 0 ? CI16 : CO, n_k = cin16 / 16;
    const int n_mt = (n_pos + 15) / 16, per_pass = kWarps * MT;
    const int n_pass = (n_mt + per_pass - 1) / per_pass;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int t0 = pass * per_pass + warp;
      const int nmt = t0 < n_mt ? min(MT, (n_mt - t0 + kWarps - 1) / kWarps) : 0;
      int a_off[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a_off[mt] = a_base(min((t0 + kWarps * mt) * 16 + frag_row_a(lane), n_pos - 1)) +
                    frag_col_a(lane);
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
      for (int kc = 0; kc < n_k; ++kc) {
        if (stream) {
          if (w_loader) cp_async_wait_all();  // chunk wseq is in
          __syncthreads();                    // ... for all; slot wseq - 1 is free
          int nj = j, nkc = kc + 1;
          if (nkc == n_k) {
            nkc = 0;
            if (pass + 1 == n_pass) nj = next_j;
          }
          if (w_loader && nj >= 0) load_chunk((wseq + 1) & 1, nj, nkc);
          mma_chunk<CO, TAPS, MT>(acc, s_w + (wseq & 1) * C::SLOT, 16 * LDO, src, a_off, toff,
                                  16 * kc, nmt, lane);
          ++wseq;
        } else {
          mma_chunk<CO, TAPS, MT>(acc, s_w + w_off[j] + 16 * kc * LDO, cin16 * LDO, src, a_off,
                                  toff, 16 * kc, nmt, lane);
        }
      }
      if (sync_epi) {
        if (in_loader) cp_async_wait_one();  // the residual tile is in
        __syncthreads();
      }
      PROF(8 + j);
      epi(t0, nmt, acc);
    }
  };
  // conv j's rounded, affine, ReLU'd output into dst ([q][co + 8] over an
  // NXo x NZo window whose (0, 0) lies at (gx0, gz0)); 0 outside the extents
  // and on dead rows
  auto to_tile = [&](bf16* dst, int NZo, float inv_nzo, int n_pos, int gx0, int gz0, bool live,
                     int j) {
    const bf16* s = sv(j);
    const bf16* b = s + CO;
    return [=, &p](int t0, int nmt, float(&acc)[MT][NT][4]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= nmt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (t0 + kWarps * mt) * 16 + (lane >> 2) + 8 * h;
          if (q >= n_pos) continue;
          const int xo = fdiv(q, inv_nzo), zo = q - xo * NZo;
          const int gx = gx0 + xo, gz = gz0 + zo;
          const bool valid = live && gx >= 0 && gx < p.xt && gz >= 0 && gz < p.zt;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int ch = n * 8 + 2 * (lane & 3);
            bf162 v = __floats2bfloat162_rn(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
            v = __hmax2(affine2(v, ld2(s + ch), ld2(b + ch)), zero2);
            st2(dst + (size_t)q * LDO + ch, valid ? v : zero2);
          }
        }
      }
    };
  };

  // the block output of row yo of item `it` from the last conv's sums,
  // through the conv-0 tile (free by then) as staging
  auto emit = [&](const Item& it, int yo) {
    return [&, yo](int t0, int nmt, float(&acc)[MT][NT][4]) {
      const int n_pos = TX * TZ, mode = p.final_mode;
      const bool row_ok = yo < p.yt;
      const int64_t row = ((int64_t)it.b * p.Y + yo) * p.X;
      if (mode == kResConv) {
        // res_conv: the rounded conv values into the warp's staging rows,
        // then the 1x1 downsample of the raw x into acc, k16 steps in order
        // (the (1,1,1) instance's sums), A from the residual tile
        int a_off[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt < nmt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = (t0 + kWarps * mt) * 16 + (lane >> 2) + 8 * h;
              if (q >= n_pos) continue;
#pragma unroll
              for (int n = 0; n < NT; ++n)
                st2(s_mid + (size_t)q * LDO + n * 8 + 2 * (lane & 3),
                    __floats2bfloat162_rn(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]));
            }
          }
          a_off[mt] = min((t0 + kWarps * mt) * 16 + frag_row_a(lane), n_pos - 1) * L.LDI +
                      frag_col_a(lane);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
        }
        for (int k0 = 0; k0 < CI16; k0 += 16) {
          uint32_t bfr[CO / 16][4];
#pragma unroll
          for (int qq = 0; qq < CO / 16; ++qq)
            ldsm_x4_trans(bfr[qq], s_wd + (size_t)(k0 + frag_row_a(lane)) * LDO +
                                       frag_col_a(lane) + 16 * qq);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt >= nmt) continue;
            uint32_t af[4];
            ldsm_x4(af, s_res + a_off[mt] + k0);
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_bf16(acc[mt][n], af, bfr[n / 2][2 * (n & 1)], bfr[n / 2][2 * (n & 1) + 1]);
          }
        }
      }
      PROF(12);
      // the final mode on the warp's own positions, two channels at a time
      // in bf16x2 ops, which round as fused_block.cu's `finish` and the
      // per-op path's torch bf16 ops do (affine2, fused_conv_mma.cuh); the
      // ReLU as there, on floats
      const bf16* s = sv(last);
      const bf16* b = s + CO;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= nmt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (t0 + kWarps * mt) * 16 + (lane >> 2) + 8 * h;
          if (q >= n_pos) continue;
          const int xo = fdiv(q, inv_tz), zo = q - xo * TZ;
          const bool valid = row_ok && it.x0 + xo < p.xt && it.z0 + zo < p.zt;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int ch = n * 8 + 2 * (lane & 3);
            bf16* at = s_mid + (size_t)q * LDO + ch;
            bf162 v = mode == kResConv
                          ? ld2(at)
                          : __floats2bfloat162_rn(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
            if (mode != kRaw) {
              v = affine2(v, ld2(s + ch), ld2(b + ch));
              if (mode == kResId) {
                v = __hadd2_rn(v, ld2(s_res + (size_t)q * L.LDI + ch));
              } else if (mode == kResConv) {
                const bf162 t = __hmul2_rn(
                    __floats2bfloat162_rn(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]),
                    ld2(s_sd + ch));
                v = __hadd2_rn(__hadd2_rn(v, t), ld2(s_bd + ch));
              }
              if (mode != kAffine) {
                const float2 f = __bfloat1622float2(v);
                v = __floats2bfloat162_rn(fmaxf(f.x, 0.f), fmaxf(f.y, 0.f));
              }
              if (!valid) v = zero2;
            }
            st2(at, v);
          }
        }
      }
      __syncwarp();
      // 4. 16-byte stores of the warp's positions inside the volume
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= nmt) continue;
        const int base = (t0 + kWarps * mt) * 16;
        for (int i = lane; i < 16 * NV; i += 32) {
          const int q = base + i / NV, v = i % NV;
          if (q >= n_pos) continue;
          const int xo = fdiv(q, inv_tz), zo = q - xo * TZ;
          const int gx = it.x0 + xo, gz = it.z0 + zo;
          if (gx < p.X && gz < p.Z)
            *reinterpret_cast<uint4*>(p.out + ((row + gx) * p.Z + gz) * CO + 8 * v) =
                *reinterpret_cast<const uint4*>(s_mid + (size_t)q * LDO + 8 * v);
        }
      }
      __syncwarp();
    };
  };

  // tap offsets of the (1,3,3) convs (input tile, conv-0 tile)
  int toff0[9], toff1[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    toff0[t] = ((t / 3) * NZ0 + t % 3) * L.LDI;
    toff1[t] = ((t / 3) * NZ1 + t % 3) * LDO;
  }
  const bool prologue = p.s_in != nullptr || p.relu0;

  int item = blockIdx.x;
  if (item >= p.n_items) return;
  Item it = item_at(item);
  int yy = KY3 ? it.y0 - 1 : it.y0;
  if (in_loader) load_input(it, yy);
  PROF(0);
  while (true) {
    const int y_last = KY3 ? it.y1 : it.y1 - 1;
    const bool emit2 = KY3 && yy > it.y0;  // conv 2 emits row yy - 1
    Item nit = it;
    int nyy = yy + 1, nitem = item;
    bool has_next = true;
    if (yy == y_last) {
      nitem = item + gridDim.x;
      has_next = nitem < p.n_items;
      if (has_next) {
        nit = item_at(nitem);
        nyy = KY3 ? nit.y0 - 1 : nit.y0;
      }
    }
    const bool live = yy >= 0 && yy < p.yt;
    if (in_loader) cp_async_wait_all();
    PROF(1);
    __syncthreads();  // this row's input is in; the last row's readers are done
    PROF(2);
    if (in_loader) {  // the residual tile of the row this iteration emits
      if (reads_x(p.final_mode) && (!KY3 || emit2))
        load_res(it, KY3 ? yy - 1 : yy);
      else
        cp_async_commit();
    }
    if (prologue) {
      if (live) {
        const int nvi = CI16 / 8;
        const int total = (TX + 4) * NZ0 * nvi;
        for (int i = threadIdx.x; i < total; i += kThreads) {
          const int v = i % nvi, pos = i / nvi;
          const int xr = pos / NZ0, zr = pos - xr * NZ0;
          const int gx = it.x0 - 2 + xr, gz = it.z0 - 2 + zr;
          if (gx < 0 || gx >= p.xt || gz < 0 || gz >= p.zt) continue;  // stays 0
          uint4* at = reinterpret_cast<uint4*>(s_in + (size_t)pos * L.LDI + 8 * v);
          uint4 val = *at;
          bf162* hv = reinterpret_cast<bf162*>(&val);
          if (p.s_in != nullptr) {
            const uint4 s4 = *reinterpret_cast<const uint4*>(sv_in + 8 * v);
            const uint4 b4 = *reinterpret_cast<const uint4*>(bv_in + 8 * v);
            const bf162* sh = reinterpret_cast<const bf162*>(&s4);
            const bf162* bh = reinterpret_cast<const bf162*>(&b4);
#pragma unroll
            for (int e = 0; e < 4; ++e) hv[e] = affine2(hv[e], sh[e], bh[e]);
          }
          if (p.relu0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) hv[e] = __hmax2(hv[e], zero2);
          }
          *at = val;
        }
      }
      __syncthreads();
    }
    // conv 0 over the window with a halo of 1
    stage(std::integral_constant<int, 9>{}, 0, s_in, (TX + 2) * NZ1,
          [&](int q) {
            const int xm = fdiv(q, inv_nz1);
            return (xm * NZ0 + q - xm * NZ1) * L.LDI;
          },
          toff0, 1, false,
          to_tile(s_mid, NZ1, inv_nz1, (TX + 2) * NZ1, it.x0 - 1, it.z0 - 1, live, 0));
    PROF(3);
    __syncthreads();  // the conv-0 tile is whole; the input tile is free
    PROF(4);
    if (in_loader) {
      if (has_next)
        load_input(nit, nyy);
      else
        cp_async_commit();
    }
    PROF(5);
    // conv 1 over the window
    const int after1 = emit2 ? 2 : has_next ? 0 : -1;
    auto a1 = [&](int q) {
      const int xo = fdiv(q, inv_tz);
      return (xo * NZ1 + q - xo * TZ) * LDO;
    };
    if constexpr (KY3) {
      stage(std::integral_constant<int, 9>{}, 1, s_mid, TX * TZ, a1, toff1, after1, false,
            to_tile(s_ring + mod3(yy) * ring_slot, TZ, inv_tz, TX * TZ, it.x0, it.z0, live, 1));
      PROF(6);
      if (emit2) {
        // the (3,1,1) conv of ring rows yy - 2, yy - 1, yy (taps 0, 1, 2)
        if (in_loader) cp_async_wait_one();  // the residual tile is in
        __syncthreads();
        PROF(7);
        const int toff2[3] = {mod3(yy - 2) * ring_slot, mod3(yy - 1) * ring_slot,
                              mod3(yy) * ring_slot};
        stage(std::integral_constant<int, 3>{}, 2, s_ring, TX * TZ,
              [&](int q) { return q * LDO; }, toff2, has_next ? 0 : -1, false, emit(it, yy - 1));
        PROF(11);
      }
    } else {
      stage(std::integral_constant<int, 9>{}, 1, s_mid, TX * TZ, a1, toff1, after1, true,
            emit(it, yy));
      PROF(11);
    }
    if (!has_next) break;
    it = nit;
    yy = nyy;
    item = nitem;
  }
}

// ---- host side -----------------------------------------------------------

struct Plan {
  int TX, TZ, G, n_xt, n_zt, n_yc, items, grid, stream;
  size_t smem;
};

struct Cand {
  int tx, tz, stream;  // window, weights streamed
};

// The window and the weights' residence: the first candidate whose tiles
// fit (TX, TZ cut to X, Z), with n = 2 also one pass of the last conv (its
// epilogue stages into the conv-0 tile it reads); first among the windows
// whose conv 0 takes one pass, then among all.  The order is from timing
// the candidates at the model's stage shapes on the H100: at 64 channels
// two convs keep their weights resident where they fit
// (8 x 24, 8 x 16), else stream them with an 8 x 30 window; three convs'
// weights never fit beside a useful window.  G: of Y, Y/2, Y/4, ... (down
// to 4 rows with a (3,1,1) conv, 1 without), the chunk that minimises the
// items per resident block times the rows each item walks (G, plus the
// two halo rows of a (3,1,1) conv).  Returns 0, -1 when no window fits,
// or a CUDA error.
template <int CO, bool KY3>
int make_plan(Plan& pl, int B, int Y, int X, int Z, int ci, int mode) {
  static const Cand c16[] = {{8, 32, 0}, {4, 32, 0}, {2, 32, 0}, {1, 32, 0}, {1, 16, 0}};
  static const Cand c32[] = {{8, 32, 0}, {8, 16, 0}, {4, 32, 0}, {4, 16, 0}, {2, 16, 0},
                             {1, 16, 0}};
  static const Cand c64[] = {{8, 24, 0}, {8, 16, 0}, {8, 30, 1}, {8, 24, 1}, {8, 22, 1},
                             {8, 20, 1}, {8, 16, 1}, {4, 24, 1}, {4, 16, 1}, {2, 16, 1},
                             {1, 16, 1}};
  // three 64-channel convs: streamed only
  const Cand* cand = CO == 16 ? c16 : CO == 32 ? c32 : KY3 ? c64 + 3 : c64;
  const int n_cand = CO == 16 ? 5 : CO == 32 ? 6 : KY3 ? 8 : 11;
  pl = Plan{};
  constexpr int kOnePass = kWarps * 16 * m_tiles<CO, KY3>();  // positions of one pass
  for (int i = 0; i < 2 * n_cand && pl.TX == 0; ++i) {
    const Cand& c = cand[i % n_cand];
    const int tx = min(c.tx, X), tz = min(c.tz, Z);
    if (i < n_cand && (tx + 2) * (tz + 2) > kOnePass) continue;
    if (!KY3 && tx * tz > kOnePass) continue;
    const size_t smem = layout<CO, KY3>(ci, tx, tz, mode, c.stream).total * sizeof(bf16);
    if (smem <= kMaxSmem) {
      pl.TX = tx;
      pl.TZ = tz;
      pl.stream = c.stream;
      pl.smem = smem;
    }
  }
  if (pl.TX == 0) return -1;
  pl.n_xt = (X + pl.TX - 1) / pl.TX;
  pl.n_zt = (Z + pl.TZ - 1) / pl.TZ;
  const int slots = resident_blocks(fused_block_mma_kernel<CO, KY3>, pl.smem, 1, 1LL << 40);
  if (slots < 0) return -slots;
  const long tiles = (long)pl.n_xt * pl.n_zt * B;
  const int g_min = KY3 ? 4 : 1;
  long best = -1;
  for (int G = Y;; G = (G + 1) / 2) {
    const long items = tiles * ((Y + G - 1) / G);
    const long cost = (items + slots - 1) / slots * (G + (KY3 ? 2 : 0));
    if (best < 0 || cost < best) {
      best = cost;
      pl.G = G;
    }
    if (G <= g_min) break;
  }
  pl.n_yc = (Y + pl.G - 1) / pl.G;
  pl.items = (int)(tiles * pl.n_yc);
  pl.grid = min(pl.items, slots);
  return 0;
}

template <int CO, bool KY3>
int run(Params p, cudaStream_t stream, Plan* out) {
  Plan pl;
  const int rc = make_plan<CO, KY3>(pl, p.B, p.Y, p.X, p.Z, p.ci, p.final_mode);
  if (out != nullptr) {
    *out = pl;
    return rc;
  }
  if (rc != 0) return rc < 0 ? (int)cudaErrorInvalidValue : rc;
  p.TX = pl.TX;
  p.TZ = pl.TZ;
  p.G = pl.G;
  p.n_xt = pl.n_xt;
  p.n_zt = pl.n_zt;
  p.n_yc = pl.n_yc;
  p.n_items = pl.items;
  p.stream = pl.stream;
  fused_block_mma_kernel<CO, KY3><<<pl.grid, kThreads, pl.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// With out set, only plans.
int dispatch(int n_conv, int co, const Params& p, cudaStream_t stream, Plan* out) {
  const bool ky3 = n_conv == 3;
  if (co == 16) return ky3 ? run<16, true>(p, stream, out) : run<16, false>(p, stream, out);
  if (co == 32) return ky3 ? run<32, true>(p, stream, out) : run<32, false>(p, stream, out);
  if (co == 64) return ky3 ? run<64, true>(p, stream, out) : run<64, false>(p, stream, out);
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int n_conv, int final_mode, int X, int Z, int ci, int co) {
  return (n_conv == 2 || n_conv == 3) && final_mode >= kRaw && final_mode <= kResConv &&
         (long long)X * Z * (ci > co ? ci : co) < (1LL << 31) &&
         ci > 0 && ci % 8 == 0 && (co == 16 || co == 32 || co == 64) &&
         (final_mode != kResId || ci == co);
}

}  // namespace

// The tiling a call would take: out = {TX, G, shared memory bytes per block,
// blocks (persistent), TZ, weights streamed (0 or 1)}.  Returns 0; -1 when no window's tiles fit in
// shared memory or the shapes are not taken (co in {16, 32, 64}, ci % 8 ==
// 0); else the CUDA error of the occupancy query.
extern "C" int mmf_fused_block_mma_plan(int n_conv, int final_mode, int B, int Y, int X, int Z,
                                        int ci, int co, long long* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (!shapes_ok(n_conv, final_mode, X, Z, ci, co)) return -1;
  Params p{};
  p.B = B, p.Y = Y, p.X = X, p.Z = Z, p.ci = ci, p.final_mode = final_mode;
  Plan pl{};
  const int rc = dispatch(n_conv, co, p, nullptr, &pl);
  if (rc != 0) return rc;
  out[0] = pl.TX;
  out[1] = pl.G;
  out[2] = (long long)pl.smem;
  out[3] = pl.grid;
  out[4] = pl.TZ;
  out[5] = pl.stream;
  return 0;
}

// bf16 only.  n_conv 2: two (1,3,3) convs; 3: (1,3,3), (1,3,3), (3,1,1).
// final_mode: 0 raw, 1 affine, 2 relu, 3 res_id (ci == co), 4 res_conv (wd,
// sd, bd given).  x (B, Y, X, Z, ci) and out (B, Y, X, Z, co) contiguous;
// s_in / b_in (ci) both null or both given; w_j contiguous (kY, kX, kz, c_in,
// co); s_j / b_j (co), the last conv's null for raw; wd (1, 1, 1, ci, co),
// sd / bd (co); every pointer 16-byte aligned.  ci % 8 == 0, co in {16, 32,
// 64}.  ext: null, or host memory holding the true extents {yt, xt, zt} (1 <=
// yt <= Y, ...).  Returns the cudaGetLastError() of the launch (0 on
// success).
extern "C" int mmf_fused_block_mma(int n_conv, int final_mode, int relu0, const void* x,
                                   const void* s_in, const void* b_in, const void* w0,
                                   const void* s0, const void* b0, const void* w1,
                                   const void* s1, const void* b1, const void* w2,
                                   const void* s2, const void* b2, const void* wd,
                                   const void* sd, const void* bd, void* out, const int* ext,
                                   int B, int Y, int X, int Z, int ci, int co, void* stream) {
  if (!shapes_ok(n_conv, final_mode, X, Z, ci, co) || (s_in == nullptr) != (b_in == nullptr))
    return (int)cudaErrorInvalidValue;
  if (final_mode == kResConv && (wd == nullptr || sd == nullptr || bd == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* s_last = n_conv == 3 ? s2 : s1;
  if (final_mode != kRaw && s_last == nullptr) return (int)cudaErrorInvalidValue;
  if (ext != nullptr && (ext[0] < 1 || ext[0] > Y || ext[1] < 1 || ext[1] > X || ext[2] < 1 ||
                         ext[2] > Z))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.s_in = static_cast<const bf16*>(s_in);
  p.b_in = static_cast<const bf16*>(b_in);
  const void* ws[3] = {w0, w1, w2};
  const void* ss[3] = {s0, s1, s2};
  const void* bs[3] = {b0, b1, b2};
  for (int j = 0; j < 3; ++j) {
    p.w[j] = static_cast<const bf16*>(ws[j]);
    p.s[j] = static_cast<const bf16*>(ss[j]);
    p.b[j] = static_cast<const bf16*>(bs[j]);
  }
  p.wd = static_cast<const bf16*>(wd);
  p.sd = static_cast<const bf16*>(sd);
  p.bd = static_cast<const bf16*>(bd);
  p.out = static_cast<bf16*>(out);
  p.B = B, p.Y = Y, p.X = X, p.Z = Z, p.ci = ci;
  p.yt = ext != nullptr ? ext[0] : Y;
  p.xt = ext != nullptr ? ext[1] : X;
  p.zt = ext != nullptr ? ext[2] : Z;
  p.relu0 = relu0;
  p.final_mode = final_mode;
  return dispatch(n_conv, co, p, static_cast<cudaStream_t>(stream), nullptr);
}

#ifdef MMF_K8_PROFILE
// The cycles per phase since the last reset (and resets them): 0 set-up, 1
// the wait for a row's input, 2 the barrier after it, 8 / 9 / 10 conv 0 /
// 1 / 2's MMAs (conv 0's with the entry activation), 3 conv 0's epilogue,
// 4 the barrier after it, 5 issuing the next row's copy, 6 conv 1's ring
// epilogue, 7 the barrier before conv 2, 12 the output's staging and
// res_conv's 1x1, 11 the rest of the output.
extern "C" int mmf_k8_profile(long long* out, int reset) {
  unsigned long long h[16];
  int rc = (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(h));
  for (int i = 0; i < 16; ++i) out[i] = (long long)h[i];
  if (reset) {
    for (int i = 0; i < 16; ++i) h[i] = 0;
    rc |= (int)cudaMemcpyToSymbol(g_prof, h, sizeof(h));
  }
  return rc;
}
#endif
