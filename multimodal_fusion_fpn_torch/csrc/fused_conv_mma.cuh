// Staging pieces of the tensor-core kernels (fused_conv_mma.cu, the bf16
// forward; fused_conv_bwd_mma.cu, the bf16 backward): 16-byte cp.async
// copies of channels-last tiles with their halo into shared memory, the
// activation on bf16x2 lanes, the tile walk of persistent blocks and their
// occupancy.  The fragment helpers (ldmatrix, mma.sync) are in
// fused_conv_common.cuh.
#pragma once

#include "fused_conv_common.cuh"

namespace mmf {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kRows = 8;  // (y, x) rows per tile: one per warp
constexpr int kZT = 32;   // z positions per tile row: two m16 tiles
constexpr int kPad = 8;   // bf16 padding of each shared row
constexpr int kWarps = kThreads / 32;

// Rows of a tile along x: 8 where the conv has an x halo, so the halo is a
// quarter of the rows; else 1 (8 rows along y, as the (3,1,1) conv's halo
// wants, or no halo at all).
constexpr int mma_tile_x(int KX) { return KX == 3 ? kRows : 1; }

// The widest channel block of 64, 32 or 16 that divides n, and log2 of its
// 16-byte vectors.
inline int chunk(int n) { return n % 64 == 0 ? 64 : n % 32 == 0 ? 32 : 16; }
__host__ __device__ inline int lg_vectors(int nc) { return nc == 16 ? 1 : nc == 32 ? 2 : 3; }

// x*s+b on two bf16 lanes, each op rounded to bf16: affine()'s rounding.
// In fp32 a bf16 x bf16 product is exact (in the normal range), and a bf16
// + bf16 sum is exact or, where the addends' exponents differ by more than
// 15, off the larger addend by less than half a bf16 ulp; so affine()'s
// one rounding of the fp32 result to bf16 is the native bf16 op's.  The _rn
// forms keep ptxas from contracting the two into one fma (one rounding).
__device__ __forceinline__ bf162 affine2(bf162 x, bf162 s, bf162 b) {
  return __hadd2_rn(__hmul2_rn(x, s), b);
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read) where
// !valid.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The positions of a staged tile: row r at (y, x) = (ry0 + r / NXS, rx0 +
// r % NXS), r < NROWS, z positions zs0 + zz, zz < NZ; in shared memory at
// row r * ZSPAN + zi, zi = zz, or (HZ > 0) by z parity (zz & 1) * HZ +
// (zz >> 1), so stride-2 reads stay on consecutive rows.
template <int NXS_, int NROWS_, int NZ_, int HZ_ = 0>
struct Rows {
  static constexpr int NXS = NXS_, NROWS = NROWS_, NZ = NZ_, HZ = HZ_;
  static constexpr int ZSPAN = HZ > 0 ? 2 * HZ : NZ;
  int ry0, rx0, zs0;
  __device__ static int at(int r, int zz) {
    return r * ZSPAN + (HZ > 0 ? (zz & 1) * HZ + (zz >> 1) : zz);
  }
  // whether the position lies in [0, ey) x [0, ex) x [0, ez)
  __device__ bool inside(int r, int zz, int ey, int ex, int ez) const {
    const int gy = ry0 + r / NXS, gx = rx0 + r % NXS, gz = zs0 + zz;
    return gy >= 0 && gy < ey && gx >= 0 && gx < ex && gz >= 0 && gz < ez;
  }
  // offset of the position in a (Y, X, Zl) volume (in positions)
  __device__ int64_t at_volume(int r, int zz, int X, int Zl) const {
    return ((int64_t)(ry0 + r / NXS) * X + rx0 + r % NXS) * Zl + zs0 + zz;
  }
  // offset of the position in a (Y, X, Zl) volume, or -1 outside it
  __device__ int64_t offset(int r, int zz, int Y, int X, int Zl) const {
    return inside(r, zz, Y, X, Zl) ? at_volume(r, zz, X, Zl) : -1;
  }
};

// Calls f(r, zz, v) for every 16-byte vector v < 2^lg of every position of
// the tile, spread over the block's threads.
template <class R, class F>
__device__ __forceinline__ void for_vectors(int lg, F f) {
  const int total = (R::NROWS * R::NZ) << lg;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int p = idx >> lg;
    const int r = p / R::NZ;
    f(r, p - r * R::NZ, idx & ((1 << lg) - 1));
  }
}

// Start copying channels [c0, c0 + 8 * 2^lg) of the tile's positions of src
// (a (Y, X, Zl, C) volume at src + base) into s (rows of LD elements); zero
// outside the volume.
template <class R>
__device__ __forceinline__ void load_tile(bf16* s, int LD, const bf16* __restrict__ src,
                                          int64_t base, int Y, int X, int Zl, int C,
                                          int c0, int lg, const R& rows) {
  for_vectors<R>(lg, [&](int r, int zz, int v) {
    const int64_t off = rows.offset(r, zz, Y, X, Zl);
    cp_async16(s + (size_t)R::at(r, zz) * LD + 8 * v,
               off < 0 ? src : src + base + off * C + c0 + 8 * v, off >= 0);
  });
}

// dst = relu?(src * s + b) of the staged x at the forward's rounding (a copy
// where neither is given), zero outside [0, Y) x [0, X) x [0, Z): the
// activated input t.  s_sb: the scale of the tile's channels, their bias at
// s_sb + NC (bf16), or null.  dst may be src.
template <class R>
__device__ __forceinline__ void activate_tile(bf16* dst, const bf16* src, int LD,
                                              const bf16* s_sb, int NC, int relu,
                                              int lg, int Y, int X, int Z,
                                              const R& rows) {
  for_vectors<R>(lg, [&](int r, int zz, int v) {
    const size_t at = (size_t)R::at(r, zz) * LD + 8 * v;
    uint4 val = *reinterpret_cast<const uint4*>(src + at);
    if (!rows.inside(r, zz, Y, X, Z)) {
      val = make_uint4(0u, 0u, 0u, 0u);
    } else if (s_sb != nullptr || relu) {
      bf162* h = reinterpret_cast<bf162*>(&val);
      if (s_sb != nullptr) {
        const uint4 s4 = *reinterpret_cast<const uint4*>(s_sb + 8 * v);
        const uint4 b4 = *reinterpret_cast<const uint4*>(s_sb + NC + 8 * v);
        const bf162* sh = reinterpret_cast<const bf162*>(&s4);
        const bf162* bh = reinterpret_cast<const bf162*>(&b4);
#pragma unroll
        for (int q = 0; q < 4; ++q) h[q] = affine2(h[q], sh[q], bh[q]);
      }
      if (relu) {
        const bf162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
        for (int q = 0; q < 4; ++q) h[q] = __hmax2(h[q], zero);
      }
    }
    *reinterpret_cast<uint4*>(dst + at) = val;
  });
}

// (b, y0, x0, z0) of spatial tile `tile`, z fastest: TY x TX rows, kZT z.
struct TileAt {
  int b, y0, x0, z0;
};
__device__ __forceinline__ TileAt tile_at(int tile, int Y, int X, int Zl, int TX) {
  const int TY = kRows / TX;
  const int n_zt = (Zl + kZT - 1) / kZT, n_xt = (X + TX - 1) / TX, n_yt = (Y + TY - 1) / TY;
  TileAt t;
  t.z0 = tile % n_zt * kZT;
  tile /= n_zt;
  t.x0 = tile % n_xt * TX;
  tile /= n_xt;
  t.y0 = tile % n_yt * TY;
  t.b = tile / n_yt;
  return t;
}

__host__ __device__ inline long long n_tiles_of(int B, int Y, int X, int Zl, int TX) {
  const int TY = kRows / TX;
  return (long long)B * ((Y + TY - 1) / TY) * ((X + TX - 1) / TX) * ((Zl + kZT - 1) / kZT);
}

constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a block may opt into on sm_90

// Blocks per channel group that the card holds at once (the resident blocks
// over all `groups` groups), at least 1 and at most n_tiles; minus a CUDA
// error if the kernel cannot run with `smem` bytes.  A kernel's shared
// memory limit (set once, to kMaxSmem), its occupancy at each `smem` and
// the card's SM count are kept per kernel and device, so after the first
// launch a launch asks the runtime only for the current device.
template <typename Kernel>
int resident_blocks(Kernel kern, size_t smem, int groups, long long n_tiles) {
  struct Entry {  // a kernel's occupancy at one shared memory size
    const void* kern;
    int dev;
    size_t smem;
    int per_sm;
  };
  constexpr int kDevices = 16, kEntries = 256;
  static int sms[kDevices];
  static Entry entries[kEntries];
  static int n_entries = 0;
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return -rc;
  if (dev >= kDevices) return -(int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    rc = (int)cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (rc != 0) return -rc;
  }
  const void* key = reinterpret_cast<const void*>(kern);
  int per_sm = 0;
  for (int i = 0; i < n_entries && per_sm == 0; ++i)
    if (entries[i].kern == key && entries[i].dev == dev && entries[i].smem == smem)
      per_sm = entries[i].per_sm;
  if (per_sm == 0) {
    rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kMaxSmem);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (rc != 0) return -rc;
    if (per_sm == 0) return -(int)cudaErrorInvalidConfiguration;
    if (n_entries < kEntries) entries[n_entries++] = Entry{key, dev, smem, per_sm};
  }
  long long n = (long long)per_sm * sms[dev] / groups;
  if (n < 1) n = 1;
  return (int)(n < n_tiles ? n : n_tiles);
}

inline int tap_key(int ky, int kx, int kz, int sz) {
  return ((ky * 4 + kx) * 4 + kz) * 4 + sz;
}

// The tap sets of the fused conv: (kY, kX, kz, z stride).
#define MMF_TAPS(M) \
  M(1, 3, 3, 1)     \
  M(3, 1, 1, 1)     \
  M(1, 1, 1, 1)     \
  M(1, 1, 3, 1)     \
  M(1, 1, 3, 2)

}  // namespace mmf
