// Depthwise-conv kernels of the MHSA stages, channel-last (B, H, W, C),
// stride 1, zero SAME padding, fp32 accumulation:
//
//   cpe:   y = dwconv3x3(x) + b + x          (ConvPosEnc with its residual)
//   crpe:  y = q * (dwconv7x7(v) + b)        (ConvRelPosEnc with its gate)
//
// and their backwards. Two tiled kernel templates, on the window K and on
// the epilogue, and one reduce serve all four. They replace the Pallas TPU
// kernels of mdvit_tpu/ops/pallas_dwconv.py:
//
//   dwconv_fwd_tiled_kernel<K = 3, not gated>   _cpe_fwd_kernel   (_cpe_fwd)
//   dwconv_fwd_tiled_kernel<K = 7, gated>       _crpe_fwd_kernel  (_crpe_fwd_call)
//   dwconv_bwd_tiled_kernel<K = 3, not gated>   _cpe_bwd_kernel   (_cpe_vjp_bwd)
//   dwconv_bwd_tiled_kernel<K = 7, gated>       _crpe_bwd_kernel  (_crpe_vjp_bwd)
//     each backward followed by dwconv_weight_reduce_kernel.
//
// Those copy a whole zero-padded image into VMEM. The fused residual and
// gate keep dwconv(x) out of device memory here as there.
//
// Bound. All four are bound by bytes on this card: CPE moves 2 images (3
// backward), CRPE 3 (5 backward), against 9 to 49 multiply-adds an output
// (147 in CRPE's backward), under the fp32 FMA rate. A thread per output is
// bound by instructions instead: K * K loads from L1, a bounds check per tap
// and 64-bit index math per output (on an H100 it reached 7 to 17% of the
// bytes bound, and bf16 ran no faster than fp32).
//
// Design. A block takes one image, an 8 x TW output tile and a slice of 32
// channels, one per lane. It stages the (8+K-1) x (TW+K-1) x 32 halo of the
// conv input in shared memory once, with asynchronous copies of the widest
// size that the pointers, strides and C allow (zeros outside the image and
// past C), so each pixel comes from device memory about once and its
// re-reads come from L2. Each thread keeps its channel's K * K weights in
// registers and owns blocks of outputs; it reads each halo row of a block
// once and applies it to every output row and tap that use it. Index math is
// 32-bit inside an image and resolved at compile time in the tap loops.
// CPE's residual x(here) is read from the staged halo's centre, not from
// device memory a second time.
//
// The backward is one pass over the same tiles: it stages the conv input
// (x or v) and u (g for CPE, as T; g * q for CRPE, formed in fp32 as it
// loads). Each thread computes the input gradient conv(u, w turned 180
// degrees) (plus u(here): CPE's dx; CRPE's dv), CRPE's dq = g * (conv(v) +
// b), and its K * K dw and 1 db partial sums; the block folds its thread
// rows in a fixed order in shared memory and writes one partial row per
// tile. dw and db are sums over B*H*W: the Pallas kernel carries them across
// its sequential batch grid; blocks here run in no order, so the reduce adds
// the tiles' rows in a fixed order afterwards, without float atomics. Two
// calls give the same bits. CRPE's 49 weights and 50 partial sums per thread
// take ~185 registers, so a backward block has 4 thread rows (128 threads),
// a CRPE thread running over 1 x 4 strips; a CPE thread, with 9 and 10,
// owns an 8 x 4 block (4 x 4 in 8-wide tiles). The 3x3 and 5x5 CRPE head
// groups reach the kernel zero-embedded in the 7x7 window; their zero taps
// are computed.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace mdvit {
namespace {

constexpr int kSlice = 32;         // channels of a block, one per lane
constexpr int kRows = 8;           // thread rows of a forward block
constexpr int kBwdRows = 4;        // of a backward block
constexpr int kTileH = 8;          // TILE_H in ops/kernels.py
constexpr int kRX = 4;             // outputs of a thread along W

// Tile width: 16, or 8 for images at most 8 wide (as dwconv_weight_tiles in
// ops/kernels.py counts them); the tile is kTileH x TW output pixels.
int tile_w(int width) { return width > 8 ? 16 : 8; }

template <int K, int TW>
__host__ __device__ constexpr int halo_pixels() { return (kTileH + K - 1) * (TW + K - 1); }

// A vector of VEC bytes of T, the unit of a halo copy.
template <typename T, int VEC>
struct alignas(VEC) Pack {
  static_assert(VEC >= static_cast<int>(sizeof(T)), "a copy holds whole elements");
  T v[VEC / sizeof(T)];
};

// One copy of VEC bytes from device to shared memory, zeros if !valid
// (cp.async reads src-size bytes and fills the rest with zeros). cp.async
// has no 2-byte size: that one is a plain load and store.
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  if constexpr (VEC == 2) {
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src) : static_cast<unsigned short>(0);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? VEC : 0;
    if constexpr (VEC == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(n));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                   "n"(VEC), "r"(n));
  }
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy i of a tile's halo: its halo pixel, its channel offset cc in the
// slice, the image pixel y * W + x it reads, and whether that lies in the
// image and below C (a copy never straddles C: C is a multiple of the
// elements in a copy).
template <typename T, int K, int TW, int VEC>
struct HaloCopy {
  static constexpr int kPer = VEC / sizeof(T);
  static constexpr int kCopies = kSlice / kPer;  // copies per pixel
  static constexpr int kCount = halo_pixels<K, TW>() * kCopies;
  int pix, cc, at;
  bool valid;
  __device__ __forceinline__ HaloCopy(int i, int y0, int x0, int c0, int height,
                                      int width, int chans) {
    pix = i / kCopies;
    cc = (i % kCopies) * kPer;
    const int y = y0 + pix / (TW + K - 1) - K / 2;
    const int x = x0 + pix % (TW + K - 1) - K / 2;
    valid = y >= 0 && y < height && x >= 0 && x < width && c0 + cc < chans;
    at = valid ? y * width + x : 0;
  }
};

// Stage the halo of img (one image, pixel stride ps) into s[pix][32] as T
// with asynchronous copies; the caller waits.
template <typename T, int K, int TW, int VEC, int ROWS>
__device__ __forceinline__ void stage_halo(T* s, const T* img, int ps, int y0, int x0,
                                           int c0, int height, int width, int chans) {
  using H = HaloCopy<T, K, TW, VEC>;
  const int tid = threadIdx.y * kSlice + threadIdx.x;
  for (int i = tid; i < H::kCount; i += ROWS * kSlice) {
    const H h(i, y0, x0, c0, height, width, chans);
    copy_async<VEC>(s + h.pix * kSlice + h.cc,
                    h.valid ? img + h.at * ps + c0 + h.cc : img, h.valid);
  }
}

// Stage u = g * q over the halo into s[pix][32] as fp32 (g contiguous,
// pixel stride chans; q pixel stride q_ps), zeros outside. Each thread loads
// kBatch copies of g and q before it stores any, so a block waits for a few
// round trips to memory, not one per copy.
template <typename T, int K, int TW, int VEC, int ROWS>
__device__ __forceinline__ void stage_product(float* __restrict__ s, const T* __restrict__ g,
                                              const T* __restrict__ q, int q_ps, int y0,
                                              int x0, int c0, int height, int width,
                                              int chans) {
  using H = HaloCopy<T, K, TW, VEC>;
  using P = Pack<T, VEC>;
  constexpr int kBatch = 4;
  const int tid = threadIdx.y * kSlice + threadIdx.x;
  constexpr int kThreads = ROWS * kSlice;
  for (int i0 = tid; i0 < H::kCount; i0 += kBatch * kThreads) {
    P gp[kBatch], qp[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      const H h(i, y0, x0, c0, height, width, chans);
      if (i < H::kCount && h.valid) {
        gp[k] = *reinterpret_cast<const P*>(g + h.at * chans + c0 + h.cc);
        qp[k] = *reinterpret_cast<const P*>(q + h.at * q_ps + c0 + h.cc);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      if (i >= H::kCount) break;
      const H h(i, y0, x0, c0, height, width, chans);
      float* dst = s + h.pix * kSlice + h.cc;
#pragma unroll
      for (int e = 0; e < H::kPer; ++e)
        dst[e] = h.valid ? to_f(gp[k].v[e]) * to_f(qp[k].v[e]) : 0.f;
    }
  }
}

// Block coordinates: blockIdx.x = (b, tile row, tile column), blockIdx.y =
// channel slice.
template <int TW>
struct TileOf {
  int b, y0, x0, c0;
  __device__ __forceinline__ TileOf(int height, int width) {
    const int tiles_x = (width + TW - 1) / TW;
    const int tiles_y = (height + kTileH - 1) / kTileH;
    int t = blockIdx.x;
    x0 = (t % tiles_x) * TW;
    t /= tiles_x;
    y0 = (t % tiles_y) * kTileH;
    b = t / tiles_y;
    c0 = blockIdx.y * kSlice;
  }
};

// Channel c's K * K weights, zeros past C.
template <typename T, int K>
__device__ __forceinline__ void load_weights(float (&wr)[K * K], const T* __restrict__ w,
                                             int c, int chans) {
  const bool in = c < chans;
#pragma unroll
  for (int t = 0; t < K * K; ++t) wr[t] = in ? to_f(w[t * chans + c]) : 0.f;
}

// Forward: out = q * (dwconv(v) + b) if GATED (CRPE), else dwconv(v) + b +
// v(here) (CPE, v being x). A thread owns RY x 4 outputs of one channel
// (RY = 4 for TW = 16, 2 for TW = 8: the 8 thread rows cover the tile) and
// reads RY + K - 1 halo rows of K + 3 values.
template <typename T, int K, int TW, int VEC, bool GATED>
__global__ void __launch_bounds__(kSlice * kRows) dwconv_fwd_tiled_kernel(
    const T* __restrict__ q, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int height, int width,
    int chans, long long q_bs, int q_ps, long long v_bs, int v_ps) {
  constexpr int P = K / 2;
  constexpr int HW = TW + K - 1;
  constexpr int RY = kTileH * TW / (kRX * kRows);
  extern __shared__ float4 smem_f4[];
  T* s_v = reinterpret_cast<T*>(smem_f4);
  const TileOf<TW> tile(height, width);
  const int c = tile.c0 + threadIdx.x;
  stage_halo<T, K, TW, VEC, kRows>(s_v, v + tile.b * v_bs, v_ps, tile.y0, tile.x0,
                                   tile.c0, height, width, chans);
  float wr[K * K];
  load_weights<T, K>(wr, w, c, chans);
  const float bv = c < chans ? to_f(bias[c]) : 0.f;
  copy_async_wait_all();
  __syncthreads();
  if (c >= chans) return;  // no barrier below

  const int oy = (threadIdx.y / (TW / kRX)) * RY;
  const int ox = (threadIdx.y % (TW / kRX)) * kRX;
  float acc[RY][kRX];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int x = 0; x < kRX; ++x) acc[r][x] = 0.f;
  const T* base = s_v + (oy * HW + ox) * kSlice + threadIdx.x;
#pragma unroll
  for (int iy = 0; iy < RY + K - 1; ++iy) {
    float row[kRX + K - 1];
#pragma unroll
    for (int j = 0; j < kRX + K - 1; ++j) row[j] = to_f(base[(iy * HW + j) * kSlice]);
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int ky = iy - r;
      if (ky < 0 || ky >= K) continue;
#pragma unroll
      for (int x = 0; x < kRX; ++x)
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
          acc[r][x] = fmaf(row[x + kx], wr[ky * K + kx], acc[r][x]);
    }
  }
  const T* qb = GATED ? q + tile.b * q_bs : nullptr;
  T* ob = out + static_cast<long long>(tile.b) * height * width * chans;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int y = tile.y0 + oy + r;
#pragma unroll
    for (int x = 0; x < kRX; ++x) {
      const int xx = tile.x0 + ox + x;
      if (y < height && xx < width) {
        const int pix = y * width + xx;
        if constexpr (GATED)
          ob[pix * chans + c] = from_f<T>(to_f(qb[pix * q_ps + c]) * (acc[r][x] + bv));
        else
          ob[pix * chans + c] =
              from_f<T>(acc[r][x] + bv + to_f(base[((r + P) * HW + x + P) * kSlice]));
      }
    }
  }
}

// Backward. With u = g * q (GATED, CRPE) or u = g (CPE): dv = dwconv(u, w
// turned 180 degrees), plus u(here) for CPE (its dx, v being x); for CRPE
// dq = g * (dwconv(v) + b); and the tile's partial dw = sum vpad * u,
// db = sum u. A block has 4 thread rows; a thread owns kRuns blocks of
// R x 4 outputs, one after another: CRPE 8 * TW / 16 strips of 1 x 4 (its
// 49 weights and 50 partials take ~185 registers), CPE one block of
// (8 * TW / 16) x 4. For each it reads R + K - 1 halo rows of v (dq and dw),
// then as many of u (dv).
template <typename T, int K, int TW, bool GATED>
constexpr int bwd_smem() {
  using U = std::conditional_t<GATED, float, T>;
  constexpr int stage =
      halo_pixels<K, TW>() * kSlice * static_cast<int>(sizeof(U) + sizeof(T));
  constexpr int fold = kBwdRows * (K * K + 1) * kSlice * 4;
  return stage > fold ? stage : fold;
}

template <typename T, int K, int TW, int VEC, bool GATED>
__global__ void __launch_bounds__(kSlice * kBwdRows, 2)
    dwconv_bwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ v,
                            const T* __restrict__ g, const T* __restrict__ w,
                            const T* __restrict__ bias, T* __restrict__ dq,
                            T* __restrict__ dv, float* __restrict__ partial, int height,
                            int width, int chans, long long q_bs, int q_ps,
                            long long v_bs, int v_ps) {
  using U = std::conditional_t<GATED, float, T>;
  constexpr int KK = K * K;
  constexpr int P = K / 2;
  constexpr int HW = TW + K - 1;
  constexpr int R = GATED ? 1 : kTileH * TW / (kRX * kBwdRows);  // rows of a block
  constexpr int kRuns = kTileH * TW / (kRX * R * kBwdRows);        // blocks per thread
  extern __shared__ float4 smem_f4[];
  U* s_u = reinterpret_cast<U*>(smem_f4);
  T* s_v = reinterpret_cast<T*>(s_u + halo_pixels<K, TW>() * kSlice);
  const TileOf<TW> tile(height, width);
  const int c = tile.c0 + threadIdx.x;
  const long long img = static_cast<long long>(tile.b) * height * width * chans;
  stage_halo<T, K, TW, VEC, kBwdRows>(s_v, v + tile.b * v_bs, v_ps, tile.y0, tile.x0,
                                      tile.c0, height, width, chans);
  if constexpr (GATED)
    stage_product<T, K, TW, VEC, kBwdRows>(s_u, g + img, q + tile.b * q_bs, q_ps,
                                           tile.y0, tile.x0, tile.c0, height, width,
                                           chans);
  else
    stage_halo<T, K, TW, VEC, kBwdRows>(s_u, g + img, chans, tile.y0, tile.x0, tile.c0,
                                        height, width, chans);
  float wr[KK];
  load_weights<T, K>(wr, w, c, chans);
  float bv = 0.f;
  if constexpr (GATED) bv = c < chans ? to_f(bias[c]) : 0.f;
  copy_async_wait_all();
  __syncthreads();

  // lanes past C hold zeros (staged and weights) and write nothing
  float dw[KK + 1];
#pragma unroll
  for (int t = 0; t <= KK; ++t) dw[t] = 0.f;
#pragma unroll 1
  for (int run = 0; run < kRuns; ++run) {
    const int sub = threadIdx.y + run * kBwdRows;
    const int oy = (sub / (TW / kRX)) * R;
    const int ox = (sub % (TW / kRX)) * kRX;
    float uo[R][kRX], aq[R][kRX], av[R][kRX];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int x = 0; x < kRX; ++x) {
        uo[r][x] = to_f(s_u[((oy + r + P) * HW + ox + P + x) * kSlice + threadIdx.x]);
        aq[r][x] = 0.f;
        av[r][x] = 0.f;
        dw[KK] += uo[r][x];
      }
    const T* vb = s_v + (oy * HW + ox) * kSlice + threadIdx.x;
#pragma unroll
    for (int iy = 0; iy < R + K - 1; ++iy) {
      float row[kRX + K - 1];
#pragma unroll
      for (int j = 0; j < kRX + K - 1; ++j) row[j] = to_f(vb[(iy * HW + j) * kSlice]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ky = iy - r;
        if (ky < 0 || ky >= K) continue;
#pragma unroll
        for (int x = 0; x < kRX; ++x)
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            if constexpr (GATED) aq[r][x] = fmaf(row[x + kx], wr[ky * K + kx], aq[r][x]);
            dw[ky * K + kx] = fmaf(row[x + kx], uo[r][x], dw[ky * K + kx]);
          }
      }
    }
    const U* ub = s_u + (oy * HW + ox) * kSlice + threadIdx.x;
#pragma unroll
    for (int iy = 0; iy < R + K - 1; ++iy) {
      float row[kRX + K - 1];
#pragma unroll
      for (int j = 0; j < kRX + K - 1; ++j) row[j] = to_f(ub[(iy * HW + j) * kSlice]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ky = iy - r;
        if (ky < 0 || ky >= K) continue;
#pragma unroll
        for (int x = 0; x < kRX; ++x)
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
            av[r][x] = fmaf(row[x + kx], wr[KK - 1 - (ky * K + kx)], av[r][x]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = tile.y0 + oy + r;
      if (c >= chans || y >= height) continue;
#pragma unroll
      for (int x = 0; x < kRX; ++x) {
        const int xx = tile.x0 + ox + x;
        if (xx >= width) continue;
        const long long at = img + (y * width + xx) * chans + c;
        if constexpr (GATED) {
          dq[at] = from_f<T>(to_f(g[at]) * (aq[r][x] + bv));
          dv[at] = from_f<T>(av[r][x]);
        } else {
          dv[at] = from_f<T>(av[r][x] + uo[r][x]);
        }
      }
    }
  }

  // fold the thread rows in order, one partial row per tile
  __syncthreads();
  float* s_fold = reinterpret_cast<float*>(smem_f4);  // [kBwdRows][KK + 1][kSlice]
#pragma unroll
  for (int t = 0; t <= KK; ++t)
    s_fold[(threadIdx.y * (KK + 1) + t) * kSlice + threadIdx.x] = dw[t];
  __syncthreads();
  float* dst = partial + static_cast<long long>(blockIdx.x) * (KK + 1) * chans;
  for (int t = threadIdx.y; t <= KK; t += kBwdRows) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r)
      s += s_fold[(r * (KK + 1) + t) * kSlice + threadIdx.x];
    if (c < chans) dst[t * chans + c] = s;
  }
}

// Second pass: total[j] = sum over tiles of partial[tile][j] in a fixed
// order. Up to kReduceOneRowTiles tiles a thread adds its column's tiles in
// tile order (SPLIT false). Beyond, a block of 32 columns splits the tiles
// between its warp rows: row r adds the `per` tiles from r * per on, in tile
// order, and the block adds its rows' sums in row order in shared memory.
// The split depends on the tile count alone, so two calls give the same
// bits.
constexpr int kReduceThreads = 256;      // of a block without split
constexpr int kReduceOneRowTiles = 32;   // most tiles without split
constexpr int kReduceWarps = 32;         // most warp rows of a split block
constexpr int kReduceTilesPerWarp = 16;  // tiles a warp row adds, at least

template <bool SPLIT>
__global__ void __launch_bounds__(SPLIT ? kSlice * kReduceWarps : kReduceThreads)
    dwconv_weight_reduce_kernel(const float* __restrict__ partial,
                                float* __restrict__ total, int tiles, int n, int per) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (!SPLIT) {
    if (j >= n) return;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += partial[static_cast<long long>(t) * n + j];
    total[j] = s;
  } else {
    __shared__ float s_sum[kReduceWarps][kSlice];
    const int t0 = threadIdx.y * per;
    const int t1 = min(t0 + per, tiles);
    float s = 0.f;
    if (j < n) {
#pragma unroll 4
      for (int t = t0; t < t1; ++t) s += partial[static_cast<long long>(t) * n + j];
    }
    s_sum[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && j < n) {
      float sum = 0.f;
      for (int r = 0; r < static_cast<int>(blockDim.y); ++r) sum += s_sum[r][threadIdx.x];
      total[j] = sum;
    }
  }
}

int launch_reduce(const float* partial, float* total, int tiles, int n,
                  cudaStream_t stream) {
  if (tiles <= kReduceOneRowTiles) {
    dwconv_weight_reduce_kernel<false>
        <<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, stream>>>(
            partial, total, tiles, n, tiles);
  } else {
    const int warps = std::min(kReduceWarps,
                               (tiles + kReduceTilesPerWarp - 1) / kReduceTilesPerWarp);
    const int per = (tiles + warps - 1) / warps;
    dwconv_weight_reduce_kernel<true><<<(n + kSlice - 1) / kSlice, dim3(kSlice, warps), 0,
                                        stream>>>(partial, total, tiles, n, per);
  }
  return static_cast<int>(cudaGetLastError());
}

// Call f(tile width, copy bytes) with both as compile-time constants; VEC of
// fp32 is 4, 8 or 16 bytes, of bf16 also 2.
template <typename T, typename F>
int dispatch(int width, int vec, F&& f) {
  using std::integral_constant;
  auto with_vec = [&](auto tw) -> int {
    switch (vec) {
      case 16: return f(tw, integral_constant<int, 16>{});
      case 8: return f(tw, integral_constant<int, 8>{});
      case 4: return f(tw, integral_constant<int, 4>{});
      case 2:
        if constexpr (sizeof(T) == 2) return f(tw, integral_constant<int, 2>{});
        return kUnsupported;
      default: return kUnsupported;
    }
  };
  return tile_w(width) == 16 ? with_vec(integral_constant<int, 16>{})
                             : with_vec(integral_constant<int, 8>{});
}

dim3 tile_grid(int batch, int height, int width, int chans) {
  const int tw = tile_w(width);
  return dim3(batch * ((height + kTileH - 1) / kTileH) * ((width + tw - 1) / tw),
              (chans + kSlice - 1) / kSlice);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int K, bool GATED>
int conv_fwd(const void* q, const void* v, const void* w, const void* b, void* out,
             int batch, int height, int width, int chans, long long q_bs, int q_ps,
             long long v_bs, int v_ps, int vec, cudaStream_t s) {
  return dispatch<T>(width, vec, [&](auto tw, auto vb) -> int {
    constexpr int TW = decltype(tw)::value, VEC = decltype(vb)::value;
    constexpr int smem = halo_pixels<K, TW>() * kSlice * static_cast<int>(sizeof(T));
    auto kernel = dwconv_fwd_tiled_kernel<T, K, TW, VEC, GATED>;
    int err = set_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<tile_grid(batch, height, width, chans), dim3(kSlice, kRows), smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(out), height, width, chans, q_bs,
        q_ps, v_bs, v_ps);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T, int K, bool GATED>
int conv_bwd(const void* q, const void* v, const void* w, const void* b, const void* g,
             void* dq, void* dv, float* partial, float* total, int tiles, int batch,
             int height, int width, int chans, long long q_bs, int q_ps, long long v_bs,
             int v_ps, int vec, cudaStream_t s) {
  const dim3 grid = tile_grid(batch, height, width, chans);
  if (tiles != static_cast<int>(grid.x)) return kUnsupported;
  const int err = dispatch<T>(width, vec, [&](auto tw, auto vb) -> int {
    constexpr int TW = decltype(tw)::value, VEC = decltype(vb)::value;
    constexpr int smem = bwd_smem<T, K, TW, GATED>();
    auto kernel = dwconv_bwd_tiled_kernel<T, K, TW, VEC, GATED>;
    int e = set_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, dim3(kSlice, kBwdRows), smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(dq),
        static_cast<T*>(dv), partial, height, width, chans, q_bs, q_ps, v_bs, v_ps);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  return launch_reduce(partial, total, tiles, (K * K + 1) * chans, s);
}

}  // namespace
}  // namespace mdvit

// Every view below is (B, H, W, C) with unit channel stride, its own pixel
// stride (row stride W * pixel stride) and batch stride, in elements, with
// H * W * max(pixel stride, C) below 2^31; every output and g are contiguous
// (B, H, W, C). vec: bytes per halo copy (16, 8, 4, or 2 for bf16), dividing
// every pointer, every stride and C's bytes. Each returns cudaGetLastError()
// after its launches, or -1 for an unsupported dtype or vec.

// cpe: x (pixel stride x_ps, batch stride x_bs); w: (3, 3, C) contiguous;
// b: (C,).
extern "C" int mdvit_cpe_conv_fwd(int dtype, const void* x, const void* w,
                                  const void* b, void* out, int batch, int height,
                                  int width, int chans, long long x_bs, int x_ps,
                                  int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::conv_fwd<float, 3, false>(nullptr, x, w, b, out, batch, height, width,
                                            chans, 0, 0, x_bs, x_ps, vec, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::conv_fwd<__nv_bfloat16, 3, false>(nullptr, x, w, b, out, batch, height,
                                                    width, chans, 0, 0, x_bs, x_ps, vec,
                                                    s);
  return mdvit::kUnsupported;
}

// crpe: q, v with their own strides; w: (7, 7, C) contiguous; b: (C,).
extern "C" int mdvit_crpe_conv_fwd(int dtype, const void* q, const void* v,
                                   const void* w, const void* b, void* out,
                                   int batch, int height, int width, int chans,
                                   long long q_bs, int q_ps, long long v_bs,
                                   int v_ps, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::conv_fwd<float, 7, true>(q, v, w, b, out, batch, height, width, chans,
                                           q_bs, q_ps, v_bs, v_ps, vec, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::conv_fwd<__nv_bfloat16, 7, true>(q, v, w, b, out, batch, height, width,
                                                   chans, q_bs, q_ps, v_bs, v_ps, vec, s);
  return mdvit::kUnsupported;
}

// The backwards: two launches each, the fused tile kernel and the reduce.
// partial: fp32 scratch of tiles * (K * K + 1) * C, tiles = B * ceil(H / 8)
// * ceil(W / TW) (dwconv_weight_tiles in ops/kernels.py); total: fp32
// (K * K + 1, C), rows 0..K*K-1 dw (K, K, C), row K*K db.

// cpe: x, w as in the forward; g, dx.
extern "C" int mdvit_cpe_conv_bwd(int dtype, const void* x, const void* w,
                                  const void* g, void* dx, void* partial,
                                  void* total, int tiles, int batch, int height,
                                  int width, int chans, long long x_bs, int x_ps,
                                  int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* tp = static_cast<float*>(total);
  if (dtype == mdvit::kFloat32)
    return mdvit::conv_bwd<float, 3, false>(nullptr, x, w, nullptr, g, nullptr, dx, pp,
                                            tp, tiles, batch, height, width, chans, 0, 0,
                                            x_bs, x_ps, vec, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::conv_bwd<__nv_bfloat16, 3, false>(nullptr, x, w, nullptr, g, nullptr,
                                                    dx, pp, tp, tiles, batch, height,
                                                    width, chans, 0, 0, x_bs, x_ps, vec,
                                                    s);
  return mdvit::kUnsupported;
}

// crpe: q, v, w, b as in the forward; g, dq, dv.
extern "C" int mdvit_crpe_conv_bwd(int dtype, const void* q, const void* v,
                                   const void* w, const void* b, const void* g,
                                   void* dq, void* dv, void* partial, void* total,
                                   int tiles, int batch, int height, int width,
                                   int chans, long long q_bs, int q_ps,
                                   long long v_bs, int v_ps, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* tp = static_cast<float*>(total);
  if (dtype == mdvit::kFloat32)
    return mdvit::conv_bwd<float, 7, true>(q, v, w, b, g, dq, dv, pp, tp, tiles, batch,
                                           height, width, chans, q_bs, q_ps, v_bs, v_ps,
                                           vec, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::conv_bwd<__nv_bfloat16, 7, true>(q, v, w, b, g, dq, dv, pp, tp, tiles,
                                                   batch, height, width, chans, q_bs,
                                                   q_ps, v_bs, v_ps, vec, s);
  return mdvit::kUnsupported;
}
