// Depthwise-conv kernels of the MHSA stages, channel-last (B, H, W, C),
// stride 1, zero SAME padding, fp32 accumulation:
//
//   cpe:   y = dwconv3x3(x) + b + x          (ConvPosEnc with its residual)
//   crpe:  y = q * (dwconv7x7(v) + b)        (ConvRelPosEnc with its gate)
//
// and their backwards. Replace the Pallas TPU kernels of
// mdvit_tpu/ops/pallas_dwconv.py: _cpe_fwd_kernel (launched by _cpe_fwd),
// _cpe_bwd_kernel (by _cpe_vjp_bwd), _crpe_fwd_kernel (by _crpe_fwd_call)
// and _crpe_bwd_kernel (by _crpe_vjp_bwd). Those copy a whole zero-padded
// image into VMEM. The fused residual and gate keep dwconv(x) out of device
// memory here as there. dw and db are sums over B*H*W: the Pallas kernel
// carries them across its sequential batch grid; blocks here run in no
// order, so they take two passes and no float atomics: per-tile partial sums
// into a scratch buffer, then a kernel that adds the tiles in tile order.
// Two calls give the same bits.
//
// CPE (3x3): one thread per output element (pixel, channel), neighbouring
// threads on neighbouring channels, so each tap's load is coalesced and the
// 9 re-reads of a pixel's neighbours hit L1/L2.
//
// CRPE (7x7), tiled. Its bound on this card is bytes (3 to 5 images moved;
// 49 multiply-adds an output, 147 in the backward, stay under the fp32 FMA
// rate), but a thread per output, as for CPE, was bound by instructions: 49
// loads from L1 and 64-bit index math per output, 3% of the FMA rate and
// 7% of the bytes bound. Here a block takes one image, an 8 x TW output tile
// and a slice of 32 channels, one per lane: it stages the (8+6) x (TW+6) x
// 32 halo of v in shared memory once, with asynchronous copies of the widest
// size that the pointers, strides and C allow (zeros outside the image and
// past C). Each thread keeps its channel's 49 weights in registers and owns
// a block of outputs; it reads each halo row of that block once and applies
// it to every output row and tap that use it, so a shared-memory read feeds
// up to 7 x 4 multiply-adds. Index math is 32-bit inside an image and
// resolved at compile time in the tap loops. The backward fuses what took
// four launches into one pass over the same tiles: it stages v and u = g * q
// (formed in fp32 as it loads, a few loads in flight per thread), and each
// thread computes dq = g * (conv(v) + b), dv = conv(u, w turned 180
// degrees) and its 49 dw and 1 db partial sums; the block folds its thread
// rows in a fixed order in shared memory and writes one partial row per tile
// for the reduce. The 49 weights and 50 partial sums per thread take ~185
// registers, so a C' block has 4 thread rows (128 threads): two blocks share
// an SM and one's staging overlaps the other's arithmetic. The 3x3 and 5x5
// head groups reach the kernel zero-embedded in the 7x7 window; their zero
// taps are computed, not assumed.
#include <type_traits>

#include "common.cuh"

namespace mdvit {
namespace {

constexpr int kThreads = 256;

// A strided (B, H, W, C) view with unit channel stride: batch and pixel
// strides in elements (row stride W * ps).
template <typename T>
struct Grid {
  const T* p;
  long long bs;
  long long ps;
  __device__ __forceinline__ float at(int b, long long pix, int c) const {
    return to_f(p[b * bs + pix * ps + c]);
  }
};

// out = sum_taps x(neighbour) * w[tap] [+ bias] [+ x(here)]; FLIP turns the
// kernel by 180 degrees; bias may be null.
template <typename T, int K, bool RESID, bool FLIP>
__global__ void __launch_bounds__(kThreads) dwconv_fwd_kernel(
    Grid<T> x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ out, int batch, int height, int width, int chans) {
  constexpr int P = K / 2;
  const long long total = static_cast<long long>(batch) * height * width * chans;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int c = static_cast<int>(idx % chans);
    long long pix = idx / chans;
    const int px = static_cast<int>(pix % width);
    pix /= width;
    const int py = static_cast<int>(pix % height);
    const int b = static_cast<int>(pix / height);
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int yy = py + ky - P;
      if (yy < 0 || yy >= height) continue;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int xx = px + kx - P;
        if (xx < 0 || xx >= width) continue;
        const long long nb = static_cast<long long>(yy) * width + xx;
        const int tap = FLIP ? (K * K - 1 - (ky * K + kx)) : (ky * K + kx);
        acc += x.at(b, nb, c) * to_f(w[tap * chans + c]);
      }
    }
    if (bias != nullptr) acc += to_f(bias[c]);
    if (RESID) acc += x.at(b, static_cast<long long>(py) * width + px, c);
    out[idx] = from_f<T>(acc);
  }
}

// First pass of CPE's dw/db: block (32 channels x 8 pixel lanes) sums, over
// one tile of kWeightTilePixels flat pixels, in(neighbour(p, tap)) * g(p)
// for every tap and g(p) for the bias. Partial sums go to
// partial[tile][tap][c], tap K*K being the bias.
constexpr int kWeightTilePixels = 256;  // WEIGHT_TILE_PIXELS in ops/kernels.py
constexpr int kLanes = 8;

template <typename T, int K>
__global__ void __launch_bounds__(32 * kLanes) dwconv_weight_partial_kernel(
    Grid<T> in, Grid<T> g, float* __restrict__ partial, int batch, int height,
    int width, int chans) {
  constexpr int P = K / 2;
  constexpr int kTaps = K * K + 1;
  __shared__ float s_sum[kLanes][32];
  const int c = blockIdx.y * 32 + threadIdx.x;
  const int lane = threadIdx.y;
  const long long pixels = static_cast<long long>(batch) * height * width;
  const long long p0 = static_cast<long long>(blockIdx.x) * kWeightTilePixels;
  float acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t] = 0.f;
  if (c < chans) {
    for (int i = lane; i < kWeightTilePixels; i += kLanes) {
      const long long p = p0 + i;
      if (p >= pixels) break;
      const int px = static_cast<int>(p % width);
      const int py = static_cast<int>((p / width) % height);
      const int b = static_cast<int>(p / (static_cast<long long>(width) * height));
      const long long here = static_cast<long long>(py) * width + px;
      const float u = g.at(b, here, c);
      acc[K * K] += u;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const int yy = py + ky - P;
        if (yy < 0 || yy >= height) continue;
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const int xx = px + kx - P;
          if (xx < 0 || xx >= width) continue;
          acc[ky * K + kx] += in.at(b, static_cast<long long>(yy) * width + xx, c) * u;
        }
      }
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * kTaps * chans;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    s_sum[lane][threadIdx.x] = acc[t];
    __syncthreads();
    if (lane == 0 && c < chans) {
      float s = 0.f;
      for (int l = 0; l < kLanes; ++l) s += s_sum[l][threadIdx.x];
      out[t * chans + c] = s;
    }
    __syncthreads();
  }
}

// Second pass: total[j] = sum over tiles, in tile order, of partial[tile][j].
__global__ void __launch_bounds__(kThreads) dwconv_weight_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ total, int tiles,
    int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += partial[static_cast<long long>(t) * n + j];
  total[j] = s;
}

int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < (1LL << 30) ? blocks : (1LL << 30));
}

int launch_reduce(const float* partial, float* total, int tiles, int n,
                  cudaStream_t stream) {
  dwconv_weight_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, total, tiles, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool RESID, bool FLIP>
int launch_conv(Grid<T> x, const void* w, const void* b, void* out, int batch,
                int height, int width, int chans, cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * height * width * chans;
  dwconv_fwd_kernel<T, K, RESID, FLIP><<<grid_for(total), kThreads, 0, stream>>>(
      x, static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out),
      batch, height, width, chans);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cpe_fwd(const void* x, const void* w, const void* b, void* out, int batch,
            int height, int width, int chans, long long x_bs, long long x_ps,
            cudaStream_t s) {
  const Grid<T> xg{static_cast<const T*>(x), x_bs, x_ps};
  return launch_conv<T, 3, true, false>(xg, w, b, out, batch, height, width, chans, s);
}

template <typename T>
int cpe_bwd(const void* x, const void* w, const void* g, void* dx,
            float* partial, float* total, int tiles, int batch, int height,
            int width, int chans, long long x_bs, long long x_ps,
            cudaStream_t s) {
  const long long img = static_cast<long long>(height) * width * chans;
  const Grid<T> xg{static_cast<const T*>(x), x_bs, x_ps};
  const Grid<T> gg{static_cast<const T*>(g), img, chans};
  // dx = dwconv(g, flipped w) + g
  int err = launch_conv<T, 3, true, true>(gg, w, nullptr, dx, batch, height, width,
                                          chans, s);
  if (err != 0) return err;
  const long long pixels = static_cast<long long>(batch) * height * width;
  if (tiles != (pixels + kWeightTilePixels - 1) / kWeightTilePixels)
    return kUnsupported;
  dwconv_weight_partial_kernel<T, 3><<<dim3(tiles, (chans + 31) / 32), dim3(32, kLanes),
                                       0, s>>>(xg, gg, partial, batch, height, width,
                                               chans);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(partial, total, tiles, 10 * chans, s);
}

// ------------------------------------------------------------ CRPE, tiled

constexpr int kK = 7;                   // CRPE window
constexpr int kTaps = kK * kK;          // 49; partial rows carry kTaps + 1
constexpr int kSlice = 32;              // channels of a block, one per lane
constexpr int kRows = 8;                // thread rows of a C block (blockDim.y)
constexpr int kBwdRows = 4;             // of a C' block: 2 blocks fit an SM

constexpr int kTileH = 8;               // CRPE_TILE_H in ops/kernels.py
constexpr int kRX = 4;                  // outputs of a thread along W

// Tile width: 16, or 8 for images at most 8 wide (as crpe_weight_tiles in
// ops/kernels.py counts them); the tile is kTileH x TW output pixels.
int crpe_tile_w(int width) { return width > 8 ? 16 : 8; }

template <int TW>
__host__ __device__ constexpr int halo_pixels() { return (kTileH + kK - 1) * (TW + kK - 1); }

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
template <typename T, int TW, int VEC>
struct HaloCopy {
  static constexpr int kPer = VEC / sizeof(T);
  static constexpr int kCopies = kSlice / kPer;  // copies per pixel
  static constexpr int kCount = halo_pixels<TW>() * kCopies;
  int pix, cc, at;
  bool valid;
  __device__ __forceinline__ HaloCopy(int i, int y0, int x0, int c0, int height,
                                      int width, int chans) {
    pix = i / kCopies;
    cc = (i % kCopies) * kPer;
    const int y = y0 + pix / (TW + kK - 1) - kK / 2;
    const int x = x0 + pix % (TW + kK - 1) - kK / 2;
    valid = y >= 0 && y < height && x >= 0 && x < width && c0 + cc < chans;
    at = valid ? y * width + x : 0;
  }
};

// Stage the halo of img (one image, pixel stride ps) into s[pix][32] as T
// with asynchronous copies; the caller waits.
template <typename T, int TW, int VEC, int ROWS>
__device__ __forceinline__ void stage_halo(T* s, const T* img, int ps, int y0, int x0,
                                           int c0, int height, int width, int chans) {
  using H = HaloCopy<T, TW, VEC>;
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
template <typename T, int TW, int VEC, int ROWS>
__device__ __forceinline__ void stage_product(float* __restrict__ s, const T* __restrict__ g,
                                              const T* __restrict__ q, int q_ps, int y0,
                                              int x0, int c0, int height, int width,
                                              int chans) {
  using H = HaloCopy<T, TW, VEC>;
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

template <typename T>
__device__ __forceinline__ void load_weights(float (&wr)[kTaps], float& bv,
                                             const T* __restrict__ w,
                                             const T* __restrict__ bias, int c,
                                             int chans) {
  const bool in = c < chans;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) wr[t] = in ? to_f(w[t * chans + c]) : 0.f;
  bv = in ? to_f(bias[c]) : 0.f;
}

// C: out = q * (dwconv7x7(v) + b). A thread owns RY x 4 outputs of one
// channel (RY = 4 for TW = 16, 2 for TW = 8: the 8 thread rows cover the
// tile) and reads RY + 6 halo rows of 10 values.
template <typename T, int TW, int VEC>
__global__ void __launch_bounds__(kSlice * kRows) crpe_fwd_tiled_kernel(
    const T* __restrict__ q, const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int height, int width,
    int chans, long long q_bs, int q_ps, long long v_bs, int v_ps) {
  constexpr int HW = TW + kK - 1;
  constexpr int RY = kTileH * TW / (kRX * kRows);
  extern __shared__ float4 smem_f4[];
  T* s_v = reinterpret_cast<T*>(smem_f4);
  const TileOf<TW> tile(height, width);
  const int c = tile.c0 + threadIdx.x;
  stage_halo<T, TW, VEC, kRows>(s_v, v + tile.b * v_bs, v_ps, tile.y0, tile.x0,
                                tile.c0, height, width, chans);
  float wr[kTaps], bv;
  load_weights(wr, bv, w, bias, c, chans);
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
  for (int iy = 0; iy < RY + kK - 1; ++iy) {
    float row[kRX + kK - 1];
#pragma unroll
    for (int j = 0; j < kRX + kK - 1; ++j) row[j] = to_f(base[(iy * HW + j) * kSlice]);
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int ky = iy - r;
      if (ky < 0 || ky >= kK) continue;
#pragma unroll
      for (int x = 0; x < kRX; ++x)
#pragma unroll
        for (int kx = 0; kx < kK; ++kx)
          acc[r][x] = fmaf(row[x + kx], wr[ky * kK + kx], acc[r][x]);
    }
  }
  const T* qb = q + tile.b * q_bs;
  T* ob = out + static_cast<long long>(tile.b) * height * width * chans;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int y = tile.y0 + oy + r;
#pragma unroll
    for (int x = 0; x < kRX; ++x) {
      const int xx = tile.x0 + ox + x;
      if (y < height && xx < width) {
        const int pix = y * width + xx;
        ob[pix * chans + c] = from_f<T>(to_f(qb[pix * q_ps + c]) * (acc[r][x] + bv));
      }
    }
  }
}

// C': with u = g * q, dq = g * (dwconv(v) + b), dv = dwconv(u, flipped w),
// and the tile's partial dw = sum vpad * u, db = sum u. A thread owns
// 8 * TW / (4 * kBwdRows) runs of 4 outputs along W, one after another; for
// each it reads 7 halo rows of v (dq and dw) and then 7 of u (dv).
template <typename T, int TW>
constexpr int crpe_bwd_smem() {
  constexpr int stage = halo_pixels<TW>() * kSlice * (4 + static_cast<int>(sizeof(T)));
  constexpr int fold = kBwdRows * (kTaps + 1) * kSlice * 4;
  return stage > fold ? stage : fold;
}

template <typename T, int TW, int VEC>
__global__ void __launch_bounds__(kSlice * kBwdRows, 2) crpe_bwd_tiled_kernel(
    const T* __restrict__ q, const T* __restrict__ v, const T* __restrict__ g,
    const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ dq,
    T* __restrict__ dv, float* __restrict__ partial, int height, int width,
    int chans, long long q_bs, int q_ps, long long v_bs, int v_ps) {
  constexpr int HW = TW + kK - 1;
  constexpr int kRuns = kTileH * TW / (kRX * kBwdRows);  // runs of 4 per thread
  extern __shared__ float4 smem_f4[];
  float* s_u = reinterpret_cast<float*>(smem_f4);
  T* s_v = reinterpret_cast<T*>(s_u + halo_pixels<TW>() * kSlice);
  const TileOf<TW> tile(height, width);
  const int c = tile.c0 + threadIdx.x;
  const long long img = static_cast<long long>(tile.b) * height * width * chans;
  stage_halo<T, TW, VEC, kBwdRows>(s_v, v + tile.b * v_bs, v_ps, tile.y0, tile.x0,
                                   tile.c0, height, width, chans);
  stage_product<T, TW, VEC, kBwdRows>(s_u, g + img, q + tile.b * q_bs, q_ps, tile.y0,
                                      tile.x0, tile.c0, height, width, chans);
  float wr[kTaps], bv;
  load_weights(wr, bv, w, bias, c, chans);
  copy_async_wait_all();
  __syncthreads();

  // lanes past C hold zeros (staged and weights) and write nothing
  float dw[kTaps + 1];
#pragma unroll
  for (int t = 0; t <= kTaps; ++t) dw[t] = 0.f;
  const T* gb = g + img;
  T* dqb = dq + img;
  T* dvb = dv + img;
#pragma unroll 1
  for (int run = 0; run < kRuns; ++run) {
    const int sub = threadIdx.y + run * kBwdRows;
    const int oy = sub / (TW / kRX);
    const int ox = (sub % (TW / kRX)) * kRX;
    float uo[kRX], aq[kRX], av[kRX];
#pragma unroll
    for (int x = 0; x < kRX; ++x) {
      uo[x] = s_u[((oy + kK / 2) * HW + ox + kK / 2 + x) * kSlice + threadIdx.x];
      aq[x] = 0.f;
      av[x] = 0.f;
      dw[kTaps] += uo[x];
    }
    const T* vb = s_v + (oy * HW + ox) * kSlice + threadIdx.x;
#pragma unroll
    for (int ky = 0; ky < kK; ++ky) {
      float row[kRX + kK - 1];
#pragma unroll
      for (int j = 0; j < kRX + kK - 1; ++j) row[j] = to_f(vb[(ky * HW + j) * kSlice]);
#pragma unroll
      for (int x = 0; x < kRX; ++x)
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          aq[x] = fmaf(row[x + kx], wr[ky * kK + kx], aq[x]);
          dw[ky * kK + kx] = fmaf(row[x + kx], uo[x], dw[ky * kK + kx]);
        }
    }
    const float* ub = s_u + (oy * HW + ox) * kSlice + threadIdx.x;
#pragma unroll
    for (int ky = 0; ky < kK; ++ky) {
      float row[kRX + kK - 1];
#pragma unroll
      for (int j = 0; j < kRX + kK - 1; ++j) row[j] = ub[(ky * HW + j) * kSlice];
#pragma unroll
      for (int x = 0; x < kRX; ++x)
#pragma unroll
        for (int kx = 0; kx < kK; ++kx)
          av[x] = fmaf(row[x + kx], wr[kTaps - 1 - (ky * kK + kx)], av[x]);
    }
    const int y = tile.y0 + oy;
    if (c < chans && y < height) {
#pragma unroll
      for (int x = 0; x < kRX; ++x) {
        const int xx = tile.x0 + ox + x;
        if (xx < width) {
          const int at = (y * width + xx) * chans + c;
          dqb[at] = from_f<T>(to_f(gb[at]) * (aq[x] + bv));
          dvb[at] = from_f<T>(av[x]);
        }
      }
    }
  }

  // fold the 8 thread rows in order, one partial row per tile
  __syncthreads();
  float* s_fold = s_u;  // [kBwdRows][kTaps + 1][kSlice]
#pragma unroll
  for (int t = 0; t <= kTaps; ++t)
    s_fold[(threadIdx.y * (kTaps + 1) + t) * kSlice + threadIdx.x] = dw[t];
  __syncthreads();
  float* dst = partial + static_cast<long long>(blockIdx.x) * (kTaps + 1) * chans;
  for (int t = threadIdx.y; t <= kTaps; t += kBwdRows) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r)
      s += s_fold[(r * (kTaps + 1) + t) * kSlice + threadIdx.x];
    if (c < chans) dst[t * chans + c] = s;
  }
}

// Call f(tile width, copy bytes) with both as compile-time constants; VEC of
// fp32 is 4, 8 or 16 bytes, of bf16 also 2.
template <typename T, typename F>
int dispatch_crpe(int width, int vec, F&& f) {
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
  return crpe_tile_w(width) == 16 ? with_vec(integral_constant<int, 16>{})
                                  : with_vec(integral_constant<int, 8>{});
}

dim3 crpe_grid(int batch, int height, int width, int chans) {
  const int tw = crpe_tile_w(width);
  return dim3(batch * ((height + kTileH - 1) / kTileH) * ((width + tw - 1) / tw),
              (chans + kSlice - 1) / kSlice);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int crpe_fwd(const void* q, const void* v, const void* w, const void* b,
             void* out, int batch, int height, int width, int chans,
             long long q_bs, int q_ps, long long v_bs, int v_ps, int vec,
             cudaStream_t s) {
  return dispatch_crpe<T>(width, vec, [&](auto tw, auto vb) -> int {
    constexpr int TW = decltype(tw)::value, VEC = decltype(vb)::value;
    constexpr int smem = halo_pixels<TW>() * kSlice * static_cast<int>(sizeof(T));
    auto kernel = crpe_fwd_tiled_kernel<T, TW, VEC>;
    int err = set_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<crpe_grid(batch, height, width, chans), dim3(kSlice, kRows), smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(out), height, width, chans, q_bs,
        q_ps, v_bs, v_ps);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int crpe_bwd(const void* q, const void* v, const void* w, const void* b,
             const void* g, void* dq, void* dv, float* partial, float* total,
             int tiles, int batch, int height, int width, int chans,
             long long q_bs, int q_ps, long long v_bs, int v_ps, int vec,
             cudaStream_t s) {
  const dim3 grid = crpe_grid(batch, height, width, chans);
  if (tiles != static_cast<int>(grid.x)) return kUnsupported;
  const int err = dispatch_crpe<T>(width, vec, [&](auto tw, auto vb) -> int {
    constexpr int TW = decltype(tw)::value, VEC = decltype(vb)::value;
    constexpr int smem = crpe_bwd_smem<T, TW>();
    auto kernel = crpe_bwd_tiled_kernel<T, TW, VEC>;
    int e = set_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, dim3(kSlice, kBwdRows), smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(dq),
        static_cast<T*>(dv), partial, height, width, chans, q_bs, q_ps, v_bs, v_ps);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  return launch_reduce(partial, total, tiles, (kTaps + 1) * chans, s);
}

}  // namespace
}  // namespace mdvit

// x: (B, H, W, C) view with unit channel stride, pixel stride x_ps and batch
// stride x_bs (elements; row stride W * x_ps); w: (3, 3, C) contiguous;
// b: (C,); out: contiguous (B, H, W, C). Returns cudaGetLastError() after
// the launch, or -1 for an unsupported dtype.
extern "C" int mdvit_cpe_conv_fwd(int dtype, const void* x, const void* w,
                                  const void* b, void* out, int batch, int height,
                                  int width, int chans, long long x_bs,
                                  long long x_ps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::cpe_fwd<float>(x, w, b, out, batch, height, width, chans, x_bs,
                                 x_ps, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::cpe_fwd<__nv_bfloat16>(x, w, b, out, batch, height, width, chans,
                                         x_bs, x_ps, s);
  return mdvit::kUnsupported;
}

// q, v: (B, H, W, C) views as x above, each with its own strides (pixel
// strides and H * W * stride below 2^31); w: (7, 7, C) contiguous; b: (C,);
// out: contiguous (B, H, W, C). vec: bytes per halo copy (16, 8, 4, or 2 for
// bf16), dividing every pointer, both strides and C's bytes.
extern "C" int mdvit_crpe_conv_fwd(int dtype, const void* q, const void* v,
                                   const void* w, const void* b, void* out,
                                   int batch, int height, int width, int chans,
                                   long long q_bs, int q_ps, long long v_bs,
                                   int v_ps, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::crpe_fwd<float>(q, v, w, b, out, batch, height, width, chans,
                                  q_bs, q_ps, v_bs, v_ps, vec, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::crpe_fwd<__nv_bfloat16>(q, v, w, b, out, batch, height, width,
                                          chans, q_bs, q_ps, v_bs, v_ps, vec, s);
  return mdvit::kUnsupported;
}

// Backward of cpe. x as in the forward; g, dx: contiguous (B, H, W, C);
// partial: fp32 scratch of tiles * 10 * C, tiles = ceil(B*H*W / 256);
// total: fp32 (10, C), rows 0..8 dw (3, 3, C), row 9 db.
extern "C" int mdvit_cpe_conv_bwd(int dtype, const void* x, const void* w,
                                  const void* g, void* dx, void* partial,
                                  void* total, int tiles, int batch, int height,
                                  int width, int chans, long long x_bs,
                                  long long x_ps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* tp = static_cast<float*>(total);
  if (dtype == mdvit::kFloat32)
    return mdvit::cpe_bwd<float>(x, w, g, dx, pp, tp, tiles, batch, height, width,
                                 chans, x_bs, x_ps, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::cpe_bwd<__nv_bfloat16>(x, w, g, dx, pp, tp, tiles, batch, height,
                                         width, chans, x_bs, x_ps, s);
  return mdvit::kUnsupported;
}

// Backward of crpe: two launches, the fused tile kernel and the reduce.
// q, v, vec as in the forward; g, dq, dv: contiguous (B, H, W, C); partial:
// fp32 scratch of tiles * 50 * C, tiles = B * ceil(H / 8) * ceil(W / TW)
// (crpe_weight_tiles in ops/kernels.py); total: fp32 (50, C), rows 0..48 dw
// (7, 7, C), row 49 db.
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
    return mdvit::crpe_bwd<float>(q, v, w, b, g, dq, dv, pp, tp, tiles, batch,
                                  height, width, chans, q_bs, q_ps, v_bs, v_ps, vec, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::crpe_bwd<__nv_bfloat16>(q, v, w, b, g, dq, dv, pp, tp, tiles,
                                          batch, height, width, chans, q_bs, q_ps,
                                          v_bs, v_ps, vec, s);
  return mdvit::kUnsupported;
}
