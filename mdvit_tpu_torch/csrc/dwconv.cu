// Depthwise-conv kernels of the MHSA stages, channel-last (B, H, W, C),
// stride 1, zero SAME padding, fp32 accumulation:
//
//   cpe:   y = dwconv3x3(x) + b + x          (ConvPosEnc with its residual)
//   crpe:  y = q * (dwconv7x7(v) + b)        (ConvRelPosEnc with its gate)
//
// and their backwards. Replace the Pallas TPU kernels of
// mdvit_tpu/ops/pallas_dwconv.py: _cpe_fwd_kernel (launched by _cpe_fwd),
// _crpe_fwd_kernel (by _crpe_fwd_call), _cpe_bwd_kernel (by _cpe_vjp_bwd) and
// _crpe_bwd_kernel (by _crpe_vjp_bwd). Those copy a whole zero-padded image
// into VMEM; here each thread computes one output element (pixel, channel),
// neighbouring threads on neighbouring channels, so every tap's load is
// coalesced in the channel-last layout and the K*K re-reads of a pixel's
// neighbours hit L1/L2, not device memory.
//
// Bound on this card: memory. Each output takes K*K multiply-adds (9 or 49)
// for 2 to 6 elements moved, far below the H100's ~295 flops per byte. The
// fused residual and gate keep dwconv(x) out of device memory, as the Pallas
// kernels do. The CRPE window is one 7x7 kernel whose 3x3 and 5x5 head
// groups are zero-embedded; the zero taps are not skipped yet. q and v are
// taken as strided views of the (B, N, 3C) qkv projection, so no copy is made.
//
// The backward's image-shaped gradients are the same dwconv with the kernel
// turned by 180 degrees (dx of cpe with the +g of its residual; dq of crpe
// is crpe itself with g as the gate; dv of crpe convolves u = g * q, formed
// on the fly). dw and db are sums over B*H*W. The Pallas kernel carries them
// across its sequential batch grid; blocks here run in no order, so they take
// two passes and no float atomics: per-tile partial sums into a scratch
// buffer, then a second kernel that adds the tiles in a fixed order. The
// result is the same bits on every call.
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

// out = [gate *] (sum_taps in(neighbour) * w[tap] [+ bias]) [+ x(here)], where
// in = x, or x * x2 when PROD; FLIP turns the kernel by 180 degrees; bias may
// be null.
template <typename T, int K, bool GATE, bool RESID, bool FLIP, bool PROD>
__global__ void __launch_bounds__(kThreads) dwconv_fwd_kernel(
    Grid<T> x, Grid<T> x2, Grid<T> gate, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int batch, int height,
    int width, int chans) {
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
        float in = x.at(b, nb, c);
        if (PROD) in *= x2.at(b, nb, c);
        const int tap = FLIP ? (K * K - 1 - (ky * K + kx)) : (ky * K + kx);
        acc += in * to_f(w[tap * chans + c]);
      }
    }
    if (bias != nullptr) acc += to_f(bias[c]);
    const long long here = static_cast<long long>(py) * width + px;
    if (RESID) acc += x.at(b, here, c);
    if (GATE) acc = gate.at(b, here, c) * acc;
    out[idx] = from_f<T>(acc);
  }
}

// First pass of dw/db: block (32 channels x 8 pixel lanes) sums, over one tile
// of kWeightTilePixels flat pixels, in(neighbour(p, tap)) * u(p) for every tap
// and u(p) for the bias, with u = g or g * q (PROD). Partial sums go to
// partial[tile][tap][c], tap K*K being the bias.
constexpr int kWeightTilePixels = 256;  // WEIGHT_TILE_PIXELS in ops/kernels.py
constexpr int kLanes = 8;

template <typename T, int K, bool PROD>
__global__ void __launch_bounds__(32 * kLanes) dwconv_weight_partial_kernel(
    Grid<T> in, Grid<T> g, Grid<T> q, float* __restrict__ partial, int batch,
    int height, int width, int chans) {
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
      float u = g.at(b, here, c);
      if (PROD) u *= q.at(b, here, c);
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

template <typename T, int K, bool GATE, bool RESID, bool FLIP, bool PROD>
int launch_conv(Grid<T> x, Grid<T> x2, Grid<T> gate, const void* w,
                const void* b, void* out, int batch, int height, int width,
                int chans, cudaStream_t stream) {
  const long long total = static_cast<long long>(batch) * height * width * chans;
  dwconv_fwd_kernel<T, K, GATE, RESID, FLIP, PROD><<<grid_for(total), kThreads, 0, stream>>>(
      x, x2, gate, static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), batch, height, width, chans);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool PROD>
int launch_weight_grads(Grid<T> in, Grid<T> g, Grid<T> q, float* partial,
                        float* total, int tiles, int batch, int height,
                        int width, int chans, cudaStream_t stream) {
  const long long pixels = static_cast<long long>(batch) * height * width;
  if (tiles != (pixels + kWeightTilePixels - 1) / kWeightTilePixels)
    return kUnsupported;
  const dim3 grid(tiles, (chans + 31) / 32);
  dwconv_weight_partial_kernel<T, K, PROD><<<grid, dim3(32, kLanes), 0, stream>>>(
      in, g, q, partial, batch, height, width, chans);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = (K * K + 1) * chans;
  dwconv_weight_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, total, tiles, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cpe_fwd(const void* x, const void* w, const void* b, void* out, int batch,
            int height, int width, int chans, long long x_bs, long long x_ps,
            cudaStream_t s) {
  const Grid<T> xg{static_cast<const T*>(x), x_bs, x_ps};
  return launch_conv<T, 3, false, true, false, false>(xg, xg, xg, w, b, out, batch,
                                                      height, width, chans, s);
}

template <typename T>
int crpe_fwd(const void* q, const void* v, const void* w, const void* b,
             void* out, int batch, int height, int width, int chans,
             long long q_bs, long long q_ps, long long v_bs, long long v_ps,
             cudaStream_t s) {
  const Grid<T> vg{static_cast<const T*>(v), v_bs, v_ps};
  const Grid<T> qg{static_cast<const T*>(q), q_bs, q_ps};
  return launch_conv<T, 7, true, false, false, false>(vg, vg, qg, w, b, out, batch,
                                                      height, width, chans, s);
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
  int err = launch_conv<T, 3, false, true, true, false>(gg, gg, gg, w, nullptr, dx,
                                                        batch, height, width, chans, s);
  if (err != 0) return err;
  return launch_weight_grads<T, 3, false>(xg, gg, gg, partial, total, tiles, batch,
                                          height, width, chans, s);
}

template <typename T>
int crpe_bwd(const void* q, const void* v, const void* w, const void* b,
             const void* g, void* dq, void* dv, float* partial, float* total,
             int tiles, int batch, int height, int width, int chans,
             long long q_bs, long long q_ps, long long v_bs, long long v_ps,
             cudaStream_t s) {
  const long long img = static_cast<long long>(height) * width * chans;
  const Grid<T> qg{static_cast<const T*>(q), q_bs, q_ps};
  const Grid<T> vg{static_cast<const T*>(v), v_bs, v_ps};
  const Grid<T> gg{static_cast<const T*>(g), img, chans};
  // dq = g * (dwconv(v) + b): the forward with g as the gate
  int err = launch_conv<T, 7, true, false, false, false>(vg, vg, gg, w, b, dq, batch,
                                                         height, width, chans, s);
  if (err != 0) return err;
  // dv = dwconv(g * q, flipped w)
  err = launch_conv<T, 7, false, false, true, true>(gg, qg, gg, w, nullptr, dv, batch,
                                                    height, width, chans, s);
  if (err != 0) return err;
  return launch_weight_grads<T, 7, true>(vg, gg, qg, partial, total, tiles, batch,
                                         height, width, chans, s);
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

// q, v: (B, H, W, C) views as x above, each with its own strides; w: (7, 7, C)
// contiguous; b: (C,); out: contiguous (B, H, W, C).
extern "C" int mdvit_crpe_conv_fwd(int dtype, const void* q, const void* v,
                                   const void* w, const void* b, void* out,
                                   int batch, int height, int width, int chans,
                                   long long q_bs, long long q_ps, long long v_bs,
                                   long long v_ps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::crpe_fwd<float>(q, v, w, b, out, batch, height, width, chans,
                                  q_bs, q_ps, v_bs, v_ps, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::crpe_fwd<__nv_bfloat16>(q, v, w, b, out, batch, height, width,
                                          chans, q_bs, q_ps, v_bs, v_ps, s);
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

// Backward of crpe. q, v as in the forward; g, dq, dv: contiguous
// (B, H, W, C); partial: fp32 scratch of tiles * 50 * C; total: fp32 (50, C),
// rows 0..48 dw (7, 7, C), row 49 db.
extern "C" int mdvit_crpe_conv_bwd(int dtype, const void* q, const void* v,
                                   const void* w, const void* b, const void* g,
                                   void* dq, void* dv, void* partial, void* total,
                                   int tiles, int batch, int height, int width,
                                   int chans, long long q_bs, long long q_ps,
                                   long long v_bs, long long v_ps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* tp = static_cast<float*>(total);
  if (dtype == mdvit::kFloat32)
    return mdvit::crpe_bwd<float>(q, v, w, b, g, dq, dv, pp, tp, tiles, batch,
                                  height, width, chans, q_bs, q_ps, v_bs, v_ps, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::crpe_bwd<__nv_bfloat16>(q, v, w, b, g, dq, dv, pp, tp, tiles,
                                          batch, height, width, chans, q_bs, q_ps,
                                          v_bs, v_ps, s);
  return mdvit::kUnsupported;
}
