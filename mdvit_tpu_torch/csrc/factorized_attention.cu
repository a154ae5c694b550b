// Factorized attention, forward:  out = scale * q_h @ (softmax_n(k_h)^T v_h)
// for every head h, with the softmax taken over the N tokens in fp32.
//
// Replaces the Pallas TPU kernel mdvit_tpu/ops/pallas_attention.py
// (_fwd_kernel, launched by _call_fwd via factorized_attention). That kernel
// holds one batch element's whole (N, C) slab in VMEM and forms the full C x C
// product before masking it to the block diagonal. On Hopper a block has at
// most 227 KB of shared memory (one fp32 (4096, 64) slab is 1 MiB), so the
// work is cut per (batch element, head) instead and N is streamed in tiles:
//
//   pass 1  online column max and sum of exp over N for the head's ch columns;
//   pass 2  the ch x ch Gram matrix sum_n exp(k - max)[n, i] * v[n, j] in fp32,
//           scaled by 1/sum at the end; the masked C x C product is never formed;
//   pass 3  out[n, j] = scale * sum_i q[n, i] * T[i, j].
//
// Bound on this card: memory. The work is 4*N*C*ch flops for 4*N*C elements
// moved, a few flops per byte, far below the H100's ~295 flops per byte. The
// kernel reads k twice (passes 1 and 2), q and v once, and writes out once;
// the fp32 sums live in registers and shared memory only. q, k and v are
// taken as strided views of the (B, N, 3C) qkv projection (row stride 3C), so
// no copy is made to split them. Known limits left for later work: only
// B * heads blocks run (128 at B=16, 8 at B=1, on 132 SMs), and the products
// run on CUDA cores, not tensor cores.
#include "common.cuh"

namespace mdvit {
namespace {

constexpr int kThreads = 256;

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads) factorized_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int n_tok, int heads, long long batch_stride,
    long long row_stride, float scale) {
  constexpr int kTile = 2048 / CH;        // token rows per shared-memory tile
  constexpr int kGroups = kThreads / CH;  // row groups of pass 1
  constexpr int kPairs = CH * CH;         // entries of the head's Gram matrix
  constexpr int kPairGroups = kPairs >= kThreads ? 1 : kThreads / kPairs;
  constexpr int kPairsPerThread = (kPairs + kThreads - 1) / kThreads;

  __shared__ float s_a[kTile * CH];  // exp(k - max) in pass 2, q in pass 3
  __shared__ float s_b[kTile * CH];  // v in pass 2
  __shared__ float s_t[kPairs];      // softmax(k)^T v of this head
  __shared__ float s_red[2 * kThreads];
  __shared__ float s_max[CH];
  __shared__ float s_inv[CH];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const long long in_off = b * batch_stride + h * CH;
  q += in_off;
  k += in_off;
  v += in_off;
  const int c_all = heads * CH;
  out += static_cast<long long>(b) * n_tok * c_all + h * CH;

  // ---- pass 1: column max and sum of exp, online over the token rows
  {
    const int col = tid % CH;
    const int grp = tid / CH;
    float m = -INFINITY;
    float s = 0.f;
    if (grp < kGroups) {
      for (int n = grp; n < n_tok; n += kGroups) {
        const float x = to_f(k[n * row_stride + col]);
        if (x > m) {
          s = s * expf(m - x) + 1.f;
          m = x;
        } else {
          s += expf(x - m);
        }
      }
    }
    s_red[tid] = m;
    s_red[kThreads + tid] = s;
    __syncthreads();
    if (tid < CH) {
      float mm = -INFINITY;
      for (int g = 0; g < kGroups; ++g) mm = fmaxf(mm, s_red[g * CH + tid]);
      float ss = 0.f;
      for (int g = 0; g < kGroups; ++g) {
        const float mg = s_red[g * CH + tid];
        if (mg > -INFINITY) ss += s_red[kThreads + g * CH + tid] * expf(mg - mm);
      }
      s_max[tid] = mm;
      s_inv[tid] = 1.f / ss;
    }
    __syncthreads();
  }

  // ---- pass 2: Gram matrix of exp(k - max) and v, accumulated in fp32
  float acc[kPairsPerThread];
  int pi[kPairsPerThread];
  int pj[kPairsPerThread];
#pragma unroll
  for (int pp = 0; pp < kPairsPerThread; ++pp) {
    acc[pp] = 0.f;
    const int p = (kPairGroups > 1 ? tid % kPairs : tid + pp * kThreads);
    pi[pp] = (p < kPairs ? p / CH : 0);
    pj[pp] = (p < kPairs ? p % CH : 0);
  }
  const int grp2 = kPairGroups > 1 ? tid / kPairs : 0;
  for (int n0 = 0; n0 < n_tok; n0 += kTile) {
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int r = i / CH;
      const int c = i % CH;
      const int n = n0 + r;
      float ke = 0.f;
      float vv = 0.f;
      if (n < n_tok) {
        ke = expf(to_f(k[n * row_stride + c]) - s_max[c]);
        vv = to_f(v[n * row_stride + c]);
      }
      s_a[i] = ke;
      s_b[i] = vv;
    }
    __syncthreads();
    const int rows = min(kTile, n_tok - n0);
    if (kPairGroups > 1) {
      if (grp2 < kPairGroups) {
        float a = acc[0];
        for (int r = grp2; r < rows; r += kPairGroups)
          a += s_a[r * CH + pi[0]] * s_b[r * CH + pj[0]];
        acc[0] = a;
      }
    } else {
      for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int pp = 0; pp < kPairsPerThread; ++pp)
          acc[pp] += s_a[r * CH + pi[pp]] * s_b[r * CH + pj[pp]];
      }
    }
    __syncthreads();
  }
  if (kPairGroups > 1) {
    s_red[tid] = (grp2 < kPairGroups ? acc[0] : 0.f);
    __syncthreads();
    if (tid < kPairs) {
      float t = 0.f;
      for (int g = 0; g < kPairGroups; ++g) t += s_red[g * kPairs + tid];
      s_t[tid] = t * s_inv[tid / CH];
    }
  } else {
#pragma unroll
    for (int pp = 0; pp < kPairsPerThread; ++pp) {
      const int p = tid + pp * kThreads;
      if (p < kPairs) s_t[p] = acc[pp] * s_inv[pi[pp]];
    }
  }
  __syncthreads();

  // ---- pass 3: out = scale * q @ T, one output element per thread and step
  for (int n0 = 0; n0 < n_tok; n0 += kTile) {
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int n = n0 + i / CH;
      s_a[i] = (n < n_tok ? to_f(q[n * row_stride + i % CH]) : 0.f);
    }
    __syncthreads();
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int r = i / CH;
      const int j = i % CH;
      const int n = n0 + r;
      if (n < n_tok) {
        float o = 0.f;
#pragma unroll 8
        for (int ii = 0; ii < CH; ++ii) o += s_a[r * CH + ii] * s_t[ii * CH + j];
        out[static_cast<long long>(n) * c_all + j] = from_f<T>(o * scale);
      }
    }
    __syncthreads();
  }
}

// Backward. Replaces the Pallas TPU kernel of _vjp_bwd (_bwd_kernel) in
// mdvit_tpu/ops/pallas_attention.py. Per (batch element b, head h), with
// ks = softmax_n(k), T = ks^T v, the output gradient g and inner[i] =
// sum_j dT[i, j] T[i, j] (which equals the column sum over N of ks * (v dT^T)
// that the Pallas kernel takes):
//
//   dq = scale * g T^T,  dT = scale * q^T g,  dv = ks dT,
//   dk = ks * (v dT^T - inner).
//
// The Pallas kernel walks a head's N tokens in one grid step; here the tokens
// are cut into chunks of kRows rows so that B * heads * chunks blocks fill the
// card, in two launches and with no atomics:
//
//   partials  one block per (b, h, chunk s) reads its chunk of q, k, v, g once
//             and writes, in fp32, the chunk's column max m_s, l_s = sum_n
//             exp(k - m_s), T_s = sum_n exp(k - m_s)^T v and D_s = sum_n q^T g;
//   apply     one block per (b, h, chunk) folds the chunks' partials in the
//             order s = 0..S-1 (M = max m_s, a_s = exp(m_s - M), L = sum a_s l_s,
//             T = sum a_s T_s / L, dT = scale * sum D_s), then reads its chunk
//             of k, v, g once and writes dq, dk, dv.
//
// Each block repeats the fold of its (b, h): a few KB (ch 8) to 64 KB (ch 64)
// of L2 reads, in exchange for no third launch and no cross-block ordering. A
// second call gives the same bits.
//
// Bound on this card: memory at ch 8 to 40, fp32 issue at ch 64 (the work is
// 10*N*C*ch flops for 7*N*C elements moved). The design moves 10 image-sized
// arrays (partials: q, k, v, g; apply: k, v, g in, dq, dk, dv out) plus the
// partials. What it does about it:
//   - each thread issues every load of its share of the chunk into registers
//     before its first shared-memory store (on an H100 about a fifth off the
//     fp32 time at 64x64 and 32x32, against staging element by element);
//   - both launches tile their products in registers: a thread owns a 4x4
//     tile of T_s and of D_s (partials) or 4 rows x 4 columns of dq, dv and
//     dk (apply), so each float4 read from shared memory feeds 4 FMAs, not 1;
//   - the apply's transposed ch x ch matrices are padded, so the fold's
//     stores into them do not serialise on one bank (32-way at ch 64), and
//     inner comes out of the product loop, which reads T and dT anyway.
// Chunks of half the rows at ch 8 and 16 measured slower (twice the partials
// to write and fold), and so did a cap of 5 partials blocks an SM (spills).
// Tensor-core products at ch 40 and 64 are left for later work.
template <int CH>
struct AttnBwd {
  // token rows of a chunk, ~2048 values of each input (ATTENTION_CHUNK_ROWS
  // in ops/kernels.py mirrors this)
  static constexpr int kRows = CH == 8 ? 256 : CH == 16 ? 128 : CH == 40 ? 64 : 32;
  static constexpr int kChunkEl = kRows * CH;
  // floats of one (b, h, chunk) partial: m, l, then T_s and D_s (ch x ch each)
  static constexpr int kPartial = 2 * CH + 2 * CH * CH;
  // apply: a thread per 4 x 4 tile of the chunk's (kRows, CH) outputs
  static constexpr int kApplyThreads = (kRows / 4) * (CH / 4);
  // pitch of the apply's transposed (CH, kRows) input tiles: float4 rows,
  // and 4 more floats so that a warp's transposing stores spread over banks
  static constexpr int kPitch = kRows + 4;
  // pitch of the apply's transposed ch x ch matrices: float4 rows, and 4 more
  // floats so that the fold's transposing stores spread over banks
  static constexpr int kTPitch = CH + 4;
  static constexpr int kApplySmemFloats = 2 * CH * kTPitch + CH * CH + 3 * CH * kPitch + 2 * CH;
  static_assert(CH % 4 == 0 && kRows % 4 == 0, "4 x 4 register tiles");
  static_assert(kChunkEl % kApplyThreads == 0, "whole staging rounds");
};

constexpr int kPartThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[x][y] += a[x] * b[y]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
}

// four neighbouring elements in one store (16 B fp32, 8 B bf16)
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int CH>
__global__ void __launch_bounds__(kPartThreads) factorized_attention_bwd_partials_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, float* __restrict__ ws, int n_tok, int heads,
    int chunks, long long batch_stride, long long row_stride,
    long long g_batch_stride, long long g_row_stride) {
  using P = AttnBwd<CH>;
  constexpr int kEl = P::kChunkEl;
  constexpr int kTilesPerRow = CH / 4;
  constexpr int kTiles = kTilesPerRow * kTilesPerRow;  // 4x4 tiles of a ch x ch sum
  constexpr int kGroups = kTiles >= kPartThreads ? 1 : kPartThreads / kTiles;
  // per-thread sums left after the warp shuffles: one per warp while a warp
  // holds several row groups of each tile (ch 8, 16), else one per row group
  constexpr int kHolders = kTiles < 32 ? kPartThreads / 32 : kGroups;
  constexpr int kColGroups = kPartThreads / CH;  // row groups of the column statistics
  static_assert(kEl % kPartThreads == 0, "whole staging rounds");
  static_assert(kHolders * 2 * CH * CH <= 4 * kEl, "holders' sums fit the staging buffer");

  __shared__ __align__(16) float s_buf[4 * kEl];  // k (then exp(k - m)), v, q, g
  __shared__ float s_col[kPartThreads];
  __shared__ float s_m[CH];
  float* s_k = s_buf;
  float* s_v = s_buf + kEl;
  float* s_q = s_buf + 2 * kEl;
  float* s_g = s_buf + 3 * kEl;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / chunks;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n0 = (blockIdx.x % chunks) * P::kRows;
  const int rows = min(P::kRows, n_tok - n0);
  const long long in_off = b * batch_stride + n0 * row_stride + h * CH;
  q += in_off;
  k += in_off;
  v += in_off;
  g += b * g_batch_stride + n0 * g_row_stride + h * CH;

  // ---- stage the chunk in fp32, rows in the order of memory: every load of
  // the thread is issued before the first store to shared memory
  {
    constexpr int kStage = kEl / kPartThreads;
    float kr[kStage], vr[kStage], qr[kStage], gr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kPartThreads;
      const int r = i / CH;
      const int c = i % CH;
      if (r < rows) {
        const long long o = r * row_stride + c;
        kr[u] = to_f(k[o]);
        vr[u] = to_f(v[o]);
        qr[u] = to_f(q[o]);
        gr[u] = to_f(g[r * g_row_stride + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kPartThreads;
      if (i / CH < rows) {
        s_k[i] = kr[u];
        s_v[i] = vr[u];
        s_q[i] = qr[u];
        s_g[i] = gr[u];
      }
    }
  }
  __syncthreads();

  // ---- column max m_s, then exp(k - m_s) in place and its column sum l_s
  const int col = tid % CH;
  const int cgrp = tid / CH;
  if (cgrp < kColGroups) {
    float m = -INFINITY;
    for (int r = cgrp; r < rows; r += kColGroups) m = fmaxf(m, s_k[r * CH + col]);
    s_col[cgrp * CH + col] = m;
  }
  __syncthreads();
  if (tid < CH) {
    float m = -INFINITY;
    for (int gi = 0; gi < kColGroups; ++gi) m = fmaxf(m, s_col[gi * CH + tid]);
    s_m[tid] = m;
  }
  __syncthreads();
  if (cgrp < kColGroups) {
    const float m = s_m[col];
    float l = 0.f;
    for (int r = cgrp; r < rows; r += kColGroups) {
      const float e = expf(s_k[r * CH + col] - m);
      s_k[r * CH + col] = e;
      l += e;
    }
    s_col[cgrp * CH + col] = l;
  }
  __syncthreads();
  float* out = ws + static_cast<long long>(blockIdx.x) * P::kPartial;
  if (tid < CH) {
    float l = 0.f;
    for (int gi = 0; gi < kColGroups; ++gi) l += s_col[gi * CH + tid];
    out[tid] = s_m[tid];
    out[CH + tid] = l;
  }

  // ---- T_s = exp(k - m_s)^T v and D_s = q^T g: a 4x4 tile of each per
  // thread, the chunk's rows split between kGroups row groups
  const int tile = tid % kTiles;
  const int grp = tid / kTiles;
  const int i0 = (tile / kTilesPerRow) * 4;
  const int j0 = (tile % kTilesPerRow) * 4;
  float at[4][4] = {};
  float ad[4][4] = {};
  if (grp < kGroups) {
    for (int r = grp; r < rows; r += kGroups) {
      outer4(at, ld4(s_k + r * CH + i0), ld4(s_v + r * CH + j0));
      outer4(ad, ld4(s_q + r * CH + i0), ld4(s_g + r * CH + j0));
    }
  }
  if constexpr (kTiles < 32) {
    // lanes tile, tile + kTiles, ... of a warp hold the same tile: add them
#pragma unroll
    for (int off = kTiles; off < 32; off <<= 1)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          at[x][y] += __shfl_xor_sync(0xffffffffu, at[x][y], off);
          ad[x][y] += __shfl_xor_sync(0xffffffffu, ad[x][y], off);
        }
  }
  __syncthreads();  // the staged chunk is read; its buffer takes the holders' sums
  const int holder = kTiles < 32 ? tid / 32 : grp;
  const bool holds = kTiles < 32 ? (tid % 32) < kTiles : grp < kGroups;
  if (holds) {
    float* st = s_buf + holder * 2 * CH * CH;
    float* sd = st + CH * CH;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        st[(i0 + x) * CH + j0 + y] = at[x][y];
        sd[(i0 + x) * CH + j0 + y] = ad[x][y];
      }
  }
  __syncthreads();
  for (int e = tid; e < 2 * CH * CH; e += kPartThreads) {
    float s = s_buf[e];
    for (int hh = 1; hh < kHolders; ++hh) s += s_buf[hh * 2 * CH * CH + e];
    out[2 * CH + e] = s;
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(AttnBwd<CH>::kApplyThreads) factorized_attention_bwd_apply_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ ws, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int n_tok, int heads, int chunks, long long batch_stride,
    long long row_stride, long long g_batch_stride, long long g_row_stride,
    float scale) {
  using P = AttnBwd<CH>;
  constexpr int kThreads = P::kApplyThreads;  // this kernel's block
  constexpr int kPitch = P::kPitch;
  constexpr int kPairs = CH * CH;
  constexpr int kPairsPerThread = (kPairs + kThreads - 1) / kThreads;
  constexpr int kTPitch = P::kTPitch;
  constexpr int kBatch = kPairsPerThread >= 16 ? 1 : 16 / kPairsPerThread;

  extern __shared__ __align__(16) float smem[];
  float* s_tt = smem;                  // s_tt[j * kTPitch + i] = T[i][j]
  float* s_dtt = s_tt + CH * kTPitch;  // s_dtt[j * kTPitch + i] = dT[i][j]
  float* s_dt = s_dtt + CH * kTPitch;  // s_dt[i * CH + j] = dT[i][j]
  float* s_g = s_dt + kPairs;          // chunk of g, transposed: s_g[c * kPitch + r]
  float* s_k = s_g + CH * kPitch;      // k, then ks = exp(k - M) / L
  float* s_v = s_k + CH * kPitch;
  float* s_m = s_v + CH * kPitch;      // M
  float* s_il = s_m + CH;              // 1 / L

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n0 = blockIdx.y * P::kRows;
  const int rows = min(P::kRows, n_tok - n0);
  const long long in_off = b * batch_stride + n0 * row_stride + h * CH;
  k += in_off;
  v += in_off;
  g += b * g_batch_stride + n0 * g_row_stride + h * CH;

  // ---- stage the chunk of k, v, g, transposed: every load of the thread is
  // issued before the first store to shared memory
  {
    constexpr int kStage = P::kChunkEl / kThreads;
    float kr[kStage], vr[kStage], gr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / CH;
      const int c = i % CH;
      if (r < rows) {
        const long long o = r * row_stride + c;
        kr[u] = to_f(k[o]);
        vr[u] = to_f(v[o]);
        gr[u] = to_f(g[r * g_row_stride + c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / CH;
      const int c = i % CH;
      if (r < rows) {
        s_k[c * kPitch + r] = kr[u];
        s_v[c * kPitch + r] = vr[u];
        s_g[c * kPitch + r] = gr[u];
      }
    }
  }

  // ---- M = max m_s and L = sum exp(m_s - M) l_s of the head's columns, the
  // chunks in the order s = 0..S-1, 16 chunks' loads in flight at a time
  const float* part = ws + static_cast<long long>(bh) * chunks * P::kPartial;
  if (tid < CH) {
    float mx = -INFINITY;
    for (int s0 = 0; s0 < chunks; s0 += 16) {
      float ms[16];
#pragma unroll
      for (int sb = 0; sb < 16; ++sb)
        ms[sb] = s0 + sb < chunks ? part[(s0 + sb) * P::kPartial + tid] : -INFINITY;
#pragma unroll
      for (int sb = 0; sb < 16; ++sb) mx = fmaxf(mx, ms[sb]);
    }
    float l = 0.f;
    for (int s0 = 0; s0 < chunks; s0 += 16) {
      float ms[16], ls[16];
#pragma unroll
      for (int sb = 0; sb < 16; ++sb) {
        const bool in = s0 + sb < chunks;
        ms[sb] = in ? part[(s0 + sb) * P::kPartial + tid] : -INFINITY;
        ls[sb] = in ? part[(s0 + sb) * P::kPartial + CH + tid] : 0.f;
      }
#pragma unroll
      for (int sb = 0; sb < 16; ++sb)
        l += (ms[sb] > -INFINITY ? expf(ms[sb] - mx) : 0.f) * ls[sb];
    }
    s_m[tid] = mx;
    s_il[tid] = 1.f / l;
  }
  __syncthreads();

  // ---- T = sum a_s T_s / L and dT = scale * sum D_s; ks = exp(k - M) / L
  {
    float t[kPairsPerThread];
    float d[kPairsPerThread];
#pragma unroll
    for (int u = 0; u < kPairsPerThread; ++u) {
      t[u] = 0.f;
      d[u] = 0.f;
    }
    // kBatch chunks' loads in flight at a time; a chunk past S adds 0
    for (int s0 = 0; s0 < chunks; s0 += kBatch) {
      float ms[kBatch][kPairsPerThread], ts[kBatch][kPairsPerThread],
          ds[kBatch][kPairsPerThread];
#pragma unroll
      for (int sb = 0; sb < kBatch; ++sb) {
        const float* ps = part + (s0 + sb) * P::kPartial;
#pragma unroll
        for (int u = 0; u < kPairsPerThread; ++u) {
          const int e = tid + u * kThreads;
          const bool in = s0 + sb < chunks && (kPairs % kThreads == 0 || e < kPairs);
          ms[sb][u] = in ? ps[e / CH] : -INFINITY;
          ts[sb][u] = in ? ps[2 * CH + e] : 0.f;
          ds[sb][u] = in ? ps[2 * CH + kPairs + e] : 0.f;
        }
      }
#pragma unroll
      for (int sb = 0; sb < kBatch; ++sb)
#pragma unroll
        for (int u = 0; u < kPairsPerThread; ++u) {
          const int e = tid + u * kThreads;
          const float a = ms[sb][u] > -INFINITY
                              ? expf(ms[sb][u] - s_m[min(e, kPairs - 1) / CH]) : 0.f;
          t[u] += a * ts[sb][u];
          d[u] += ds[sb][u];
        }
    }
#pragma unroll
    for (int u = 0; u < kPairsPerThread; ++u) {
      const int e = tid + u * kThreads;
      if (kPairs % kThreads == 0 || e < kPairs) {
        const int i = e / CH;
        const int j = e % CH;
        const float dd = d[u] * scale;
        s_tt[j * kTPitch + i] = t[u] * s_il[i];
        s_dtt[j * kTPitch + i] = dd;
        s_dt[e] = dd;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < P::kChunkEl / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int c = i / P::kRows;
    const int r = i % P::kRows;
    if (r < rows) {
      float* p = s_k + c * kPitch + r;
      *p = expf(*p - s_m[c]) * s_il[c];
    }
  }
  __syncthreads();

  // ---- dq = scale * g T^T, dv = ks dT, v dT^T: 4 rows x 4 columns a thread
  const int r0 = (tid / (CH / 4)) * 4;
  const int c0 = (tid % (CH / 4)) * 4;
  float aq[4][4] = {};
  float av[4][4] = {};
  float ak[4][4] = {};
  float inner[4] = {};  // inner[c] = sum_j dT[c, j] T[c, j], from the same rows
#pragma unroll 4
  for (int j = 0; j < CH; ++j) {
    const float4 tt = ld4(s_tt + j * kTPitch + c0);
    const float4 de = ld4(s_dtt + j * kTPitch + c0);
    outer4(aq, ld4(s_g + j * kPitch + r0), tt);
    outer4(av, ld4(s_k + j * kPitch + r0), ld4(s_dt + j * CH + c0));
    outer4(ak, ld4(s_v + j * kPitch + r0), de);
    inner[0] = fmaf(de.x, tt.x, inner[0]);
    inner[1] = fmaf(de.y, tt.y, inner[1]);
    inner[2] = fmaf(de.z, tt.z, inner[2]);
    inner[3] = fmaf(de.w, tt.w, inner[3]);
  }
  const int c_all = heads * CH;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = r0 + x;
    if (r < rows) {
      float oq[4], ov[4], ok[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int c = c0 + y;
        oq[y] = aq[x][y] * scale;
        ov[y] = av[x][y];
        ok[y] = s_k[c * kPitch + r] * (ak[x][y] - inner[y]);
      }
      const long long o = (static_cast<long long>(b) * n_tok + n0 + r) * c_all + h * CH + c0;
      store4(dq + o, oq);
      store4(dv + o, ov);
      store4(dk + o, ok);
    }
  }
}

template <typename T, int CH>
int launch_bwd_ch(const T* q, const T* k, const T* v, const T* g, T* dq, T* dk,
                  T* dv, float* ws, int batch, int n_tok, int heads,
                  long long batch_stride, long long row_stride,
                  long long g_batch_stride, long long g_row_stride, float scale,
                  cudaStream_t stream) {
  using P = AttnBwd<CH>;
  const int chunks = (n_tok + P::kRows - 1) / P::kRows;
  factorized_attention_bwd_partials_kernel<T, CH>
      <<<batch * heads * chunks, kPartThreads, 0, stream>>>(
          q, k, v, g, ws, n_tok, heads, chunks, batch_stride, row_stride,
          g_batch_stride, g_row_stride);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int smem = P::kApplySmemFloats * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    err = static_cast<int>(cudaFuncSetAttribute(
        factorized_attention_bwd_apply_kernel<T, CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
  }
  factorized_attention_bwd_apply_kernel<T, CH>
      <<<dim3(batch * heads, chunks), P::kApplyThreads, smem, stream>>>(
          k, v, g, ws, dq, dk, dv, n_tok, heads, chunks, batch_stride, row_stride,
          g_batch_stride, g_row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, void* ws, int batch, int n_tok,
               int heads, int ch, long long batch_stride, long long row_stride,
               long long g_batch_stride, long long g_row_stride, float scale,
               cudaStream_t stream) {
#define MDVIT_FA_BWD_CASE(C)                                                   \
  case C:                                                                      \
    return launch_bwd_ch<T, C>(                                                \
        static_cast<const T*>(q), static_cast<const T*>(k),                    \
        static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(dq), \
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(ws),     \
        batch, n_tok, heads, batch_stride, row_stride, g_batch_stride,         \
        g_row_stride, scale, stream);
  switch (ch) {
    MDVIT_FA_BWD_CASE(8)
    MDVIT_FA_BWD_CASE(16)
    MDVIT_FA_BWD_CASE(40)
    MDVIT_FA_BWD_CASE(64)
    default:
      return kUnsupported;
  }
#undef MDVIT_FA_BWD_CASE
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n_tok, int heads, int ch, long long batch_stride,
           long long row_stride, float scale, cudaStream_t stream) {
  const dim3 grid(batch * heads);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
#define MDVIT_FA_CASE(C)                                                  \
  case C:                                                                 \
    factorized_attention_fwd_kernel<T, C><<<grid, kThreads, 0, stream>>>( \
        qp, kp, vp, op, n_tok, heads, batch_stride, row_stride, scale);   \
    break;
  switch (ch) {
    MDVIT_FA_CASE(8)
    MDVIT_FA_CASE(16)
    MDVIT_FA_CASE(40)
    MDVIT_FA_CASE(64)
    default:
      return kUnsupported;
  }
#undef MDVIT_FA_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mdvit

// q, k, v: (B, N, heads*ch) views with unit channel stride, the given row and
// batch strides (in elements); out: contiguous (B, N, heads*ch). Returns the
// cudaGetLastError() code after the launch, or -1 for an unsupported dtype/ch.
extern "C" int mdvit_factorized_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int batch, int n_tok, int heads, int ch, long long batch_stride,
    long long row_stride, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch<float>(q, k, v, out, batch, n_tok, heads, ch,
                                batch_stride, row_stride, scale, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch<__nv_bfloat16>(q, k, v, out, batch, n_tok, heads, ch,
                                        batch_stride, row_stride, scale, s);
  return mdvit::kUnsupported;
}

// q, k, v as above; g: (B, N, heads*ch) view with unit channel stride and its
// own batch and row strides; dq, dk, dv: contiguous (B, N, heads*ch); ws: fp32
// workspace of B * heads * chunks * (2 ch + 2 ch^2) floats, chunks =
// ceil(N / kRows), every entry written by the partials launch before the
// apply launch reads it. Two launches on the stream.
extern "C" int mdvit_factorized_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    void* dq, void* dk, void* dv, void* ws, int batch, int n_tok, int heads,
    int ch, long long batch_stride, long long row_stride,
    long long g_batch_stride, long long g_row_stride, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch_bwd<float>(q, k, v, g, dq, dk, dv, ws, batch, n_tok,
                                    heads, ch, batch_stride, row_stride,
                                    g_batch_stride, g_row_stride, scale, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch_bwd<__nv_bfloat16>(
        q, k, v, g, dq, dk, dv, ws, batch, n_tok, heads, ch, batch_stride,
        row_stride, g_batch_stride, g_row_stride, scale, s);
  return mdvit::kUnsupported;
}
