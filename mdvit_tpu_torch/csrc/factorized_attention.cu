// Factorized attention per head h, with the softmax over the N tokens in fp32:
//
//   forward   out = scale * q_h (softmax_n(k_h)^T v_h)
//   backward  with ks = softmax_n(k), T = ks^T v, the output gradient g and
//             inner[i] = sum_j dT[i, j] T[i, j] (which equals the column sum
//             over N of ks * (v dT^T) that the Pallas kernel takes):
//             dq = scale * g T^T,  dT = scale * q^T g,  dv = ks dT,
//             dk = ks * (v dT^T - inner).
//
// Replaces the Pallas TPU kernels of mdvit_tpu/ops/pallas_attention.py:
// _fwd_kernel (launched by _call_fwd) and _bwd_kernel (by _vjp_bwd). Each
// walks one batch element's N tokens in one grid step, with its whole (N, C)
// slab in VMEM. On Hopper blocks run in parallel, in no order, and a block
// has at most 227 KB of shared memory (one fp32 (4096, 64) slab is 1 MiB).
// So the tokens of a head are cut into S chunks of R rows, about 2048 to
// 2560 values of an input (AttnChunk::kRows; the forward takes twice the
// rows at ch 64; the wrappers size the workspace by
// mdvit_factorized_attention_workspace, so the rows live here alone), and
// each direction is two launches, with no atomics:
//
//   partials  one block per (batch element b, head h, chunk s) reads its
//             chunk of k and v once (backward: of q and g too) and writes,
//             in fp32, the chunk's column max m_s, l_s = sum_n exp(k - m_s),
//             T_s = sum_n exp(k - m_s)^T v (backward: and D_s = sum_n q^T g).
//             One device function (attention_partials) is the body of both
//             directions' partials kernels, so both form T the same way;
//   apply     one block per (b, h, s) folds the S partials of its (b, h) in
//             the order s = 0..S-1 (fold_chunks: M = max m_s, a_s = exp(m_s -
//             M), L = sum a_s l_s, T = sum a_s T_s / L; backward: and dT =
//             scale * sum D_s), then reads its chunk of q (forward) or of k,
//             v, g (backward) once and writes out (forward) or dq, dk, dv.
//
// Each apply block repeats the fold of its (b, h): a few KB (ch 8) to 64 KB
// (ch 64, backward) of L2 reads, in exchange for no third launch and no
// cross-block ordering. A second call gives the same bits.
//
// Bound on this card: bytes, but for the backward at ch 64 and the bf16
// forward at ch 64, which the fp32 FMA rate bounds. The forward does
// 4*N*C*ch flops and moves 4 images (q, k, v in, out), ch/4 flops a byte in
// fp32, under the H100's 67 TFLOP/s / 3.35 TB/s = 20; the backward does
// 10*N*C*ch flops and moves 7 images. What the design does about it:
//   - enough blocks: B * heads * S, 2048 at B = 16 and 128 at B = 1 at the
//     64x64 stage, where one block a (b, h) would run 128 and 8 on 132 SMs;
//   - every input read once: the forward's launches move k, v, then q, out (4
//     images), the backward's q, k, v, g, then k, v, g, dq, dk, dv (10), each
//     plus its partials;
//   - each thread starts every load of its share of a chunk into registers
//     before its first shared-memory store;
//   - the products run in 4x4 register tiles: a thread owns a 4x4 tile of T_s
//     (and D_s) in the partials, or 4 rows x 4 columns of out (dq, dv, dk) in
//     the applies, so each float4 read from shared memory feeds 4 FMAs;
//   - the applies' ch x ch matrices and transposed chunk tiles are padded, so
//     the fold's and the staging's stores spread over the banks; the
//     backward takes inner from its product loop;
//   - the forward's apply is a programmatic dependent launch: its blocks may
//     start while the partials' last wave runs and stage q before they wait
//     on the partials grid (on an H100 14-20% off a call at B = 1, 7-12% at
//     B = 16 at 64x64 and 32x32, but 8% onto 16x16 at B = 16, whose partials
//     fill the card in one wave; releasing the apply only after the
//     partials' writes lost most of the gain).
// Head widths: every ch from 1 to 64. MDViT's four (8, 16, 40, 64) have
// instances of their own, with ch a compile-time constant. Any other ch runs
// in the instance of the next width bucket CH >= ch (8, 12, ..., 40, 48, 64:
// dispatch_ch), with ch passed at run time: a chunk is staged CH columns
// wide, the columns past ch as zeros, and only the first ch columns of an
// output are stored. That is exact: a zero q or g column adds nothing to
// q T, g T^T or q^T g, a zero v column makes the padded columns of T zero,
// and the padded rows of T and dT (a zero k column's softmax is 1 / N) meet
// only zero columns of q or g. A head starts at channel h * ch, which is
// 4-aligned only when ch is, so the padded instances store 4 values at once
// only then, and one at a time otherwise (CoaT's ch 19, 27; MPViT's 22, 27,
// 46). CoaT's N = H * W + 1 tokens (a cls row) are a ragged last chunk like
// any other N.
// The products stay on CUDA-core FMAs: TF32 mma would break fp32 parity with
// the reference, and bf16 mma would round exp(k - m) and T, which the plain
// version does not. Chunks of half the rows at ch 8 and 16 measured slower in
// the backward (twice the partials to write and fold), and so did a cap of 5
// partials blocks an SM (spills).
#include <type_traits>

#include "common.cuh"

namespace mdvit {
namespace {

// The token chunks of one head, staged CH columns wide (CH: a width bucket,
// a multiple of 4 from 8 to 64); kGrad: the backward's.
template <int CH, bool kGrad>
struct AttnChunk {
  // token rows of a chunk: 2048 to 2560 values of an input, and enough that
  // the partials' per-row-group sums fit the staging buffer (kHolders below).
  // The forward stages two inputs, not four, so at ch 64 it takes twice the
  // backward's rows: at 8x8 one chunk a head, which on an H100 took A 17 ->
  // 14 us a call at B = 16; twice the rows at ch 40 ran slower at B = 1 (half
  // the partials blocks) and spilled in bf16
  static constexpr int kRows = CH == 8    ? 256
                               : CH == 12 ? 192
                               : CH <= 20 ? 128
                               : CH == 24 ? 96
                               : CH == 28 ? 80
                               : CH <= 40 ? 64
                               : CH == 48 ? 48
                               : kGrad    ? 32
                                          : 64;
  static constexpr int kEl = kRows * CH;
  // ch x ch sums of a chunk: T_s, and D_s backward
  static constexpr int kSums = kGrad ? 2 : 1;
  // floats of one (b, h, chunk) partial in the workspace: m_s (ch), l_s (ch),
  // then T_s (ch x ch, row-major) and, backward, D_s (ch x ch)
  static constexpr int kPartial = 2 * CH + kSums * CH * CH;
  // apply: a thread per 4 x 4 tile of the chunk's (kRows, CH) outputs
  static constexpr int kApplyThreads = (kRows / 4) * (CH / 4);
  // pitch of the apply's transposed (CH, kRows) input tiles: float4 rows,
  // and 4 more floats so that a warp's transposing stores spread over banks
  static constexpr int kPitch = kRows + 4;
  // pitch of the apply's ch x ch matrices: float4 rows, and 4 more floats so
  // that the fold's stores (transposing, backward) spread over banks
  static constexpr int kTPitch = CH + 4;
  static_assert(CH % 4 == 0 && kRows % 4 == 0, "4 x 4 register tiles");
  static_assert(kEl % kApplyThreads == 0, "whole staging rounds");
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

// Columns c0..c0+3 of an output row at p: 4 at once, or, in a padded
// instance (kPad), the first `left` of them one at a time unless all 4 lie
// within ch and the row's head is 4-aligned (`aligned`: ch % 4 == 0).
template <bool kPad, typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&o)[4], int left, bool aligned) {
  if (!kPad || (aligned && left >= 4)) {
    store4(p, o);
    return;
  }
#pragma unroll
  for (int y = 0; y < 4; ++y)
    if (y < left) p[y] = from_f<T>(o[y]);
}

// The body of launch 1 of both directions: one block per (b, h, chunk).
// Workspace layout: AttnChunk<CH, kGrad>::kPartial floats per (b, h, chunk),
// the chunks of a (b, h) consecutive. The forward stages k and v only (q and
// g are not read); the backward stages q and g as well and adds D_s. kPad:
// the head is ch_arg <= CH channels wide, and columns past it stage as zeros;
// else it is CH wide.
template <typename T, int CH, bool kGrad, bool kPad>
__device__ __forceinline__ void attention_partials(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, float* __restrict__ ws, int n_tok, int heads, int ch_arg,
    int chunks, long long batch_stride, long long row_stride,
    long long g_batch_stride, long long g_row_stride) {
  using P = AttnChunk<CH, kGrad>;
  constexpr int kEl = P::kEl;
  constexpr int kSums = P::kSums;
  constexpr int kTilesPerRow = CH / 4;
  constexpr int kTiles = kTilesPerRow * kTilesPerRow;  // 4x4 tiles of a ch x ch sum
  constexpr int kGroups = kTiles >= kPartThreads ? 1 : kPartThreads / kTiles;
  // while a warp holds several row groups of each tile (kTiles a power of 2
  // below 32: ch 8, 16) warp shuffles add them and one sum per warp is left,
  // else one per row group
  constexpr bool kShuffle = kTiles < 32 && (kTiles & (kTiles - 1)) == 0;
  constexpr int kHolders = kShuffle ? kPartThreads / 32 : kGroups;
  constexpr int kColGroups = kPartThreads / CH;  // row groups of the column statistics
  // staging rounds; the last one partial where kEl is not a multiple of the
  // block (CH 28): its elements past kEl lie in rows >= kRows >= rows, which
  // the row test below skips
  constexpr int kStage = (kEl + kPartThreads - 1) / kPartThreads;
  static_assert(kHolders * kSums * CH * CH <= 2 * kSums * kEl,
                "holders' sums fit the staging buffer");

  __shared__ __align__(16) float s_buf[2 * kSums * kEl];  // k (then exp(k - m)), v[, q, g]
  __shared__ float s_col[kPartThreads];
  __shared__ float s_m[CH];
  float* s_k = s_buf;
  float* s_v = s_buf + kEl;
  float* s_q = s_buf + 2 * kEl;  // backward only
  float* s_g = s_buf + 3 * kEl;  // backward only

  // the forward's apply grid may launch now and stage q; it waits for this
  // grid to finish before it reads the workspace
  if constexpr (!kGrad) asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / chunks;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n0 = (blockIdx.x % chunks) * P::kRows;
  const int rows = min(P::kRows, n_tok - n0);
  const int ch = kPad ? ch_arg : CH;
  const long long in_off = b * batch_stride + n0 * row_stride + h * ch;
  k += in_off;
  v += in_off;
  if constexpr (kGrad) {
    q += in_off;
    g += b * g_batch_stride + n0 * g_row_stride + h * ch;
  }

  // ---- stage the chunk in fp32, rows in the order of memory: every load of
  // the thread is issued before the first store to shared memory
  {
    float kr[kStage], vr[kStage], qr[kStage], gr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kPartThreads;
      const int r = i / CH;
      const int c = i % CH;
      if (r < rows) {
        if (!kPad || c < ch) {
          const long long o = r * row_stride + c;
          kr[u] = to_f(k[o]);
          vr[u] = to_f(v[o]);
          if constexpr (kGrad) {
            qr[u] = to_f(q[o]);
            gr[u] = to_f(g[r * g_row_stride + c]);
          }
        } else {
          kr[u] = vr[u] = qr[u] = gr[u] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kPartThreads;
      if (i / CH < rows) {
        s_k[i] = kr[u];
        s_v[i] = vr[u];
        if constexpr (kGrad) {
          s_q[i] = qr[u];
          s_g[i] = gr[u];
        }
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

  // ---- T_s = exp(k - m_s)^T v (and D_s = q^T g): a 4x4 tile of each per
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
      if constexpr (kGrad) outer4(ad, ld4(s_q + r * CH + i0), ld4(s_g + r * CH + j0));
    }
  }
  if constexpr (kShuffle) {
    // lanes tile, tile + kTiles, ... of a warp hold the same tile: add them
#pragma unroll
    for (int off = kTiles; off < 32; off <<= 1)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          at[x][y] += __shfl_xor_sync(0xffffffffu, at[x][y], off);
          if constexpr (kGrad) ad[x][y] += __shfl_xor_sync(0xffffffffu, ad[x][y], off);
        }
  }
  __syncthreads();  // the staged chunk is read; its buffer takes the holders' sums
  const int holder = kShuffle ? tid / 32 : grp;
  const bool holds = kShuffle ? (tid % 32) < kTiles : grp < kGroups;
  if (holds) {
    float* st = s_buf + holder * kSums * CH * CH;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        st[(i0 + x) * CH + j0 + y] = at[x][y];
        if constexpr (kGrad) st[CH * CH + (i0 + x) * CH + j0 + y] = ad[x][y];
      }
  }
  __syncthreads();
  for (int e = tid; e < kSums * CH * CH; e += kPartThreads) {
    float s = s_buf[e];
    for (int hh = 1; hh < kHolders; ++hh) s += s_buf[hh * kSums * CH * CH + e];
    out[2 * CH + e] = s;
  }
}

// The partials kernels of the forward and the backward, each with a name of
// its own for the profiler.
template <typename T, int CH, bool kPad>
__global__ void __launch_bounds__(kPartThreads) factorized_attention_fwd_partials_kernel(
    const T* __restrict__ k, const T* __restrict__ v, float* __restrict__ ws, int n_tok,
    int heads, int ch, int chunks, long long batch_stride, long long row_stride) {
  attention_partials<T, CH, false, kPad>(nullptr, k, v, nullptr, ws, n_tok, heads, ch,
                                         chunks, batch_stride, row_stride, 0, 0);
}

template <typename T, int CH, bool kPad>
__global__ void __launch_bounds__(kPartThreads) factorized_attention_bwd_partials_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, float* __restrict__ ws, int n_tok, int heads, int ch,
    int chunks, long long batch_stride, long long row_stride,
    long long g_batch_stride, long long g_row_stride) {
  attention_partials<T, CH, true, kPad>(q, k, v, g, ws, n_tok, heads, ch, chunks,
                                        batch_stride, row_stride, g_batch_stride,
                                        g_row_stride);
}

// The pairs of a ch x ch sum that each of kThreads threads folds.
template <int CH, int kThreads>
struct Fold {
  static constexpr int kPairs = CH * CH;
  static constexpr int kPerThread = (kPairs + kThreads - 1) / kThreads;
  // chunks whose loads are in flight at a time
  static constexpr int kBatch = kPerThread >= 16 ? 1 : 16 / kPerThread;
  static_assert(kThreads >= CH, "a thread per column folds M and L");
};

// The first half of both applies: the fold of one (b, h)'s S chunk partials
// (part: the first of them, kPartial floats apart), in the order s = 0..S-1.
// Threads 0..CH-1 write M = max m_s to s_m and 1 / L, L = sum a_s l_s with
// a_s = exp(m_s - M), to s_il; after a barrier every thread folds the pairs
// e = tid + u * kThreads of the ch x ch sums: t[u] = sum a_s T_s[e] / L and,
// with kGrad, d[u] = sum D_s[e]. A chunk whose max is -inf adds 0. Reads
// s_m and s_il again, so the caller's next barrier must come before they
// change.
template <int CH, int kThreads, int kPartial, bool kGrad>
__device__ __forceinline__ void fold_chunks(
    const float* __restrict__ part, int chunks, float* s_m, float* s_il,
    float (&t)[Fold<CH, kThreads>::kPerThread], float (&d)[Fold<CH, kThreads>::kPerThread]) {
  using F = Fold<CH, kThreads>;
  constexpr int kPairs = F::kPairs;
  constexpr int kPer = F::kPerThread;
  constexpr int kBatch = F::kBatch;
  const int tid = threadIdx.x;

  // ---- M and L of the head's columns, 16 chunks' loads in flight at a time
  if (tid < CH) {
    float mx = -INFINITY;
    for (int s0 = 0; s0 < chunks; s0 += 16) {
      float ms[16];
#pragma unroll
      for (int sb = 0; sb < 16; ++sb)
        ms[sb] = s0 + sb < chunks ? part[(s0 + sb) * kPartial + tid] : -INFINITY;
#pragma unroll
      for (int sb = 0; sb < 16; ++sb) mx = fmaxf(mx, ms[sb]);
    }
    float l = 0.f;
    for (int s0 = 0; s0 < chunks; s0 += 16) {
      float ms[16], ls[16];
#pragma unroll
      for (int sb = 0; sb < 16; ++sb) {
        const bool in = s0 + sb < chunks;
        ms[sb] = in ? part[(s0 + sb) * kPartial + tid] : -INFINITY;
        ls[sb] = in ? part[(s0 + sb) * kPartial + CH + tid] : 0.f;
      }
#pragma unroll
      for (int sb = 0; sb < 16; ++sb)
        l += (ms[sb] > -INFINITY ? expf(ms[sb] - mx) : 0.f) * ls[sb];
    }
    s_m[tid] = mx;
    s_il[tid] = 1.f / l;
  }
  __syncthreads();

  // ---- T (and the sum of D_s), kBatch chunks' loads in flight at a time; a
  // chunk past S adds 0
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    t[u] = 0.f;
    d[u] = 0.f;
  }
  for (int s0 = 0; s0 < chunks; s0 += kBatch) {
    float ms[kBatch][kPer], ts[kBatch][kPer], ds[kBatch][kPer];
#pragma unroll
    for (int sb = 0; sb < kBatch; ++sb) {
      const float* ps = part + (s0 + sb) * kPartial;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int e = tid + u * kThreads;
        const bool in = s0 + sb < chunks && (kPairs % kThreads == 0 || e < kPairs);
        ms[sb][u] = in ? ps[e / CH] : -INFINITY;
        ts[sb][u] = in ? ps[2 * CH + e] : 0.f;
        if constexpr (kGrad) ds[sb][u] = in ? ps[2 * CH + kPairs + e] : 0.f;
      }
    }
#pragma unroll
    for (int sb = 0; sb < kBatch; ++sb)
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int e = tid + u * kThreads;
        const float a = ms[sb][u] > -INFINITY
                            ? expf(ms[sb][u] - s_m[min(e, kPairs - 1) / CH]) : 0.f;
        t[u] += a * ts[sb][u];
        if constexpr (kGrad) d[u] += ds[sb][u];
      }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) t[u] *= s_il[min(tid + u * kThreads, kPairs - 1) / CH];
}

// Forward launch 2: out = scale * q T for one chunk of one (b, h). The grid's
// y is the chunks of this call's n_tok rows; fold is the number of partials
// of a (b, h) in ws, fold_chunks' S: the same chunks, or, under context
// parallelism, every rank's chunks gathered in rank order.
template <typename T, int CH, bool kPad>
__global__ void __launch_bounds__(AttnChunk<CH, false>::kApplyThreads)
    factorized_attention_fwd_apply_kernel(const T* __restrict__ q,
                                          const float* __restrict__ ws,
                                          T* __restrict__ out, int n_tok, int heads,
                                          int ch_arg, int fold, long long batch_stride,
                                          long long row_stride, float scale) {
  using P = AttnChunk<CH, false>;
  using F = Fold<CH, P::kApplyThreads>;
  constexpr int kThreads = P::kApplyThreads;  // this kernel's block
  constexpr int kPitch = P::kPitch;
  constexpr int kTPitch = P::kTPitch;

  __shared__ __align__(16) float s_t[CH * kTPitch];  // s_t[i * kTPitch + j] = T[i][j]
  __shared__ __align__(16) float s_q[CH * kPitch];   // chunk of q, transposed: s_q[c * kPitch + r]
  __shared__ float s_m[CH];                          // M
  __shared__ float s_il[CH];                         // 1 / L

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n0 = blockIdx.y * P::kRows;
  const int rows = min(P::kRows, n_tok - n0);
  const int ch = kPad ? ch_arg : CH;
  q += b * batch_stride + n0 * row_stride + h * ch;

  // ---- stage the chunk of q, transposed: every load of the thread starts
  // before the first store to shared memory
  {
    constexpr int kStage = P::kEl / kThreads;
    float qr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / CH;
      const int c = i % CH;
      if (r < rows) qr[u] = (!kPad || c < ch) ? to_f(q[r * row_stride + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / CH;
      if (r < rows) s_q[(i % CH) * kPitch + r] = qr[u];
    }
  }

  // ---- T = sum a_s T_s / L, once the partials grid has finished and its
  // writes are visible (a no-op when this grid was launched without a
  // programmatic dependency)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  {
    float t[F::kPerThread], unused[F::kPerThread];
    fold_chunks<CH, kThreads, P::kPartial, false>(
        ws + static_cast<long long>(bh) * fold * P::kPartial, fold, s_m, s_il, t, unused);
#pragma unroll
    for (int u = 0; u < F::kPerThread; ++u) {
      const int e = tid + u * kThreads;
      if (F::kPairs % kThreads == 0 || e < F::kPairs) s_t[(e / CH) * kTPitch + e % CH] = t[u];
    }
  }
  __syncthreads();

  // ---- out = scale * q T: 4 rows x 4 columns a thread
  const int r0 = (tid / (CH / 4)) * 4;
  const int c0 = (tid % (CH / 4)) * 4;
  float acc[4][4] = {};
#pragma unroll 8
  for (int i = 0; i < CH; ++i)
    outer4(acc, ld4(s_q + i * kPitch + r0), ld4(s_t + i * kTPitch + c0));
  const int c_all = heads * ch;
  const bool aligned = ch % 4 == 0;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = r0 + x;
    if (r < rows) {
      float o[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) o[y] = acc[x][y] * scale;
      store_cols<kPad>(out + (static_cast<long long>(b) * n_tok + n0 + r) * c_all + h * ch + c0,
                       o, ch - c0, aligned);
    }
  }
}

// Backward launch 2: dq, dk, dv for one chunk of one (b, h); fold as in the
// forward's apply.
template <typename T, int CH, bool kPad>
__global__ void __launch_bounds__(AttnChunk<CH, true>::kApplyThreads) factorized_attention_bwd_apply_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ ws, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int n_tok, int heads, int ch_arg, int fold, long long batch_stride,
    long long row_stride, long long g_batch_stride, long long g_row_stride,
    float scale) {
  using P = AttnChunk<CH, true>;
  using F = Fold<CH, P::kApplyThreads>;
  constexpr int kThreads = P::kApplyThreads;  // this kernel's block
  constexpr int kPitch = P::kPitch;
  constexpr int kPairs = CH * CH;
  constexpr int kTPitch = P::kTPitch;

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
  const int ch = kPad ? ch_arg : CH;
  const long long in_off = b * batch_stride + n0 * row_stride + h * ch;
  k += in_off;
  v += in_off;
  g += b * g_batch_stride + n0 * g_row_stride + h * ch;

  // ---- stage the chunk of k, v, g, transposed: every load of the thread is
  // issued before the first store to shared memory
  {
    constexpr int kStage = P::kEl / kThreads;
    float kr[kStage], vr[kStage], gr[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = tid + u * kThreads;
      const int r = i / CH;
      const int c = i % CH;
      if (r < rows) {
        if (!kPad || c < ch) {
          const long long o = r * row_stride + c;
          kr[u] = to_f(k[o]);
          vr[u] = to_f(v[o]);
          gr[u] = to_f(g[r * g_row_stride + c]);
        } else {
          kr[u] = vr[u] = gr[u] = 0.f;
        }
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

  // ---- T = sum a_s T_s / L and dT = scale * sum D_s; ks = exp(k - M) / L
  {
    float t[F::kPerThread], d[F::kPerThread];
    fold_chunks<CH, kThreads, P::kPartial, true>(
        ws + static_cast<long long>(bh) * fold * P::kPartial, fold, s_m, s_il, t, d);
#pragma unroll
    for (int u = 0; u < F::kPerThread; ++u) {
      const int e = tid + u * kThreads;
      if (kPairs % kThreads == 0 || e < kPairs) {
        const int i = e / CH;
        const int j = e % CH;
        const float dd = d[u] * scale;
        s_tt[j * kTPitch + i] = t[u];
        s_dtt[j * kTPitch + i] = dd;
        s_dt[e] = dd;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < P::kEl / kThreads; ++u) {
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
  const int c_all = heads * ch;
  const bool aligned = ch % 4 == 0;
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
      const long long o = (static_cast<long long>(b) * n_tok + n0 + r) * c_all + h * ch + c0;
      store_cols<kPad>(dq + o, oq, ch - c0, aligned);
      store_cols<kPad>(dv + o, ov, ch - c0, aligned);
      store_cols<kPad>(dk + o, ok, ch - c0, aligned);
    }
  }
}

// Call f(CH, kPad) with compile-time constants for head width ch: MDViT's
// widths (8, 16, 40, 64) as themselves (kPad false), any other ch in 1..64 in
// the next width bucket CH >= ch (kPad true). The launches and the workspace
// size both dispatch here, so they agree on the chunk rows.
template <typename F>
int dispatch_ch(int ch, F&& f) {
  using std::integral_constant;
  using Exact = std::false_type;
  using Pad = std::true_type;
  switch (ch) {
    case 8: return f(integral_constant<int, 8>{}, Exact{});
    case 16: return f(integral_constant<int, 16>{}, Exact{});
    case 40: return f(integral_constant<int, 40>{}, Exact{});
    case 64: return f(integral_constant<int, 64>{}, Exact{});
    default: break;
  }
  if (ch < 1 || ch > 64) return kUnsupported;
  if (ch <= 8) return f(integral_constant<int, 8>{}, Pad{});
  if (ch <= 12) return f(integral_constant<int, 12>{}, Pad{});
  if (ch <= 16) return f(integral_constant<int, 16>{}, Pad{});
  if (ch <= 20) return f(integral_constant<int, 20>{}, Pad{});
  if (ch <= 24) return f(integral_constant<int, 24>{}, Pad{});
  if (ch <= 28) return f(integral_constant<int, 28>{}, Pad{});
  if (ch <= 32) return f(integral_constant<int, 32>{}, Pad{});
  if (ch <= 36) return f(integral_constant<int, 36>{}, Pad{});
  if (ch <= 40) return f(integral_constant<int, 40>{}, Pad{});
  if (ch <= 48) return f(integral_constant<int, 48>{}, Pad{});
  return f(integral_constant<int, 64>{}, Pad{});
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* ws,
               int batch, int n_tok, int heads, int ch, long long batch_stride,
               long long row_stride, float scale, cudaStream_t stream) {
  return dispatch_ch(ch, [&](auto c, auto pad) -> int {
    constexpr int CH = decltype(c)::value;
    constexpr bool kPad = decltype(pad)::value;
    using P = AttnChunk<CH, false>;
    const int chunks = (n_tok + P::kRows - 1) / P::kRows;
    factorized_attention_fwd_partials_kernel<T, CH, kPad>
        <<<batch * heads * chunks, kPartThreads, 0, stream>>>(
            static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(ws),
            n_tok, heads, ch, chunks, batch_stride, row_stride);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    // programmatic dependent launch: the apply's blocks may start while the
    // partials' last blocks run (griddepcontrol in both kernels)
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * heads, chunks);
    cfg.blockDim = dim3(P::kApplyThreads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, factorized_attention_fwd_apply_kernel<T, CH, kPad>, static_cast<const T*>(q),
        static_cast<const float*>(ws), static_cast<T*>(out), n_tok, heads, ch, chunks,
        batch_stride, row_stride, scale));
  });
}

// The launches of the split ops (context parallelism: a collective gathers
// the partials of every rank between them). The apply takes fold partials a
// (b, h) from ws and is an ordinary launch: a programmatic dependency cannot
// span the collective.
template <typename T>
int launch_fwd_partials(const void* k, const void* v, void* ws, int batch, int n_tok,
                        int heads, int ch, long long batch_stride, long long row_stride,
                        cudaStream_t stream) {
  return dispatch_ch(ch, [&](auto c, auto pad) -> int {
    constexpr int CH = decltype(c)::value;
    constexpr bool kPad = decltype(pad)::value;
    using P = AttnChunk<CH, false>;
    const int chunks = (n_tok + P::kRows - 1) / P::kRows;
    factorized_attention_fwd_partials_kernel<T, CH, kPad>
        <<<batch * heads * chunks, kPartThreads, 0, stream>>>(
            static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(ws),
            n_tok, heads, ch, chunks, batch_stride, row_stride);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_fwd_apply(const void* q, const void* ws, void* out, int batch, int n_tok,
                     int heads, int ch, int fold, long long batch_stride,
                     long long row_stride, float scale, cudaStream_t stream) {
  return dispatch_ch(ch, [&](auto c, auto pad) -> int {
    constexpr int CH = decltype(c)::value;
    constexpr bool kPad = decltype(pad)::value;
    using P = AttnChunk<CH, false>;
    const int chunks = (n_tok + P::kRows - 1) / P::kRows;
    factorized_attention_fwd_apply_kernel<T, CH, kPad>
        <<<dim3(batch * heads, chunks), P::kApplyThreads, 0, stream>>>(
            static_cast<const T*>(q), static_cast<const float*>(ws), static_cast<T*>(out),
            n_tok, heads, ch, fold, batch_stride, row_stride, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_bwd_partials(const void* q, const void* k, const void* v, const void* g,
                        void* ws, int batch, int n_tok, int heads, int ch,
                        long long batch_stride, long long row_stride,
                        long long g_batch_stride, long long g_row_stride,
                        cudaStream_t stream) {
  return dispatch_ch(ch, [&](auto c, auto pad) -> int {
    constexpr int CH = decltype(c)::value;
    constexpr bool kPad = decltype(pad)::value;
    using P = AttnChunk<CH, true>;
    const int chunks = (n_tok + P::kRows - 1) / P::kRows;
    factorized_attention_bwd_partials_kernel<T, CH, kPad>
        <<<batch * heads * chunks, kPartThreads, 0, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(g), static_cast<float*>(ws), n_tok, heads, ch, chunks,
            batch_stride, row_stride, g_batch_stride, g_row_stride);
    return static_cast<int>(cudaGetLastError());
  });
}

// The backward's apply, with the dynamic shared memory it needs.
template <typename T, int CH, bool kPad>
int bwd_apply(const T* k, const T* v, const T* g, const float* ws, T* dq, T* dk, T* dv,
              int batch, int n_tok, int heads, int ch, int fold, long long batch_stride,
              long long row_stride, long long g_batch_stride, long long g_row_stride,
              float scale, cudaStream_t stream) {
  using P = AttnChunk<CH, true>;
  const int chunks = (n_tok + P::kRows - 1) / P::kRows;
  constexpr int smem = (2 * CH * P::kTPitch + CH * CH + 3 * CH * P::kPitch + 2 * CH) *
                       static_cast<int>(sizeof(float));
  auto apply = factorized_attention_bwd_apply_kernel<T, CH, kPad>;
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(
        cudaFuncSetAttribute(apply, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err != 0) return err;
  }
  apply<<<dim3(batch * heads, chunks), P::kApplyThreads, smem, stream>>>(
      k, v, g, ws, dq, dk, dv, n_tok, heads, ch, fold, batch_stride, row_stride,
      g_batch_stride, g_row_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_apply(const void* k, const void* v, const void* g, const void* ws,
                     void* dq, void* dk, void* dv, int batch, int n_tok, int heads,
                     int ch, int fold, long long batch_stride, long long row_stride,
                     long long g_batch_stride, long long g_row_stride, float scale,
                     cudaStream_t stream) {
  return dispatch_ch(ch, [&](auto c, auto pad) -> int {
    return bwd_apply<T, decltype(c)::value, decltype(pad)::value>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const float*>(ws), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), batch, n_tok, heads, ch, fold, batch_stride, row_stride,
        g_batch_stride, g_row_stride, scale, stream);
  });
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, void* ws, int batch, int n_tok,
               int heads, int ch, long long batch_stride, long long row_stride,
               long long g_batch_stride, long long g_row_stride, float scale,
               cudaStream_t stream) {
  return dispatch_ch(ch, [&](auto c, auto pad) -> int {
    constexpr int CH = decltype(c)::value;
    constexpr bool kPad = decltype(pad)::value;
    using P = AttnChunk<CH, true>;
    const int chunks = (n_tok + P::kRows - 1) / P::kRows;
    factorized_attention_bwd_partials_kernel<T, CH, kPad>
        <<<batch * heads * chunks, kPartThreads, 0, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(g), static_cast<float*>(ws), n_tok, heads, ch, chunks,
            batch_stride, row_stride, g_batch_stride, g_row_stride);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    return bwd_apply<T, CH, kPad>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const float*>(ws), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), batch, n_tok, heads, ch, chunks, batch_stride, row_stride,
        g_batch_stride, g_row_stride, scale, stream);
  });
}

}  // namespace
}  // namespace mdvit

// q, k, v: (B, N, heads*ch) views with unit channel stride, the given row and
// batch strides (in elements); out: contiguous (B, N, heads*ch); ws: fp32
// workspace of B * heads * mdvit_factorized_attention_workspace(N, ch, 0)
// floats, every entry written by the partials launch before the apply launch
// reads it. Two launches on the stream. Returns the cudaGetLastError() code
// after the launches, or -1 for an unsupported dtype or a ch outside 1..64.
extern "C" int mdvit_factorized_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* out, void* ws,
    int batch, int n_tok, int heads, int ch, long long batch_stride,
    long long row_stride, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch_fwd<float>(q, k, v, out, ws, batch, n_tok, heads, ch,
                                    batch_stride, row_stride, scale, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch_fwd<__nv_bfloat16>(q, k, v, out, ws, batch, n_tok, heads, ch,
                                            batch_stride, row_stride, scale, s);
  return mdvit::kUnsupported;
}

// q, k, v as above; g: (B, N, heads*ch) view with unit channel stride and its
// own batch and row strides; dq, dk, dv: contiguous (B, N, heads*ch); ws: fp32
// workspace of B * heads * mdvit_factorized_attention_workspace(N, ch, 1)
// floats, written by the partials launch before the apply launch reads it. Two launches on the
// stream.
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

// Floats of the workspace of one (batch element, head) at n_tok tokens, with
// CH the width ch runs at (dispatch_ch): chunks * (2 CH + CH^2) for the
// forward (grad 0), chunks * (2 CH + 2 CH^2) for the backward (grad 1),
// chunks = ceil(N / AttnChunk<CH, grad>::kRows). The wrappers size their
// workspaces by it. -1 for a ch outside 1..64.
extern "C" int mdvit_factorized_attention_workspace(int n_tok, int ch, int grad) {
  return mdvit::dispatch_ch(ch, [&](auto c, auto) -> int {
    constexpr int CH = decltype(c)::value;
    using F = mdvit::AttnChunk<CH, false>;
    using B = mdvit::AttnChunk<CH, true>;
    return grad ? (n_tok + B::kRows - 1) / B::kRows * B::kPartial
                : (n_tok + F::kRows - 1) / F::kRows * F::kPartial;
  });
}

// The split launches of context parallelism, each one launch on the stream.
// fwd_partials / bwd_partials write the partials of this call's n_tok rows
// into ws (B * heads * mdvit_factorized_attention_workspace(n_tok, ch, grad)
// floats, the chunks of a (b, h) consecutive); fwd_apply / bwd_apply read
// `fold` partials a (b, h) from ws (B * heads * fold *
// mdvit_factorized_attention_partial(ch, grad) floats: every rank's chunks,
// in rank order) and write this call's rows. Return codes as above.
extern "C" int mdvit_factorized_attention_fwd_partials(
    int dtype, const void* k, const void* v, void* ws, int batch, int n_tok, int heads,
    int ch, long long batch_stride, long long row_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch_fwd_partials<float>(k, v, ws, batch, n_tok, heads, ch,
                                             batch_stride, row_stride, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch_fwd_partials<__nv_bfloat16>(k, v, ws, batch, n_tok, heads, ch,
                                                     batch_stride, row_stride, s);
  return mdvit::kUnsupported;
}

extern "C" int mdvit_factorized_attention_fwd_apply(
    int dtype, const void* q, const void* ws, void* out, int batch, int n_tok, int heads,
    int ch, int fold, long long batch_stride, long long row_stride, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch_fwd_apply<float>(q, ws, out, batch, n_tok, heads, ch, fold,
                                          batch_stride, row_stride, scale, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch_fwd_apply<__nv_bfloat16>(q, ws, out, batch, n_tok, heads, ch, fold,
                                                  batch_stride, row_stride, scale, s);
  return mdvit::kUnsupported;
}

extern "C" int mdvit_factorized_attention_bwd_partials(
    int dtype, const void* q, const void* k, const void* v, const void* g, void* ws,
    int batch, int n_tok, int heads, int ch, long long batch_stride, long long row_stride,
    long long g_batch_stride, long long g_row_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch_bwd_partials<float>(q, k, v, g, ws, batch, n_tok, heads, ch,
                                             batch_stride, row_stride, g_batch_stride,
                                             g_row_stride, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch_bwd_partials<__nv_bfloat16>(q, k, v, g, ws, batch, n_tok, heads,
                                                     ch, batch_stride, row_stride,
                                                     g_batch_stride, g_row_stride, s);
  return mdvit::kUnsupported;
}

extern "C" int mdvit_factorized_attention_bwd_apply(
    int dtype, const void* k, const void* v, const void* g, const void* ws, void* dq,
    void* dk, void* dv, int batch, int n_tok, int heads, int ch, int fold,
    long long batch_stride, long long row_stride, long long g_batch_stride,
    long long g_row_stride, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch_bwd_apply<float>(k, v, g, ws, dq, dk, dv, batch, n_tok, heads, ch,
                                          fold, batch_stride, row_stride, g_batch_stride,
                                          g_row_stride, scale, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch_bwd_apply<__nv_bfloat16>(k, v, g, ws, dq, dk, dv, batch, n_tok,
                                                  heads, ch, fold, batch_stride, row_stride,
                                                  g_batch_stride, g_row_stride, scale, s);
  return mdvit::kUnsupported;
}

// Floats of one (b, h, chunk) partial, AttnChunk<CH, grad>::kPartial, and the
// token rows of a chunk, AttnChunk<CH, grad>::kRows, with CH the width ch
// runs at; -1 for a ch outside 1..64. The wrappers hold their mirror of the
// chunking (ops/factorized_attention.py) to these.
extern "C" int mdvit_factorized_attention_partial(int ch, int grad) {
  return mdvit::dispatch_ch(ch, [&](auto c, auto) -> int {
    constexpr int CH = decltype(c)::value;
    return grad ? mdvit::AttnChunk<CH, true>::kPartial : mdvit::AttnChunk<CH, false>::kPartial;
  });
}

extern "C" int mdvit_factorized_attention_chunk_rows(int ch, int grad) {
  return mdvit::dispatch_ch(ch, [&](auto c, auto) -> int {
    constexpr int CH = decltype(c)::value;
    return grad ? mdvit::AttnChunk<CH, true>::kRows : mdvit::AttnChunk<CH, false>::kRows;
  });
}
