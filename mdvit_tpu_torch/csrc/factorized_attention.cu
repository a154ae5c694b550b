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
// mdvit_tpu/ops/pallas_attention.py. Per (batch element, head), with
// ks = softmax_n(k), T = ks^T v and the output gradient g:
//
//   pass 1  the column max and sum of exp over N, as the forward;
//   pass 2  T = ks^T v and dT = scale * q^T g (both ch x ch, fp32) in one
//           sweep over N;
//   pass 3  dq = scale * g T^T, dv = ks dT, dk = ks * (v dT^T - inner),
//           with inner[i] = sum_j dT[i, j] T[i, j]: that equals the column
//           sum over N of ks * (v dT^T) the Pallas kernel takes, so no
//           further pass over N is needed.
//
// Bound on this card: memory (10*N*C*ch flops for 7*N*C elements moved). It
// reads k three times and q, v, g twice; dq, dk, dv are written once.
template <typename T, int CH>
__global__ void __launch_bounds__(kThreads) factorized_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, int n_tok, int heads, long long batch_stride,
    long long row_stride, long long g_batch_stride, long long g_row_stride,
    float scale) {
  constexpr int kTile = 512 / CH;          // token rows per shared-memory tile
  constexpr int kTileEl = kTile * CH;
  constexpr int kGroups = kThreads / CH;   // row groups of pass 1
  constexpr int kPairs = CH * CH;
  constexpr int kPairGroups = kPairs >= kThreads ? 1 : kThreads / kPairs;
  constexpr int kPairsPerThread = (kPairs + kThreads - 1) / kThreads;

  __shared__ float s_a[kTileEl];  // ks (pass 2: exp(k - max))
  __shared__ float s_b[kTileEl];  // v
  __shared__ float s_c[kTileEl];  // q in pass 2
  __shared__ float s_d[kTileEl];  // g
  __shared__ float s_t[kPairs];   // T = ks^T v
  __shared__ float s_dt[kPairs];  // dT = scale * q^T g
  __shared__ float s_red[2 * kThreads];
  __shared__ float s_max[CH];
  __shared__ float s_inv[CH];
  __shared__ float s_inner[CH];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const long long in_off = b * batch_stride + h * CH;
  q += in_off;
  k += in_off;
  v += in_off;
  g += b * g_batch_stride + h * CH;
  const int c_all = heads * CH;
  const long long out_off = static_cast<long long>(b) * n_tok * c_all + h * CH;
  dq += out_off;
  dk += out_off;
  dv += out_off;

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
      for (int gi = 0; gi < kGroups; ++gi) mm = fmaxf(mm, s_red[gi * CH + tid]);
      float ss = 0.f;
      for (int gi = 0; gi < kGroups; ++gi) {
        const float mg = s_red[gi * CH + tid];
        if (mg > -INFINITY) ss += s_red[kThreads + gi * CH + tid] * expf(mg - mm);
      }
      s_max[tid] = mm;
      s_inv[tid] = 1.f / ss;
    }
    __syncthreads();
  }

  // ---- pass 2: T and dT in one sweep, fp32 accumulators in registers
  float acc_t[kPairsPerThread];
  float acc_d[kPairsPerThread];
#pragma unroll
  for (int pp = 0; pp < kPairsPerThread; ++pp) {
    acc_t[pp] = 0.f;
    acc_d[pp] = 0.f;
  }
  const int grp2 = kPairGroups > 1 ? tid / kPairs : 0;
  for (int n0 = 0; n0 < n_tok; n0 += kTile) {
    for (int i = tid; i < kTileEl; i += kThreads) {
      const int r = i / CH;
      const int c = i % CH;
      const int n = n0 + r;
      float ke = 0.f, vv = 0.f, qq = 0.f, gg = 0.f;
      if (n < n_tok) {
        ke = expf(to_f(k[n * row_stride + c]) - s_max[c]);
        vv = to_f(v[n * row_stride + c]);
        qq = to_f(q[n * row_stride + c]);
        gg = to_f(g[n * g_row_stride + c]);
      }
      s_a[i] = ke;
      s_b[i] = vv;
      s_c[i] = qq;
      s_d[i] = gg;
    }
    __syncthreads();
    const int rows = min(kTile, n_tok - n0);
    if (kPairGroups > 1) {
      if (grp2 < kPairGroups) {
        const int pi = (tid % kPairs) / CH;
        const int pj = (tid % kPairs) % CH;
        float at = acc_t[0], ad = acc_d[0];
        for (int r = grp2; r < rows; r += kPairGroups) {
          at += s_a[r * CH + pi] * s_b[r * CH + pj];
          ad += s_c[r * CH + pi] * s_d[r * CH + pj];
        }
        acc_t[0] = at;
        acc_d[0] = ad;
      }
    } else {
      for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int pp = 0; pp < kPairsPerThread; ++pp) {
          const int p = tid + pp * kThreads;
          if (p < kPairs) {
            const int pi = p / CH;
            const int pj = p % CH;
            acc_t[pp] += s_a[r * CH + pi] * s_b[r * CH + pj];
            acc_d[pp] += s_c[r * CH + pi] * s_d[r * CH + pj];
          }
        }
      }
    }
    __syncthreads();
  }
  if (kPairGroups > 1) {
    s_red[tid] = (grp2 < kPairGroups ? acc_t[0] : 0.f);
    s_red[kThreads + tid] = (grp2 < kPairGroups ? acc_d[0] : 0.f);
    __syncthreads();
    if (tid < kPairs) {
      float t = 0.f, d = 0.f;
      for (int gi = 0; gi < kPairGroups; ++gi) {
        t += s_red[gi * kPairs + tid];
        d += s_red[kThreads + gi * kPairs + tid];
      }
      s_t[tid] = t * s_inv[tid / CH];
      s_dt[tid] = d * scale;
    }
  } else {
#pragma unroll
    for (int pp = 0; pp < kPairsPerThread; ++pp) {
      const int p = tid + pp * kThreads;
      if (p < kPairs) {
        s_t[p] = acc_t[pp] * s_inv[p / CH];
        s_dt[p] = acc_d[pp] * scale;
      }
    }
  }
  __syncthreads();
  if (tid < CH) {
    float s = 0.f;
    for (int j = 0; j < CH; ++j) s += s_dt[tid * CH + j] * s_t[tid * CH + j];
    s_inner[tid] = s;
  }
  __syncthreads();

  // ---- pass 3: dq, dv, dk, one element (row, column) of each per thread and step
  for (int n0 = 0; n0 < n_tok; n0 += kTile) {
    for (int i = tid; i < kTileEl; i += kThreads) {
      const int r = i / CH;
      const int c = i % CH;
      const int n = n0 + r;
      float ks = 0.f, vv = 0.f, gg = 0.f;
      if (n < n_tok) {
        ks = expf(to_f(k[n * row_stride + c]) - s_max[c]) * s_inv[c];
        vv = to_f(v[n * row_stride + c]);
        gg = to_f(g[n * g_row_stride + c]);
      }
      s_a[i] = ks;
      s_b[i] = vv;
      s_d[i] = gg;
    }
    __syncthreads();
    for (int i = tid; i < kTileEl; i += kThreads) {
      const int r = i / CH;
      const int c = i % CH;
      const int n = n0 + r;
      if (n < n_tok) {
        float oq = 0.f, ov = 0.f, ok = 0.f;
#pragma unroll 8
        for (int j = 0; j < CH; ++j) {
          oq += s_d[r * CH + j] * s_t[c * CH + j];   // (g T^T)[n, c]
          ov += s_a[r * CH + j] * s_dt[j * CH + c];  // (ks dT)[n, c]
          ok += s_b[r * CH + j] * s_dt[c * CH + j];  // (v dT^T)[n, c]
        }
        const long long o = static_cast<long long>(n) * c_all + c;
        dq[o] = from_f<T>(oq * scale);
        dv[o] = from_f<T>(ov);
        dk[o] = from_f<T>(s_a[i] * (ok - s_inner[c]));
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, int batch, int n_tok, int heads,
               int ch, long long batch_stride, long long row_stride,
               long long g_batch_stride, long long g_row_stride, float scale,
               cudaStream_t stream) {
  const dim3 grid(batch * heads);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
#define MDVIT_FA_BWD_CASE(C)                                                    \
  case C:                                                                       \
    factorized_attention_bwd_kernel<T, C><<<grid, kThreads, 0, stream>>>(       \
        qp, kp, vp, gp, dqp, dkp, dvp, n_tok, heads, batch_stride, row_stride, \
        g_batch_stride, g_row_stride, scale);                                   \
    break;
  switch (ch) {
    MDVIT_FA_BWD_CASE(8)
    MDVIT_FA_BWD_CASE(16)
    MDVIT_FA_BWD_CASE(40)
    MDVIT_FA_BWD_CASE(64)
    default:
      return kUnsupported;
  }
#undef MDVIT_FA_BWD_CASE
  return static_cast<int>(cudaGetLastError());
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
// own batch and row strides; dq, dk, dv: contiguous (B, N, heads*ch).
extern "C" int mdvit_factorized_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    void* dq, void* dk, void* dv, int batch, int n_tok, int heads, int ch,
    long long batch_stride, long long row_stride, long long g_batch_stride,
    long long g_row_stride, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch_bwd<float>(q, k, v, g, dq, dk, dv, batch, n_tok, heads,
                                    ch, batch_stride, row_stride, g_batch_stride,
                                    g_row_stride, scale, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch_bwd<__nv_bfloat16>(
        q, k, v, g, dq, dk, dv, batch, n_tok, heads, ch, batch_stride,
        row_stride, g_batch_stride, g_row_stride, scale, s);
  return mdvit::kUnsupported;
}
