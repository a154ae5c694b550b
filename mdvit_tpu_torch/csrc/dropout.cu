// Dropout, DropPath and Dropout2d of the port in one pass over x:
//
//   y[e] = kept(counter(e)) ? x[e] * scale : 0
//
// with the mask hashed from element counters (SplitMix32, the JAX package's
// fast_uniform in mdvit_tpu/data/augment.py) as the element is loaded. It
// replaces no Pallas kernel: in the JAX package XLA fuses fast_uniform's
// hash, the compare and the select into one loop over x. In eager PyTorch the
// same formula (ops/layers.py: dropout_ref, and the reference of the
// benchmark's check) runs as ~30 int64 elementwise passes a call; this
// kernel gives its bits on the card (below).
//
// Counters. x is contiguous, n elements; element e has the counter
//
//   key + (e / row) * stride + (e % row) % period        (mod 2^32)
//
// key folds the seed's hash base (seed * 0x9E3779B9) and the first counter
// of this shard; row, stride and period say where the mask broadcasts:
// period = row for an element mask (Dropout; under end-to-end context
// parallelism row is a rank's block of a row-sharded axis and stride the
// unsharded tensor's), period = 1 for one draw a sample (DropPath), period
// = C for one a sample and channel (Dropout2d over NHWC). period divides
// row. A thread divides once, for the first element of its vector, by
// magic multipliers (Granlund and Montgomery); its other elements step the
// remainders.
//
// Bits. The compare is fp32 against float(keep): u = (hash >> 8) * 2^-24 is
// exact in fp32, and PyTorch's `u < keep` compares in u's dtype. The scale
// is 1 / keep in T's opmath (fp32 1 / float(keep) for fp32 and bf16, fp64
// 1 / keep for fp64), and the kept value x * scale rounds once to T:
// PyTorch's CUDA `x / keep` by a host scalar multiplies by that reciprocal
// in opmath. A dropped element is selected 0, not multiplied by a
// mask, so NaN or inf there gives 0 as torch.where does. The backward is
// this kernel on the incoming gradient (where's backward, then the
// divide's: the same products), the mask recomputed, not saved.
//
// Bound: bytes. An element is read once and written once (8 bytes fp32, 4
// bf16) against ~20 integer instructions; each thread moves one 16-byte
// vector each way (4 fp32, 8 bf16 or 2 fp64 elements), or one element
// where the pointers are not 16-byte aligned, and the tail past the last
// whole vector one element a thread.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace mdvit {
namespace {

constexpr int kThreads = 256;
constexpr int kFloat64 = 2;  // beside common.cuh's codes: fp64 dropout only

// the type T's kept value is computed in: PyTorch's opmath
template <typename T>
using OpMath = std::conditional_t<std::is_same_v<T, double>, double, float>;

// n / d for 1 <= d < 2^31 and 0 <= n < 2^31: a multiply-high, an add and a
// shift (the form of PyTorch's IntDivider).
struct Divider {
  unsigned d, magic, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while ((1u << shift) < d) ++shift;
  const uint64_t magic = ((uint64_t{1} << 32) * ((uint64_t{1} << shift) - d)) / d + 1;
  return Divider{d, static_cast<unsigned>(magic), shift};
}

__device__ __forceinline__ unsigned splitmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ bool kept(unsigned counter, float keep) {
  return __uint2float_rn(splitmix32(counter) >> 8) * 0x1p-24f < keep;
}

template <typename T>
__device__ __forceinline__ T apply(T x, unsigned counter, float keep, OpMath<T> scale) {
  if constexpr (std::is_same_v<T, double>)
    return kept(counter, keep) ? x * scale : 0.0;
  else
    return kept(counter, keep) ? from_f<T>(to_f(x) * scale) : from_f<T>(0.f);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int n, unsigned key,
                   Divider row, unsigned stride, Divider period, float keep,
                   OpMath<T> scale) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int whole = n / V;
  if (t < whole) {
    const Vec<T, V> in = reinterpret_cast<const Vec<T, V>*>(x)[t];
    const unsigned e = static_cast<unsigned>(t) * V;
    unsigned r = row.div(e);
    unsigned w = e - r * row.d;
    unsigned m = w - period.div(w) * period.d;
    Vec<T, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out.v[j] = apply(in.v[j], key + r * stride + m, keep, scale);
      if (++m == period.d) m = 0;  // period divides row: m wraps with w
      if (++w == row.d) {
        w = 0;
        ++r;
      }
    }
    reinterpret_cast<Vec<T, V>*>(y)[t] = out;
  }
  if (V > 1 && t < n - whole * V) {
    const unsigned e = static_cast<unsigned>(whole * V + t);
    const unsigned r = row.div(e);
    const unsigned w = e - r * row.d;
    const unsigned m = w - period.div(w) * period.d;
    y[e] = apply(x[e], key + r * stride + m, keep, scale);
  }
}

template <typename T>
int launch(const void* x, void* y, int n, unsigned key, int row, unsigned stride,
           int period, double keep, int vec, cudaStream_t s) {
  if (n <= 0 || row <= 0 || period <= 0 || row % period || n % row) return kUnsupported;
  const float keep_f = static_cast<float>(keep);
  const OpMath<T> scale = OpMath<T>(1) / static_cast<OpMath<T>>(keep);
  const Divider rd = make_divider(row), pd = make_divider(period);
  constexpr int kV = 16 / sizeof(T);
  const int v = vec ? kV : 1;
  const int whole = n / v;
  const int threads = whole > n - whole * v ? whole : n - whole * v;
  const int blocks = (threads + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vec)
    dropout_kernel<T, kV><<<blocks, kThreads, 0, s>>>(xp, yp, n, key, rd, stride, pd, keep_f,
                                                      scale);
  else
    dropout_kernel<T, 1><<<blocks, kThreads, 0, s>>>(xp, yp, n, key, rd, stride, pd, keep_f,
                                                     scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mdvit

// x, y: contiguous, n < 2^31 elements of one dtype (common.cuh's codes, or
// kFloat64); vec: x and y 16-byte
// aligned. Returns a cudaError_t, or kUnsupported for arguments the kernel
// does not take.
extern "C" int mdvit_dropout(int dtype, const void* x, void* y, int n, unsigned key, int row,
                             unsigned stride, int period, double keep, int vec,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mdvit::kFloat32)
    return mdvit::launch<float>(x, y, n, key, row, stride, period, keep, vec, s);
  if (dtype == mdvit::kBFloat16)
    return mdvit::launch<__nv_bfloat16>(x, y, n, key, row, stride, period, keep, vec, s);
  if (dtype == mdvit::kFloat64)
    return mdvit::launch<double>(x, y, n, key, row, stride, period, keep, vec, s);
  return mdvit::kUnsupported;
}
