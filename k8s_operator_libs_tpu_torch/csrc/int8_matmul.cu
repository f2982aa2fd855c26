// Weight-only int8 matmul for the decode path, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package serves an int8 tree by
// dequantizing it inside its jitted decode loop and leaving XLA to fuse the
// cast and scale into each consuming matmul
// (k8s_operator_libs_tpu/tpu/quantize.py:74-84), so that device memory holds
// and streams the int8 tensor. Eager PyTorch does no such fusion: without
// this kernel the port would read a bf16 copy of every weight each step.
//
// Contract (int8_linear_kernel):
//   y[M, N] = x[M, K] . deq(q)[K, N] + bias[N]
// q is int8 [N, K] (torch's row-major [out, in]), s fp32 [N], and
// deq(q)[k, n] = round_to_T(float(q[n, k]) * s[n]), the weight rounded to T
// element by element as JAX's dequantize-then-matmul rounds it. The
// products float(x) * deq accumulate in fp32; the bias (in T, may be null)
// is added and the output rounded to T once. T is bf16 or fp32. Any M >= 1
// and any K, N: a K that is not a multiple of 16 takes byte loads of q, and
// every edge is masked. x and q start on 16-byte boundaries (the wrapper
// checks), so with K % 16 == 0 every row of q and x does too.
//
// What bounds it. On the decode path M is the batch (8 at the smoke
// configuration): 2*M operations per weight byte, against the ~300 per
// byte the card needs before its arithmetic is the limit. So it is a
// matrix-vector product bound by the bytes of q, N*K, over the memory rate.
//
// Design (simple and right first; a faster one is queued in ROADMAP B):
// CUDA cores, no tensor cores. A block of 8 warps owns 32 output rows, four
// per warp, and an M-tile of 8 rows of x (blockIdx.y). The x tile is staged
// in shared memory as fp32, 1024 values of K at a time, each group of 16
// padded to 20 floats, so that a warp's 16-byte shared reads, one group per
// lane, fall on distinct banks. Each lane reads 16 int8 weights of each of
// its 4 rows with one 16-byte load, issued before the chunk's x is staged so
// that the two latencies overlap, dequantizes them in registers four at a
// time, and reuses every x value it reads from shared memory for those 4
// rows. The lanes' 32 partial sums meet in a halving warp-shuffle reduction
// (31 shuffles, one output per lane); each output is written once, with no
// atomics, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                      // warps per block
constexpr int kRowsPerWarp = 4;                // output rows (n) per warp
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMTile = 8;                      // rows of x (m) per block
constexpr int kGroup = 16;                     // K values per 16-byte load of q
constexpr int kChunk = 1024;                   // K values of x staged per pass
constexpr int kGroups = kChunk / kGroup;
constexpr int kGroupStride = kGroup + 4;       // staged floats per group: skewed

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 16 int8 weights of a row of q at k = kb..kb+15, packed as loaded
// (zero past K): one 16-byte load when every row is 16-byte aligned.
__device__ __forceinline__ int4 load_q(const int8_t* __restrict__ qrow, int kb, int K, bool vec) {
  if (kb >= K) return make_int4(0, 0, 0, 0);
  if (vec) return __ldg(reinterpret_cast<const int4*>(qrow + kb));
  int words[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if (kb + j < K) words[j >> 2] |= static_cast<int>(static_cast<uint8_t>(qrow[kb + j])) << (8 * (j & 3));
  return make_int4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ int word(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One step of the warp's halving reduction over 2*kOff values: the lane
// keeps the half its bit kOff selects and adds its partner's copy of it.
template <int kOff>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    int8_linear_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ s, const T* __restrict__ bias,
                       T* __restrict__ y, int M, int K, int N) {
  constexpr int kGroupsPerLane = kGroups / 32;
  __shared__ __align__(16) float xs[kMTile][kGroups * kGroupStride];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int m0 = blockIdx.y * kMTile;
  const int rows = min(kMTile, M - m0);
  const bool vec = K % kGroup == 0;

  float scale[kRowsPerWarp];
  const int8_t* qrow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = min(n0 + r, N - 1);  // rows past N compute row N-1, unwritten
    scale[r] = s[n];
    qrow[r] = q + static_cast<size_t>(n) * K;
  }
  float acc[kRowsPerWarp][kMTile];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int m = 0; m < kMTile; ++m) acc[r][m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    // This chunk's weights first: their loads are in flight while x is staged.
    int4 raw[kGroupsPerLane][kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kGroupsPerLane; ++i)
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        raw[i][r] = load_q(qrow[r], k0 + (lane + 32 * i) * kGroup, K, vec);
    // Stage x[m0 : m0 + 8, k0 : k0 + kChunk] as fp32, zero past M and K.
    if (vec) {
      constexpr int kPer = 16 / sizeof(T);  // values per 16-byte load
      for (int i = threadIdx.x; i < kMTile * kChunk / kPer; i += blockDim.x) {
        const int m = i / (kChunk / kPer), k = i % (kChunk / kPer) * kPer;
        float* dst = &xs[m][k / kGroup * kGroupStride + k % kGroup];
        if (m < rows && k0 + k < K) {  // K % 16 == 0: the whole load is inside
          const int4 raw_x = __ldg(reinterpret_cast<const int4*>(
              x + static_cast<size_t>(m0 + m) * K + k0 + k));
          const T* v = reinterpret_cast<const T*>(&raw_x);
#pragma unroll
          for (int e = 0; e < kPer; ++e) dst[e] = to_float<T>(v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < kPer; ++e) dst[e] = 0.f;
        }
      }
    } else {
      for (int i = threadIdx.x; i < kMTile * kChunk; i += blockDim.x) {
        const int m = i / kChunk, k = i % kChunk;
        xs[m][k / kGroup * kGroupStride + k % kGroup] =
            m < rows && k0 + k < K ? to_float<T>(x[static_cast<size_t>(m0 + m) * K + k0 + k])
                                   : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGroupsPerLane; ++i) {
      const int g = lane + 32 * i;
      if (k0 + g * kGroup >= K) break;
      // Four k at a time: one 32-bit word of each row's weights, one
      // 16-byte read of each staged x row.
#pragma unroll
      for (int j4 = 0; j4 < kGroup / 4; ++j4) {
        float w[kRowsPerWarp][4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int8_t v = static_cast<int8_t>(word(raw[i][r], j4) >> (8 * b));
            w[r][b] = to_float<T>(from_float<T>(static_cast<float>(v) * scale[r]));
          }
#pragma unroll
        for (int m = 0; m < kMTile; ++m) {
          const float4 xv = reinterpret_cast<const float4*>(&xs[m][g * kGroupStride])[j4];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            float a = acc[r][m];
            a = fmaf(xv.x, w[r][0], a);
            a = fmaf(xv.y, w[r][1], a);
            a = fmaf(xv.z, w[r][2], a);
            acc[r][m] = fmaf(xv.w, w[r][3], a);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites xs
  }

  // Sum the 32 accumulators over the warp by halving: at each step a lane
  // keeps half of its values and adds its partner's copy of that half, so
  // after 16 + 8 + 4 + 2 + 1 shuffles lane l holds the sum of value l,
  // which is (r, m) = (l / 8, l % 8).
  float v[kRowsPerWarp * kMTile];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int m = 0; m < kMTile; ++m) v[r * kMTile + m] = acc[r][m];
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  const int r = lane / kMTile, m = lane % kMTile, n = n0 + r;
  if (m < rows && n < N) {
    const float b = bias != nullptr ? to_float<T>(bias[n]) : 0.f;
    y[static_cast<size_t>(m0 + m) * N + n] = from_float<T>(v[0] + b);
  }
}

static_assert(kRowsPerWarp * kMTile == 32, "one output per lane");
static_assert(sizeof(float) * kMTile * kGroups * kGroupStride <= 48 * 1024,
              "static shared memory");
static_assert(kGroups % 32 == 0, "whole groups per lane");

}  // namespace

extern "C" {

// y = x . deq(q)^T + bias; x, y [M, K] / [M, N] in bf16 (is_bf16) or fp32,
// q int8 [N, K], s fp32 [N], bias [N] in x's type or null.
int int8_linear(const void* x, const void* q, const void* s, const void* bias, void* y, int M,
                int K, int N, int is_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (M + kMTile - 1) / kMTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, (M + kMTile - 1) / kMTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    int8_linear_kernel<T><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<const T*>(bias), static_cast<T*>(y), M, K, N);
  } else {
    int8_linear_kernel<float><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<const float*>(bias), static_cast<float*>(y),
        M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
