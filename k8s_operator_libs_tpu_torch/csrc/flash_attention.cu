// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of
// k8s_operator_libs_tpu/tpu/flash_attention.py:
//   flash_fwd_kernel     <- _flash_kernel          (flash_attention.py:64-121)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (flash_attention.py:225-274)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (flash_attention.py:277-333)
//
// Layout: q, dO, O, dQ and the dK/dV partials are [b*h, s, d]; k and v are
// [b*hk, s, d] with h = g*hk, and query row bh reads K/V row bh / g (GQA and
// MQA without materialised head repetition). lse and dvec are [b*h, s] fp32.
// Inputs are fp32 or bf16; every product and sum is accumulated in fp32.
//
// What bounds them on the card. At the trainer's shape (b*h 64, s 256, d 64,
// bf16) each kernel moves ~8-13 MB and does ~0.5-1.1 GFLOP, so the least
// time is the memory time, a few microseconds, and launch overhead is what
// a step pays. At long sequences (s 8192) they are bound by operations:
// ~275 GFLOP causal per forward against 989 TFLOP/s of bf16 tensor cores.
//
// What the design does about that. This is the simple, correct first
// version. The TPU grid's sequential axis becomes a loop inside one block,
// and the causal `pl.when` skip becomes that loop's bound, so tiles above
// the diagonal cost nothing. In the forward and dQ each thread owns one
// query row; in dK/dV two threads (four at head dim 128) share a key row,
// each holding its part of the row's K, V, dK and dV, and add their
// partial dot products with a warp shuffle. Rows and accumulators live in
// registers; the tile a block sweeps is staged in shared memory as fp32 and
// read at one address by all threads (a broadcast, free of bank conflicts).
// Dot products keep four partial sums, so a thread has four independent
// FMA chains in flight: at the trainer's shape there are only ~4 warps per
// SM to hide latency with. The products are scalar fp32 FMAs, not
// tensor-core instructions: the
// kernels are far from the operations bound at long sequences, and a later
// version moves them to wgmma with TMA-fed tiles. dQ and dK/dV stay two
// kernels with no atomics, so gradients are deterministic as on the TPU.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNeg = -1e30f;  // the mask value of the JAX package (_NEG)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tile shapes per head dim. kRows: rows a block owns (one thread each in
// the forward and dQ, kDkvSplit threads each in dK/dV). kFwdTile, kDkvTile:
// rows of the swept operand staged in shared memory per loop step.
template <int D>
struct Tiles {
  static constexpr int kRows = D <= 64 ? 64 : 32;
  static constexpr int kFwdTile = D <= 64 ? 32 : 16;
  static constexpr int kDkvTile = 32;
  static constexpr int kDkvSplit = D <= 64 ? 2 : 4;
};

// Stage rows [r0, r0 + R) of a [s, D] matrix into shared memory as fp32;
// rows past s are zero.
template <typename T, int R, int D, int NT>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int r0, int s) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = r0 + idx / D;
    dst[idx] = r < s ? to_f(src[static_cast<size_t>(r) * D + idx % D]) : 0.f;
  }
}

// Dot product of a register row with a shared-memory row (broadcast read).
template <int D>
__device__ __forceinline__ float dot_row(const float (&x)[D], const float* y) {
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four independent chains
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 w = y4[d4];
    a0 = fmaf(x[4 * d4 + 0], w.x, a0);
    a1 = fmaf(x[4 * d4 + 1], w.y, a1);
    a2 = fmaf(x[4 * d4 + 2], w.z, a2);
    a3 = fmaf(x[4 * d4 + 3], w.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// x += a * y for a register row x and a shared-memory row y.
template <int D>
__device__ __forceinline__ void axpy_row(float (&x)[D], float a, const float* y) {
  const float4* y4 = reinterpret_cast<const float4*>(y);
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 w = y4[d4];
    x[4 * d4 + 0] = fmaf(a, w.x, x[4 * d4 + 0]);
    x[4 * d4 + 1] = fmaf(a, w.y, x[4 * d4 + 1]);
    x[4 * d4 + 2] = fmaf(a, w.z, x[4 * d4 + 2]);
    x[4 * d4 + 3] = fmaf(a, w.w, x[4 * d4 + 3]);
  }
}

// Forward: one block per (bh, q-tile), one thread per query row. Folds K/V
// tiles into the online-softmax state (m, l, acc) and writes O and
// lse = m + log l.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kRows) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int g, int causal, float scale) {
  constexpr int BM = Tiles<D>::kRows;
  constexpr int BN = Tiles<D>::kFwdTile;
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int row = q0 + threadIdx.x;
  const bool valid = row < s;
  const T* kb = k + static_cast<size_t>(bh / g) * s * D;
  const T* vb = v + static_cast<size_t>(bh / g) * s * D;

  float qr[D], acc[D];
  const T* qrow = q + (static_cast<size_t>(bh) * s + (valid ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f(qrow[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNeg, l = 0.f;

  // causal: the tile's last row sees keys up to q0 + BM - 1
  const int kv_end = causal ? min(s, q0 + BM) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();
    stage_tile<T, BN, D, BM>(ks, kb, k0, s);
    stage_tile<T, BN, D, BM>(vs, vb, k0, s);
    __syncthreads();

    float sc[BN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const int key = k0 + j;
      const bool keep = key < s && (!causal || key <= row);
      sc[j] = keep ? dot_row<D>(qr, ks + j * D) : kNeg;
      mx = fmaxf(mx, sc[j]);
    }
    const float alpha = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      sc[j] = sc[j] > kNeg ? expf(sc[j] - mx) : 0.f;
      psum += sc[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) axpy_row<D>(acc, sc[j], vs + j * D);
    m = mx;
  }

  if (valid) {
    T* orow = o + (static_cast<size_t>(bh) * s + row) * D;
    const float inv_l = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f<T>(acc[d] * inv_l);
    lse[static_cast<size_t>(bh) * s + row] = m + logf(l);
  }
}

// dQ: one block per (bh, q-tile), one thread per query row, looping over
// k-tiles up to the causal bound. P = exp(S*scale - lse), dP = dO V^T,
// dS = P (dP - dvec) scale, dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kRows) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dq, int s, int g, int causal,
    float scale) {
  constexpr int BM = Tiles<D>::kRows;
  constexpr int BN = Tiles<D>::kFwdTile;
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int row = q0 + threadIdx.x;
  const bool valid = row < s;
  const T* kb = k + static_cast<size_t>(bh / g) * s * D;
  const T* vb = v + static_cast<size_t>(bh / g) * s * D;

  const size_t off = (static_cast<size_t>(bh) * s + (valid ? row : 0)) * D;
  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f(q[off + d]) : 0.f;
    dor[d] = valid ? to_f(dout[off + d]) : 0.f;
    acc[d] = 0.f;
  }
  const size_t ri = static_cast<size_t>(bh) * s + (valid ? row : 0);
  const float lse_r = valid ? lse[ri] : 0.f;
  const float dvec_r = valid ? dvec[ri] : 0.f;

  const int kv_end = causal ? min(s, q0 + BM) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();
    stage_tile<T, BN, D, BM>(ks, kb, k0, s);
    stage_tile<T, BN, D, BM>(vs, vb, k0, s);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const int key = k0 + j;
      const bool keep = valid && key < s && (!causal || key <= row);
      const float p = keep ? expf(dot_row<D>(qr, ks + j * D) * scale - lse_r) : 0.f;
      const float dp = dot_row<D>(dor, vs + j * D);
      axpy_row<D>(acc, p * (dp - dvec_r) * scale, ks + j * D);
    }
  }

  if (valid) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[off + d] = from_f<T>(acc[d]);
  }
}

// dK/dV: one block per (bh, k-tile), P = kDkvSplit threads per key row,
// looping over q-tiles from the diagonal (causal) or from 0. dV += P^T dO,
// dK += dS^T Q, per query head: the caller sums the GQA group's partials.
// Thread (r, part) holds columns [part*H, part*H + H) of key row r's K, V,
// dK and dV; the P partial dot products meet through warp shuffles. The
// staged q-tile rows are split the same way, each part padded by 4 floats
// so the P parts a warp reads at once fall in different banks.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kRows * Tiles<D>::kDkvSplit)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         T* __restrict__ dk, T* __restrict__ dv, int s, int g, int causal,
                         float scale) {
  constexpr int BN = Tiles<D>::kRows;
  constexpr int BM = Tiles<D>::kDkvTile;
  constexpr int P = Tiles<D>::kDkvSplit;
  constexpr int H = D / P;
  constexpr int NT = BN * P;
  constexpr int ROW = P * (H + 4);  // a staged row: P parts of H, each + 4 pad
  __shared__ __align__(16) float qs[BM * ROW];
  __shared__ __align__(16) float dos[BM * ROW];
  __shared__ float ls[BM];
  __shared__ float dvs[BM];

  const int bh = blockIdx.y;
  const int part = threadIdx.x % P;
  const int col = blockIdx.x * BN + threadIdx.x / P;
  const int k0 = blockIdx.x * BN;
  const bool valid = col < s;
  const T* qb = q + static_cast<size_t>(bh) * s * D;
  const T* db = dout + static_cast<size_t>(bh) * s * D;
  const float* lb = lse + static_cast<size_t>(bh) * s;
  const float* vb = dvec + static_cast<size_t>(bh) * s;

  const size_t kv_off =
      (static_cast<size_t>(bh / g) * s + (valid ? col : 0)) * D + part * H;
  float kr[H], vr[H], dka[H], dva[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    kr[j] = valid ? to_f(k[kv_off + j]) : 0.f;
    vr[j] = valid ? to_f(v[kv_off + j]) : 0.f;
    dka[j] = 0.f;
    dva[j] = 0.f;
  }

  // causal: query rows below k0 never see this tile's keys
  for (int i0 = causal ? k0 : 0; i0 < s; i0 += BM) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int at = r * ROW + (c / H) * (H + 4) + c % H;
      const bool in = i0 + r < s;
      const size_t src = static_cast<size_t>(i0 + r) * D + c;
      qs[at] = in ? to_f(qb[src]) : 0.f;
      dos[at] = in ? to_f(db[src]) : 0.f;
    }
    for (int i = threadIdx.x; i < BM; i += NT) {
      ls[i] = i0 + i < s ? lb[i0 + i] : 0.f;
      dvs[i] = i0 + i < s ? vb[i0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < BM; ++i) {
      const int row = i0 + i;
      const bool keep = valid && row < s && (!causal || col <= row);
      const float* qi = qs + i * ROW + part * (H + 4);
      const float* di = dos + i * ROW + part * (H + 4);
      float sdot = dot_row<H>(kr, qi);
      float dp = dot_row<H>(vr, di);
#pragma unroll
      for (int lane = 1; lane < P; lane <<= 1) {  // the row's P parts add up
        sdot += __shfl_xor_sync(0xffffffffu, sdot, lane);
        dp += __shfl_xor_sync(0xffffffffu, dp, lane);
      }
      const float p = keep ? expf(sdot * scale - ls[i]) : 0.f;
      const float ds = p * (dp - dvs[i]) * scale;
      axpy_row<H>(dva, p, di);
      axpy_row<H>(dka, ds, qi);
    }
  }

  if (valid) {
    const size_t off = (static_cast<size_t>(bh) * s + col) * D + part * H;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      dk[off + j] = from_f<T>(dka[j]);
      dv[off + j] = from_f<T>(dva[j]);
    }
  }
}

template <int D>
dim3 grid_for(int bh, int s) {
  return dim3((s + Tiles<D>::kRows - 1) / Tiles<D>::kRows, bh);
}

template <typename T, int D>
void launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                int s, int g, int causal, float scale, cudaStream_t st) {
  flash_fwd_kernel<T, D><<<grid_for<D>(bh, s), Tiles<D>::kRows, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, g, causal, scale);
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dvec, void* dq, int bh, int s, int g,
               int causal, float scale, cudaStream_t st) {
  flash_bwd_dq_kernel<T, D><<<grid_for<D>(bh, s), Tiles<D>::kRows, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dq), s, g, causal, scale);
}

template <typename T, int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* dvec, void* dk, void* dv, int bh, int s,
                int g, int causal, float scale, cudaStream_t st) {
  flash_bwd_dkv_kernel<T, D>
      <<<grid_for<D>(bh, s), Tiles<D>::kRows * Tiles<D>::kDkvSplit, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dk), static_cast<T*>(dv), s, g,
      causal, scale);
}

// Launches LAUNCH<T, D>(...) for the (dtype, head dim) pair, or returns
// cudaErrorInvalidValue from the entry point for a head dim it does not take.
#define FLASH_DISPATCH(LAUNCH, ...)                                   \
  do {                                                                \
    const bool bf = is_bf16 != 0;                                     \
    switch (d) {                                                      \
      case 16:                                                        \
        bf ? LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__)                   \
           : LAUNCH<float, 16>(__VA_ARGS__);                          \
        break;                                                        \
      case 32:                                                        \
        bf ? LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__)                   \
           : LAUNCH<float, 32>(__VA_ARGS__);                          \
        break;                                                        \
      case 64:                                                        \
        bf ? LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__)                   \
           : LAUNCH<float, 64>(__VA_ARGS__);                          \
        break;                                                        \
      case 128:                                                       \
        bf ? LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__)                  \
           : LAUNCH<float, 128>(__VA_ARGS__);                         \
        break;                                                        \
      default:                                                        \
        return static_cast<int>(cudaErrorInvalidValue);               \
    }                                                                 \
  } while (0)

bool bad_shape(int bh, int s, int g) {
  return bh <= 0 || bh > 65535 || s <= 0 || g <= 0 || bh % g != 0;
}

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
              int s, int d, int g, int causal, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, s, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, bh, s, g, causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* dvec, void* dq, int bh, int s, int d, int g,
                 int causal, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, s, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, dvec, dq, bh, s, g, causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* dvec, void* dk, void* dv, int bh, int s,
                  int d, int g, int causal, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, s, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, dvec, dk, dv, bh, s, g, causal, scale,
                 st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
