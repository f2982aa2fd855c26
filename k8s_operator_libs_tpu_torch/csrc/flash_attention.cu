// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of
// k8s_operator_libs_tpu/tpu/flash_attention.py:
//   flash_fwd_tc_kernel (bf16), flash_fwd_kernel (fp32)
//                        <- _flash_kernel          (flash_attention.py:64-121)
//   flash_bwd_dq_tc_kernel (bf16), flash_bwd_dq_kernel (fp32)
//                        <- _flash_bwd_dq_kernel   (flash_attention.py:225-274)
//   flash_bwd_dkv_tc_kernel (bf16), flash_bwd_dkv_kernel (fp32)
//                        <- _flash_bwd_dkv_kernel  (flash_attention.py:277-333)
// Each entry point (flash_fwd, flash_bwd_dq, flash_bwd_dkv) routes by
// dtype: bf16 to its tensor-core kernel, fp32 to its scalar one. No route
// falls back to the other. Tensor cores take fp32 only as TF32 (~1e-3
// relative), short of the 1e-4 the fp32 kernels are held to, so fp32
// stays scalar.
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
// The bf16 kernels (flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel). Scalar FMAs reach ~13 TFLOP/s, 1/75 of the
// operations bound, so the products move to wgmma: one warpgroup owns a
// 64-row tile (one wgmma M), a q-tile in the forward and dQ, a k-tile in
// dK/dV. That tile is copied once into shared memory; the other side's
// 64-row tiles (K/V, or Q/dO with their lse and dvec) stream through a
// 2-stage ring of cp.async copies, the next tile's copy in flight while
// the current one computes. Every tile is written in wgmma's swizzled
// K-major layout (TcTile), which the descriptors read K-major for Q K^T
// and dO V^T (K Q^T and V dO^T in dK/dV) and MN-major (the transpose bit)
// for P V and dS K (P^T dO and dS^T Q). Scores stay in fp32 registers; the
// online softmax runs there in the exp2 domain with quad shuffles, and P
// or dS (P^T, dS^T) goes to bf16 in registers as the A operand of the next
// wgmma, so no score leaves the SM. Causal: the loop stops at (dK/dV:
// starts from) the diagonal tile, only the diagonal and ragged last tiles
// are masked, and the heaviest tiles launch first. Each kernel accumulates
// in registers and writes its output once: no atomics, deterministic.
//
// The fp32 kernels. This is the simple, correct first version. The TPU
// grid's sequential axis becomes a loop inside one block, and the causal
// `pl.when` skip becomes that loop's bound, so tiles above the diagonal
// cost nothing. In the forward and dQ each thread owns one query row; in
// dK/dV two threads (four at head dim 128) share a key row, each holding
// its part of the row's K, V, dK and dV, and add their partial dot
// products with a warp shuffle. Rows and accumulators live in registers;
// the tile a block sweeps is staged in shared memory as fp32 and read at
// one address by all threads (a broadcast, free of bank conflicts). Dot
// products keep four partial sums, so a thread has four independent FMA
// chains in flight. The products are scalar fp32 FMAs: TF32 would miss the
// fp32 bound. dQ and dK/dV stay two kernels with no atomics, so gradients
// are deterministic as on the TPU.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_mma.cuh"

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

// ------------------------------------------------- bf16 kernels on wgmma

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTcRows = 64;      // query rows of a block: one wgmma M
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcKeys = 64;      // rows of a K/V tile

// An [R, D] bf16 tile in shared memory, in wgmma's canonical layout with
// the widest swizzle its rows take: rows of W = min(2D, 128) bytes (swizzle
// 32B, 64B or 128B), and at D 128 two 64-column blocks one after the other.
// The 16-byte chunk c of row r sits at r*W + 16c with offset bits [4, 4 +
// log2(W/16)) XORed with bits [7, ...): the address swizzle the hardware
// undoes, so tiles start on 1024-byte boundaries. The same tile is read
// K-major (rows are M or N, columns the reduction: Q, dO, K, V in Q K^T and
// dO V^T) and MN-major (rows are the reduction: V in P V, K in dS K).
template <int R, int D>
struct TcTile {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks in a block row
  static constexpr int kBlockBytes = R * kRowBytes;
  static constexpr int kBytes = R * D * 2;
  static constexpr uint32_t kSwizzle = kRowBytes == 128  ? hopper::kSwizzle128B
                                       : kRowBytes == 64 ? hopper::kSwizzle64B
                                                         : hopper::kSwizzle32B;
  static_assert(R % 8 == 0 && kBytes % 1024 == 0, "tiles keep 1024-byte alignment");

  // Byte offset of chunk c (elements [8c, 8c + 8)) of row r.
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    const uint32_t off = (c / kChunks) * kBlockBytes + r * kRowBytes + (c % kChunks) * 16;
    return off ^ (((off >> 7) & (kChunks - 1)) << 4);
  }

  // Copies rows [r0, r0 + R) of a row-major [s, D] matrix to the tile at
  // base; rows past s are zero.
  __device__ __forceinline__ static void load(uint32_t base, const __nv_bfloat16* src, int r0,
                                              int s) {
    for (int i = threadIdx.x; i < R * D / 8; i += kTcThreads) {
      const int r = i / (D / 8), c = i % (D / 8);
      const bool in = r0 + r < s;
      hopper::cp_async_16(base + offset(r, c),
                          src + static_cast<size_t>(in ? r0 + r : 0) * D + c * 8, in ? 16 : 0);
    }
  }

  // Descriptor of reduction step kk (columns [16kk, 16kk + 16)), K-major.
  __device__ __forceinline__ static uint64_t kmajor(uint32_t base, int kk) {
    const int at = kk * 32;
    return hopper::make_desc(base + (at / kRowBytes) * kBlockBytes + at % kRowBytes, 16,
                             8 * kRowBytes, kSwizzle);
  }

  // Descriptor of reduction step kk (rows [16kk, 16kk + 16)), MN-major:
  // the N = D columns span the column blocks, kBlockBytes apart.
  __device__ __forceinline__ static uint64_t mnmajor(uint32_t base, int kk) {
    return hopper::make_desc(base + kk * 16 * kRowBytes, kBlockBytes, 8 * kRowBytes, kSwizzle);
  }
};

__device__ __forceinline__ uint32_t align_1024(uint32_t addr) {
  return (addr + 1023) & ~1023u;
}

// A 2-stage ring: waits for tile t (and what was copied with it), after
// load_next(t + 1) has started the copy of tile t + 1 into the other stage.
template <typename Load>
__device__ __forceinline__ void ring_next(const Load& load_next, int t, int n_tiles) {
  if (t + 1 < n_tiles) {
    load_next(t + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
  } else {
    hopper::cp_async_wait<0>();
  }
  hopper::fence_proxy_async();
  __syncthreads();
}

// The forward's and dQ's K/V ring: K/V tile u into stage u & 1.
template <typename KT>
__device__ __forceinline__ void next_kv_tile(uint32_t sk, uint32_t sv, const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb, int t, int n_tiles,
                                             int s) {
  ring_next(
      [&](int u) {
        const uint32_t at = (u & 1) * KT::kBytes;
        KT::load(sk + at, kb, u * kTcKeys, s);
        KT::load(sv + at, vb, u * kTcKeys, s);
      },
      t, n_tiles);
}

// Whether tile k0 holds a key that some row of q-tile q0 must not see.
__device__ __forceinline__ bool tile_masked(int k0, int q0, int s, int causal) {
  return (causal && k0 + kTcKeys - 1 > q0) || k0 + kTcKeys > s;
}

// Forward on the tensor cores: one warpgroup per (bh, 64-row q-tile).
// Thread (warp w, lane l) owns rows row0 = q0 + 16w + l/4 and row0 + 8.
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int s, int g, int causal, float scale) {
  using QT = TcTile<kTcRows, D>;
  using KT = TcTile<kTcKeys, D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = align_1024(hopper::smem_u32(smem_raw));
  const uint32_t sk = sq + QT::kBytes;      // K stages 0 and 1
  const uint32_t sv = sk + 2 * KT::kBytes;  // V stages 0 and 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest q-tile first
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh / g) * s * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh / g) * s * D;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);  // accumulator columns 8j + col0 + {0, 1}
  const int kv_end = causal ? min(s, q0 + kTcRows) : s;
  const int n_tiles = (kv_end + kTcKeys - 1) / kTcKeys;

  QT::load(sq, q + static_cast<size_t>(bh) * s * D, q0, s);
  KT::load(sk, kb, 0, s);
  KT::load(sv, vb, 0, s);
  hopper::cp_async_commit();

  const float c = scale * kLog2e;  // scores in the exp2 domain
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    next_kv_tile<KT>(sk, sv, kb, vb, t, n_tiles, s);
    const uint32_t kt = sk + (t & 1) * KT::kBytes, vt = sv + (t & 1) * KT::kBytes;

    float sc[kTcKeys / 2];  // S = Q K^T
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<kTcKeys>::ss(sc, QT::kmajor(sq, kk), KT::kmajor(kt, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    const int k0 = t * kTcKeys;
    const bool masked = tile_masked(k0, q0, s, causal);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * c;
        const int key = k0 + 8 * j + col0 + (e & 1);
        if (masked && (key >= s || (causal && key > row0 + 8 * (e >> 1)))) x = kNeg;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 4 threads share its max
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
    uint32_t pa[kTcKeys / 16][4];  // P in bf16: the A operand of P V
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - m[e >> 1]);
        l[e >> 1] += sc[4 * j + e];
      }
      pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    hopper::wgmma_fence();  // O += P V
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
      hopper::Wgmma<D>::rs(acc, pa[kk], KT::mnmajor(vt, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    __syncthreads();  // the stage is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < s) {
      const float inv_l = 1.f / l[i];
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * s + row) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            hopper::pack_bf16(acc[4 * j + 2 * i] * inv_l, acc[4 * j + 2 * i + 1] * inv_l);
      }
      // natural log, as the backward kernels and flash_attention_lse read it
      if (lane % 4 == 0) lse[static_cast<size_t>(bh) * s + row] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

// dQ on the tensor cores: one warpgroup per (bh, 64-row q-tile), looping
// k-tiles to the causal bound. Per tile S = Q K^T and dP = dO V^T (wgmma),
// P = exp2(S scale log2e - lse log2e), dS = P (dP - dvec) scale in fp32,
// then dQ += dS K (wgmma, dS from registers). dQ is written once.
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dq, int s, int g, int causal, float scale) {
  using QT = TcTile<kTcRows, D>;
  using KT = TcTile<kTcKeys, D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = align_1024(hopper::smem_u32(smem_raw));
  const uint32_t sdo = sq + QT::kBytes;
  const uint32_t sk = sdo + QT::kBytes;     // K stages 0 and 1
  const uint32_t sv = sk + 2 * KT::kBytes;  // V stages 0 and 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest q-tile first
  const size_t qoff = static_cast<size_t>(bh) * s * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh / g) * s * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh / g) * s * D;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int kv_end = causal ? min(s, q0 + kTcRows) : s;
  const int n_tiles = (kv_end + kTcKeys - 1) / kTcKeys;

  QT::load(sq, q + qoff, q0, s);
  QT::load(sdo, dout + qoff, q0, s);
  KT::load(sk, kb, 0, s);
  KT::load(sv, vb, 0, s);
  hopper::cp_async_commit();

  const float c = scale * kLog2e;
  float lse2[2], dvr[2];  // the rows' lse (exp2 domain) and dvec
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t at = static_cast<size_t>(bh) * s + (row < s ? row : 0);
    lse2[i] = row < s ? lse[at] * kLog2e : 0.f;
    dvr[i] = row < s ? dvec[at] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    next_kv_tile<KT>(sk, sv, kb, vb, t, n_tiles, s);
    const uint32_t kt = sk + (t & 1) * KT::kBytes, vt = sv + (t & 1) * KT::kBytes;

    float sc[kTcKeys / 2], dp[kTcKeys / 2];  // S = Q K^T, dP = dO V^T
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<kTcKeys>::ss(sc, QT::kmajor(sq, kk), KT::kmajor(kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<kTcKeys>::ss(dp, QT::kmajor(sdo, kk), KT::kmajor(vt, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    const int k0 = t * kTcKeys;
    const bool masked = tile_masked(k0, q0, s, causal);
    uint32_t da[kTcKeys / 16][4];  // dS in bf16: the A operand of dS K
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(sc[4 * j + e] * c - lse2[e >> 1]);
        const int key = k0 + 8 * j + col0 + (e & 1);
        if (masked && (key >= s || (causal && key > row0 + 8 * (e >> 1)))) p = 0.f;
        ds[e] = p * (dp[4 * j + e] - dvr[e >> 1]) * scale;
      }
      da[j / 2][2 * (j % 2)] = hopper::pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
    }

    hopper::wgmma_fence();  // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
      hopper::Wgmma<D>::rs(acc, da[kk], KT::mnmajor(kt, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(da);
    __syncthreads();  // the stage is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < s) {
      __nv_bfloat16* drow = dq + qoff + static_cast<size_t>(row) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(drow + 8 * j) =
            hopper::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// dK/dV on the tensor cores: one warpgroup per (bh, 64-key tile), looping
// q-tiles from the diagonal (causal) or from 0. Per q-tile S^T = K Q^T and
// dP^T = V dO^T (wgmma), P^T = exp2(S^T scale log2e - lse log2e) and
// dS^T = P^T (dP^T - dvec) scale in fp32, then dV += P^T dO and dK +=
// dS^T Q (wgmma, P^T and dS^T from registers, dO and Q read MN-major).
// The partials are per query head: the caller sums the GQA group's.
// Thread (warp w, lane l) owns key rows key0 = k0 + 16w + l/4 and key0 +
// 8; its accumulator columns are query rows, so it reads 16 lse and 16
// dvec values per q-tile. Those rows are staged in shared memory beside
// the Q and dO tiles by 4-byte copies: a row of lse starts 16-byte
// aligned only when s % 4 == 0.
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s, int g, int causal,
    float scale) {
  using KT = TcTile<kTcKeys, D>;
  using QT = TcTile<kTcRows, D>;
  static_assert(kTcThreads == 2 * kTcRows, "a thread copies one lse or dvec value");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sk = align_1024(raw);
  const uint32_t sv = sk + KT::kBytes;
  const uint32_t sq = sv + KT::kBytes;          // Q stages 0 and 1
  const uint32_t sdo = sq + 2 * QT::kBytes;     // dO stages 0 and 1
  const uint32_t srows = sdo + 2 * QT::kBytes;  // per stage: lse[64], then dvec[64]
  const float* rows = reinterpret_cast<const float*>(smem_raw + (srows - raw));

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTcKeys;  // causal: k-tile 0 sees every q-tile, and goes first
  const size_t qoff = static_cast<size_t>(bh) * s * D;
  const size_t kvoff = static_cast<size_t>(bh / g) * s * D;
  const float* lb = lse + static_cast<size_t>(bh) * s;
  const float* db = dvec + static_cast<size_t>(bh) * s;
  const int lane = threadIdx.x % 32;
  const int key0 = k0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);      // accumulator columns 8j + col0 + {0, 1}
  const int i_begin = causal ? k0 : 0;  // query rows below k0 never see these keys
  const int n_tiles = (s - i_begin + kTcRows - 1) / kTcRows;

  // q-tile u into stage u & 1: its Q and dO rows, and its lse and dvec
  // (one value per thread; rows past s are zero)
  const auto load_q_tile = [&](int u) {
    const int i0 = i_begin + u * kTcRows;
    const uint32_t at = (u & 1) * QT::kBytes;
    QT::load(sq + at, q + qoff, i0, s);
    QT::load(sdo + at, dout + qoff, i0, s);
    const int i = i0 + threadIdx.x % kTcRows;
    const float* src = threadIdx.x < kTcRows ? lb : db;
    hopper::cp_async_4(srows + ((u & 1) * kTcThreads + threadIdx.x) * 4, src + (i < s ? i : 0),
                       i < s ? 4 : 0);
  };
  KT::load(sk, k + kvoff, k0, s);
  KT::load(sv, v + kvoff, k0, s);
  load_q_tile(0);
  hopper::cp_async_commit();

  const float c = scale * kLog2e;  // scores in the exp2 domain
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    ring_next(load_q_tile, t, n_tiles);
    const uint32_t qt = sq + (t & 1) * QT::kBytes, dt = sdo + (t & 1) * QT::kBytes;
    const float* lr = rows + (t & 1) * kTcThreads;  // lse; dvec at lr + kTcRows

    float st[kTcRows / 2], dpt[kTcRows / 2];  // S^T = K Q^T, dP^T = V dO^T
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<kTcRows>::ss(st, KT::kmajor(sk, kk), QT::kmajor(qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<kTcRows>::ss(dpt, KT::kmajor(sv, kk), QT::kmajor(dt, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    const int i0 = i_begin + t * kTcRows;
    // only the diagonal q-tile holds a query row above one of the keys,
    // and only the last one rows past s
    const bool masked = (causal && i0 < k0 + kTcKeys - 1) || i0 + kTcRows > s;
    uint32_t pa[kTcRows / 16][4], da[kTcRows / 16][4];  // P^T, dS^T in bf16: A operands
#pragma unroll
    for (int j = 0; j < kTcRows / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * j + col0);
      const float2 d2 = *reinterpret_cast<const float2*>(lr + kTcRows + 8 * j + col0);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + 8 * j + col0 + (e & 1);
        p[e] = exp2f(st[4 * j + e] * c - ((e & 1) ? l2.y : l2.x) * kLog2e);
        if (masked && (row >= s || (causal && key0 + 8 * (e >> 1) > row))) p[e] = 0.f;
        ds[e] = p[e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
      pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p[2], p[3]);
      da[j / 2][2 * (j % 2)] = hopper::pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
    }

    hopper::wgmma_fence();  // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk)
      hopper::Wgmma<D>::rs(dva, pa[kk], QT::mnmajor(dt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk)
      hopper::Wgmma<D>::rs(dka, da[kk], QT::mnmajor(qt, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    __syncthreads();  // the stage is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key < s) {
      const size_t at = qoff + static_cast<size_t>(key) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
            hopper::pack_bf16(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
            hopper::pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    }
  }
}

// Dynamic shared memory above 48 KB must be allowed before a launch, once
// per kernel and device; a refusal stays in cudaGetLastError, which the
// entry point returns.
template <auto Kernel>
void allow_smem(int bytes) {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  if (bytes <= 48 * 1024 || cudaGetDevice(&dev) != cudaSuccess) return;
  if (dev < kMaxDevices && allowed[dev]) return;
  if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
          cudaSuccess &&
      dev < kMaxDevices) {
    allowed[dev] = true;
  }
}

// A tc kernel's grid: bh fastest, then 64-row tiles (q-tiles in the
// forward and dQ, k-tiles in dK/dV), so that every row's heaviest tile is
// dispatched before any lighter one.
static_assert(kTcRows == kTcKeys, "q-tiles and k-tiles share the grid");
inline dim3 tc_grid(int bh, int s) { return dim3(bh, (s + kTcRows - 1) / kTcRows); }

template <int D>
void launch_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int s, int g, int causal, float scale, cudaStream_t st) {
  constexpr int smem = TcTile<kTcRows, D>::kBytes + 4 * TcTile<kTcKeys, D>::kBytes + 1024;
  allow_smem<flash_fwd_tc_kernel<D>>(smem);
  flash_fwd_tc_kernel<D><<<tc_grid(bh, s), kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s, g, causal, scale);
}

template <int D>
void launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* dvec, void* dq, int bh, int s, int g,
                  int causal, float scale, cudaStream_t st) {
  constexpr int smem = 2 * TcTile<kTcRows, D>::kBytes + 4 * TcTile<kTcKeys, D>::kBytes + 1024;
  allow_smem<flash_bwd_dq_tc_kernel<D>>(smem);
  flash_bwd_dq_tc_kernel<D><<<tc_grid(bh, s), kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dq), s, g, causal, scale);
}

template <int D>
void launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dvec, void* dk, void* dv, int bh, int s, int g,
                   int causal, float scale, cudaStream_t st) {
  // K, V; two stages of Q, dO and the lse/dvec rows
  constexpr int smem = 2 * TcTile<kTcKeys, D>::kBytes + 4 * TcTile<kTcRows, D>::kBytes +
                       2 * kTcThreads * static_cast<int>(sizeof(float)) + 1024;
  allow_smem<flash_bwd_dkv_tc_kernel<D>>(smem);
  flash_bwd_dkv_tc_kernel<D><<<tc_grid(bh, s), kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s, g, causal, scale);
}

// ------------------------------------------------------------ launchers

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

// Each entry point routes by dtype: bf16 to its tensor-core kernel, fp32
// to its scalar one.
template <typename T, int D>
void route_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int s,
               int g, int causal, float scale, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    launch_fwd_tc<D>(q, k, v, o, lse, bh, s, g, causal, scale, st);
  } else {
    launch_fwd<T, D>(q, k, v, o, lse, bh, s, g, causal, scale, st);
  }
}

template <typename T, int D>
void route_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dvec, void* dq, int bh, int s, int g, int causal, float scale,
              cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    launch_dq_tc<D>(q, k, v, dout, lse, dvec, dq, bh, s, g, causal, scale, st);
  } else {
    launch_dq<T, D>(q, k, v, dout, lse, dvec, dq, bh, s, g, causal, scale, st);
  }
}

template <typename T, int D>
void route_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dvec, void* dk, void* dv, int bh, int s, int g, int causal,
               float scale, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    launch_dkv_tc<D>(q, k, v, dout, lse, dvec, dk, dv, bh, s, g, causal, scale, st);
  } else {
    launch_dkv<T, D>(q, k, v, dout, lse, dvec, dk, dv, bh, s, g, causal, scale, st);
  }
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
  FLASH_DISPATCH(route_fwd, q, k, v, o, lse, bh, s, g, causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* dvec, void* dq, int bh, int s, int d, int g,
                 int causal, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, s, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(route_dq, q, k, v, dout, lse, dvec, dq, bh, s, g, causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* dvec, void* dk, void* dv, int bh, int s,
                  int d, int g, int causal, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, s, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(route_dkv, q, k, v, dout, lse, dvec, dk, dv, bh, s, g, causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
