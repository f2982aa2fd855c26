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
// Head dims 16, 32, 64, 128 and 256 are compiled; the wrapper zero-pads
// any other up to 256 to the next of them.
//
// Layout: q, dO, O, dQ and the dK/dV partials are [b*h, s, d]; k and v are
// [b*hk, s, d] with h = g*hk, and query row bh reads K/V row bh / g (GQA and
// MQA without materialised head repetition). lse and dvec are [b*h, s] fp32.
// Inputs are fp32 or bf16; every product and sum is accumulated in fp32.
//
// What bounds them on the card. At the trainer's shape (b*h 64, s 256, d 64,
// bf16) each kernel moves ~8-13 MB and does ~0.5-1.1 GFLOP, so the least
// time is the memory time, a few microseconds; what a call pays beyond it
// is its launch and the serial chain of its heaviest block (4 K/V tiles of
// 64 keys for a forward or dQ block: load, scores, exponentials, product).
// At long sequences (s 8192) they are bound by operations: ~275 GFLOP
// causal per forward against 989 TFLOP/s of bf16 tensor cores, and a tile's
// exponentials take the SM about as long as its products.
//
// The bf16 kernels (flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel). Scalar FMAs reach ~13 TFLOP/s, 1/75 of the
// operations bound, so the products move to wgmma. Every tile is written
// in wgmma's swizzled K-major layout (TcTile), which the descriptors read
// K-major for Q K^T and dO V^T (K Q^T and V dO^T in dK/dV) and MN-major
// (the transpose bit) for P V and dS K (P^T dO and dS^T Q). Scores stay in
// fp32 registers; the online softmax runs there in the exp2 domain with
// quad shuffles, and P or dS (P^T, dS^T) goes to bf16 in registers as the
// A operand of the next wgmma, so no score leaves the SM. Causal: the loop
// stops at (dK/dV: starts from) the diagonal tile, only the diagonal and
// ragged last tiles are masked, and the heaviest tiles launch first. Each
// kernel accumulates in registers and writes its output once: no atomics,
// deterministic.
//
// The forward and dQ (RowTc). One warpgroup owns a 64-row q-tile (one
// wgmma M), and a block is that warpgroup alone, so that an SM keeps three
// of them where shared memory allows (dQ two at head dim 128 and one at
// 256, the forward two at 256). Run in series, a tile's scores, exponentials and product leave the
// tensor cores idle while the exponentials run, and the reverse, unless
// another block fills the gap. So one elected thread issues every load by
// TMA: Q (and dO) once, K/V tiles into a ring of stages under
// full/empty mbarriers; a stage is refilled once every thread has
// released it, after the product that reads it completed, and no
// __syncthreads is left in the loop. The scores are taken a unit of keys
// at a time, and the next unit's S (and dP) is issued into a second score
// buffer before this unit's exponentials (dS) run on the waited one, so
// the tensor cores work through them; then this unit's P V (dS K) is
// issued and both are waited. The unit loop is unrolled by two so that
// each buffer is named at compile time. ptxas serializes the wgmma (C7515)
// if any other instruction writes an accumulator between a wgmma's issue
// and its wait: so the forward takes the rows' max and rescales O before
// it issues the next S, and reads the scores without writing them back.
// The units are 64 keys in the forward (32 at head dim 128 and 256, so
// that more blocks fit) and 32 in dQ, whose S and dP of two units must fit
// beside dQ in 168 registers; where two blocks an SM hold dQ's whole grid
// (the trainer's shape), dQ takes 64-key units at two blocks an SM
// instead, which halves its chain (head dims up to 64). Every head dim, in
// every plan, issues the next unit's scores before this unit's softmax.
//
// dK/dV is warp-specialised. What held its first design back: one
// warpgroup owned 64 keys and did everything in series for each q-tile --
// wait for its own cp.async copies, S^T and dP^T on wgmma, the exponentials,
// dV and dK on wgmma, a __syncthreads -- so the tensor cores idled while
// the exponentials ran and the copies cost the same 128 threads
// instructions and registers; and each 64-key tile restaged every Q and
// dO tile it swept, so over a sequence Q and dO were read s/64 times. Now
// a block is a producer warpgroup and two consumer warpgroups (384
// threads; setmaxnreg moves the producer's registers to the consumers):
// one producer thread keeps TMA loads of Q and dO in flight in a ring of
// stages under full/empty mbarriers, and the two consumers, 64 keys each,
// share every staged tile, so Q and dO are read s/128 times and one
// consumer's exponentials can run while the other's wgmma do. A consumer
// issues the next q-tile's S^T and dP^T before it waits on this tile's
// dK/dV; at head dim 128, where dK and dV of 128 columns take 128
// registers, a whole tile's scores would not fit beside them without a
// spill, so there it goes by halves of 32 query rows. At head dim 256 the
// ring has one stage (K and V of 128 keys take 128 KB and a stage 64 KB,
// so two stages would pass 227 KB): there the next q-tile's scores wait
// until this tile's stage is released and refilled, and a consumer runs
// serially, by halves. What this design does not do yet (PERF.md):
// with one block of 384 threads an SM runs two consumer warpgroups, where
// the first design ran three blocks of one, and a q-tile's chain of
// scores, exponentials and dK/dV stays as long, so at the shapes timed it
// is slower than the first design.
//
// The fp32 kernels. This is the simple, correct first version. The TPU
// grid's sequential axis becomes a loop inside one block, and the causal
// `pl.when` skip becomes that loop's bound, so tiles above the diagonal
// cost nothing. In the forward and dQ each thread owns one query row (at
// head dim 256 eight threads share it); in dK/dV two threads (four at
// head dim 128, eight at 256) share a key row, each holding its part of
// the row's K, V, dK and dV, and add their partial dot products with a
// warp shuffle. Rows and accumulators live in registers;
// the tile a block sweeps is staged in shared memory as fp32 and read at
// one address by all threads (a broadcast, free of bank conflicts). Dot
// products keep four partial sums, so a thread has four independent FMA
// chains in flight. The products are scalar fp32 FMAs: TF32 would miss the
// fp32 bound. dQ and dK/dV stay two kernels with no atomics, so gradients
// are deterministic as on the TPU.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
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

// Tile shapes per head dim. kRows: rows a block owns (kFwdSplit threads
// each in the forward and dQ, kDkvSplit threads each in dK/dV). kFwdTile,
// kDkvTile: rows of the swept operand staged in shared memory per loop
// step. At head dim 256 a whole fp32 row of O (or of dQ, with Q and dO
// beside it) would take 512+ registers a thread, so eight threads share a
// row there, each holding 32 columns; the dK/dV tile halves to keep the
// staged Q and dO within the 48 KB of static shared memory.
template <int D>
struct Tiles {
  static constexpr int kRows = D <= 64 ? 64 : 32;
  static constexpr int kFwdTile = D <= 64 ? 32 : 16;
  static constexpr int kFwdSplit = D <= 128 ? 1 : 8;
  static constexpr int kDkvTile = D <= 128 ? 32 : 16;
  static constexpr int kDkvSplit = D <= 64 ? 2 : D <= 128 ? 4 : 8;
};

// A staged fp32 row split into P parts of kPart columns, one part a thread.
// With P > 1 each part is padded by 4 floats, so that the parts a warp
// reads at once fall in different banks.
template <int D, int P>
struct SplitRow {
  static constexpr int kPart = D / P;
  static constexpr int kPad = P > 1 ? 4 : 0;
  static constexpr int kRow = P * (kPart + kPad);  // floats of a staged row
  __device__ __forceinline__ static int at(int r, int c) {
    return r * kRow + (c / kPart) * (kPart + kPad) + c % kPart;
  }
  __device__ __forceinline__ static int part(int p) { return p * (kPart + kPad); }
};

// Stage rows [r0, r0 + R) of a [s, D] matrix into shared memory as fp32,
// split in P parts; rows past s are zero.
template <typename T, int R, int D, int NT, int P>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int r0, int s) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    if constexpr (P == 1) {
      const int r = r0 + idx / D;
      dst[idx] = r < s ? to_f(src[static_cast<size_t>(r) * D + idx % D]) : 0.f;
    } else {
      const int r = idx / D, c = idx % D;
      dst[SplitRow<D, P>::at(r, c)] =
          r0 + r < s ? to_f(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
    }
  }
}

// The sum of a value over the P threads that share a row (a butterfly: each
// thread ends with the same sum, added in the same order).
template <int P>
__device__ __forceinline__ float part_sum(float x) {
#pragma unroll
  for (int lane = 1; lane < P; lane <<= 1) x += __shfl_xor_sync(0xffffffffu, x, lane);
  return x;
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

// Forward: one block per (bh, q-tile), P = kFwdSplit threads per query
// row, each holding its part of the row's Q and O. Folds K/V tiles into the
// online-softmax state (m, l, acc) and writes O and lse = m + log l.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kRows * Tiles<D>::kFwdSplit) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int s, int g, int causal, float scale) {
  constexpr int BM = Tiles<D>::kRows;
  constexpr int BN = Tiles<D>::kFwdTile;
  constexpr int P = Tiles<D>::kFwdSplit;
  using SR = SplitRow<D, P>;
  constexpr int H = SR::kPart;
  __shared__ __align__(16) float ks[BN * SR::kRow];
  __shared__ __align__(16) float vs[BN * SR::kRow];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int part = threadIdx.x % P;
  const int row = q0 + threadIdx.x / P;
  const bool valid = row < s;
  const T* kb = k + static_cast<size_t>(bh / g) * s * D;
  const T* vb = v + static_cast<size_t>(bh / g) * s * D;

  float qr[H], acc[H];
  const T* qrow = q + (static_cast<size_t>(bh) * s + (valid ? row : 0)) * D + part * H;
#pragma unroll
  for (int d = 0; d < H; ++d) {
    qr[d] = valid ? to_f(qrow[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNeg, l = 0.f;

  // causal: the tile's last row sees keys up to q0 + BM - 1
  const int kv_end = causal ? min(s, q0 + BM) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();
    stage_tile<T, BN, D, BM * P, P>(ks, kb, k0, s);
    stage_tile<T, BN, D, BM * P, P>(vs, vb, k0, s);
    __syncthreads();

    float sc[BN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const int key = k0 + j;
      const bool keep = key < s && (!causal || key <= row);
      if constexpr (P == 1) {
        sc[j] = keep ? dot_row<H>(qr, ks + j * D) : kNeg;
      } else {  // every part joins the shuffle, kept or not
        const float dot = part_sum<P>(dot_row<H>(qr, ks + j * SR::kRow + SR::part(part)));
        sc[j] = keep ? dot : kNeg;
      }
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
    for (int d = 0; d < H; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) axpy_row<H>(acc, sc[j], vs + j * SR::kRow + SR::part(part));
    m = mx;
  }

  if (valid) {
    T* orow = o + (static_cast<size_t>(bh) * s + row) * D + part * H;
    const float inv_l = 1.f / l;
#pragma unroll
    for (int d = 0; d < H; ++d) orow[d] = from_f<T>(acc[d] * inv_l);
    if (part == 0) lse[static_cast<size_t>(bh) * s + row] = m + logf(l);
  }
}

// dQ: one block per (bh, q-tile), P = kFwdSplit threads per query row,
// looping over k-tiles up to the causal bound. P = exp(S*scale - lse),
// dP = dO V^T, dS = P (dP - dvec) scale, dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<D>::kRows * Tiles<D>::kFwdSplit) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dq, int s, int g, int causal,
    float scale) {
  constexpr int BM = Tiles<D>::kRows;
  constexpr int BN = Tiles<D>::kFwdTile;
  constexpr int P = Tiles<D>::kFwdSplit;
  using SR = SplitRow<D, P>;
  constexpr int H = SR::kPart;
  __shared__ __align__(16) float ks[BN * SR::kRow];
  __shared__ __align__(16) float vs[BN * SR::kRow];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int part = threadIdx.x % P;
  const int row = q0 + threadIdx.x / P;
  const bool valid = row < s;
  const T* kb = k + static_cast<size_t>(bh / g) * s * D;
  const T* vb = v + static_cast<size_t>(bh / g) * s * D;

  const size_t off = (static_cast<size_t>(bh) * s + (valid ? row : 0)) * D + part * H;
  float qr[H], dor[H], acc[H];
#pragma unroll
  for (int d = 0; d < H; ++d) {
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
    stage_tile<T, BN, D, BM * P, P>(ks, kb, k0, s);
    stage_tile<T, BN, D, BM * P, P>(vs, vb, k0, s);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const int key = k0 + j;
      const bool keep = valid && key < s && (!causal || key <= row);
      const float* kj = ks + j * SR::kRow + SR::part(part);
      float p, dp;
      if constexpr (P == 1) {
        p = keep ? expf(dot_row<H>(qr, kj) * scale - lse_r) : 0.f;
        dp = dot_row<H>(dor, vs + j * D);
      } else {  // every part joins the shuffles, kept or not
        const float sdot = part_sum<P>(dot_row<H>(qr, kj));
        dp = part_sum<P>(dot_row<H>(dor, vs + j * SR::kRow + SR::part(part)));
        p = keep ? expf(sdot * scale - lse_r) : 0.f;
      }
      axpy_row<H>(acc, p * (dp - dvec_r) * scale, kj);
    }
  }

  if (valid) {
#pragma unroll
    for (int d = 0; d < H; ++d) dq[off + d] = from_f<T>(acc[d]);
  }
}

// dK/dV: one block per (bh, k-tile), P = kDkvSplit threads per key row,
// looping over q-tiles from the diagonal (causal) or from 0. dV += P^T dO,
// dK += dS^T Q, per query head: the caller sums the GQA group's partials.
// Thread (r, part) holds columns [part*H, part*H + H) of key row r's K, V,
// dK and dV; the P partial dot products meet through warp shuffles. The
// staged q-tile rows are split the same way (SplitRow).
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
  using SR = SplitRow<D, P>;
  constexpr int H = SR::kPart;
  constexpr int NT = BN * P;
  __shared__ __align__(16) float qs[BM * SR::kRow];
  __shared__ __align__(16) float dos[BM * SR::kRow];
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
      const int at = SR::at(r, c);
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
      const float* qi = qs + i * SR::kRow + SR::part(part);
      const float* di = dos + i * SR::kRow + SR::part(part);
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
constexpr int kTcKeys = 64;      // keys of a dK/dV consumer warpgroup

// An [R, D] bf16 tile in shared memory, in wgmma's canonical layout with
// the widest swizzle its rows take: rows of W = min(2D, 128) bytes (swizzle
// 32B, 64B or 128B), and at D 128 and 256 64-column blocks one after the
// other.
// The 16-byte chunk c of row r sits at r*W + 16c with offset bits [4, 4 +
// log2(W/16)) XORed with bits [7, ...): the address swizzle the hardware
// undoes, so tiles start on 1024-byte boundaries. The same tile is read
// K-major (rows are M or N, columns the reduction: Q, dO, K, V in Q K^T and
// dO V^T) and MN-major (rows are the reduction: V in P V, K in dS K).
template <int R, int D>
struct TcTile {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kBlockBytes = R * kRowBytes;
  static constexpr int kBytes = R * D * 2;
  static constexpr uint32_t kSwizzle = kRowBytes == 128  ? hopper::kSwizzle128B
                                       : kRowBytes == 64 ? hopper::kSwizzle64B
                                                         : hopper::kSwizzle32B;
  static_assert(R % 8 == 0 && kBytes % 1024 == 0, "tiles keep 1024-byte alignment");

  // Descriptor of reduction step kk (columns [16kk, 16kk + 16)), K-major.
  __device__ __forceinline__ static uint64_t kmajor(uint32_t base, int kk) {
    const int at = kk * 32;
    return hopper::make_desc(base + (at / kRowBytes) * kBlockBytes + at % kRowBytes, 16,
                             8 * kRowBytes, kSwizzle);
  }

  // Descriptor of reduction step kk (rows [16kk, 16kk + 16)), MN-major:
  // the N columns span the column blocks, kBlockBytes apart.
  __device__ __forceinline__ static uint64_t mnmajor(uint32_t base, int kk) {
    return hopper::make_desc(base + kk * 16 * kRowBytes, kBlockBytes, 8 * kRowBytes, kSwizzle);
  }

  // Offset of column c0 (a multiple of a column block's width): the base
  // of an MN-major operand whose N columns start there.
  __device__ __forceinline__ static uint32_t columns(int c0) {
    return (c0 / (kRowBytes / 2)) * kBlockBytes;
  }
};

// Output columns a tc block owns. A 64-row fp32 accumulator of N columns
// takes N / 2 registers a thread; at head dim 256 two of them (dK and dV)
// would take all 255, and one beside S and dP leaves too few. So above 128
// a block owns 128 columns of its output, blockIdx.z saying which, and
// recomputes S (and dP) over the whole head dim; every tc kernel then
// keeps the register budget it has at head dim 128, where ptxas fits it
// without a spill. The column base comes from blockIdx, so descriptor
// bases stay uniform.
template <int D>
struct TcCols {
  static constexpr int kCols = D < 128 ? D : 128;
  static constexpr int kSplits = D / kCols;
  __device__ __forceinline__ static int first() { return kSplits > 1 ? blockIdx.z * kCols : 0; }
};

__device__ __forceinline__ uint32_t align_1024(uint32_t addr) {
  return (addr + 1023) & ~1023u;
}

// The forward's and dQ's plan, per head dim (kDq: dQ's; kWide: dQ's plan
// for a grid that two blocks an SM hold, below). A block is one warpgroup
// owning a 64-row q-tile. Its K/V tiles of kKeys rows stream through a ring
// of kStages stages, each guarded by a full and an empty mbarrier; the
// scores are taken kUnit keys at a time (one wgmma N), the next unit's
// issued before this unit's softmax into the other of two score buffers.
// Registers set dQ's unit: it holds S and dP of two units beside dQ, so its
// units are 32 keys where three blocks share an SM (168 registers a
// thread), and 64 keys in the wide plan, two blocks an SM, which halves a
// block's chain (head dim 64 and below: above, 64-key units spill). Shared
// memory sets the forward's at head dim 128 and 256: stages of 32 keys let
// three blocks share an SM at 128 and two at 256, where 64-key stages let
// two and one. Three stages, and 128-key tiles, were slower (PERF.md §6).
template <int D, bool kDq, bool kWide = false>
struct RowTc {
  static constexpr int kD = D;
  static constexpr int kKeys = !kDq && D >= 128 ? 32 : 64;  // K/V rows of a stage: one TMA box
  static constexpr int kUnit = kDq ? (kWide ? 64 : 32) : D >= 128 ? 32 : 64;  // keys of a product
  static constexpr int kStages = 2;
  using QT = TcTile<kTcRows, D>;
  using KT = TcTile<kKeys, D>;
  // shared memory, from a 1024-byte boundary
  static constexpr int kQ = 0;                                // Q, then dO in dQ
  static constexpr int kK = kQ + (kDq ? 2 : 1) * QT::kBytes;  // K stages
  static constexpr int kV = kK + kStages * KT::kBytes;        // V stages
  static constexpr int kBars = kV + kStages * KT::kBytes;     // full, empty, then Q's
  static constexpr int kSmem = kBars + (2 * kStages + 1) * 8 + 1024;
  // the blocks an SM's 228 KB hold (1 KB reserved a block), at most 3
  // (2 wide): __launch_bounds__ then leaves each thread 65,536 / (128 kBlocks)
  static constexpr int kFit = 233472 / (kSmem + 1024);
  static constexpr int kMost = kWide ? 2 : 3;
  static constexpr int kBlocks = kFit < kMost ? kFit : kMost;
  // a stage is refilled only once released: with one stage the next
  // tile's scores would wait on a stage that is never released
  static_assert(kStages >= 2 && kKeys % kUnit == 0 && kUnit % 16 == 0, "the ring's shape");
  static_assert(kSmem <= 232448 && kBlocks >= 1, "a block's shared memory");
};

// The ring of a forward or dQ block: the stages, their barriers, the K/V
// tensor maps and the KV head.
struct KvRing {
  uint32_t sq, sk, sv;        // Q (dO after it), the K and V stages
  uint32_t full, empty, q_full;
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  int head;                   // the K/V row, bh / g
};

// TMA of K/V tile t (rows [t kKeys, + kKeys)) into stage t % kStages: one
// box of a TcTile column block each, rows past s written as zeros.
template <typename P>
__device__ __forceinline__ void load_kv(const KvRing& r, int t) {
  using KT = typename P::KT;
  constexpr int kBoxCols = KT::kRowBytes / 2;
  const int stage = t % P::kStages;
  const uint32_t fb = r.full + 8 * stage;
  hopper::mbar_arrive_expect_tx(fb, 2 * KT::kBytes);
#pragma unroll
  for (int j = 0; j < KT::kBytes / KT::kBlockBytes; ++j) {
    const uint32_t at = stage * KT::kBytes + j * KT::kBlockBytes;
    hopper::tma_load_3d(r.sk + at, r.k_map, fb, j * kBoxCols, t * P::kKeys, r.head);
    hopper::tma_load_3d(r.sv + at, r.v_map, fb, j * kBoxCols, t * P::kKeys, r.head);
  }
}

// Sets up a block's ring: thread 0 initialises the barriers, then issues
// the q-tile's Q (and dO) and the first kStages K/V tiles. The one
// __syncthreads of the kernel is here.
template <typename P>
__device__ __forceinline__ KvRing ring_start(const CUtensorMap* q_map, const CUtensorMap* do_map,
                                             const CUtensorMap* k_map, const CUtensorMap* v_map,
                                             int bh, int g, int q0, int n_tiles) {
  using QT = typename P::QT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = align_1024(hopper::smem_u32(smem_raw));
  const uint32_t full = base + P::kBars, empty = full + 8 * P::kStages;
  const KvRing r{base + P::kQ, base + P::kK, base + P::kV, full, empty,
                 empty + 8 * P::kStages, k_map, v_map, bh / g};
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kStages; ++i) {
      hopper::mbar_init(full + 8 * i, 1);              // the loading thread, with the bytes
      hopper::mbar_init(empty + 8 * i, kTcThreads);    // every thread, done reading
    }
    hopper::mbar_init(r.q_full, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(q_map);
    hopper::prefetch_tensormap(k_map);
    hopper::prefetch_tensormap(v_map);
    if (do_map != nullptr) hopper::prefetch_tensormap(do_map);
    constexpr int kBoxCols = QT::kRowBytes / 2;
    const int n_q = do_map != nullptr ? 2 : 1;
    hopper::mbar_arrive_expect_tx(r.q_full, n_q * QT::kBytes);
#pragma unroll
    for (int j = 0; j < QT::kBytes / QT::kBlockBytes; ++j) {
      hopper::tma_load_3d(r.sq + j * QT::kBlockBytes, q_map, r.q_full, j * kBoxCols, q0, bh);
      if (do_map != nullptr)
        hopper::tma_load_3d(r.sq + QT::kBytes + j * QT::kBlockBytes, do_map, r.q_full,
                            j * kBoxCols, q0, bh);
    }
    for (int t = 0; t < P::kStages && t < n_tiles; ++t) load_kv<P>(r, t);
  }
  return r;
}

// After the last unit of tile t: every thread releases its stage, and
// thread 0 refills it with tile t + kStages once all have. The warp
// reconverges before its next wgmma.
template <typename P>
__device__ __forceinline__ void ring_release(const KvRing& r, int t, int n_tiles) {
  const int stage = t % P::kStages;
  hopper::mbar_arrive(r.empty + 8 * stage);
  if (threadIdx.x == 0 && t + P::kStages < n_tiles) {
    hopper::mbar_wait(r.empty + 8 * stage, (t / P::kStages) & 1);
    load_kv<P>(r, t + P::kStages);
  }
  __syncwarp();
}

// Where unit u lies: its tile, the tile's stage, its first row there.
template <typename P>
struct Unit {
  int t, stage, row;
  __device__ __forceinline__ explicit Unit(int u)
      : t(u * P::kUnit / P::kKeys), stage(t % P::kStages), row(u * P::kUnit % P::kKeys) {}
  // whether the unit ends its tile (or the block's units)
  __device__ __forceinline__ static bool last(int u, int n_units) {
    return u + 1 == n_units || (u + 1) * P::kUnit % P::kKeys == 0;
  }
};

// Waits for unit u's tile when the unit is the tile's first.
template <typename P>
__device__ __forceinline__ void wait_tile(const KvRing& r, const Unit<P>& at) {
  if (at.row == 0) hopper::mbar_wait(r.full + 8 * at.stage, (at.t / P::kStages) & 1);
}

// Whether the N keys from k0 hold one that some row of q-tile q0 must not see.
template <int N>
__device__ __forceinline__ bool unit_masked(int k0, int q0, int s, int causal) {
  return (causal && k0 + N - 1 > q0) || k0 + N > s;
}

// Forward: S = Q K^T of unit u, issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void fwd_scores(float (&x)[RowTc<D, false>::kUnit / 2],
                                           const KvRing& r, int u) {
  using P = RowTc<D, false>;
  const Unit<P> at(u);
  wait_tile(r, at);
  const uint32_t kt = r.sk + at.stage * P::KT::kBytes + at.row * P::KT::kRowBytes;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::Wgmma<P::kUnit>::ss(x, P::QT::kmajor(r.sq, kk), P::KT::kmajor(kt, kk), kk > 0);
  hopper::wgmma_commit();
}

// A forward thread's rows: (warp w, lane l) owns rows row0 = q0 + 16w +
// l/4 and row0 + 8, accumulator columns 8j + col0 + {0, 1}.
struct RowThread {
  int q0, row0, col0, s, causal;
};

// Forward unit u from its scores x (waited). The rows' new max, alpha and
// the rescale of acc and l come first, while no product is in flight; then
// unit u + 1's S is issued into y, and this unit's exponentials run beside
// it (P rounded to bf16 in pa; x is only read, so
// no accumulator of the window is written but by wgmma). O += P V is
// issued, and everything waited. The stage is released after the tile's
// last unit.
template <int D>
__device__ __forceinline__ void fwd_unit(float (&x)[RowTc<D, false>::kUnit / 2],
                                         float (&y)[RowTc<D, false>::kUnit / 2],
                                         uint32_t (&pa)[RowTc<D, false>::kUnit / 16][4],
                                         float (&acc)[TcCols<D>::kCols / 2], float (&m)[2],
                                         float (&l)[2], const KvRing& r, const RowThread& th,
                                         uint32_t vcols, float c, int u, int n_units,
                                         int n_tiles) {
  using P = RowTc<D, false>;
  constexpr int N = P::kUnit, DC = TcCols<D>::kCols;
  const Unit<P> at(u);
  const int k0 = u * N;
  const bool masked = unit_masked<N>(k0, th.q0, th.s, th.causal);
  // whether element (j, e) is a key the row must not see
  const auto hidden = [&](int j, int e) {
    const int key = k0 + 8 * j + th.col0 + (e & 1);
    return masked && (key >= th.s || (th.causal && key > th.row0 + 8 * (e >> 1)));
  };
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1], hidden(j, e) ? kNeg : x[4 * j + e] * c);
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
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

  if (u + 1 < n_units) fwd_scores<D>(y, r, u + 1);
  // key 0, in every row's first unit, is seen by every row, so m is finite
  // and a hidden key's exp2(kNeg - m) would be 0: it is selected as 0
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = hidden(j, e) ? 0.f : exp2f(x[4 * j + e] * c - m[e >> 1]);
      l[e >> 1] += p[e];
    }
    pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p[2], p[3]);
  }

  const uint32_t vt = r.sv + at.stage * P::KT::kBytes + vcols;
  hopper::wgmma_fence();  // O += P V
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::Wgmma<DC>::rs(acc, pa[kk], P::KT::mnmajor(vt, at.row / 16 + kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(y);
  hopper::fence_regs(acc);
  hopper::fence_regs(pa);
  if (Unit<P>::last(u, n_units)) ring_release<P>(r, at.t, n_tiles);
}

// Forward on the tensor cores: one warpgroup per (bh, 64-row q-tile),
// K/V on a TMA ring (RowTc). Units alternate between the score buffers sa
// and sb, the loop unrolled by two so that each is named at compile time.
template <int D>
__global__ void __launch_bounds__(kTcThreads, RowTc<D, false>::kBlocks) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int s, int g, int causal, float scale) {
  using P = RowTc<D, false>;
  constexpr int N = P::kUnit;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest q-tile first
  const int lane = threadIdx.x % 32;
  const RowThread th{q0, q0 + (static_cast<int>(threadIdx.x) / 32) * 16 + lane / 4,
                     2 * (lane % 4), s, causal};
  const int kv_end = causal ? min(s, q0 + kTcRows) : s;
  const int n_units = (kv_end + N - 1) / N;
  const int n_tiles = (kv_end + P::kKeys - 1) / P::kKeys;
  const KvRing r = ring_start<P>(&q_map, nullptr, &k_map, &v_map, bh, g, q0, n_tiles);
  constexpr int DC = TcCols<D>::kCols;  // O columns [c0, c0 + DC) are this block's
  const int c0 = TcCols<D>::first();
  const uint32_t vcols = P::KT::columns(c0);

  const float c = scale * kLog2e;  // scores in the exp2 domain
  float acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float sa[N / 2], sb[N / 2];
  uint32_t pa[N / 16][4];  // P in bf16: the A operand of P V

  hopper::mbar_wait(r.q_full, 0);
  fwd_scores<D>(sa, r, 0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sa);
  for (int u = 0; u < n_units; u += 2) {
    fwd_unit<D>(sa, sb, pa, acc, m, l, r, th, vcols, c, u, n_units, n_tiles);
    if (u + 1 == n_units) break;
    fwd_unit<D>(sb, sa, pa, acc, m, l, r, th, vcols, c, u + 1, n_units, n_tiles);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = th.row0 + 8 * i;
    if (row < s) {
      const float inv_l = 1.f / l[i];
      __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * s + row) * D + c0 + th.col0;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            hopper::pack_bf16(acc[4 * j + 2 * i] * inv_l, acc[4 * j + 2 * i + 1] * inv_l);
      }
      // natural log, as the backward kernels and flash_attention_lse read it
      if (lane % 4 == 0 && c0 == 0)
        lse[static_cast<size_t>(bh) * s + row] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

// dQ: S = Q K^T and dP = dO V^T of unit u, issued and committed together,
// not waited for.
template <typename P>
__device__ __forceinline__ void dq_scores(float (&x)[P::kUnit / 2], float (&dx)[P::kUnit / 2],
                                          const KvRing& r, int u) {
  constexpr int D = P::kD;
  const Unit<P> at(u);
  wait_tile(r, at);
  const uint32_t rows = at.stage * P::KT::kBytes + at.row * P::KT::kRowBytes;
  const uint32_t sdo = r.sq + P::QT::kBytes;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::Wgmma<P::kUnit>::ss(x, P::QT::kmajor(r.sq, kk), P::KT::kmajor(r.sk + rows, kk),
                                kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::Wgmma<P::kUnit>::ss(dx, P::QT::kmajor(sdo, kk), P::KT::kmajor(r.sv + rows, kk),
                                kk > 0);
  hopper::wgmma_commit();
}

// dQ unit u from its S and dP (x, dx; waited): unit u + 1's are issued
// into (y, dy) first. Then P = exp2(S scale log2e - lse log2e)
// and dS = P (dP - dvec) scale in fp32, rounded to bf16 in da, dQ += dS K
// issued (K read MN-major), and everything waited; the stage is released
// after the tile's last unit.
template <typename P>
__device__ __forceinline__ void dq_unit(float (&x)[P::kUnit / 2], float (&dx)[P::kUnit / 2],
                                        float (&y)[P::kUnit / 2], float (&dy)[P::kUnit / 2],
                                        uint32_t (&da)[P::kUnit / 16][4],
                                        float (&acc)[TcCols<P::kD>::kCols / 2],
                                        const float (&lse2)[2], const float (&dvr)[2],
                                        const KvRing& r, const RowThread& th, uint32_t kcols,
                                        float c, float scale, int u, int n_units, int n_tiles) {
  constexpr int N = P::kUnit, DC = TcCols<P::kD>::kCols;
  if (u + 1 < n_units) dq_scores<P>(y, dy, r, u + 1);

  const Unit<P> at(u);
  const int k0 = u * N;
  const bool masked = unit_masked<N>(k0, th.q0, th.s, th.causal);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(x[4 * j + e] * c - lse2[e >> 1]);
      const int key = k0 + 8 * j + th.col0 + (e & 1);
      if (masked && (key >= th.s || (th.causal && key > th.row0 + 8 * (e >> 1)))) p = 0.f;
      ds[e] = p * (dx[4 * j + e] - dvr[e >> 1]) * scale;
    }
    da[j / 2][2 * (j % 2)] = hopper::pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
  }

  const uint32_t kt = r.sk + at.stage * P::KT::kBytes + kcols;
  hopper::wgmma_fence();  // dQ += dS K
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    hopper::Wgmma<DC>::rs(acc, da[kk], P::KT::mnmajor(kt, at.row / 16 + kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(y);
  hopper::fence_regs(dy);
  hopper::fence_regs(acc);
  hopper::fence_regs(da);
  if (Unit<P>::last(u, n_units)) ring_release<P>(r, at.t, n_tiles);
}

// dQ on the tensor cores: one warpgroup per (bh, 64-row q-tile), Q and dO
// once and K/V on a TMA ring (RowTc, wide or not), looping units to the
// causal bound. dQ is written once.
template <int D, bool kWide>
__global__ void __launch_bounds__(kTcThreads, RowTc<D, true, kWide>::kBlocks)
    flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dq, int s, int g, int causal, float scale) {
  using P = RowTc<D, true, kWide>;
  constexpr int N = P::kUnit;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest q-tile first
  const int lane = threadIdx.x % 32;
  const RowThread th{q0, q0 + (static_cast<int>(threadIdx.x) / 32) * 16 + lane / 4,
                     2 * (lane % 4), s, causal};
  const int kv_end = causal ? min(s, q0 + kTcRows) : s;
  const int n_units = (kv_end + N - 1) / N;
  const int n_tiles = (kv_end + P::kKeys - 1) / P::kKeys;
  const KvRing r = ring_start<P>(&q_map, &do_map, &k_map, &v_map, bh, g, q0, n_tiles);

  constexpr int DC = TcCols<D>::kCols;  // dQ columns [c0, c0 + DC) are this block's
  const int c0 = TcCols<D>::first();
  const uint32_t kcols = P::KT::columns(c0);
  const float c = scale * kLog2e;
  float lse2[2], dvr[2];  // the rows' lse (exp2 domain) and dvec
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = th.row0 + 8 * i;
    const size_t at = static_cast<size_t>(bh) * s + (row < s ? row : 0);
    lse2[i] = row < s ? lse[at] * kLog2e : 0.f;
    dvr[i] = row < s ? dvec[at] : 0.f;
  }
  float acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;
  float sa[N / 2], dpa[N / 2], sb[N / 2], dpb[N / 2];  // S, dP of two units
  uint32_t da[N / 16][4];  // dS in bf16: the A operand of dS K

  hopper::mbar_wait(r.q_full, 0);
  dq_scores<P>(sa, dpa, r, 0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sa);
  hopper::fence_regs(dpa);
  for (int u = 0; u < n_units; u += 2) {
    dq_unit<P>(sa, dpa, sb, dpb, da, acc, lse2, dvr, r, th, kcols, c, scale, u, n_units, n_tiles);
    if (u + 1 == n_units) break;
    dq_unit<P>(sb, dpb, sa, dpa, da, acc, lse2, dvr, r, th, kcols, c, scale, u + 1, n_units,
               n_tiles);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = th.row0 + 8 * i;
    if (row < s) {
      __nv_bfloat16* drow = dq + (static_cast<size_t>(bh) * s + row) * D + c0 + th.col0;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        *reinterpret_cast<uint32_t*>(drow + 8 * j) =
            hopper::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// dK/dV on the tensor cores, warp-specialised: one block per (bh, tile of
// kConsumers x 64 keys, column split). Warpgroup 0 produces: after
// setmaxnreg lowers its registers, one thread issues TMA loads (K and V of
// the block's keys once, then each q-tile's Q and dO into a ring of
// kStages stages, each guarded by a full and an empty mbarrier), and its
// warp brings the q-tile's lse and dvec rows (a bulk copy when every row
// starts 16-byte aligned, else 4-byte cp.async by the warp's 32 lanes,
// each arriving on the same full barrier). Warpgroups 1.. consume: after
// setmaxnreg raises their registers, consumer c owns keys [kc, kc + 64),
// kc = k0 + 64c, and for each q-tile computes S^T = K Q^T and dP^T = V dO^T
// (wgmma), P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T -
// dvec) scale in fp32, then dV += P^T dO and dK += dS^T Q (wgmma, P^T and
// dS^T from registers, dO and Q read MN-major), and releases the stage on
// its empty barrier once those have read it. Both consumers read each
// staged tile. A consumer takes a q-tile in units of kUnitRows query rows
// (the whole tile, or at 128 accumulator columns each half), and issues
// the next unit's S^T and dP^T before it waits on this unit's dK/dV,
// except with a ring of one stage (head dim 256), where it runs serially.
// Causal: q-tiles wholly above a
// consumer's keys (consumer 1's first) are skipped, the stage still
// released; a consumer whose keys all lie past s computes and writes
// nothing. The partials are per query head: the caller sums the GQA
// group's. Thread (warp w, lane l) of a consumer owns key rows key0 = kc +
// 16w + l/4 and key0 + 8; its accumulator columns are query rows, so it
// reads 16 lse and 16 dvec values per q-tile from the stage.
template <int D>
struct DkvTc {
  static constexpr int kConsumers = 2;  // warpgroups of 64 keys sharing each stage
  static constexpr int kKeys = kConsumers * kTcKeys;
  // Q/dO stages. At head dim 256, K and V of 128 keys take 128 KB and a
  // stage 64 KB: two stages would pass the 227 KB a block may have.
  static constexpr int kStages = D <= 128 ? 2 : 1;
  // A consumer takes a q-tile in kHalves units of kUnitRows query rows:
  // beside accumulators of 128 columns (dK and dV take 128 registers) the
  // next unit's scores fit without a spill only for half a q-tile.
  static constexpr int kHalves = TcCols<D>::kCols > 64 ? 2 : 1;
  static constexpr int kUnitRows = kTcRows / kHalves;
  static constexpr int kThreads = (1 + kConsumers) * kTcThreads;
  // setmaxnreg: of the launch's 168 registers a thread (65,536 / 384) the
  // producer keeps 40 (at 24 ptxas spilled) and the consumers take 232
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  using KT = TcTile<kTcKeys, D>;
  using QT = TcTile<kTcRows, D>;
  static constexpr int kRowFloats = 2 * kTcRows;  // a stage's lse[64], then dvec[64]
  // shared memory, from a 1024-byte boundary
  static constexpr int kK = 0;                                  // K: a tile a consumer
  static constexpr int kV = kK + kConsumers * KT::kBytes;       // V: a tile a consumer
  static constexpr int kQ = kV + kConsumers * KT::kBytes;       // Q stages
  static constexpr int kDo = kQ + kStages * QT::kBytes;         // dO stages
  static constexpr int kRows = kDo + kStages * QT::kBytes;      // lse/dvec stages
  static constexpr int kBars = kRows + kStages * kRowFloats * 4;  // full, empty, K/V
  static constexpr int kSmem = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(kProducerRegs * kTcThreads + kConsumerRegs * kConsumers * kTcThreads <=
                    65536 / kThreads / 8 * 8 * kThreads,
                "the block's registers at launch");
};

// What a consumer's units share: its key tile and rows, the ring's shared
// memory and the scores' scale.
struct DkvUnits {
  uint32_t kt, vt;       // the consumer's K and V tiles
  uint32_t sq, sdo;      // the Q and dO stages
  uint32_t full;         // the stages' full barriers
  const float* rows;     // the stages' lse and dvec rows
  int i_begin, kc, key0, col0, s, causal;
  float cexp, scale;
};

// A consumer's S^T = K Q^T and dP^T = V dO^T of unit v (query rows
// [kUnitRows h, + kUnitRows) of q-tile v / kHalves, h = v % kHalves; both
// K-major), issued once the tile's stage has landed, and committed; not
// waited for.
template <int D>
__device__ __forceinline__ void dkv_scores(float (&st)[DkvTc<D>::kUnitRows / 2],
                                           float (&dpt)[DkvTc<D>::kUnitRows / 2],
                                           const DkvUnits& c, int v) {
  using P = DkvTc<D>;
  constexpr int N = P::kUnitRows;
  const int t = v / P::kHalves, stage = t % P::kStages;
  if (v % P::kHalves == 0) hopper::mbar_wait(c.full + 8 * stage, (t / P::kStages) & 1);
  const uint32_t rows = stage * P::QT::kBytes + (v % P::kHalves) * N * P::QT::kRowBytes;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::Wgmma<N>::ss(st, P::KT::kmajor(c.kt, kk), P::QT::kmajor(c.sq + rows, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::Wgmma<N>::ss(dpt, P::KT::kmajor(c.vt, kk), P::QT::kmajor(c.sdo + rows, kk), kk > 0);
  hopper::wgmma_commit();
}

// Unit u of a consumer from its S^T and dP^T: P^T = exp2(S^T scale log2e -
// lse log2e) and dS^T = P^T (dP^T - dvec) scale in fp32, rounded to bf16
// in pa and da, then dV += P^T dO and dK += dS^T Q issued (wgmma, P^T and
// dS^T from registers, dO and Q read MN-major) and committed; not waited
// for.
template <int D>
__device__ __forceinline__ void dkv_grads(const float (&st)[DkvTc<D>::kUnitRows / 2],
                                          const float (&dpt)[DkvTc<D>::kUnitRows / 2],
                                          uint32_t (&pa)[DkvTc<D>::kUnitRows / 16][4],
                                          uint32_t (&da)[DkvTc<D>::kUnitRows / 16][4],
                                          float (&dka)[TcCols<D>::kCols / 2],
                                          float (&dva)[TcCols<D>::kCols / 2], const DkvUnits& c,
                                          int u) {
  using P = DkvTc<D>;
  using QT = typename P::QT;
  constexpr int H = P::kHalves, NR = P::kUnitRows, DC = TcCols<D>::kCols;
  const int stage = u / H % P::kStages, h = u % H;
  const uint32_t qt = c.sq + stage * QT::kBytes, dt = c.sdo + stage * QT::kBytes;
  const uint32_t qcols = QT::columns(TcCols<D>::first());
  const float* lr = c.rows + stage * P::kRowFloats + h * NR;  // lse; dvec at lr + kTcRows
  const int i0 = c.i_begin + u / H * kTcRows;  // the q-tile's first row
  const int r0 = i0 + h * NR;                  // the unit's
  // only the diagonal q-tile holds a query row above one of the keys, and
  // only the last one rows past s
  const bool masked = (c.causal && i0 < c.kc + kTcKeys - 1) || i0 + kTcRows > c.s;
#pragma unroll
  for (int j = 0; j < NR / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * j + c.col0);
    const float2 d2 = *reinterpret_cast<const float2*>(lr + kTcRows + 8 * j + c.col0);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * j + c.col0 + (e & 1);
      // a masked row's lse and dvec may be stale (a bulk copy stops at s):
      // selected away, never multiplied in
      const bool keep =
          !masked || (row < c.s && !(c.causal && c.key0 + 8 * (e >> 1) > row));
      p[e] = keep ? exp2f(st[4 * j + e] * c.cexp - ((e & 1) ? l2.y : l2.x) * kLog2e) : 0.f;
      ds[e] = keep ? p[e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * c.scale : 0.f;
    }
    pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p[2], p[3]);
    da[j / 2][2 * (j % 2)] = hopper::pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NR / 16; ++kk)
    hopper::Wgmma<DC>::rs(dva, pa[kk], QT::mnmajor(dt + qcols, h * (NR / 16) + kk), 1);
#pragma unroll
  for (int kk = 0; kk < NR / 16; ++kk)
    hopper::Wgmma<DC>::rs(dka, da[kk], QT::mnmajor(qt + qcols, h * (NR / 16) + kk), 1);
  hopper::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DkvTc<D>::kThreads, 1) flash_bwd_dkv_tc_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s, int g, int causal,
    float scale, int rows_bulk) {
  using P = DkvTc<D>;
  using KT = typename P::KT;
  using QT = typename P::QT;
  constexpr int S = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = align_1024(raw);
  const uint32_t sk = base + P::kK, sv = base + P::kV, sq = base + P::kQ, sdo = base + P::kDo;
  const uint32_t srows = base + P::kRows;
  const uint32_t full = base + P::kBars, empty = full + 8 * S, kv_full = empty + 8 * S;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (srows - raw));

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * P::kKeys;  // causal: key tile 0 sees every q-tile, and goes first
  const int i_begin = causal ? k0 : 0;   // query rows below k0 never see these keys
  const int n_tiles = (s - i_begin + kTcRows - 1) / kTcRows;
  // consumers with a key below s
  const int active = min(P::kConsumers, (s - k0 + kTcKeys - 1) / kTcKeys);
  // the warpgroup, uniform across the warp (a shuffle's result is), so
  // that descriptor bases derived from it stay in uniform registers
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kTcThreads, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      // the producer's arrival (with the stage's bytes), and with 4-byte
      // row copies one arrival of each of its warp's lanes
      hopper::mbar_init(full + 8 * i, rows_bulk ? 1 : 1 + 32);
      hopper::mbar_init(empty + 8 * i, kTcThreads * active);  // every consumer thread
    }
    hopper::mbar_init(kv_full, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (role == 0) {
    // ---------------------------------------------------------- producer
    hopper::setmaxnreg_dec<P::kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    constexpr int kBoxCols = KT::kRowBytes / 2;  // a column block of TcTile
    if (lane == 0) {
      hopper::prefetch_tensormap(&k_map);
      hopper::prefetch_tensormap(&v_map);
      hopper::prefetch_tensormap(&q_map);
      hopper::prefetch_tensormap(&do_map);
      hopper::mbar_arrive_expect_tx(kv_full, 2 * active * KT::kBytes);
      for (int c = 0; c < active; ++c) {
#pragma unroll
        for (int j = 0; j < D / kBoxCols; ++j) {
          const uint32_t at = c * KT::kBytes + j * KT::kBlockBytes;
          hopper::tma_load_3d(sk + at, &k_map, kv_full, j * kBoxCols, k0 + c * kTcKeys, bh / g);
          hopper::tma_load_3d(sv + at, &v_map, kv_full, j * kBoxCols, k0 + c * kTcKeys, bh / g);
        }
      }
    }
    const float* lrow = lse + static_cast<size_t>(bh) * s;
    const float* drow = dvec + static_cast<size_t>(bh) * s;
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % S;
      const uint32_t fb = full + 8 * stage;
      const uint32_t rows_at = srows + stage * P::kRowFloats * 4;
      const int i0 = i_begin + t * kTcRows;
      hopper::mbar_wait(empty + 8 * stage, ((t / S) & 1) ^ 1);  // the first round passes
      if (!rows_bulk) {  // a row starts only 4-byte aligned: rows past s read as zeros
#pragma unroll
        for (int r = 0; r < P::kRowFloats / 32; ++r) {
          const int v = lane + 32 * r;
          const int i = i0 + v % kTcRows;
          const float* src = (v < kTcRows ? lrow : drow) + (i < s ? i : 0);
          hopper::cp_async_4(rows_at + 4 * v, src, i < s ? 4 : 0);
        }
        hopper::cp_async_arrive_noinc(fb);
      }
      if (lane == 0) {
        // rows past s of a bulk copy are left as they were: the consumers
        // mask those rows without reading their values into the result
        const uint32_t row_bytes = rows_bulk ? 4 * min(kTcRows, s - i0) : 0;
        hopper::mbar_arrive_expect_tx(fb, 2 * QT::kBytes + 2 * row_bytes);
#pragma unroll
        for (int j = 0; j < D / kBoxCols; ++j) {
          const uint32_t at = stage * QT::kBytes + j * QT::kBlockBytes;
          hopper::tma_load_3d(sq + at, &q_map, fb, j * kBoxCols, i0, bh);
          hopper::tma_load_3d(sdo + at, &do_map, fb, j * kBoxCols, i0, bh);
        }
        if (rows_bulk) {
          hopper::bulk_load(rows_at, lrow + i0, row_bytes, fb);
          hopper::bulk_load(rows_at + kTcRows * 4, drow + i0, row_bytes, fb);
        }
      }
    }
    // Leave once every copy has landed and every stage has been released,
    // so that no copy of this warp's outlives it.
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    if (lane == 0) {
      for (int t = n_tiles; t < n_tiles + S; ++t)
        hopper::mbar_wait(empty + 8 * (t % S), ((t / S) & 1) ^ 1);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<P::kConsumerRegs>();
  const int c = role - 1;
  if (c >= active) return;  // every key past s
  const int kc = k0 + c * kTcKeys;
  const int lane = threadIdx.x % 32;
  const int key0 = kc + (threadIdx.x % kTcThreads / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);  // accumulator columns 8j + col0 + {0, 1}
  const DkvUnits units{sk + c * KT::kBytes, sv + c * KT::kBytes, sq, sdo, full, rows,
                       i_begin, kc, key0, col0, s, causal, scale * kLog2e, scale};
  constexpr int DC = TcCols<D>::kCols;  // dK, dV columns [c0, c0 + DC) are this block's
  const int c0 = TcCols<D>::first();
  float dka[DC / 2], dva[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  hopper::mbar_wait(kv_full, 0);

  int t = 0;
  // causal: the q-tiles wholly above these keys hold nothing for them
  for (; t < n_tiles && causal && i_begin + t * kTcRows + kTcRows - 1 < kc; ++t) {
    hopper::mbar_wait(full + 8 * (t % S), (t / S) & 1);
    hopper::mbar_arrive(empty + 8 * (t % S));
  }
  constexpr int H = P::kHalves, NR = P::kUnitRows;
  const int u0 = t * H, n_units = n_tiles * H;  // this consumer's units
  float st[NR / 2], dpt[NR / 2];            // S^T = K Q^T, dP^T = V dO^T of a unit
  uint32_t pa[NR / 16][4], da[NR / 16][4];  // P^T, dS^T in bf16: A operands
  if (u0 < n_units) dkv_scores<D>(st, dpt, units, u0);
  for (int u = u0; u < n_units; ++u) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    dkv_grads<D>(st, dpt, pa, da, dka, dva, units, u);
    // Issue the next unit's S^T and dP^T before waiting on this unit's dK
    // and dV. With a ring of one stage the next q-tile's stage is this
    // one's, refilled only once released, and a consumer runs serially.
    const bool ahead = S > 1 && u + 1 < n_units;
    if (ahead) {
      dkv_scores<D>(st, dpt, units, u + 1);
      hopper::wgmma_wait<1>();  // this unit's dK/dV; the next scores run on
    } else {
      hopper::wgmma_wait<0>();
    }
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    // the q-tile's last unit: this thread's reads of its stage are done
    if (u % H == H - 1) hopper::mbar_arrive(empty + 8 * (u / H % S));
    if (!ahead && u + 1 < n_units) dkv_scores<D>(st, dpt, units, u + 1);
  }
  hopper::wgmma_wait<0>();  // nothing is in flight; ptxas cannot tell on its own
  hopper::fence_regs(dka);
  hopper::fence_regs(dva);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key < s) {
      const size_t at = (static_cast<size_t>(bh) * s + key) * D + c0 + col0;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
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

// The forward's and dQ's grid: bh fastest, then 64-row q-tiles, so that
// every row's heaviest tile is dispatched before any lighter one; then the
// output's column splits.
template <int D>
dim3 tc_grid(int bh, int s) {
  return dim3(bh, (s + kTcRows - 1) / kTcRows, TcCols<D>::kSplits);
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's
// entry-point query, so the library links the runtime alone; null when the
// driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult result{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &found, 12000, cudaEnableDefault, &result);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault, &result);
#endif
    return err == cudaSuccess && result == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(found)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major [heads, s, D] bf16 tensor: boxes of R rows
// by one column block of TcTile (min(D, 64) columns), swizzled as TcTile
// lays a block out (32B, 64B or 128B), so that box j of a tile lands as
// its column block j and the wgmma descriptors read it unchanged. Rows
// past s (within a head) read as zeros.
template <int D, int R = kTcRows>
bool encode_rows(CUtensorMap* map, const void* ptr, int heads, int s) {
  using T = TcTile<R, D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::kRowBytes / 2), R, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The forward's and dQ's launches: Q (dO) maps of 64-row boxes, K/V maps of
// kKeys-row boxes, built here for every call and passed by value. Returns
// the first error: a map the driver refused, or cudaGetLastError after
// the launch.
template <int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                          int bh, int s, int g, int causal, float scale, cudaStream_t st) {
  using P = RowTc<D, false>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_rows<D>(&q_map, q, bh, s) || !encode_rows<D, P::kKeys>(&k_map, k, bh / g, s) ||
      !encode_rows<D, P::kKeys>(&v_map, v, bh / g, s))
    return cudaErrorInvalidValue;
  allow_smem<flash_fwd_tc_kernel<D>>(P::kSmem);
  flash_fwd_tc_kernel<D><<<tc_grid<D>(bh, s), kTcThreads, P::kSmem, st>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), s, g,
      causal, scale);
  return cudaGetLastError();
}

// The SMs of the current device, read once per device.
int sm_count() {
  constexpr int kMaxDevices = 64;
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// dQ takes its wide plan (64-key units, two blocks an SM) where two blocks
// an SM hold the whole grid, so that a third would find no block to run
// (the trainer's b 8, h 8, s 256: 256 blocks on 132 SMs), and 32-key
// units at three blocks an SM otherwise; the wide plan is built for head
// dims up to 64.
template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dvec, void* dq, int bh, int s, int g,
                         int causal, float scale, cudaStream_t st) {
  using P = RowTc<D, true>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, do_map, k_map, v_map;
  if (!encode_rows<D>(&q_map, q, bh, s) || !encode_rows<D>(&do_map, dout, bh, s) ||
      !encode_rows<D, P::kKeys>(&k_map, k, bh / g, s) ||
      !encode_rows<D, P::kKeys>(&v_map, v, bh / g, s))
    return cudaErrorInvalidValue;
  const dim3 grid = tc_grid<D>(bh, s);
  const auto* lse_f = static_cast<const float*>(lse);
  const auto* dvec_f = static_cast<const float*>(dvec);
  auto* dq_b = static_cast<__nv_bfloat16*>(dq);
  if constexpr (D <= 64) {
    using W = RowTc<D, true, true>;
    static_assert(W::kKeys == P::kKeys, "both plans read the same maps");
    if (grid.x * grid.y * grid.z <= 2u * sm_count()) {
      allow_smem<flash_bwd_dq_tc_kernel<D, true>>(W::kSmem);
      flash_bwd_dq_tc_kernel<D, true><<<grid, kTcThreads, W::kSmem, st>>>(
          q_map, do_map, k_map, v_map, lse_f, dvec_f, dq_b, s, g, causal, scale);
      return cudaGetLastError();
    }
  }
  allow_smem<flash_bwd_dq_tc_kernel<D, false>>(P::kSmem);
  flash_bwd_dq_tc_kernel<D, false><<<grid, kTcThreads, P::kSmem, st>>>(
      q_map, do_map, k_map, v_map, lse_f, dvec_f, dq_b, s, g, causal, scale);
  return cudaGetLastError();
}

// The tensor maps are built here, on the host, for every call, and passed
// by value (__grid_constant__). Returns the first error: a map the driver
// refused, or cudaGetLastError after the launch.
template <int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* dvec, void* dk, void* dv, int bh, int s,
                          int g, int causal, float scale, cudaStream_t st) {
  using P = DkvTc<D>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, do_map, k_map, v_map;
  if (!encode_rows<D>(&q_map, q, bh, s) || !encode_rows<D>(&do_map, dout, bh, s) ||
      !encode_rows<D>(&k_map, k, bh / g, s) || !encode_rows<D>(&v_map, v, bh / g, s))
    return cudaErrorInvalidValue;
  // lse and dvec rows by bulk copy where every row starts 16-byte aligned
  const int rows_bulk = s % 4 == 0 && reinterpret_cast<uintptr_t>(lse) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(dvec) % 16 == 0;
  allow_smem<flash_bwd_dkv_tc_kernel<D>>(P::kSmem);
  // bh fastest, then the key tiles (the heaviest, k0 0, first), then the
  // column splits
  const dim3 grid(bh, (s + P::kKeys - 1) / P::kKeys, TcCols<D>::kSplits);
  flash_bwd_dkv_tc_kernel<D><<<grid, P::kThreads, P::kSmem, st>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s, g, causal, scale, rows_bulk);
  return cudaGetLastError();
}

// ------------------------------------------------------------ launchers

template <int D>
dim3 grid_for(int bh, int s) {
  return dim3((s + Tiles<D>::kRows - 1) / Tiles<D>::kRows, bh);
}

template <typename T, int D>
void launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                int s, int g, int causal, float scale, cudaStream_t st) {
  flash_fwd_kernel<T, D><<<grid_for<D>(bh, s), Tiles<D>::kRows * Tiles<D>::kFwdSplit, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, g, causal, scale);
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dvec, void* dq, int bh, int s, int g,
               int causal, float scale, cudaStream_t st) {
  flash_bwd_dq_kernel<T, D>
      <<<grid_for<D>(bh, s), Tiles<D>::kRows * Tiles<D>::kFwdSplit, 0, st>>>(
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
// to its scalar one. A route returns what failed before its launch, if
// anything (the entry point then returns it), else cudaSuccess.
template <typename T, int D>
cudaError_t route_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                      int s, int g, int causal, float scale, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_fwd_tc<D>(q, k, v, o, lse, bh, s, g, causal, scale, st);
  } else {
    launch_fwd<T, D>(q, k, v, o, lse, bh, s, g, causal, scale, st);
    return cudaSuccess;
  }
}

template <typename T, int D>
cudaError_t route_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* dvec, void* dq, int bh, int s, int g,
                     int causal, float scale, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dq_tc<D>(q, k, v, dout, lse, dvec, dq, bh, s, g, causal, scale, st);
  } else {
    launch_dq<T, D>(q, k, v, dout, lse, dvec, dq, bh, s, g, causal, scale, st);
    return cudaSuccess;
  }
}

template <typename T, int D>
cudaError_t route_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dvec, void* dk, void* dv, int bh, int s, int g,
                      int causal, float scale, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_dkv_tc<D>(q, k, v, dout, lse, dvec, dk, dv, bh, s, g, causal, scale, st);
  } else {
    launch_dkv<T, D>(q, k, v, dout, lse, dvec, dk, dv, bh, s, g, causal, scale, st);
    return cudaSuccess;
  }
}

// status = LAUNCH<T, D>(...) for the (dtype, head dim) pair, into the entry
// point's local `status`, or returns cudaErrorInvalidValue from the entry
// point for a head dim it does not take.
#define FLASH_DISPATCH(LAUNCH, ...)                                   \
  do {                                                                \
    const bool bf = is_bf16 != 0;                                     \
    switch (d) {                                                      \
      case 16:                                                        \
        status = bf ? LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__)          \
                    : LAUNCH<float, 16>(__VA_ARGS__);                 \
        break;                                                        \
      case 32:                                                        \
        status = bf ? LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__)          \
                    : LAUNCH<float, 32>(__VA_ARGS__);                 \
        break;                                                        \
      case 64:                                                        \
        status = bf ? LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__)          \
                    : LAUNCH<float, 64>(__VA_ARGS__);                 \
        break;                                                        \
      case 128:                                                       \
        status = bf ? LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__)         \
                    : LAUNCH<float, 128>(__VA_ARGS__);                \
        break;                                                        \
      case 256:                                                       \
        status = bf ? LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__)         \
                    : LAUNCH<float, 256>(__VA_ARGS__);                \
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
  cudaError_t status = cudaSuccess;
  FLASH_DISPATCH(route_fwd, q, k, v, o, lse, bh, s, g, causal, scale, st);
  return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* dvec, void* dq, int bh, int s, int d, int g,
                 int causal, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, s, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t status = cudaSuccess;
  FLASH_DISPATCH(route_dq, q, k, v, dout, lse, dvec, dq, bh, s, g, causal, scale, st);
  return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* dvec, void* dk, void* dv, int bh, int s,
                  int d, int g, int causal, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, s, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t status = cudaSuccess;
  FLASH_DISPATCH(route_dkv, q, k, v, dout, lse, dvec, dk, dv, bh, s, g, causal, scale, st);
  return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
}

}  // extern "C"
