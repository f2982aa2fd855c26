// Weight-only int8 matmul for the decode path, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package serves an int8 tree by
// dequantizing it inside its jitted decode loop and leaving XLA to fuse the
// cast and scale into each consuming matmul
// (k8s_operator_libs_tpu/tpu/quantize.py:74-84), so that device memory holds
// and streams the int8 tensor. Eager PyTorch does no such fusion: without
// this kernel the port would read a bf16 copy of every weight each step.
//
// Contract (both kernels):
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
// byte the card needs before its arithmetic is the limit. So its bound is
// the bytes of q, N*K, over the memory rate. At the smoke configuration's
// decode shapes (K, N of 512 and 2048) a launch moves 0.26-1 MB and the
// whole int8 model ~14 MB, which the 50 MB L2 holds from step to step: a
// launch then takes ~3 us against a bound of ~0.2 us, and what it pays is
// latency, launch to store in series, not bytes.
//
// bf16: int8_linear_tc_kernel, the products on the tensor cores. The first
// design (int8_linear_kernel below, which fp32 keeps: TF32 cannot meet the
// fp32 contract) had three limits; this design answers each, and a fourth
// step (4.) takes the serial start off the chain of launches.
// 1. The grid was too small: a block owned 32 rows and walked all of K, so
//    N 512 gave 16 blocks on 132 SMs, each walking K in series. Here a block
//    owns 16 rows and K is split across its warps (k_warps, 8 or 4) and,
//    where a warp's slice would still not fit in its ring, across the blocks
//    of a thread-block cluster (cluster, at most 8), so that every chunk of
//    q is requested as the kernel starts. Filling every SM with blocks is
//    not the aim: at the 512-wide decode shapes a cluster's barrier measured
//    costlier than the blocks it adds (PERF.md §6). The plan is int8_plan
//    (tpu/quantize.py), a function of (M, K, N, SM count) alone, and comes
//    in as two arguments.
// 2. Each block ran a serial chain: x staged behind a barrier, q loaded one
//    chunk ahead, a 31-shuffle reduction. Here nothing is staged: each lane
//    streams its 16 bytes of each of two q rows and 32 bytes of x per 64-wide
//    chunk straight into registers through a 2-deep ring (q bypasses L1 and
//    asks L2 for 256-byte fetches; x, which every block rereads, stays
//    cached), so 2 KB of q per warp is in flight from the first instruction;
//    a deeper ring measured slower, its registers costing resident warps.
//    The partial sums meet once, at the end: through shared memory within
//    the block, then each block of a cluster writes its sums into the
//    shared memory of rank 0 (distributed shared memory) and rank 0 adds
//    them in rank order, which is K order. One cluster barrier wait on the
//    way, whose arrival was made at the start. No atomics, no workspace, no
//    second launch: two launches are bit-equal, and a CUDA graph may hold it.
// 3. The products ran on CUDA cores: M fp32 FMAs per weight, 32 accumulators
//    a lane. Here mma.sync m16n8k16 takes them, the 16 weight rows as its m16
//    side and 8 rows of x as its n8 side (rows past M are zero; M > 8 takes
//    more blocks along y): 4 accumulators a lane, each k16 product added to
//    them in fp32. A lane dequantizes its
//    weights into A fragments in registers: byte to fp32 exactly by the 2^23
//    trick (q ^ 0x80 into the low byte of 0x4B000000, less 2^23 + 128), times
//    s[n] in fp32, then rounded to bf16 in pairs. The k order inside a chunk
//    is permuted alike for A and B, which leaves the sum unchanged, so that
//    a lane's 16 bytes of a row feed its A fragments of four k16 steps
//    without a shuffle: in step j, lane (g, t)'s logical k {2t, 2t+1, 2t+8,
//    2t+9} are the physical k 16t + 4j + {0, 1, 2, 3}.
// 4. A decode step runs its int8 matmuls back to back (q, k and v on the
//    same x, then out, the MLP's two), and each launch waited for the one
//    ahead to end before it computed an index. Here each is launched with
//    programmatic stream serialization and begins before the one ahead has
//    ended: it computes its indices and slice bounds, makes its cluster's
//    first arrival and asks L2 for its rows of q, its scales and bias
//    (prefetches, which move no value into a thread), then waits in
//    griddepcontrol.wait until the kernel ahead has ended and its writes
//    are visible, and lets the next launch begin its own start
//    (griddepcontrol.launch_dependents). Above 16 MB of weight, which L2
//    would not keep, there is no prefetch and the next launch may begin
//    only once this one's loads are done. Every register load (q, s, the
//    bias, x), every store of y and every write into another block's
//    shared memory comes after the wait, so the result does not depend on
//    which kernel wrote an input last or still reads y's memory, and stays
//    bit-equal to a launch without the attribute. A kernel ahead launched
//    without the attribute ends as before the wait returns.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hopper_mma.cuh"

namespace {

namespace cg = cooperative_groups;

// ------------------------------------------- fp32: CUDA cores (first design)
//
// A block of 8 warps owns 32 output rows, four per warp, and an M-tile of 8
// rows of x (blockIdx.y). The x tile is staged in shared memory as fp32,
// 1024 values of K at a time, each group of 16 padded to 20 floats, so that
// a warp's 16-byte shared reads, one group per lane, fall on distinct banks.
// Each lane reads 16 int8 weights of each of its 4 rows with one 16-byte
// load, issued before the chunk's x is staged so that the two latencies
// overlap, dequantizes them in registers four at a time, and reuses every x
// value it reads from shared memory for those 4 rows. The lanes' 32 partial
// sums meet in a halving warp-shuffle reduction (31 shuffles, one output per
// lane); each output is written once, with no atomics.

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

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

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

// ------------------------------------------------ bf16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 16;          // output rows per block: mma.sync's m16 side
constexpr int kTcM = 8;              // rows of x per block: its n8 side
constexpr int kTcOut = kTcRows * kTcM;
constexpr int kTcChunk = 64;         // K per warp step: 16 bytes of q per lane and row
constexpr int kTcMaxWarps = 8;       // k_warps
constexpr int kTcMaxCluster = 8;     // blocks of a cluster (the portable limit)
constexpr int kTcStages = 2;         // chunks of q and x in flight per warp
constexpr float kByteBias = 8388736.f;  // 2^23 + 128
constexpr long long kTcEarlyBytes = 16ll << 20;  // a third of the 50 MB L2

// A lane's share of one 64-wide chunk at k = 64c + 16t: 16 bytes of q of
// rows g and g + 8 of the tile, and 16 values of x row g.
struct Chunk {
  int4 qa, qb;  // q[n0 + g][k, k + 16), q[n0 + g + 8][k, k + 16)
  int4 xa, xb;  // x[m0 + g][k, k + 8), x[m0 + g][k + 8, k + 16)
};

// 16 bytes of q that no one rereads: past L1, with 256-byte L2 fetches.
__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The 16 int8 of a row of q at k, k + 16 (zero past K, or for a row past N).
__device__ __forceinline__ int4 tc_load_q(const int8_t* row, int k, int K, bool vec) {
  if (row == nullptr || k >= K) return make_int4(0, 0, 0, 0);
  return vec ? ld_stream(row + k) : load_q(row, k, K, false);
}

// The 16 bf16 of a row of x at k, k + 16 (zero past K, or for a row past M).
__device__ __forceinline__ void tc_load_x(int4& lo, int4& hi, const bf16* row, int k, int K,
                                          bool vec) {
  if (row == nullptr || k >= K) {
    lo = hi = make_int4(0, 0, 0, 0);
  } else if (vec) {
    lo = __ldg(reinterpret_cast<const int4*>(row + k));
    hi = __ldg(reinterpret_cast<const int4*>(row + k + 8));
  } else {
    int w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k0 = k + 2 * i;
      const unsigned a = k0 < K ? __bfloat16_as_ushort(row[k0]) : 0u;
      const unsigned b = k0 + 1 < K ? __bfloat16_as_ushort(row[k0 + 1]) : 0u;
      w[i] = static_cast<int>(a | b << 16);
    }
    lo = make_int4(w[0], w[1], w[2], w[3]);
    hi = make_int4(w[4], w[5], w[6], w[7]);
  }
}

// Chunk `chunk` of a lane's rows of q and x (k = 64 chunk + 16t); past the
// warp's slice (chunk >= end) nothing is loaded.
__device__ __forceinline__ void tc_load(Chunk& c, int chunk, int end, int t, const int8_t* qa,
                                        const int8_t* qb, const bf16* xr, int K, bool vec) {
  if (chunk >= end) return;
  const int k = chunk * kTcChunk + 16 * t;
  c.qa = tc_load_q(qa, k, K, vec);
  c.qb = tc_load_q(qb, k, K, vec);
  tc_load_x(c.xa, c.xb, xr, k, K, vec);
}

// Bytes b and b + 1 of u (four weights as q + 128, unsigned) dequantized,
// float(q) * s, and rounded to a bf16 pair. 0x4B0000uu is the float
// 2^23 + uu exactly, so subtracting 2^23 + 128 gives float(q) exactly.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t u, int b, float s) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) - kByteBias;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651 + b)) - kByteBias;
  return hopper::pack_bf16(lo * s, hi * s);
}

// acc += the chunk's 16 x 64 weights . its 64 x 8 values of x, in four k16
// steps; step j takes word j of each q row and words 2j, 2j + 1 of x. Each
// step's product starts from zero and is added to acc in fp32, rounding to
// nearest: the tensor cores' own accumulation truncates, and over a long K
// the truncations build up.
__device__ __forceinline__ void tc_chunk(float (&acc)[4], const Chunk& c, float sa, float sb) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t ua = static_cast<uint32_t>(word(c.qa, j)) ^ 0x80808080u;
    const uint32_t ub = static_cast<uint32_t>(word(c.qb, j)) ^ 0x80808080u;
    const uint32_t a[4] = {dequant_pair(ua, 0, sa), dequant_pair(ub, 0, sb),
                           dequant_pair(ua, 2, sa), dequant_pair(ub, 2, sb)};
    const int4 xv = j < 2 ? c.xa : c.xb;
    const uint32_t b[2] = {static_cast<uint32_t>(word(xv, 2 * (j & 1))),
                           static_cast<uint32_t>(word(xv, 2 * (j & 1) + 1))};
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    hopper::mma_m16n8k16(d, a, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += d[i];
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Launched in clusters of cs blocks along x (cs a power of two <= 8) of
// 32 * k_warps threads; block x / cs owns output rows [16(x / cs), +16) and
// rows [8y, +8) of x. Warp w of the block of cluster rank r sums the chunks
// of K slice r * k_warps + w of cs * k_warps, cut as int8_plan cuts them.
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    int8_linear_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                          const float* __restrict__ s, const bf16* __restrict__ bias,
                          bf16* __restrict__ y, int M, int K, int N) {
  __shared__ float part[kTcMaxWarps][kTcOut];      // each warp's D, [m][row]
  __shared__ float total[kTcMaxCluster][kTcOut];   // rank 0: each block's sum
  __shared__ float bias_s[kTcRows];                // the tile's bias, in fp32
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // Phase 1 of the cluster barrier: this block has started. Rank 0's
  // shared memory is written only after the phase completes.
  if (cs > 1) cluster_arrive_relaxed();
  const int k_warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x / cs * kTcRows, m0 = blockIdx.y * kTcM;
  const bool vec = K % 16 == 0;
  const int chunks = (K + kTcChunk - 1) / kTcChunk, slices = cs * k_warps;
  const int slice = rank * k_warps + warp;
  const int c_begin = static_cast<int>(static_cast<long long>(slice) * chunks / slices);
  const int c_end = static_cast<int>(static_cast<long long>(slice + 1) * chunks / slices);

  const int8_t* qa = n0 + g < N ? q + static_cast<size_t>(n0 + g) * K : nullptr;
  const int8_t* qb = n0 + g + 8 < N ? q + static_cast<size_t>(n0 + g + 8) * K : nullptr;
  const bf16* xr = m0 + g < M ? x + static_cast<size_t>(m0 + g) * K : nullptr;

  // A weight that fits well inside L2 (the decode shapes): its rows are
  // prefetched, and the next launch may start as soon as this one has
  // passed its wait. A larger one streams from memory: a prefetch would
  // evict before use, and the next launch's early start and prefetches
  // would take bandwidth from this one (K = N = 8192 measured slower), so
  // the next launch may start only once this one's loads are done.
  const bool small = static_cast<long long>(N) * K <= kTcEarlyBytes;
  // Before the wait: L2 prefetches only, which move no value into a
  // thread, so whatever kernel wrote q, s or the bias last, what is loaded
  // after the wait is what it wrote. Lane r < 16 asks for row n0 + r's
  // bytes of the warp's slice; warp 0's lanes 16 and 17 for the tile's
  // scales and bias (64 and 32 bytes, each inside one line).
  if (lane < kTcRows && n0 + lane < N && vec && c_end > c_begin && small) {
    const int k_begin = c_begin * kTcChunk, k_end = min(K, c_end * kTcChunk);
    hopper::bulk_prefetch_l2(q + static_cast<size_t>(n0 + lane) * K + k_begin,
                             static_cast<uint32_t>(k_end - k_begin));
  } else if (warp == 0 && lane == kTcRows) {
    hopper::prefetch_l2(s + n0);
  } else if (warp == 0 && lane == kTcRows + 1 && bias != nullptr) {
    hopper::prefetch_l2(bias + n0);
  }
  // The kernel ahead (launched with or without programmatic serialization)
  // has ended and its writes are visible; then the next int8 launch may
  // start its own prologue while this one runs.
  hopper::grid_dependency_wait();
  if (small) hopper::launch_dependents();

  Chunk ring[kTcStages];
#pragma unroll
  for (int p = 0; p < kTcStages; ++p) tc_load(ring[p], c_begin + p, c_end, t, qa, qb, xr, K, vec);
  const float sa = qa != nullptr ? s[n0 + g] : 0.f;
  const float sb = qb != nullptr ? s[n0 + g + 8] : 0.f;
  if (threadIdx.x < kTcRows) {  // loaded beside q, read after the loop
    const int n = n0 + threadIdx.x;
    bias_s[threadIdx.x] = bias != nullptr && n < N ? __bfloat162float(bias[n]) : 0.f;
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = c_begin; c < c_end; c += kTcStages) {
#pragma unroll
    for (int p = 0; p < kTcStages; ++p) {
      if (c + p < c_end) {
        const Chunk cur = ring[p];
        // in flight while cur is computed
        tc_load(ring[p], c + p + kTcStages, c_end, t, qa, qb, xr, K, vec);
        tc_chunk(acc, cur, sa, sb);
      }
    }
  }

  if (!small) hopper::launch_dependents();  // every load of this block is done

  float* mine = part[warp];
  mine[2 * t * kTcRows + g] = acc[0];
  mine[(2 * t + 1) * kTcRows + g] = acc[1];
  mine[2 * t * kTcRows + g + 8] = acc[2];
  mine[(2 * t + 1) * kTcRows + g + 8] = acc[3];
  __syncthreads();
  // Output o = 16 m + row of the tile: the sum of the block's warps in K
  // order, then (rank 0, in a cluster) of the blocks in rank order. A
  // thread's outputs share o % 16 (blockDim.x is a multiple of 32), so
  // they share a row n and a bias.
  const int n_out = n0 + threadIdx.x % kTcRows;
  const bool n_ok = n_out < N;
  const float b_out = bias_s[threadIdx.x % kTcRows];
  bf16* y_out = y + n_out;
  float* to = &total[0][0];
  if (cs > 1) {
    cluster_wait();  // phase 1: every block has started
    to = cluster.map_shared_rank(to, 0) + rank * kTcOut;
  }
  for (int o = threadIdx.x; o < kTcOut; o += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < k_warps; ++w) sum += part[w][o];
    const int m = m0 + o / kTcRows;
    if (cs > 1) {
      to[o] = sum;  // into rank 0's shared memory
    } else if (m < M && n_ok) {
      y_out[static_cast<size_t>(m) * N] = __float2bfloat16_rn(sum + b_out);
    }
  }
  if (cs == 1) return;
  cluster_arrive_release();  // phase 2: this block's sums are in rank 0
  if (rank != 0) return;     // no block reads another's part or total but rank 0's
  cluster_wait();
  for (int o = threadIdx.x; o < kTcOut; o += blockDim.x) {
    float sum = 0.f;
    for (int r = 0; r < cs; ++r) sum += total[r][o];
    const int m = m0 + o / kTcRows;
    if (m < M && n_ok) y_out[static_cast<size_t>(m) * N] = __float2bfloat16_rn(sum + b_out);
  }
}

}  // namespace

extern "C" {

// y = x . deq(q)^T + bias; x, y [M, K] / [M, N] in bf16 (is_bf16) or fp32,
// q int8 [N, K], s fp32 [N], bias [N] in x's type or null. bf16 runs
// int8_linear_tc_kernel under the plan (k_warps, cluster) of int8_plan,
// with programmatic stream serialization (a launch, or a stream capture,
// that refuses it returns its error); fp32 runs int8_linear_kernel<float>,
// which has a fixed plan and ignores the two.
int int8_linear(const void* x, const void* q, const void* s, const void* bias, void* y, int M,
                int K, int N, int is_bf16, int k_warps, int cluster, void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if ((M + kMTile - 1) / kMTile > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, (M + kMTile - 1) / kMTile);
    int8_linear_kernel<float><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<const float*>(bias), static_cast<float*>(y),
        M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = (N + kTcRows - 1) / kTcRows;
  if (k_warps < 1 || k_warps > kTcMaxWarps || cluster < 1 || cluster > kTcMaxCluster ||
      (cluster & (cluster - 1)) != 0 || tiles * cluster > INT_MAX ||
      (M + kTcM - 1) / kTcM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * cluster), (M + kTcM - 1) / kTcM);
  config.blockDim = dim3(32 * k_warps);
  config.stream = st;
  // the cluster, and programmatic dependent launch: the kernel may start
  // its prologue before the one ahead of it in the stream has ended
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attrs;
  config.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, int8_linear_tc_kernel, static_cast<const bf16*>(x),
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), M, K, N);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
