// Cached attention of one decode step for Hopper (sm_90a):
// decode_attention_kernel, and decode_attention_merge_kernel for the split plan.
//
// Replaces no Pallas kernel. The JAX package's cached attention is flax's
// dot_product_attention over the decode cache (k8s_operator_libs_tpu/tpu/
// workload.py, MultiHeadDotProductAttention in decode mode), which XLA fuses;
// the port ran it as two einsums (tpu/workload.py _attend) that copied every
// layer's whole [b, total, h, hd] cache into new layouts each step and
// attended over all `total` positions, the unwritten ones masked.
//
// What it computes, for each row and head, the query of this step against
// the cache's written prefix:
//   o = softmax(q . K[0..index]^T / sqrt(hd)) . V[0..index]
// flax masks the positions after `index` with finfo.min, which gives them a
// weight of exactly 0, so leaving them unread is the same function. Scores,
// the running max and sum and the P.V accumulator are fp32 (the exp2
// domain); the output is rounded once, to q's dtype (bf16 or fp32).
//
// Layout: q and o [b, h, hd] (a step's one position); K and V the cache as
// flax lays it out, [b, total, h, hd], read in place. Every head dim whose
// head row is whole 16-byte chunks (bf16 hd % 8 == 0, fp32 hd % 4 == 0) up
// to 256 runs, on the kernel compiled for the next of 16, 32, 64, 128, 256.
//
// What bounds it on the card: bytes. A launch reads 2 * b * (index + 1) *
// h * hd elements of cache and does 4 * b * h * (index + 1) * hd operations,
// one operation a byte in bf16, far under the card's ~295. At the serving
// cell's shape (b 512, h 16, hd 64, bf16, index 255) that is 537 MB, 160 us
// at 3.35 TB/s. So the design is about moving the bytes:
// - A block takes one row's positions for a group of heads, all of them
//   where their lanes fit in 256 threads. Then a tile of positions is one
//   contiguous range of the cache (2 KB a position at GPT-2 medium),
//   fetched by one bulk copy for K and one for V; otherwise by one bulk
//   copy a position each.
// - One thread issues the copies into a ring of 3 stages, each completing
//   on its own mbarrier, so two tiles are in flight while the block folds
//   the third into its online softmax. A stage is refilled after a
//   __syncthreads once every thread has read it. Each byte of the prefix is
//   copied once and read from shared memory once.
// - A thread owns 16-byte chunks of one head (tph threads a head); a score
//   is a dot product over the chunks and a shuffle sum over the tph lanes.
//   Positions go four at a time: four scores, one rescale of the running
//   state, four exponentials and four V chunks into the accumulator.
// Which plan runs is chosen by the wrapper (tpu/flash_attention.py
// decode_plan) from the shape alone:
// - b x (head groups) blocks fill the card at least twice over (the
//   serving cell: 512 blocks of 16 heads on 132 SMs): each block takes its
//   row's whole prefix and writes the output; no split.
// - Fewer (GPT-2 XL at b 8: 8 blocks of 25 heads): the prefix is split over
//   up to ~2 x SMs blocks of at least four tiles each (flash-decoding).
//   Each writes its unnormalised fp32 accumulator with its max and sum, and
//   decode_attention_merge_kernel merges the parts in split order, in fp32.
// No atomics: a launch is deterministic. It launches on the given stream,
// never synchronises, allocates nothing (the wrapper passes the split
// plan's scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_mma.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kMaxThreads = 256;
constexpr int kGroup = 4;      // positions folded into the online softmax at a time
constexpr int kMaxTile = 32;   // positions a stage
constexpr int kMaxSmem = 226 * 1024;  // dynamic: an SM's 227 KB a block, less the mbarriers'
constexpr float kLog2e = 1.4426950408889634f;

// Elements of T a thread owns in a head of compiled width W: a 16-byte
// chunk, or two where one a lane would need more than 32 lanes a head.
template <typename T, int W>
struct Lanes {
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte chunk
  static constexpr int kVec = (W / 32 > kPiece) ? W / 32 : kPiece;
  static constexpr int kPieces = kVec / kPiece;
  static constexpr int kPerHead = W / kVec;  // threads a head: 2..32, a power of two
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8], __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8], float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint4 u;
  u.x = hopper::pack_bf16(f[0], f[1]);
  u.y = hopper::pack_bf16(f[2], f[3]);
  u.z = hopper::pack_bf16(f[4], f[5]);
  u.w = hopper::pack_bf16(f[6], f[7]);
  return u;
}

__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// The thread's kVec elements at `src` (a head row, global or shared) as
// floats; a 16-byte chunk at or past hd reads as 0.
template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* src, int col, int hd,
                                         float (&out)[Lanes<T, W>::kVec]) {
  using L = Lanes<T, W>;
#pragma unroll
  for (int c = 0; c < L::kPieces; ++c) {
    float f[8] = {};
    if (col + c * L::kPiece < hd) {
      unpack(*reinterpret_cast<const uint4*>(src + c * L::kPiece), f, T{});
    }
#pragma unroll
    for (int e = 0; e < L::kPiece; ++e) out[c * L::kPiece + e] = f[e];
  }
}

// Grid (head groups, splits, b); blockDim round_up(heads * kPerHead, 32).
// Block (group, split, row) attends heads [group * heads, +heads) of `row`
// over positions [split * split_len, min(n, +split_len)), n = index + 1.
// Without part_o it writes o; with it, the split's unnormalised
// accumulator part_o [b, splits, h, hd] and (max, sum) part_ml [b, splits,
// h, 2], both fp32 and in the exp2 domain.
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ part_o, float* __restrict__ part_ml, int total,
                            int h, int hd, int n, int heads, int tile, int split_len,
                            float scale_log2) {
  using L = Lanes<T, W>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int group = blockIdx.x, split = blockIdx.y, row = blockIdx.z;
  const int splits = gridDim.y;
  const int h0 = group * heads;
  const int hg = min(heads, h - h0);              // heads of this block
  const int p0 = split * split_len;
  const int count = min(n - p0, split_len);       // >= 1: the plan leaves no split empty
  const int n_tiles = (count + tile - 1) / tile;
  const int slice = hg * hd;                      // elements of a position, this block's heads
  const int stage_elems = tile * heads * hd;      // a K (or V) tile at the widest group
  const size_t pos_stride = static_cast<size_t>(h) * hd;
  const size_t first = (static_cast<size_t>(row) * total + p0) * pos_stride + h0 * hd;
  const T* k_src = k + first;
  const T* v_src = v + first;
  const bool contiguous = hg == h;                // a tile is one range of the cache

  const int head = threadIdx.x / L::kPerHead;     // within the group
  const int col = (threadIdx.x % L::kPerHead) * L::kVec;
  const bool active = head < hg;
  const int lim = active ? hd : 0;                // a lane past it reads zeros
  const int off = head * hd + col;                // within a position's slice

  // one thread fills a stage with tile t's positions, K then V
  auto issue = [&](int t) {
    const int s = t % kStages;
    const int cnt = min(tile, count - t * tile);
    const uint32_t bytes = static_cast<uint32_t>(slice * sizeof(T));
    const uint32_t bar = hopper::smem_u32(&full[s]);
    T* k_dst = smem + s * 2 * stage_elems;
    T* v_dst = k_dst + stage_elems;
    const size_t src = static_cast<size_t>(t) * tile * pos_stride;
    hopper::mbar_arrive_expect_tx(bar, 2 * cnt * bytes);
    if (contiguous) {
      hopper::bulk_load(hopper::smem_u32(k_dst), k_src + src, cnt * bytes, bar);
      hopper::bulk_load(hopper::smem_u32(v_dst), v_src + src, cnt * bytes, bar);
    } else {
      for (int p = 0; p < cnt; ++p) {
        const size_t at = src + p * pos_stride;
        hopper::bulk_load(hopper::smem_u32(k_dst + p * slice), k_src + at, bytes, bar);
        hopper::bulk_load(hopper::smem_u32(v_dst + p * slice), v_src + at, bytes, bar);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(hopper::smem_u32(&full[s]), 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue(t);
  }

  // this thread's query chunk, scaled into the exp2 domain
  float qv[L::kVec], acc[L::kVec];
  const size_t head_row = (static_cast<size_t>(row) * h + h0 + min(head, hg - 1)) * hd;
  load_vec<T, W>(q + head_row + col, col, lim, qv);
#pragma unroll
  for (int e = 0; e < L::kVec; ++e) {
    qv[e] *= scale_log2;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    hopper::mbar_wait(hopper::smem_u32(&full[s]), (t / kStages) & 1);
    const T* ks = smem + s * 2 * stage_elems + off;
    const T* vs = ks + stage_elems;
    const int cnt = min(tile, count - t * tile);
    for (int p = 0; p < cnt; p += kGroup) {
      float sc[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        sc[u] = 0.f;
        if (p + u < cnt) {  // uniform over the block
          float kv[L::kVec];
          load_vec<T, W>(ks + (p + u) * slice, col, lim, kv);
#pragma unroll
          for (int e = 0; e < L::kVec; ++e) sc[u] = fmaf(qv[e], kv[e], sc[u]);
        }
      }
#pragma unroll
      for (int x = L::kPerHead / 2; x > 0; x >>= 1) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], x);
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (p + u >= cnt) sc[u] = -INFINITY;
        m_new = fmaxf(m_new, sc[u]);
      }
      // m_new is finite: position p is always written
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (p + u < cnt) {
          const float w = exp2f(sc[u] - m_new);
          float vv[L::kVec];
          load_vec<T, W>(vs + (p + u) * slice, col, lim, vv);
          l += w;
#pragma unroll
          for (int e = 0; e < L::kVec; ++e) acc[e] = fmaf(w, vv[e], acc[e]);
        }
      }
      m = m_new;
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && t + kStages < n_tiles) issue(t + kStages);
  }

  if (!active) return;
#pragma unroll
  for (int c = 0; c < L::kPieces; ++c) {
    const int d = col + c * L::kPiece;
    if (d >= hd) break;
    float* a = acc + c * L::kPiece;
    if (part_o == nullptr) {
      float f[8] = {};
      const float inv = 1.f / l;
#pragma unroll
      for (int e = 0; e < L::kPiece; ++e) f[e] = a[e] * inv;
      *reinterpret_cast<uint4*>(o + head_row + d) = pack(f, T{});
    } else {
      const size_t at = ((static_cast<size_t>(row) * splits + split) * h + h0 + head) * hd + d;
#pragma unroll
      for (int e = 0; e < L::kPiece; ++e) part_o[at + e] = a[e];
    }
  }
  if (part_o != nullptr && col == 0) {
    const size_t at = ((static_cast<size_t>(row) * splits + split) * h + h0 + head) * 2;
    part_ml[at] = m;
    part_ml[at + 1] = l;
  }
}

// Grid (h, b), blockDim round_up(hd, 32): o[row, head, d] from the splits'
// parts, merged in split order in fp32.
template <typename T>
__global__ void decode_attention_merge_kernel(const float* __restrict__ part_o,
                                              const float* __restrict__ part_ml,
                                              T* __restrict__ o, int h, int hd, int splits) {
  const int head = blockIdx.x, row = blockIdx.y, d = threadIdx.x;
  if (d >= hd) return;
  const size_t base = static_cast<size_t>(row) * splits * h + head;  // split 0's (row, head)
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[(base + s * h) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = base + static_cast<size_t>(s) * h;
    const float w = exp2f(part_ml[at * 2] - m);
    l = fmaf(part_ml[at * 2 + 1], w, l);
    acc = fmaf(part_o[at * hd + d], w, acc);
  }
  const float out = acc / l;
  if constexpr (sizeof(T) == 2) {
    o[(static_cast<size_t>(row) * h + head) * hd + d] = __float2bfloat16_rn(out);
  } else {
    o[(static_cast<size_t>(row) * h + head) * hd + d] = out;
  }
}

// Dynamic shared memory above 48 KB must be allowed before a launch, once
// per kernel and device, at the most any plan asks; a refusal stays in
// cudaGetLastError, which the entry point returns.
template <auto Kernel>
void allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return;
  if (dev < kMaxDevices && allowed[dev]) return;
  // and the most shared memory an SM can hold, so that four 48 KB blocks fit
  if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) ==
          cudaSuccess &&
      cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) == cudaSuccess &&
      dev < kMaxDevices) {
    allowed[dev] = true;
  }
}

template <typename T, int W>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* part_o,
                   void* part_ml, int b, int total, int h, int hd, int n, int heads, int tile,
                   int splits, int split_len, float scale, cudaStream_t st) {
  using L = Lanes<T, W>;
  const int threads = (heads * L::kPerHead + 31) / 32 * 32;
  const int groups = (h + heads - 1) / heads;
  const size_t smem = static_cast<size_t>(kStages) * 2 * tile * heads * hd * sizeof(T);
  if (threads > kMaxThreads || groups > 65535 || smem > static_cast<size_t>(kMaxSmem) ||
      (hd * static_cast<int>(sizeof(T))) % 16 != 0)
    return cudaErrorInvalidValue;
  allow_smem<decode_attention_kernel<T, W>>();
  const bool merge = splits > 1;
  decode_attention_kernel<T, W><<<dim3(groups, splits, b), threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), merge ? static_cast<float*>(part_o) : nullptr,
      merge ? static_cast<float*>(part_ml) : nullptr, total, h, hd, n, heads, tile, split_len,
      scale * kLog2e);
  if (!merge) return cudaSuccess;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attention_merge_kernel<T><<<dim3(h, b), (hd + 31) / 32 * 32, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml), static_cast<T*>(o),
      h, hd, splits);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_width(int width, const void* q, const void* k, const void* v, void* o,
                         void* part_o, void* part_ml, int b, int total, int h, int hd, int n,
                         int heads, int tile, int splits, int split_len, float scale,
                         cudaStream_t st) {
#define DECODE_WIDTH(W)                                                                        \
  case W:                                                                                      \
    return launch<T, W>(q, k, v, o, part_o, part_ml, b, total, h, hd, n, heads, tile, splits, \
                        split_len, scale, st)
  switch (width) {
    DECODE_WIDTH(16);
    DECODE_WIDTH(32);
    DECODE_WIDTH(64);
    DECODE_WIDTH(128);
    DECODE_WIDTH(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_WIDTH
}

}  // namespace

extern "C" {

// o [b, h, hd] = cached attention of q [b, h, hd] over K/V [b, total, h, hd]
// at positions 0..index, in bf16 (is_bf16) or fp32; scale is 1/sqrt(hd).
// The plan (tpu/flash_attention.py decode_plan): `heads` a block, `tile`
// positions a stage, `splits` blocks a row's prefix of `split_len`
// positions each (none empty); with splits > 1, part_o [b, splits, h, hd]
// and part_ml [b, splits, h, 2] fp32 are the merge's scratch.
int decode_attention(const void* q, const void* k, const void* v, void* o, void* part_o,
                     void* part_ml, int b, int total, int h, int hd, int index, int heads,
                     int tile, int splits, int split_len, int is_bf16, float scale,
                     void* stream) {
  const int n = index + 1;
  if (b < 1 || b > 65535 || total < 1 || index < 0 || index >= total || h < 1 || hd < 1 ||
      hd > 256 || heads < 1 || heads > h || tile < kGroup || tile > kMaxTile ||
      tile % kGroup != 0 || splits < 1 || splits > 65535 || split_len < 1 ||
      static_cast<long long>(splits - 1) * split_len >= n ||
      static_cast<long long>(splits) * split_len < n ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int width = 16;
  while (width < hd) width *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t status =
      is_bf16 ? launch_width<__nv_bfloat16>(width, q, k, v, o, part_o, part_ml, b, total, h, hd,
                                            n, heads, tile, splits, split_len, scale, st)
              : launch_width<float>(width, q, k, v, o, part_o, part_ml, b, total, h, hd, n,
                                    heads, tile, splits, split_len, scale, st);
  return static_cast<int>(status != cudaSuccess ? status : cudaGetLastError());
}

}  // extern "C"
