// Weight-only int8 matrix product for Hopper: out = (x @ W^T) * scale.
//
// Replaces the Pallas kernel handwritten_ocr_tpu/ops/int8_matmul.py:_kernel.
//
// Layout: x [M, K] (bf16 or fp32, M <= 32 decode rows); W [N, K] int8 (the
// port's [out, in] layout: one output channel's weights are contiguous
// along K); scale [N] fp32; out [M, N] bf16 or fp32. Arithmetic as the TPU
// kernel: each int8 weight is widened to x's type (exact), products are
// summed in fp32, the fp32 sum is multiplied by its channel's scale, and
// only then cast to the output type.
//
// Bound: bytes. A decode step reads every weight once and does 2*M flops
// per weight byte (M <= 32), far below the card's ~295 flops per byte, so
// the kernel's job is to stream W at the memory rate and touch little else.
//
// Design (bf16 x). A block of 8 warps owns 128 output channels (16 per
// warp; 4 warps and 64 channels where N is small, so that the split-K
// merge below spreads over more blocks) and walks its k range in tiles of
// 128. Each tile's W slice (128 x
// 128 int8, 16 KB) and x slice (M rows x 128 bf16) go by 16-byte cp.async
// into a 4-stage ring of shared memory, so three tiles' loads fly while one
// computes (~64 KB in flight per block, two blocks per SM), and x is read
// from L2 once per block rather than once per warp. Each warp runs the
// product as mma.sync.m16n8k16 (bf16 -> fp32) with W as the A operand (16
// channels x 16 k), widened in registers by integer ops (i8x4_to_bf16),
// and x^T as B (16 k x 8 rows; ceil(M/8) row tiles). The sum over k does
// not care in which order k is visited, so k is permuted within each
// 64-wide half of a tile such that every lane's operands are 16 contiguous
// bytes: lane (g = lane/4, t = lane%4) reads channel g's and channel g+8's
// weights at k = 16t..16t+15 and x row g of each row tile at the same k;
// mma step s (0..3) takes bytes 4s..4s+3 as the fragment's logical k {2t,
// 2t+1, 2t+8, 2t+9}. Shared rows are XOR-swizzled by 16-byte chunk so those
// reads are free of bank conflicts. Where the channels alone give too few
// blocks to fill the card, K is split over blocks (grid.y) in the same
// launch: each split stores its fp32 partial, and the last block to arrive
// at its channel tile (an arrival counter in a zeroed workspace) sums the
// partials in split order, applies the scale, casts, writes and resets the
// counter to 0 — one launch, deterministic, and capturable in a CUDA graph.
// The ragged last k tile and ragged N are zero-filled in the loads; K not a
// multiple of 16 or unaligned pointers take byte loads into the same ring.
// fp32 x (the fp32 reference runs) takes an FMA body of its own
// (int8_f32_kernel, described above it) with the same split-K merge.
#include "hopper.cuh"

namespace {

// The bf16 kernel's block: WARPS (4 or 8) warps of 16 output channels,
// BN = 16 * WARPS channels per block.
constexpr int BK = 128;           // k per tile
constexpr int STAGES = 4;
constexpr int MAX_M = 32;

struct MatArgs {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* partial;   // [tiles, split, M, BN] fp32 when split > 1
  int* counters;    // [tiles] int32, 0 between launches, when split > 1
  int m, n, k, split, k_per_split;
};

template <int WARPS, int TILES> __host__ __device__ constexpr int stage_bytes() {
  return 16 * WARPS * BK + 8 * TILES * BK * 2;   // W tile, then x rows
}
template <int WARPS, int TILES> constexpr int smem_bytes() {
  return STAGES * stage_bytes<WARPS, TILES>();
}

// Chunk j (16 bytes) of W row r sits at chunk j ^ 4(r & 1); chunk j of x
// row r at chunk j ^ (r & 1). A quarter-warp's 16-byte reads (rows g, g+1
// of one parity pair, four chunks each) then hit 32 distinct banks.
__device__ __forceinline__ int w_chunk(int r, int j) { return j ^ ((r & 1) << 2); }
__device__ __forceinline__ int x_chunk(int r, int j) { return j ^ (r & 1); }

// One k tile into ring stage `sw` (W) / `sx` (x): 16-byte cp.async with
// zero fill past N, M or the split's k_end (ALIGNED), else byte loads.
template <int WARPS, int TILES, bool ALIGNED>
__device__ __forceinline__ void load_tile(const MatArgs& a, int8_t* sw,
                                          uint8_t* sx, int ch0, int k0,
                                          int k_end) {
  constexpr int NTHREADS = 32 * WARPS, BN = 16 * WARPS;
  const int tid = threadIdx.x;
  constexpr int W_CHUNKS = BN * BK / 16;          // 8 per row
  constexpr int X_CHUNKS = 8 * TILES * BK / 8;    // 16 per row
#pragma unroll
  for (int it = 0; it < W_CHUNKS / NTHREADS; ++it) {
    const int idx = it * NTHREADS + tid;
    const int r = idx / 8, j = idx % 8;
    const int ch = ch0 + r, kk = k0 + 16 * j;
    int8_t* dst = sw + r * BK + 16 * w_chunk(r, j);
    const int8_t* src = a.w + (size_t)ch * a.k + kk;
    if constexpr (ALIGNED) {
      const bool ok = ch < a.n && kk < k_end;
      cp_async16_zfill(dst, ok ? src : a.w, ok);
    } else {
      uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t b = (ch < a.n && kk + e < k_end) ? static_cast<uint8_t>(src[e]) : 0u;
        words[e / 4] |= b << (8 * (e % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
#pragma unroll
  for (int it = 0; it < (X_CHUNKS + NTHREADS - 1) / NTHREADS; ++it) {
    const int idx = it * NTHREADS + tid;
    if (idx >= X_CHUNKS) break;
    const int r = idx / 16, j = idx % 16;
    const int kk = k0 + 8 * j;
    uint8_t* dst = sx + r * (BK * 2) + 16 * x_chunk(r, j);
    const __nv_bfloat16* src = x + (size_t)r * a.k + kk;
    if constexpr (ALIGNED) {
      const bool ok = r < a.m && kk < k_end;
      cp_async16_zfill(dst, ok ? src : x, ok);
    } else {
      uint16_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = (r < a.m && kk + e < k_end) ? *reinterpret_cast<const uint16_t*>(src + e)
                                         : uint16_t(0);
      uint32_t words[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        words[e] = static_cast<uint32_t>(h[2 * e]) | (static_cast<uint32_t>(h[2 * e + 1]) << 16);
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

// The warp's products over one k tile in the ring.
template <int TILES>
__device__ __forceinline__ void mma_tile(float (&acc)[TILES][4], const int8_t* sw,
                                         const uint8_t* sx, int row_lo, int g, int t) {
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jw = 4 * half + t;                // 16-byte chunk of W
    const uint4 w_lo = *reinterpret_cast<const uint4*>(sw + row_lo * BK + 16 * w_chunk(row_lo, jw));
    const uint4 w_hi = *reinterpret_cast<const uint4*>(sw + row_hi * BK + 16 * w_chunk(row_hi, jw));
    uint4 xv[TILES][2];
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      const int r = 8 * j + g;
      const int jx = 8 * half + 2 * t;          // 16-byte chunks of x
      xv[j][0] = *reinterpret_cast<const uint4*>(sx + r * (BK * 2) + 16 * x_chunk(r, jx));
      xv[j][1] = *reinterpret_cast<const uint4*>(sx + r * (BK * 2) + 16 * x_chunk(r, jx + 1));
    }
    const uint32_t* wl = &w_lo.x;
    const uint32_t* wh = &w_hi.x;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t frag[4];
      i8x4_to_bf16(wl[s], frag[0], frag[2]);
      i8x4_to_bf16(wh[s], frag[1], frag[3]);
#pragma unroll
      for (int j = 0; j < TILES; ++j) {
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(xv[j]);
        mma_bf16(acc[j], frag, xw[2 * s], xw[2 * s + 1]);
      }
    }
  }
}

// After a split's block has stored its fp32 partial [M][BN] of channel
// tile `tile`: the last block of the tile to arrive (an arrival counter in
// a zeroed workspace) sums the partials in split order, applies the scale,
// casts, writes and resets the counter to 0.
template <typename OUT, int BN, int NTHREADS>
__device__ void arrive_and_merge(const MatArgs& a, int tile, int ch0) {
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const float* part = a.partial + (size_t)tile * a.split * a.m * BN;
  __threadfence();     // this split's partial is visible before it arrives
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + tile, 1) == a.split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();     // every split's partial is visible to the last block
  // Four channels per thread and step: 16-byte loads, many in flight.
  const float4* part4 = reinterpret_cast<const float4*>(part);
  const size_t split_stride = (size_t)a.m * BN / 4;
  for (int idx = tid; idx < a.m * BN / 4; idx += NTHREADS) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int y = 0; y < a.split; ++y) {   // in split order: deterministic
      const float4 v = __ldcg(part4 + y * split_stride + idx);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int row = idx / (BN / 4), c = 4 * (idx % (BN / 4));
    const float sums[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = ch0 + c + e;
      if (ch < a.n)
        static_cast<OUT*>(a.out)[(size_t)row * a.n + ch] = from_f<OUT>(sums[e] * a.scale[ch]);
    }
  }
  if (tid == 0) a.counters[tile] = 0;   // ready for the next launch
}

template <typename OUT, int WARPS, int TILES, bool ALIGNED>
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
int8_mma_kernel(const MatArgs a) {
  constexpr int NTHREADS = 32 * WARPS, BN = 16 * WARPS;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int ch0 = tile * BN;
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.k, k_begin + a.k_per_split);
  const int n_kt = (k_end - k_begin + BK - 1) / BK;

  float acc[TILES][4];
#pragma unroll
  for (int j = 0; j < TILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  constexpr int SB = stage_bytes<WARPS, TILES>();
  auto stage_w = [&](int i) { return reinterpret_cast<int8_t*>(smem + i * SB); };
  auto stage_x = [&](int i) { return smem + i * SB + BN * BK; };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_kt)
      load_tile<WARPS, TILES, ALIGNED>(a, stage_w(i), stage_x(i), ch0, k_begin + i * BK, k_end);
    cp_async_commit();
  }
  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile i landed for all; stage (i - 1) % STAGES is free
    const int nxt = i + STAGES - 1;
    if (nxt < n_kt)
      load_tile<WARPS, TILES, ALIGNED>(a, stage_w(nxt % STAGES), stage_x(nxt % STAGES), ch0,
                                       k_begin + nxt * BK, k_end);
    cp_async_commit();
    mma_tile<TILES>(acc, stage_w(i % STAGES), stage_x(i % STAGES), 16 * warp + g, g, t);
  }
  cp_async_wait<0>();

  // C fragment: acc[j][0..1] = channel 16w+g, rows 8j+2t, 8j+2t+1; [2..3]
  // = channel 16w+g+8.
  if (a.split == 1) {
#pragma unroll
    for (int j = 0; j < TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * j + 2 * t + (e % 2);
        const int ch = ch0 + 16 * warp + g + (e < 2 ? 0 : 8);
        if (row < a.m && ch < a.n)
          static_cast<OUT*>(a.out)[(size_t)row * a.n + ch] = from_f<OUT>(acc[j][e] * a.scale[ch]);
      }
    return;
  }
  float* part = a.partial + (size_t)tile * a.split * a.m * BN;
#pragma unroll
  for (int j = 0; j < TILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * j + 2 * t + (e % 2);
      const int c = 16 * warp + g + (e < 2 ? 0 : 8);
      if (row < a.m) part[((size_t)split * a.m + row) * BN + c] = acc[j][e];
    }
  arrive_and_merge<OUT, BN, NTHREADS>(a, tile, ch0);
}

// ---- fp32 x: the FMA body --------------------------------------------------
//
// Replaces the first fp32-x kernel (one warp per output channel, lanes
// stepping over k one byte each), in which every warp read all of x,
// [M, K] fp32, from L2 again: 12.6 GB of L2 reads at a qwen3:32b gate of
// 24 rows against 131 MB of weights. Bound: operations. The products stay
// in full fp32 (no TF32: the TPU kernel widens exactly and sums in fp32,
// and the fp32 reference runs exist to be exact), 2*M*N*K flops at the
// card's 67 TFLOP/s of fp32 FMAs (the gate at 24 rows: 0.094 ms), well
// above the weight read (0.039 ms).
//
// A block of 8 warps owns 128 output channels and walks its k range in
// tiles of 128: the tile's W slice (128 x 128 int8, chunk j of row r at
// chunk j ^ (r & 7)) and x slice (M rows x 128 fp32) go by 16-byte cp.async
// into a 4-stage ring of shared memory, so x is read from L2 once per
// block. Warp w takes k 16w .. 16w+15 of every tile, lane l channels l +
// 32i (i < 4): a 16-byte read of each channel's 16 k (conflict-free by the
// swizzle), widened to fp32 exactly by a byte permute and one subtraction
// (0x4B0000uu is 2^23 + uu), then for each row m one broadcast 16-byte read
// of x[m] and 16 FMAs into the lane's 4 x M fp32 sums: 16 FMAs per shared
// memory read. The eight warps' sums meet in shared memory and are added
// in warp order; the channel scale multiplies the fp32 sum. Where the
// channels alone do not fill the SMs, K is split over blocks (grid.y) and
// merged in the launch as in the bf16 body (arrive_and_merge).
constexpr int F32_WARPS = 8;
constexpr int F32_BN = 128;   // output channels per block: 4 per lane
constexpr int F32_STAGES = 4;

template <int MT> __host__ __device__ constexpr int f32_stage_bytes() {
  return F32_BN * BK + MT * BK * (int)sizeof(float);   // W tile, then x rows
}

// One k tile into ring stage `sw` (W) / `sx` (x): 16-byte cp.async with
// zero fill past N, M or k_end (ALIGNED), else element loads.
template <int MT, bool ALIGNED>
__device__ __forceinline__ void load_f32_tile(const MatArgs& a, int8_t* sw, float* sx, int ch0,
                                              int k0, int k_end) {
  constexpr int NTHREADS = 32 * F32_WARPS;
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < F32_BN * (BK / 16) / NTHREADS; ++it) {
    const int idx = it * NTHREADS + tid, r = idx / 8, j = idx % 8;
    const int ch = ch0 + r, kk = k0 + 16 * j;
    int8_t* dst = sw + r * BK + 16 * (j ^ (r & 7));
    const int8_t* src = a.w + (size_t)ch * a.k + kk;
    if constexpr (ALIGNED) {
      const bool ok = ch < a.n && kk < k_end;
      cp_async16_zfill(dst, ok ? src : a.w, ok);
    } else {
      uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t b = (ch < a.n && kk + e < k_end) ? static_cast<uint8_t>(src[e]) : 0u;
        words[e / 4] |= b << (8 * (e % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
  const float* x = static_cast<const float*>(a.x);
  for (int idx = tid; idx < MT * (BK / 4); idx += NTHREADS) {
    const int r = idx / (BK / 4), j = idx % (BK / 4), kk = k0 + 4 * j;
    float* dst = sx + r * BK + 4 * j;
    const float* src = x + (size_t)r * a.k + kk;
    if constexpr (ALIGNED) {
      const bool ok = r < a.m && kk < k_end;
      cp_async16_zfill(dst, ok ? src : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = (r < a.m && kk + e < k_end) ? src[e] : 0.f;
    }
  }
}

// The lane's channels lane + 32i against k 16 warp .. 16 warp + 15 of one
// k tile in the ring.
template <int MT>
__device__ __forceinline__ void f32_tile(float (&acc)[4][MT], const int8_t* sw, const float* sx,
                                         int warp, int lane) {
  uint4 wr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = lane + 32 * i;
    wr[i] = *reinterpret_cast<const uint4*>(sw + r * BK + 16 * (warp ^ (r & 7)));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {   // k 16 warp + 4q .. + 3
    float wf[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t word = (&wr[i].x)[q] ^ 0x80808080u;   // byte b -> b + 128
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wf[i][e] = __uint_as_float(__byte_perm(word, 0x4B00u, 0x5440u | e)) - 8388736.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 xv = *reinterpret_cast<const float4*>(sx + m * BK + 16 * warp + 4 * q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][m] = fmaf(wf[i][0], xv.x, acc[i][m]);
        acc[i][m] = fmaf(wf[i][1], xv.y, acc[i][m]);
        acc[i][m] = fmaf(wf[i][2], xv.z, acc[i][m]);
        acc[i][m] = fmaf(wf[i][3], xv.w, acc[i][m]);
      }
    }
  }
}

template <int MT, bool ALIGNED>
__global__ void __launch_bounds__(32 * F32_WARPS, 1)
int8_f32_kernel(const MatArgs a) {
  constexpr int NTHREADS = 32 * F32_WARPS, SB = f32_stage_bytes<MT>();
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int ch0 = tile * F32_BN;
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.k, k_begin + a.k_per_split);
  const int n_kt = (k_end - k_begin + BK - 1) / BK;

  float acc[4][MT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[i][m] = 0.f;
  auto stage_w = [&](int i) { return reinterpret_cast<int8_t*>(smem + i * SB); };
  auto stage_x = [&](int i) { return reinterpret_cast<float*>(smem + i * SB + F32_BN * BK); };
#pragma unroll
  for (int i = 0; i < F32_STAGES - 1; ++i) {
    if (i < n_kt) load_f32_tile<MT, ALIGNED>(a, stage_w(i), stage_x(i), ch0, k_begin + i * BK, k_end);
    cp_async_commit();
  }
  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<F32_STAGES - 2>();
    __syncthreads();   // tile i landed for all; stage (i - 1) % STAGES is free
    const int nxt = i + F32_STAGES - 1;
    if (nxt < n_kt)
      load_f32_tile<MT, ALIGNED>(a, stage_w(nxt % F32_STAGES), stage_x(nxt % F32_STAGES), ch0,
                                 k_begin + nxt * BK, k_end);
    cp_async_commit();
    f32_tile<MT>(acc, stage_w(i % F32_STAGES), stage_x(i % F32_STAGES), warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' sums meet there

  // Eight rows at a time: red[warp][row][channel], summed in warp order.
  float* red = reinterpret_cast<float*>(smem);
  float* part = a.partial + ((size_t)tile * a.split + split) * a.m * F32_BN;
#pragma unroll
  for (int m0 = 0; m0 < MT; m0 += 8) {
#pragma unroll
    for (int mm = 0; mm < 8; ++mm)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[(warp * 8 + mm) * F32_BN + lane + 32 * i] = acc[i][m0 + mm];
    __syncthreads();
    for (int idx = tid; idx < 8 * F32_BN; idx += NTHREADS) {
      const int mm = idx / F32_BN, c = idx % F32_BN, row = m0 + mm, ch = ch0 + c;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < F32_WARPS; ++w) sum += red[(w * 8 + mm) * F32_BN + c];
      if (row >= a.m) continue;
      if (a.split > 1) part[(size_t)row * F32_BN + c] = sum;
      else if (ch < a.n) static_cast<float*>(a.out)[(size_t)row * a.n + ch] = sum * a.scale[ch];
    }
    __syncthreads();   // red is rewritten by the next eight rows
  }
  if (a.split > 1) arrive_and_merge<float, F32_BN, NTHREADS>(a, tile, ch0);
}

template <int MT, bool ALIGNED>
cudaError_t launch_f32(const MatArgs& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  auto kernel = int8_f32_kernel<MT, ALIGNED>;
  constexpr int smem = F32_STAGES * f32_stage_bytes<MT>();
  static_assert(8 * F32_WARPS * F32_BN * sizeof(float) <= (size_t)smem, "the warps' sums fit the ring");
  cudaError_t err = set_smem_once(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + F32_BN - 1) / F32_BN, a.split);
  kernel<<<grid, 32 * F32_WARPS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool ALIGNED>
cudaError_t dispatch_f32(const MatArgs& a, cudaStream_t stream) {
  switch ((a.m + 7) / 8) {
    case 1: return launch_f32<8, ALIGNED>(a, stream);
    case 2: return launch_f32<16, ALIGNED>(a, stream);
    case 3: return launch_f32<24, ALIGNED>(a, stream);
    case 4: return launch_f32<32, ALIGNED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename OUT, int WARPS, int TILES, bool ALIGNED>
cudaError_t launch_mma(const MatArgs& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  auto kernel = int8_mma_kernel<OUT, WARPS, TILES, ALIGNED>;
  constexpr int smem = smem_bytes<WARPS, TILES>();
  cudaError_t err = set_smem_once(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 16 * WARPS - 1) / (16 * WARPS), a.split);
  kernel<<<grid, 32 * WARPS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename OUT, int WARPS, bool ALIGNED>
cudaError_t dispatch_tiles(const MatArgs& a, cudaStream_t stream) {
  switch ((a.m + 7) / 8) {
    case 1: return launch_mma<OUT, WARPS, 1, ALIGNED>(a, stream);
    case 2: return launch_mma<OUT, WARPS, 2, ALIGNED>(a, stream);
    case 3: return launch_mma<OUT, WARPS, 3, ALIGNED>(a, stream);
    case 4: return launch_mma<OUT, WARPS, 4, ALIGNED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename OUT>
cudaError_t dispatch(const MatArgs& a, int block_channels, bool aligned,
                     cudaStream_t stream) {
  if (block_channels == 64)
    return aligned ? dispatch_tiles<OUT, 4, true>(a, stream)
                   : dispatch_tiles<OUT, 4, false>(a, stream);
  if (block_channels == 128)
    return aligned ? dispatch_tiles<OUT, 8, true>(a, stream)
                   : dispatch_tiles<OUT, 8, false>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// One call's arguments in one record, as the Python wrapper packs them
// (struct format "=7Q9i"): one ctypes argument to convert instead of 16.
// x_dtype / out_dtype: 0 = float32, 1 = bfloat16 (fp32 x needs fp32 out).
// block_channels: output channels per block (BN): 64 or 128 for bf16 x,
// 128 for fp32 x. split > 1 needs `partial` of
// ceil(N/BN)*split*M*BN fp32 and `counters` of ceil(N/BN) int32 that are 0
// (the kernel leaves them 0); split y sums k in [y * k_per_split, (y + 1)
// * k_per_split), a multiple of 64 when split > 1: the splits must cover K
// and none may be empty. aligned: K % 16 == 0 and x, W 16-byte aligned.
struct Int8MatmulCall {
  const void* x;
  const void* w;
  const void* scale;
  void* out;
  void* partial;
  void* counters;
  void* stream;
  int m, n, k, split, k_per_split, block_channels, aligned, x_dtype, out_dtype;
};

// Returns cudaGetLastError() after the launch (0 = launched).
HOCR_EXPORT int hocr_int8_matmul(const Int8MatmulCall* call) {
  const Int8MatmulCall& c = *call;
  if (c.m == 0 || c.n == 0) return 0;
  if (c.m < 0 || c.m > MAX_M || c.k <= 0 || c.split < 1 || c.k_per_split < 1 ||
      (c.split > 1 && c.k_per_split % 64 != 0) ||
      (long long)(c.split - 1) * c.k_per_split >= c.k ||
      (long long)c.split * c.k_per_split < c.k ||
      (c.split > 1 && (c.partial == nullptr || c.counters == nullptr)))
    return cudaErrorInvalidValue;
  MatArgs a;
  a.x = c.x;
  a.w = static_cast<const int8_t*>(c.w);
  a.scale = static_cast<const float*>(c.scale);
  a.out = c.out;
  a.partial = static_cast<float*>(c.partial);
  a.counters = static_cast<int*>(c.counters);
  a.m = c.m;
  a.n = c.n;
  a.k = c.k;
  a.split = c.split;
  a.k_per_split = c.k_per_split;
  cudaStream_t stm = static_cast<cudaStream_t>(c.stream);
  if (c.x_dtype == kFloat32) {
    if (c.out_dtype != kFloat32 || c.block_channels != F32_BN) return cudaErrorInvalidValue;
    return c.aligned ? dispatch_f32<true>(a, stm) : dispatch_f32<false>(a, stm);
  }
  if (c.x_dtype != kBFloat16) return cudaErrorInvalidValue;
  if (c.out_dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(a, c.block_channels, c.aligned != 0, stm);
  if (c.out_dtype == kFloat32) return dispatch<float>(a, c.block_channels, c.aligned != 0, stm);
  return cudaErrorInvalidValue;
}
