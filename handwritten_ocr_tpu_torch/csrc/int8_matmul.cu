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
// the kernel's job is to stream W at the memory rate and touch it once.
//
// Design (bf16 x): one warp owns 16 output channels and runs the product
// as mma.sync.m16n8k16 (bf16 -> fp32) with W as the A operand (16 channels
// x 16 k) and x^T as B (16 k x 8 rows of x; ceil(M/8) tiles). The sum over
// k does not care in which order k is visited, so k is permuted within each
// 64-wide chunk such that every lane's operands are contiguous in memory:
// lane (g = lane/4, t = lane%4) loads 16 bytes of channel g and 16 of
// channel g+8 at k = 16t..16t+15 of the chunk, and 32 bytes of x row g of
// each row tile at the same k; mma step s (0..3) takes bytes 4s..4s+3 of
// them as the fragment's logical k {2t, 2t+1, 2t+8, 2t+9}. Weights are
// read with streaming loads (evict-first) and the next chunk is loaded
// while the current one computes. Where the channels alone give too few
// blocks to keep the card's memory busy (N <= 25600 at the decode shapes),
// K is split over blocks (grid.y); each split writes an fp32 partial and a
// second small kernel sums the splits in a fixed order, applies the scale
// and casts. fp32 x (tests, the fp32 reference) takes a plain FMA kernel,
// one warp per channel.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;        // warps per block
constexpr int NTHREADS = 32 * WARPS;
constexpr int CH = 16;          // output channels per warp (mma rows)
constexpr int KC = 64;          // k per chunk (4 mma k-steps of 16)
constexpr int MAX_M = 32;

struct MatArgs {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* partial;   // [split, M, N] fp32 when split > 1
  int m, n, k, split, chunks_per_split;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes i and i+1 of a 16-byte weight vector, widened to a bf16 pair
// (byte i in the low half). Every int8 value is exact in bf16.
__device__ __forceinline__ uint32_t widen2(const uint4& w, int i) {
  const uint32_t word = (&w.x)[i / 4];
  const int lo = static_cast<int8_t>((word >> (8 * (i % 4))) & 0xffu);
  const int hi = static_cast<int8_t>((word >> (8 * (i % 4 + 1))) & 0xffu);
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 weights row[k0 .. k0+15], 0 past K or for a channel past N.
template <bool ALIGNED>
__device__ __forceinline__ uint4 load_w16(const int8_t* row, int k0, int k,
                                          bool valid) {
  if constexpr (ALIGNED) {   // K % 16 == 0: a chunk piece is wholly in or out
    if (valid && k0 < k) return __ldcs(reinterpret_cast<const uint4*>(row + k0));
    return make_uint4(0, 0, 0, 0);
  } else {
    uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t b = (valid && k0 + j < k) ? static_cast<uint8_t>(row[k0 + j]) : 0u;
      words[j / 4] |= b << (8 * (j % 4));
    }
    return make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// 16 bf16 values row[k0 .. k0+15] as 8 words, 0 past K or for a row past M.
template <bool ALIGNED>
__device__ __forceinline__ void load_x16(const __nv_bfloat16* row, int k0,
                                         int k, bool valid, uint4 (&out)[2]) {
  if constexpr (ALIGNED) {
    if (valid && k0 < k) {
      out[0] = __ldg(reinterpret_cast<const uint4*>(row + k0));
      out[1] = __ldg(reinterpret_cast<const uint4*>(row + k0 + 8));
    } else {
      out[0] = out[1] = make_uint4(0, 0, 0, 0);
    }
  } else {
    uint16_t h[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      h[j] = (valid && k0 + j < k)
                 ? *reinterpret_cast<const uint16_t*>(row + k0 + j) : uint16_t(0);
    }
    uint32_t* words = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      words[j] = static_cast<uint32_t>(h[2 * j]) | (static_cast<uint32_t>(h[2 * j + 1]) << 16);
  }
}

template <int TILES>
struct Chunk {
  uint4 w_lo, w_hi;     // channels g and g+8
  uint4 x[TILES][2];    // rows 8j+g of x
};

template <int TILES, bool ALIGNED>
__device__ __forceinline__ void load_chunk(Chunk<TILES>& c, const MatArgs& a,
                                           const int8_t* w_lo, const int8_t* w_hi,
                                           bool ok_lo, bool ok_hi, int g, int k0) {
  c.w_lo = load_w16<ALIGNED>(w_lo, k0, a.k, ok_lo);
  c.w_hi = load_w16<ALIGNED>(w_hi, k0, a.k, ok_hi);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
#pragma unroll
  for (int j = 0; j < TILES; ++j) {
    const int row = 8 * j + g;
    load_x16<ALIGNED>(x + (size_t)row * a.k, k0, a.k, row < a.m, c.x[j]);
  }
}

template <int TILES>
__device__ __forceinline__ void mma_chunk(float (&acc)[TILES][4],
                                          const Chunk<TILES>& c) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t frag[4];
    frag[0] = widen2(c.w_lo, 4 * s);
    frag[1] = widen2(c.w_hi, 4 * s);
    frag[2] = widen2(c.w_lo, 4 * s + 2);
    frag[3] = widen2(c.w_hi, 4 * s + 2);
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(c.x[j]);
      mma_bf16(acc[j], frag, xw[2 * s], xw[2 * s + 1]);
    }
  }
}

template <typename OUT, int TILES, bool ALIGNED>
__global__ void __launch_bounds__(NTHREADS)
int8_mma_kernel(const MatArgs a) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ch0 = (blockIdx.x * WARPS + threadIdx.x / 32) * CH;
  if (ch0 >= a.n) return;
  const int ch_lo = ch0 + g, ch_hi = ch0 + g + 8;
  const bool ok_lo = ch_lo < a.n, ok_hi = ch_hi < a.n;
  const int8_t* w_lo = a.w + (size_t)ch_lo * a.k;
  const int8_t* w_hi = a.w + (size_t)ch_hi * a.k;
  const int n_chunks = (a.k + KC - 1) / KC;
  const int c_begin = blockIdx.y * a.chunks_per_split;
  const int c_end = min(n_chunks, c_begin + a.chunks_per_split);

  float acc[TILES][4];
#pragma unroll
  for (int j = 0; j < TILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (c_begin < c_end) {
    Chunk<TILES> cur, nxt;
    load_chunk<TILES, ALIGNED>(cur, a, w_lo, w_hi, ok_lo, ok_hi, g,
                               c_begin * KC + 16 * t);
    for (int c = c_begin; c < c_end; ++c) {
      if (c + 1 < c_end)   // the next chunk's loads fly while this one computes
        load_chunk<TILES, ALIGNED>(nxt, a, w_lo, w_hi, ok_lo, ok_hi, g,
                                   (c + 1) * KC + 16 * t);
      mma_chunk<TILES>(acc, cur);
      cur = nxt;
    }
  }

  // C fragment: acc[j][0..1] = channel g, rows 8j+2t, 8j+2t+1; [2..3] = g+8.
#pragma unroll
  for (int j = 0; j < TILES; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * j + 2 * t + (e % 2);
      const int ch = e < 2 ? ch_lo : ch_hi;
      if (row >= a.m || ch >= a.n) continue;
      if (a.split == 1) {
        static_cast<OUT*>(a.out)[(size_t)row * a.n + ch] =
            from_f<OUT>(acc[j][e] * a.scale[ch]);
      } else {
        a.partial[((size_t)blockIdx.y * a.m + row) * a.n + ch] = acc[j][e];
      }
    }
  }
}

// fp32 x: one warp per output channel, lanes stride over k, M fp32 sums
// per lane reduced across the warp; scale on the fp32 sum.
__global__ void __launch_bounds__(NTHREADS)
int8_simt_kernel(const MatArgs a) {
  const int lane = threadIdx.x % 32;
  const int ch = blockIdx.x * WARPS + threadIdx.x / 32;
  if (ch >= a.n) return;
  const float* x = static_cast<const float*>(a.x);
  const int8_t* w = a.w + (size_t)ch * a.k;
  float acc[MAX_M];
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) acc[m] = 0.f;
  for (int kk = lane; kk < a.k; kk += 32) {
    const float wv = static_cast<float>(w[kk]);
#pragma unroll
    for (int m = 0; m < MAX_M; ++m)
      if (m < a.m) acc[m] = fmaf(x[(size_t)m * a.k + kk], wv, acc[m]);
  }
  const float sc = a.scale[ch];
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) {
    if (m >= a.m) break;
    const float total = group_sum<32>(acc[m]);
    if (lane == 0) static_cast<float*>(a.out)[(size_t)m * a.n + ch] = total * sc;
  }
}

// Sums the split partials of one output in split order, then scale, cast.
template <typename OUT>
__global__ void combine_kernel(const MatArgs a) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)a.m * a.n;
  if (idx >= total) return;
  float sum = 0.f;
  for (int y = 0; y < a.split; ++y) sum += a.partial[(size_t)y * total + idx];
  static_cast<OUT*>(a.out)[idx] = from_f<OUT>(sum * a.scale[idx % a.n]);
}

template <typename OUT, int TILES>
cudaError_t launch_mma(const MatArgs& a, bool aligned, cudaStream_t stream) {
  const dim3 grid((a.n + WARPS * CH - 1) / (WARPS * CH), a.split);
  if (aligned)
    int8_mma_kernel<OUT, TILES, true><<<grid, NTHREADS, 0, stream>>>(a);
  else
    int8_mma_kernel<OUT, TILES, false><<<grid, NTHREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return err;
  const size_t total = (size_t)a.m * a.n;
  combine_kernel<OUT><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename OUT>
cudaError_t dispatch_tiles(const MatArgs& a, bool aligned, cudaStream_t stream) {
  switch ((a.m + 7) / 8) {
    case 1: return launch_mma<OUT, 1>(a, aligned, stream);
    case 2: return launch_mma<OUT, 2>(a, aligned, stream);
    case 3: return launch_mma<OUT, 3>(a, aligned, stream);
    case 4: return launch_mma<OUT, 4>(a, aligned, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = launched). x_dtype /
// out_dtype: 0 = float32, 1 = bfloat16 (fp32 x needs fp32 out). split > 1
// needs `partial` of split*M*N fp32 and bf16 x; chunks_per_split counts
// 64-wide k chunks. aligned: K % 16 == 0 and x, W 16-byte aligned.
HOCR_EXPORT int hocr_int8_matmul(const void* x, const void* w,
                                 const void* scale, void* out, void* partial,
                                 int m, int n, int k, int split,
                                 int chunks_per_split, int aligned,
                                 int x_dtype, int out_dtype, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (m < 0 || m > MAX_M || k <= 0 || split < 1 || chunks_per_split < 1)
    return cudaErrorInvalidValue;
  MatArgs a;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.partial = static_cast<float*>(partial);
  a.m = m;
  a.n = n;
  a.k = k;
  a.split = split;
  a.chunks_per_split = chunks_per_split;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32) {
    if (out_dtype != kFloat32 || split != 1) return cudaErrorInvalidValue;
    int8_simt_kernel<<<(n + WARPS - 1) / WARPS, NTHREADS, 0, stm>>>(a);
    return cudaGetLastError();
  }
  if (x_dtype != kBFloat16) return cudaErrorInvalidValue;
  if (out_dtype == kBFloat16) return dispatch_tiles<__nv_bfloat16>(a, aligned != 0, stm);
  if (out_dtype == kFloat32) return dispatch_tiles<float>(a, aligned != 0, stm);
  return cudaErrorInvalidValue;
}
