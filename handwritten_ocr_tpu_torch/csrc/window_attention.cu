// Window attention of the vision tower for Hopper: block-diagonal attention
// inside uniform 64-token windows, reading packed qkv, rope applied on load.
//
// Replaces the Pallas kernels handwritten_ocr_tpu/ops/window_attention.py:
// _packed_kernel (default layout) and _window_kernel (fold layout), which
// compute the same function. The TPU kernel takes a chunk of windows per
// grid step and masks the off-diagonal blocks of one big score matrix;
// here a block owns one (page, window, group of heads), so no score outside
// the window is ever computed.
//
// Layout: qkv [B, P, 3*H*hd] (q | k | v, heads contiguous inside each),
// cos/sin [P, hd] fp32, valid [P] uint8 (0 = dead slot), out [B, P, H*hd].
// Math, as the TPU kernel: cos/sin rounded to the qkv dtype; q and k roped
// (x*cos + rotate_half(x)*sin, fp32 then one rounding to the qkv dtype);
// scores fp32, dead keys -inf; softmax with the all-masked guard (such a row
// returns 0); P divided by its denominator and rounded to the qkv dtype
// BEFORE the P.V product; fp32 accumulation.
//
// What bounds it: bytes. At the tower's shape (qkv [8, 3456, 3840] bf16,
// 16 heads of 80) it reads 212 MB and writes 71 MB against ~9 GFLOP, so
// the design moves every byte once, in 16-byte vectors, and keeps the
// products off the FMA pipes.
//
// Two bodies, one function:
// - bf16 (the model's dtype): one block of 256 threads per (page, window,
//   pair of heads). cp.async brings the pair's q, k, v rows in 16-byte
//   vectors into shared memory (rows padded to 176 bytes so ldmatrix hits
//   distinct banks) while the threads read the window's cos/sin once for
//   both heads and round them to bf16. Rope runs in registers on 16-byte
//   vectors: vector j of a head's first half pairs with vector j + 5 (40 =
//   5 x 8), and each product and the sum round in fp32 as PyTorch rounds
//   them, then once to bf16. Warps 0-3 take head 0 and warps 4-7 head 1,
//   16 query rows each: Q.K^T and P.V run as mma.sync.m16n8k16 (bf16 in,
//   fp32 accumulate) from ldmatrix fragments (V transposed by
//   ldmatrix.trans); the scores stay in registers, and P is normalised and
//   rounded to bf16 there before it becomes the A operand of P.V. Each
//   warp stages its 16 x 80 output in its own q rows and writes whole head
//   rows as 16-byte vectors. 88 KB of shared memory: two blocks per SM, so
//   one block's loads overlap another's products.
// - fp32: the 64 x hd q, k, v tiles and the 64 x 64 score tile sit in
//   shared memory (~70 KB at hd 80). 256 threads as 16 x 16; each owns 4
//   rows x 4 strided columns of the scores and 4 rows x hd/16 output
//   columns. Plain fp32 FMA.
#include "hopper.cuh"

namespace {

constexpr int WL = 64;  // window length
constexpr int NT = 256;

template <int HD> constexpr size_t window_smem_bytes() {
  return sizeof(float) * (size_t)(2 * WL * (HD + 1) + WL * HD + WL * (WL + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
window_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, const uint8_t* __restrict__ valid,
              T* __restrict__ out, int p_len, int heads, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1;
  constexpr int PS = WL + 1;
  constexpr int NC = HD / 16;
  constexpr int HALF = HD / 2;
  float* sq = smem;             // [WL][QS]
  float* sk = sq + WL * QS;     // [WL][QS]
  float* sv = sk + WL * QS;     // [WL][HD]
  float* sp = sv + WL * HD;     // [WL][PS]

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int d_model = heads * HD;
  const size_t row_stride = 3 * (size_t)d_model;
  const int p0 = w * WL;
  const T* base = qkv + ((size_t)b * p_len + p0) * row_stride + (size_t)h * HD;

  for (int i = tid; i < WL * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    const T* row = base + (size_t)r * row_stride;
    const int partner = c < HALF ? c + HALF : c - HALF;
    const float sign = c < HALF ? -1.f : 1.f;
    const float cs = round_to<T>(cos_t[(size_t)(p0 + r) * HD + c]);
    const float sn = round_to<T>(sin_t[(size_t)(p0 + r) * HD + c]);
    const float qx = to_f(row[c]), qr = sign * to_f(row[partner]);
    const float kx = to_f(row[d_model + c]), kr = sign * to_f(row[d_model + partner]);
    sq[r * QS + c] = round_to<T>(qx * cs + qr * sn);
    sk[r * QS + c] = round_to<T>(kx * cs + kr * sn);
    sv[r * HD + c] = to_f(row[2 * d_model + c]);
  }
  __syncthreads();

  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], kk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sq[(ty * 4 + i) * QS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kk[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
  }

  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ok[j] = valid[p0 + tx + 16 * j] != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = ok[j] ? s[i][j] * scale : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = group_max<16>(mx);
    const float safe = (mx == -INFINITY) ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = ok[j] ? expf(s[i][j] - safe) : 0.f;
      sum += s[i][j];
    }
    const float denom = fmaxf(group_sum<16>(sum), 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sp[(ty * 4 + i) * PS + tx + 16 * j] = round_to<T>(s[i][j] / denom);
  }
  __syncthreads();

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < WL; ++kk) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = sp[(ty * 4 + i) * PS + kk];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float vv = sv[kk * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
    }
  }
  T* ob = out + ((size_t)b * p_len + p0) * d_model + (size_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(size_t)(ty * 4 + i) * d_model + tx + 16 * c] = from_f<T>(acc[i][c]);
}

// ---- bf16 body: tensor cores, a pair of heads per block -----------------
constexpr int GROUP = 2;   // heads per block
constexpr int MT = 256;    // 8 warps: 4 per head, 16 query rows each
constexpr int RS = 88;     // row stride (elements) of the q/k/v tiles

template <int HD> struct WinTiles {
  static constexpr int TILE = WL * RS;     // one [64][RS] tile
  static constexpr int VEC = HD / 8;       // 16-byte vectors per head row
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (3 * GROUP * TILE + 2 * WL * HD) + WL;
  static_assert(HD % 16 == 0 && VEC % 2 == 0, "rope pairs whole vectors");
};

template <int HD>
__global__ void __launch_bounds__(MT)
window_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                  const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t,
                  const uint8_t* __restrict__ valid,
                  __nv_bfloat16* __restrict__ out, int p_len, int heads,
                  float scale) {
  using L = WinTiles<HD>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // [q|k|v][head][WL][RS]
  bf16* tcos = tiles + 3 * GROUP * L::TILE;          // [WL][HD]
  bf16* tsin = tcos + WL * HD;                       // [WL][HD]
  uint8_t* svalid = reinterpret_cast<uint8_t*>(tsin + WL * HD);

  const int h0 = blockIdx.y * GROUP;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int d_model = heads * HD;
  const int p0 = blockIdx.x * WL;
  const bf16* rows = qkv + ((size_t)b * p_len + p0) * 3 * d_model;

  constexpr int PER_ROW = 3 * GROUP * L::VEC;
  for (int i = tid; i < WL * PER_ROW; i += MT) {
    const int r = i / PER_ROW, rem = i % PER_ROW;
    const int part = rem / (GROUP * L::VEC), hv = rem % (GROUP * L::VEC);
    const int hs = hv / L::VEC, vec = hv % L::VEC;
    cp_async16(tiles + (part * GROUP + hs) * L::TILE + r * RS + vec * 8,
               rows + (size_t)r * 3 * d_model + part * d_model + (h0 + hs) * HD + vec * 8);
  }
  const float4* cos4 = reinterpret_cast<const float4*>(cos_t + (size_t)p0 * HD);
  const float4* sin4 = reinterpret_cast<const float4*>(sin_t + (size_t)p0 * HD);
  for (int i = tid; i < WL * HD / 4; i += MT) {
    const float4 c = cos4[i], s = sin4[i];
    reinterpret_cast<__nv_bfloat162*>(tcos)[2 * i] = __floats2bfloat162_rn(c.x, c.y);
    reinterpret_cast<__nv_bfloat162*>(tcos)[2 * i + 1] = __floats2bfloat162_rn(c.z, c.w);
    reinterpret_cast<__nv_bfloat162*>(tsin)[2 * i] = __floats2bfloat162_rn(s.x, s.y);
    reinterpret_cast<__nv_bfloat162*>(tsin)[2 * i + 1] = __floats2bfloat162_rn(s.z, s.w);
  }
  if (tid < WL) svalid[tid] = valid[p0 + tid];
  cp_async_wait_all();
  __syncthreads();

  // Rope on q and k in place: vector j (first half) and j + HALF (second).
  constexpr int HALF = L::VEC / 2;
  for (int i = tid; i < 2 * GROUP * WL * HALF; i += MT) {
    const int j = i % HALF;
    const int r = (i / HALF) % WL;
    bf16* x = tiles + (i / (HALF * WL)) * L::TILE + r * RS;
    float xl[8], xh[8], cl[8], ch[8], sl[8], sh[8];
    unpack16(*reinterpret_cast<const uint4*>(x + j * 8), xl, bf16());
    unpack16(*reinterpret_cast<const uint4*>(x + (j + HALF) * 8), xh, bf16());
    unpack16(*reinterpret_cast<const uint4*>(tcos + r * HD + j * 8), cl, bf16());
    unpack16(*reinterpret_cast<const uint4*>(tcos + r * HD + (j + HALF) * 8), ch, bf16());
    unpack16(*reinterpret_cast<const uint4*>(tsin + r * HD + j * 8), sl, bf16());
    unpack16(*reinterpret_cast<const uint4*>(tsin + r * HD + (j + HALF) * 8), sh, bf16());
    uint4 lo, hi;
    uint32_t* lw = reinterpret_cast<uint32_t*>(&lo);
    uint32_t* hw = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float ol[2], oh[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ol[u] = __fadd_rn(__fmul_rn(xl[e + u], cl[e + u]), __fmul_rn(-xh[e + u], sl[e + u]));
        oh[u] = __fadd_rn(__fmul_rn(xh[e + u], ch[e + u]), __fmul_rn(xl[e + u], sh[e + u]));
      }
      lw[e / 2] = pack_bf16(ol[0], ol[1]);
      hw[e / 2] = pack_bf16(oh[0], oh[1]);
    }
    *reinterpret_cast<uint4*>(x + j * 8) = lo;
    *reinterpret_cast<uint4*>(x + (j + HALF) * 8) = hi;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int hs = warp / 4, rb = (warp % 4) * 16;
  bf16* sq = tiles + hs * L::TILE;
  const bf16* sk = tiles + (GROUP + hs) * L::TILE;
  const bf16* sv = tiles + (2 * GROUP + hs) * L::TILE;
  constexpr int KS = HD / 16;

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qa[ks], sq + (rb + lane % 16) * RS + ks * 16 + (lane / 16) * 8);

  float s[WL / 8][4];
#pragma unroll
  for (int j = 0; j < WL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int np = 0; np < WL / 16; ++np) {
      uint32_t kb[4];
      ldmatrix_x4(kb, sk + (np * 16 + (lane / 16) * 8 + lane % 8) * RS + ks * 16 +
                          ((lane / 8) % 2) * 8);
      mma_bf16(s[2 * np], qa[ks], kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], qa[ks], kb[2], kb[3]);
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < WL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = svalid[j * 8 + 2 * t + (e & 1)] != 0;
      s[j][e] = ok ? s[j][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = group_max<4>(mx[r]);
    safe[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];
  }
#pragma unroll
  for (int j = 0; j < WL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - safe[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) denom[r] = fmaxf(group_sum<4>(sum[r]), 1e-30f);
  // P normalised and rounded to bf16 as the A operand of P.V: k-step kk
  // takes score tiles 2kk, 2kk+1.
  uint32_t pa[WL / 16][4];
#pragma unroll
  for (int j = 0; j < WL / 8; ++j) {
    pa[j / 2][(j % 2) * 2] = pack_bf16(s[j][0] / denom[0], s[j][1] / denom[0]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[j][2] / denom[1], s[j][3] / denom[1]);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WL / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, sv + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * RS +
                                dp * 16 + (lane / 16) * 8);
      mma_bf16(o[2 * dp], pa[kk], vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
    }
  }

  // Stage the warp's 16 output rows in its own q rows (no other warp reads
  // them), then write whole head rows as 16-byte vectors.
  bf16* so = sq + rb * RS;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(so + g * RS + n * 8 + 2 * t) =
        __floats2bfloat162_rn(o[n][0], o[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(so + (g + 8) * RS + n * 8 + 2 * t) =
        __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
  __syncwarp();
  bf16* ob = out + ((size_t)b * p_len + p0 + rb) * d_model + (size_t)(h0 + hs) * HD;
  for (int i = lane; i < 16 * L::VEC; i += 32) {
    const int r = i / L::VEC, v = i % L::VEC;
    *reinterpret_cast<uint4*>(ob + (size_t)r * d_model + v * 8) =
        *reinterpret_cast<const uint4*>(so + r * RS + v * 8);
  }
}

template <int HD>
cudaError_t launch(const void* qkv, const float* cos_t, const float* sin_t,
                   const uint8_t* valid, void* out, int b, int p_len,
                   int heads, float scale, int dtype, cudaStream_t stream) {
  dim3 grid(p_len / WL, 1, b);
  if (dtype == kBFloat16) {
    if (heads % GROUP != 0) return cudaErrorInvalidValue;
    const size_t smem = WinTiles<HD>::SMEM;
    static bool configured[kMaxDevices] = {};
    cudaError_t err = set_smem_once(window_mma_kernel<HD>, smem, configured);
    if (err != cudaSuccess) return err;
    grid.y = heads / GROUP;
    window_mma_kernel<HD><<<grid, MT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), cos_t, sin_t, valid,
        static_cast<__nv_bfloat16*>(out), p_len, heads, scale);
  } else if (dtype == kFloat32) {
    const size_t smem = window_smem_bytes<HD>();
    static bool configured[kMaxDevices] = {};
    cudaError_t err = set_smem_once(window_kernel<float, HD>, smem, configured);
    if (err != cudaSuccess) return err;
    grid.y = heads;
    window_kernel<float, HD><<<grid, NT, smem, stream>>>(
        static_cast<const float*>(qkv), cos_t, sin_t, valid,
        static_cast<float*>(out), p_len, heads, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
HOCR_EXPORT int hocr_window_attention(const void* qkv, const void* cos_t,
                                      const void* sin_t, const void* valid,
                                      void* out, int b, int p_len, int heads,
                                      int hd, int window_len, float scale,
                                      int dtype, void* stream) {
  if (window_len != WL || p_len % WL != 0) return cudaErrorInvalidValue;
  if (hd != 80) return cudaErrorInvalidValue;  // the vision tower's width
  if (b == 0 || p_len == 0) return 0;
  return launch<80>(qkv, static_cast<const float*>(cos_t),
                    static_cast<const float*>(sin_t),
                    static_cast<const uint8_t*>(valid), out, b, p_len, heads,
                    scale, dtype, static_cast<cudaStream_t>(stream));
}
