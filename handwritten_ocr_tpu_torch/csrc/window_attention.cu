// Window attention of the vision tower for Hopper: block-diagonal attention
// inside uniform 64-token windows, reading packed qkv, rope applied on load.
//
// Replaces the Pallas kernels handwritten_ocr_tpu/ops/window_attention.py:
// _packed_kernel (default layout) and _window_kernel (fold layout), which
// compute the same function. The TPU kernel takes a chunk of windows per
// grid step and masks the off-diagonal blocks of one big score matrix;
// here one thread block owns one (batch, window, head), so no score outside
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
// Design: the 64 x hd q, k, v tiles and the 64 x 64 score tile sit in shared
// memory (~70 KB at hd 80). 256 threads as 16 x 16; each owns 4 rows x 4
// strided columns of the scores and 4 rows x hd/16 output columns. Plain
// fp32 FMA.
#include "common.cuh"

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

template <typename T, int HD>
cudaError_t launch(const void* qkv, const float* cos_t, const float* sin_t,
                   const uint8_t* valid, void* out, int b, int p_len,
                   int heads, float scale, cudaStream_t stream) {
  const size_t smem = window_smem_bytes<HD>();
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem_once(window_kernel<T, HD>, smem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid(p_len / WL, heads, b);
  window_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qkv), cos_t, sin_t, valid, static_cast<T*>(out),
      p_len, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* qkv, const float* cos_t,
                        const float* sin_t, const uint8_t* valid, void* out,
                        int b, int p_len, int heads, float scale,
                        cudaStream_t stream) {
  if (hd != 80) return cudaErrorInvalidValue;  // the vision tower's width
  return launch<T, 80>(qkv, cos_t, sin_t, valid, out, b, p_len, heads, scale,
                       stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
HOCR_EXPORT int hocr_window_attention(const void* qkv, const void* cos_t,
                                      const void* sin_t, const void* valid,
                                      void* out, int b, int p_len, int heads,
                                      int hd, int window_len, float scale,
                                      int dtype, void* stream) {
  if (window_len != WL || p_len % WL != 0) return cudaErrorInvalidValue;
  if (b == 0 || p_len == 0) return 0;
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  const uint8_t* vd = static_cast<const uint8_t*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, qkv, c, s, vd, out, b, p_len, heads,
                                      scale, st);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, qkv, c, s, vd, out, b, p_len, heads, scale,
                              st);
  return cudaErrorInvalidValue;
}
