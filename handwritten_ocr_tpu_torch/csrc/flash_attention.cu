// Flash attention (GQA, optional causal, per-key mask) for Hopper.
//
// Replaces the Pallas kernel handwritten_ocr_tpu/ops/flash_attention.py:
// _flash_kernel. The TPU grid walks (batch*head, q block, k block) with the
// k axis sequential and carries m / l / acc in VMEM scratch across it; here
// one thread block owns one (batch*q-head, 64-row q tile) and walks the k
// tiles in an in-block loop, so nothing carries between blocks.
//
// Layout: q [B, T, Hq, D], k/v [B, S, Hkv, D], mask [M, S] uint8 (M = 1 or
// B, optional), out [B, T, Hq, D]; q-head h reads kv-head h / (Hq / Hkv).
// Math: scores in fp32 from the input dtype, scaled after the dot; masked
// keys (col >= S, mask 0, or col > row when causal) get -inf; online softmax
// with the TPU kernel's guards (m == -inf rows contribute 0, denominator
// max(l, 1e-30)), so an all-masked row gives exactly 0. P is rounded to the
// value dtype before the P.V product, as the TPU kernel does; accumulation
// is fp32.
//
// Two bodies, one function:
// - bf16 (the model's dtype): tensor cores. 4 warps own 16 query rows
//   each of a 64-row tile; Q.K^T and P.V run as mma.sync.m16n8k16 (bf16
//   in, fp32 accumulate). Q's fragments stay in registers for the whole
//   block; 64-key tiles of K and V stream through two shared-memory
//   buffers by cp.async (the next tile loads while the current one
//   computes); V's operands come out transposed by ldmatrix.trans; the
//   score accumulators become the P.V operands in registers (rounded to
//   bf16), with no trip through shared memory. Rows are padded by 8
//   elements so fragment loads hit distinct banks.
// - fp32: plain FMA. 256 threads as a 16 x 16 grid, each owning 4 rows x 4
//   strided columns of the 64 x 64 score tile and 4 rows x D/16 output
//   columns; Q in shared memory, the K tile then the V tile in one buffer.
// No TMA / wgmma pipeline yet: that is later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D> constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BQ * (BK + 1));
}

// ---- fp32 body: plain FMA ----------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const uint8_t* __restrict__ mask,
             T* __restrict__ out, int t_len, int s_len, int hq, int hkv,
             int mask_rows, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;
  constexpr int PS = BK + 1;
  constexpr int NC = D / 16;
  float* sq = smem;               // [BQ][QS]
  float* skv = sq + BQ * QS;      // [BK][QS]: the K tile, then the V tile
  float* sp = skv + BK * QS;      // [BQ][PS]

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const size_t q_row = (size_t)hq * D;
  const size_t kv_row = (size_t)hkv * D;
  const T* qb = q + (size_t)b * t_len * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * s_len * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * s_len * kv_row + (size_t)hk * D;
  const uint8_t* mb =
      mask ? mask + (size_t)(mask_rows == 1 ? 0 : b) * s_len : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sq[r * QS + c] = (q0 + r < t_len) ? to_f(qb[(size_t)(q0 + r) * q_row + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // Causal: key tiles strictly above the diagonal are skipped.
  const int k_end = causal ? min(s_len, q0 + BQ) : s_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers of skv / sp are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      skv[r * QS + c] = (k0 + r < s_len) ? to_f(kb[(size_t)(k0 + r) * kv_row + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = skv[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    bool key_ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      key_ok[j] = col < s_len && (mb == nullptr || mb[col] != 0);
    }
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = key_ok[j] && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - safe) : 0.f;
        sum += p;
        sp[(ty * 4 + i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      sum = group_sum<16>(sum);
      corr[i] = (m[i] == -INFINITY) ? 0.f : expf(m[i] - safe);
      l[i] = corr[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done reading the K tile
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      skv[r * QS + c] = (k0 + r < s_len) ? to_f(vb[(size_t)(k0 + r) * kv_row + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = skv[kk * QS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = out + (size_t)b * t_len * q_row + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= t_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(size_t)row * q_row + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

// ---- bf16 body: tensor cores -------------------------------------------
constexpr int MQ = 64;   // query rows per block (16 per warp)
constexpr int MK = 64;   // keys per tile
constexpr int MT = 128;  // 4 warps

template <int D> constexpr size_t mma_smem_bytes() {
  // Q, then two buffers each of K and V, all rows padded by 8 elements.
  return sizeof(__nv_bfloat16) * (size_t)(MQ + 4 * MK) * (D + 8);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without a register stop; zero-fills when the
// source is out of range (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The two B fragments of an m16n8k16 product over a row-major [k][n]
// tile: rows k0..k0+15 (addressed by lanes 0-15), cols n0..n0+7.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(a));
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A holds
// rows g and g+8 at cols 2t, 2t+1 (and +8); B holds col g at rows 2t, 2t+1
// (and +8); C holds rows g and g+8 at cols 2t, 2t+1.
template <int D>
__global__ void __launch_bounds__(MT)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int t_len, int s_len,
                 int hq, int hkv, int mask_rows, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int QS = D + 8;        // row stride of every tile
  constexpr int NKS = D / 16;      // k-steps over the head dim
  constexpr int NDT = D / 8;       // 8-col tiles of the output
  constexpr int VPR = D / 8;       // 16-byte vectors per row
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MQ][QS]
  __nv_bfloat16* sk = sq + MQ * QS;                                // [2][MK][QS]
  __nv_bfloat16* sv = sk + 2 * MK * QS;                            // [2][MK][QS]

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * MQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;

  const size_t q_row = (size_t)hq * D;
  const size_t kv_row = (size_t)hkv * D;
  const __nv_bfloat16* qb = q + (size_t)b * t_len * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * s_len * kv_row + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * s_len * kv_row + (size_t)hk * D;
  const uint8_t* mb =
      mask ? mask + (size_t)(mask_rows == 1 ? 0 : b) * s_len : nullptr;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < MQ * VPR; i += MT) {
    const int r = i / VPR, cv = i % VPR;
    uint4 val = zero;
    if (q0 + r < t_len)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_row + cv * 8);
    *reinterpret_cast<uint4*>(sq + r * QS + cv * 8) = val;
  }
  __syncthreads();
  const int ra = warp * 16 + g;    // this thread's two rows: ra and ra + 8
  uint32_t qa[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ld32(sq + ra * QS + c);
    qa[ks][1] = ld32(sq + (ra + 8) * QS + c);
    qa[ks][2] = ld32(sq + ra * QS + c + 8);
    qa[ks][3] = ld32(sq + (ra + 8) * QS + c + 8);
  }

  float o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + ra, q0 + ra + 8};

  const int k_end = causal ? min(s_len, q0 + MQ) : s_len;
  const int n_tiles = (k_end + MK - 1) / MK;
  // Tile `tile` of K and V into buffer `buf`, as one cp.async group.
  auto issue = [&](int tile, int buf) {
    for (int i = tid; i < MK * VPR; i += MT) {
      const int r = i / VPR, cv = i % VPR;
      const int col = tile * MK + r;
      const bool ok = col < s_len;
      const size_t off = ok ? (size_t)col * kv_row + cv * 8 : 0;
      cp_async16(sk + (buf * MK + r) * QS + cv * 8, kb + off, ok);
      cp_async16(sv + (buf * MK + r) * QS + cv * 8, vb + off, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    const int k0 = tile * MK;
    if (tile + 1 < n_tiles) {       // the next tile loads during this one
      issue(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* skb = sk + buf * MK * QS;
    const __nv_bfloat16* svb = sv + buf * MK * QS;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        const __nv_bfloat16* kr = skb + (j * 8 + g) * QS + ks * 16 + 2 * t;
        mma_bf16(s[j], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < s_len && (mb == nullptr || mb[col] != 0) &&
                        (!causal || col <= row[e >> 1]);
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float safe[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = group_max<4>(mx[r]);
      const float m_new = fmaxf(m[r], mx[r]);
      safe[r] = (m_new == -INFINITY) ? 0.f : m_new;
      corr[r] = (m[r] == -INFINITY) ? 0.f : expf(m[r] - safe[r]);
      m[r] = m_new;
    }
    // P as the A operand of P.V: k-step kk takes score tiles 2kk, 2kk+1.
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[j][0] - safe[0]), p1 = expf(s[j][1] - safe[0]);
      const float p2 = expf(s[j][2] - safe[1]), p3 = expf(s[j][3] - safe[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = corr[r] * l[r] + group_sum<4>(sum[r]);
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= corr[e >> 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, svb + (kk * 16 + (lane & 15)) * QS + dt * 8);
        mma_bf16(o[dt], pa[kk], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  __nv_bfloat16* ob = out + (size_t)b * t_len * q_row + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= t_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(o[dt][2 * r] / denom, o[dt][2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row[r] * q_row + dt * 8 + 2 * t) = pair;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, int b, int t_len, int s_len,
                   int hq, int hkv, int mask_rows, int causal, float scale,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = mma_smem_bytes<D>();
    static bool configured[kMaxDevices] = {};
    cudaError_t err = set_smem_once(flash_mma_kernel<D>, smem, configured);
    if (err != cudaSuccess) return err;
    dim3 grid((t_len + MQ - 1) / MQ, b * hq);
    flash_mma_kernel<D><<<grid, MT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<T*>(out), t_len, s_len,
        hq, hkv, mask_rows, causal, scale);
  } else {
    const size_t smem = flash_smem_bytes<D>();
    static bool configured[kMaxDevices] = {};
    cudaError_t err = set_smem_once(flash_kernel<T, D>, smem, configured);
    if (err != cudaSuccess) return err;
    dim3 grid((t_len + BQ - 1) / BQ, b * hq);
    flash_kernel<T, D><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<T*>(out), t_len, s_len,
        hq, hkv, mask_rows, causal, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const uint8_t* mask, void* out, int b, int t_len,
                       int s_len, int hq, int hkv, int mask_rows, int causal,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 80:
      return launch<T, 80>(q, k, v, mask, out, b, t_len, s_len, hq, hkv,
                           mask_rows, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, mask, out, b, t_len, s_len, hq, hkv,
                            mask_rows, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
HOCR_EXPORT int hocr_flash_attention(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int b, int t_len, int s_len,
                                     int hq, int hkv, int d, int mask_rows,
                                     int causal, float scale, int dtype,
                                     void* stream) {
  if (t_len == 0 || b == 0) return 0;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, m, out, b, t_len, s_len, hq,
                                     hkv, mask_rows, causal, scale, st);
  if (dtype == kFloat32)
    return dispatch_d<float>(d, q, k, v, m, out, b, t_len, s_len, hq, hkv,
                             mask_rows, causal, scale, st);
  return cudaErrorInvalidValue;
}
