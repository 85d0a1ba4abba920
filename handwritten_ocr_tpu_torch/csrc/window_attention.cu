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
// returns 0); P divided by its denominator (the fp32 body multiplies by its
// reciprocal, within an ulp) and rounded to the qkv dtype BEFORE the P.V
// product; fp32 accumulation.
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
// - fp32 (the reference and fp32 reads): one block of 128 threads per
//   (page, window, head), heads fastest. At the fp32 read's shape (qkv
//   [1, 3456, 3840]) it moves 73 MB against 1.1 GFLOP (both products;
//   3.4 GFLOP of tf32 products in 3xTF32, 0.007 ms at the 495 TFLOP/s tf32
//   peak): bound by bytes, 0.022 ms at 3.35 TB/s. What holds it back is
//   latency: each block loads, ropes, multiplies and writes in turn, so
//   the design keeps many blocks on an SM. Two tiles of 64 rows padded to
//   84 floats (43 KB): four blocks an SM, 16 warps. cp.async brings q and
//   k in 16-byte vectors; rope runs in place on 16-byte vectors (vector j
//   of a head row pairs with j + 10), one thread owning both halves of
//   its pairs, with the window's cos/sin read once and each product and
//   sum rounded in fp32 as PyTorch rounds them. Warps 0-3 take 16 query
//   rows each. Q.K^T runs on the tensor cores as 3xTF32 (mma.sync.m16n8k8:
//   each operand split into tf32 hi + lo, the products lo.hi, hi.lo and
//   hi.hi summed in fp32, within ~2^-20 of a product, where one TF32 pass
//   errs ~2^-11). v then comes into k's tile, landing while the softmax
//   runs and the SM's other blocks compute. The 64 scores of a row stay in
//   registers (max and sum as quad shuffles); P is normalised there and
//   becomes P.V's A operand as it stands: score tile j's columns 2t and
//   2t+1 serve as k-slots t and t+4, and V's rows are read in that same
//   order. The stride of 84 (20 mod 32 banks) keeps every fragment load,
//   q's and k's rows g and V's rows 2t and 2t+1, free of bank conflicts.
//   Output staged in the warp's own q rows and written as 16-byte vectors.
#include "hopper.cuh"

namespace {

constexpr int WL = 64;  // window length

// ---- fp32 body: 3xTF32 on the tensor cores, one head per block ----------
constexpr int FT = 128;    // 4 warps, 16 query rows each
constexpr int FS = 84;     // row stride (floats) of the q and k/v tiles

template <int HD> struct F32Tiles {
  static constexpr int TILE = WL * FS;     // one [64][FS] tile
  static constexpr int VEC = HD / 4;       // 16-byte vectors per head row
  static constexpr int HV = HD / 8;        // vectors in half a head row
  static constexpr int PAIRS = WL * HV / FT;  // rope pairs a thread
  // q, then k and after Q.K^T v in the same tile; the valid bytes.
  static constexpr size_t SMEM = sizeof(float) * 2 * TILE + WL;
  static_assert(HD == 80 && PAIRS == 5, "the rope pairs cover 10 vectors a half row");
  static_assert(FS % 4 == 0 && FS >= HD, "rows stay 16-byte aligned");
};

// Rope pair u of thread tid: (row r, vector j of the first half, vector
// j + HV). Pairs 0-3 take vectors 0-7 of each row, eight lanes a row, so
// that a quarter warp reads 128 contiguous bytes of cos/sin and of a tile
// row (every bank once); pair 4 takes vectors 8 and 9, two lanes a row.
__device__ __forceinline__ void rope_pair(int tid, int u, int& r, int& j) {
  const int i = tid + u * FT;
  r = u < 4 ? i / 8 : tid / 2;
  j = u < 4 ? i % 8 : 8 + tid % 2;
}

template <int HD>
__global__ void __launch_bounds__(FT, 4)
window_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t, const uint8_t* __restrict__ valid,
                  float* __restrict__ out, int p_len, int heads, float scale) {
  using L = F32Tiles<HD>;
  extern __shared__ __align__(16) float fsm[];
  float* sq = fsm;                 // [WL][FS] q, roped in place
  float* skv = sq + L::TILE;       // [WL][FS] k, roped in place; then v
  uint8_t* svalid = reinterpret_cast<uint8_t*>(skv + L::TILE);

  // Heads fastest, so that the blocks in flight together read whole qkv
  // rows of a few windows and share their cos/sin in L2.
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int d_model = heads * HD;
  const int p0 = blockIdx.y * WL;
  const float* rows = qkv + ((size_t)b * p_len + p0) * 3 * d_model + (size_t)h * HD;

  // q and k (and the valid bytes) as 16-byte cp.async copies.
  for (int i = tid; i < 2 * WL * L::VEC; i += FT) {
    const int part = i / (WL * L::VEC), r = (i / L::VEC) % WL, vec = i % L::VEC;
    cp_async16(sq + part * L::TILE + r * FS + vec * 4,
               rows + (size_t)r * 3 * d_model + part * d_model + vec * 4);
  }
  if (tid < WL / 16) cp_async16(svalid + tid * 16, valid + p0 + tid * 16);
  cp_async_wait_all();
  __syncthreads();

  // Rope q and k in place, with the window's cos/sin read once. A thread
  // owns its pairs' both halves, so it reads them all before it writes and
  // no barrier sits in between. Each product and the sum round in fp32 as
  // PyTorch rounds them.
  const float4* cos4 = reinterpret_cast<const float4*>(cos_t + (size_t)p0 * HD);
  const float4* sin4 = reinterpret_cast<const float4*>(sin_t + (size_t)p0 * HD);
#pragma unroll
  for (int u = 0; u < L::PAIRS; ++u) {
    int r, j;
    rope_pair(tid, u, r, j);
    const float4 cl = cos4[r * L::VEC + j], ch = cos4[r * L::VEC + j + L::HV];
    const float4 sl = sin4[r * L::VEC + j], sh = sin4[r * L::VEC + j + L::HV];
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      float4* xl = reinterpret_cast<float4*>(sq + part * L::TILE + r * FS) + j;
      float4* xh = xl + L::HV;
      const float4 lo = *xl, hi = *xh;
      *xl = make_float4(__fadd_rn(__fmul_rn(lo.x, cl.x), __fmul_rn(-hi.x, sl.x)),
                        __fadd_rn(__fmul_rn(lo.y, cl.y), __fmul_rn(-hi.y, sl.y)),
                        __fadd_rn(__fmul_rn(lo.z, cl.z), __fmul_rn(-hi.z, sl.z)),
                        __fadd_rn(__fmul_rn(lo.w, cl.w), __fmul_rn(-hi.w, sl.w)));
      *xh = make_float4(__fadd_rn(__fmul_rn(hi.x, ch.x), __fmul_rn(lo.x, sh.x)),
                        __fadd_rn(__fmul_rn(hi.y, ch.y), __fmul_rn(lo.y, sh.y)),
                        __fadd_rn(__fmul_rn(hi.z, ch.z), __fmul_rn(lo.z, sh.z)),
                        __fadd_rn(__fmul_rn(hi.w, ch.w), __fmul_rn(lo.w, sh.w)));
    }
  }
  __syncthreads();

  // Q.K^T: warp w takes query rows 16w..16w+15 against all 64 keys. With
  // the row stride of 84 floats (84 = 20 mod 32) the lanes' rows g start
  // on banks 20g mod 32, eight distinct multiples of 4, and t adds 0-3:
  // every A and B fragment load hits 32 distinct banks.
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rb = warp * 16;
  const float* qa = sq + (rb + g) * FS + t;
  float sc[WL / 8][4];
#pragma unroll
  for (int j = 0; j < WL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 8; ++ks) {
    uint32_t ah[4], al[4];
    split_tf32(qa[ks * 8], ah[0], al[0]);
    split_tf32(qa[8 * FS + ks * 8], ah[1], al[1]);
    split_tf32(qa[ks * 8 + 4], ah[2], al[2]);
    split_tf32(qa[8 * FS + ks * 8 + 4], ah[3], al[3]);
    uint32_t bh[WL / 8][2], bl[WL / 8][2];
#pragma unroll
    for (int nt = 0; nt < WL / 8; ++nt) {
      const float* kb = skv + (nt * 8 + g) * FS + ks * 8 + t;
      split_tf32(kb[0], bh[nt][0], bl[nt][0]);
      split_tf32(kb[4], bh[nt][1], bl[nt][1]);
    }
    mma_3xtf32_rows<WL / 8>(sc, ah, al, bh, bl);
  }

  // Every warp is done with k: v goes into its tile and lands while the
  // softmax runs (and other blocks on the SM compute).
  __syncthreads();
  for (int i = tid; i < WL * L::VEC; i += FT) {
    const int r = i / L::VEC, vec = i % L::VEC;
    cp_async16(skv + r * FS + vec * 4, rows + (size_t)r * 3 * d_model + 2 * d_model + vec * 4);
  }
  cp_async_commit();

  // Scores in registers: sc[j][e] is row g + 8 (e >> 1), key 8j + 2t +
  // (e & 1); bit k of `live` says whether key k is live.
  const uint64_t live =
      (uint64_t)__ballot_sync(0xffffffffu, svalid[32 + lane] != 0) << 32 |
      __ballot_sync(0xffffffffu, svalid[lane] != 0);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < WL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = (live >> (j * 8 + 2 * t + (e & 1))) & 1;
      sc[j][e] = ok ? sc[j][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
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
      sc[j][e] = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - safe[e >> 1]);
      sum[e >> 1] += sc[j][e];
    }
  // P normalised by the reciprocal of its denominator (one division a
  // row, within an ulp of dividing each term).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(group_sum<4>(sum[r]), 1e-30f);
#pragma unroll
  for (int j = 0; j < WL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] *= inv[e >> 1];

  cp_async_wait_all();
  __syncthreads();

  // P.V with P straight from registers. Score tile j's C layout (row g,
  // keys 8j + 2t and 8j + 2t + 1) becomes k-step j's A fragment by taking
  // key 8j + 2t as k-slot t and 8j + 2t + 1 as slot t + 4; V's B fragment
  // reads its rows in the same order: row 8j + 2t (b0) and 8j + 2t + 1
  // (b1) at col 8n + g. Rows 2t start on banks 8t mod 32 (168 = 8 mod 32)
  // and 2t + 1 on 8t + 20, so with g's 0-7 both loads are conflict free.
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < WL / 8; ++j) {
    uint32_t ph[4], pl[4];
    split_tf32(sc[j][0], ph[0], pl[0]);
    split_tf32(sc[j][2], ph[1], pl[1]);
    split_tf32(sc[j][1], ph[2], pl[2]);
    split_tf32(sc[j][3], ph[3], pl[3]);
    const float* vb = skv + (j * 8 + 2 * t) * FS + g;
    uint32_t bh[HD / 8][2], bl[HD / 8][2];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      split_tf32(vb[n * 8], bh[n][0], bl[n][0]);
      split_tf32(vb[FS + n * 8], bh[n][1], bl[n][1]);
    }
    mma_3xtf32_rows<HD / 8>(o, ph, pl, bh, bl);
  }

  // Stage the warp's 16 output rows in its own q rows (no other warp reads
  // them), then write whole head rows as 16-byte vectors.
  float* so = sq + rb * FS;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(so + g * FS + n * 8 + 2 * t) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(so + (g + 8) * FS + n * 8 + 2 * t) = make_float2(o[n][2], o[n][3]);
  }
  __syncwarp();
  float* ob = out + ((size_t)b * p_len + p0 + rb) * d_model + (size_t)h * HD;
  for (int i = lane; i < 16 * L::VEC; i += 32) {
    const int r = i / L::VEC, v = i % L::VEC;
    *reinterpret_cast<float4*>(ob + (size_t)r * d_model + v * 4) =
        *reinterpret_cast<const float4*>(so + r * FS + v * 4);
  }
}

// Opt the fp32 body into its shared memory and the largest carveout, so
// that four blocks share an SM; once per device.
template <int HD> cudaError_t configure_f32() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(window_f32_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)F32Tiles<HD>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(window_f32_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
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
    cudaError_t err = configure_f32<HD>();
    if (err != cudaSuccess) return err;
    const dim3 heads_first(heads, p_len / WL, b);
    window_f32_kernel<HD><<<heads_first, FT, F32Tiles<HD>::SMEM, stream>>>(
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
