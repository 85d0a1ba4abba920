// Fused append + paged GQA attention for Hopper: the decode step's
// attention, over full-precision or int8 KV pools.
//
// Replaces the Pallas kernel handwritten_ocr_tpu/ops/paged_decode_attention.py:
// _kernel, both its fp-KV and its int8-KV branch.
//
// Layout: q [S, T, Hq, D]; k_new/v_new [S, T, Hkv, D]; pools [L, N, BS, Hkv,
// D] (page-major, one page = [BS, Hkv, D]); tables [S, W] int32 pool block
// ids; start [S], n_valid [S] int32; out [S, T, Hq, D]. int8 pools come
// with fp32 scale pools [L, N, Hkv, BS] (one scale per token and head).
// Semantics, as the TPU kernel: token i < n_valid of slot s is appended at
// pos = min(start + i, W*BS - 1) through the slot's table; query token i
// (of any of the G = Hq/Hkv heads of a kv-head group) attends to the slot's
// cols <= start + i. All math fp32 (q scaled before the dot); a slot with
// n_valid == 0 appends nothing, reads no page and outputs 0. Rows i >=
// n_valid output 0 (callers never read them).
//
// THE POOLS ARE UPDATED IN PLACE (the TPU kernel returns them aliased).
//
// Design. A decode step has few live slots x 4 kv-heads, too few blocks to
// fill 132 SMs if each block walked a whole context, so the context is
// split (flash-decoding): grid (slot, kv-head, row tile of 16 of the G*T
// query rows x split of `split_cols` cols). Each block runs an online
// softmax over its split and writes its partial (m, l, unnormalised acc)
// to scratch; a second kernel combines the splits of each row. The block
// (row tile 0, split 0) appends the head's new rows to the pool; every
// block reads the cached cols < start from the pool pages and the new
// cols start .. start+n_valid-1 straight from k_new / v_new, so no block
// reads a pool row another block is writing. Key tiles of 64 cols stream
// through shared memory: the tile's row addresses are looked up once (one
// table read per col), then every thread issues all its 16-byte loads of
// the tile before using any. 128 threads, each owning one query row x 8
// strided cols of the scores and D/8 output cols.
//
// int8 pools (P = int8_t). Append: per (slot, token, head) amax = max|k|
// over D in fp32, scale = max(amax, 1e-6) / 127 by a true division, q =
// round-half-even(k / scale), no clip: bit-equal to the JAX package's
// _quantize_rows. Each scale goes straight to [layer, block, h, pos % BS]
// (the TPU kernel's whole-page read-modify-write is a VMEM-alignment
// workaround). Every block quantises the step's new rows of its head into
// shared memory the same way and reads the new cols from there, so they
// carry the same quantisation error as the appended rows. Scores of the
// int8 keys are multiplied by k_scale[col] before the mask; p is added to
// l before it is multiplied by v_scale[col] for the P.V product.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int RT = 16;   // query rows per block
constexpr int KT = 64;   // key cols per tile
constexpr int NT = 128;
constexpr int MAX_NEW_INT8 = 64;   // new tokens per call over int8 pools

struct PagedArgs {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* k_pool;
  void* v_pool;
  float* k_scale;    // [L, N, Hkv, BS] fp32 (int8 pools only)
  float* v_scale;
  const int* tables;
  const int* start;
  const int* n_valid;
  void* out;
  float* part_acc;   // [S, Hkv, G*T, n_split, D] unnormalised P.V
  float* part_ml;    // [S, Hkv, G*T, n_split, 2] running max, denominator
  int slots, t_len, hq, hkv, width, bs, n_blocks, layer, split_cols, n_split;
  float scale;
};

template <int D> constexpr size_t paged_smem_bytes(bool quant) {
  // fp32 q / K / V / P tiles, then (int8 pools) the new rows quantised:
  // int8 K and V [MAX_NEW_INT8][D] and their scales.
  return sizeof(float) * (size_t)(RT * (D + 1) + KT * (D + 1) + KT * D + RT * (KT + 1)) +
         (quant ? (size_t)MAX_NEW_INT8 * (2 * D + 2 * sizeof(float)) : 0);
}

// Quantises the first nv new rows of head h of slot s into shared memory:
// int8 rows s_kq/s_vq [nv][D] and scales s_ks/s_vs [nv]. One thread per
// element (D == NT); `red` is 2 * NT/32 floats of scratch.
template <typename T, int D>
__device__ void quantize_new_rows(const T* k_new, const T* v_new, int s, int h,
                                  int t_len, int hkv, int nv, int8_t* s_kq,
                                  int8_t* s_vq, float* s_ks, float* s_vs,
                                  float* red) {
  static_assert(D == NT, "one thread per element of a row");
  const int tid = threadIdx.x, warp = tid / 32;
  for (int i = 0; i < nv; ++i) {
    const size_t src = ((size_t)(s * t_len + i) * hkv + h) * D + tid;
    const float kx = to_f(k_new[src]);
    const float vx = to_f(v_new[src]);
    const float ka = group_max<32>(fabsf(kx));
    const float va = group_max<32>(fabsf(vx));
    if (tid % 32 == 0) {
      red[warp] = ka;
      red[NT / 32 + warp] = va;
    }
    __syncthreads();
    float kmax = red[0], vmax = red[NT / 32];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) {
      kmax = fmaxf(kmax, red[w]);
      vmax = fmaxf(vmax, red[NT / 32 + w]);
    }
    const float ksc = __fdiv_rn(fmaxf(kmax, 1e-6f), 127.f);
    const float vsc = __fdiv_rn(fmaxf(vmax, 1e-6f), 127.f);
    s_kq[i * D + tid] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(kx, ksc)));
    s_vq[i * D + tid] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(vx, vsc)));
    if (tid == 0) {
      s_ks[i] = ksc;
      s_vs[i] = vsc;
    }
    __syncthreads();   // red is reused by the next row
  }
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(NT)
paged_kernel(const PagedArgs a) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k_new = static_cast<const T*>(a.k_new);
  const T* __restrict__ v_new = static_cast<const T*>(a.v_new);
  P* __restrict__ k_pool = static_cast<P*>(a.k_pool);
  P* __restrict__ v_pool = static_cast<P*>(a.v_pool);
  const int t_len = a.t_len, hq = a.hq, hkv = a.hkv, bs = a.bs;
  extern __shared__ float smem[];
  constexpr int QS = D + 1;
  constexpr int PS = KT + 1;
  constexpr int NC = D / 8;
  float* sq = smem;            // [RT][QS]
  float* sk = sq + RT * QS;    // [KT][QS]
  float* sv = sk + KT * QS;    // [KT][D]
  float* sp = sv + KT * D;     // [RT][PS]
  float* s_ks = sp + RT * PS;                          // [MAX_NEW_INT8] (int8)
  float* s_vs = s_ks + MAX_NEW_INT8;
  int8_t* s_kq = reinterpret_cast<int8_t*>(s_vs + MAX_NEW_INT8);  // [MAX_NEW_INT8][D]
  int8_t* s_vq = s_kq + MAX_NEW_INT8 * D;
  __shared__ float s_red[2 * NT / 32];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int row_tiles = gridDim.z / a.n_split;
  const int tile = blockIdx.z % row_tiles;
  const int split = blockIdx.z / row_tiles;
  const int tid = threadIdx.x;
  const int group = hq / hkv;
  const int rows = group * t_len;
  const int st = a.start[s];
  const int nv = a.n_valid[s];
  const int* tab = a.tables + (size_t)s * a.width;
  const int cap = a.width * bs - 1;
  const size_t row_elems = (size_t)hkv * D;
  const size_t page_elems = (size_t)bs * row_elems;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * page_elems;

  if constexpr (QUANT)
    quantize_new_rows<T, D>(k_new, v_new, s, h, t_len, hkv, nv, s_kq, s_vq,
                            s_ks, s_vs, s_red);

  // ---- append (one block per slot and head) ----
  if (tile == 0 && split == 0) {
    for (int idx = tid; idx < nv * D; idx += NT) {
      const int i = idx / D, c = idx % D;
      const int pos = min(st + i, cap);
      const int blk = tab[pos / bs];
      const size_t dst = layer_off + (size_t)blk * page_elems +
                         (size_t)(pos % bs) * row_elems + (size_t)h * D + c;
      if constexpr (QUANT) {
        k_pool[dst] = s_kq[idx];
        v_pool[dst] = s_vq[idx];
        if (c == 0) {
          const size_t sc = (((size_t)a.layer * a.n_blocks + blk) * hkv + h) * bs + pos % bs;
          a.k_scale[sc] = s_ks[i];
          a.v_scale[sc] = s_vs[i];
        }
      } else {
        const size_t src = ((size_t)(s * t_len + i) * hkv + h) * D + c;
        k_pool[dst] = k_new[src];
        v_pool[dst] = v_new[src];
      }
    }
  }

  // ---- query rows of this tile: row r is (g = r / T, token i = r % T) ----
  const int my_row = tid / 8;       // 0..15
  const int lane8 = tid % 8;
  const int r_glob = tile * RT + my_row;
  const int my_tok = r_glob % t_len;
  const bool row_ok = r_glob < rows && my_tok < nv;
  for (int idx = tid; idx < RT * D; idx += NT) {
    const int rr = idx / D, c = idx % D;
    const int r = tile * RT + rr;
    const int i = r % t_len, g = r / t_len;
    float val = 0.f;
    if (r < rows && i < nv)
      val = to_f(q[((size_t)(s * t_len + i) * hq + h * group + g) * D + c]) * a.scale;
    sq[rr * QS + c] = val;
  }

  float m = -INFINITY, l = 0.f, acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  const int limit = st + nv;
  const int row_max = st + my_tok;

  constexpr int VEC = 16 / sizeof(P);   // elements per 16-byte load
  constexpr int VPR = D / VEC;           // 16-byte loads per K/V row
  constexpr int ITERS = KT * VPR / NT;   // loads per thread per tile
  __shared__ const P* s_kp[KT];          // source row of each tile col
  __shared__ const P* s_vp[KT];          // (nullptr: past the limit)
  __shared__ float s_kcs[KT];            // int8: scale of each tile col
  __shared__ float s_vcs[KT];

  const int c_begin = split * a.split_cols;
  const int c_end = min(limit, c_begin + a.split_cols);
  for (int k0 = c_begin; k0 < c_end; k0 += KT) {
    __syncthreads();
    if (tid < KT) {
      // One table lookup per col: cached cols come from their pool page,
      // this call's new cols straight from k_new / v_new.
      const int col = k0 + tid;
      const P* kp = nullptr;
      const P* vp = nullptr;
      float kcs = 0.f, vcs = 0.f;
      if (col < st) {
        const int blk = tab[col / bs];
        const size_t off = layer_off + (size_t)blk * page_elems +
                           (size_t)(col % bs) * row_elems + (size_t)h * D;
        kp = k_pool + off;
        vp = v_pool + off;
        if constexpr (QUANT) {
          const size_t sc = (((size_t)a.layer * a.n_blocks + blk) * hkv + h) * bs + col % bs;
          kcs = a.k_scale[sc];
          vcs = a.v_scale[sc];
        }
      } else if (col < limit) {
        if constexpr (QUANT) {   // this call's rows, quantised in shared memory
          kp = s_kq + (col - st) * D;
          vp = s_vq + (col - st) * D;
          kcs = s_ks[col - st];
          vcs = s_vs[col - st];
        } else {
          const size_t src = ((size_t)(s * t_len + col - st) * hkv + h) * D;
          kp = k_new + src;
          vp = v_new + src;
        }
      }
      s_kp[tid] = kp;
      s_vp[tid] = vp;
      s_kcs[tid] = kcs;
      s_vcs[tid] = vcs;
    }
    __syncthreads();
    // All of a thread's 16-byte loads are issued before any is used, so
    // 2 * ITERS loads per thread are in flight at once.
    uint4 kraw[ITERS], vraw[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = it * NT + tid, r = i / VPR, cv = i % VPR;
      const P* kp = s_kp[r];
      const P* vp = s_vp[r];
      kraw[it] = kp ? *reinterpret_cast<const uint4*>(kp + cv * VEC) : make_uint4(0, 0, 0, 0);
      vraw[it] = vp ? *reinterpret_cast<const uint4*>(vp + cv * VEC) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = it * NT + tid, r = i / VPR, cv = i % VPR;
      float kf[VEC], vf[VEC];
      unpack16(kraw[it], kf, P());
      unpack16(vraw[it], vf, P());
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sk[r * QS + cv * VEC + e] = kf[e];
        sv[r * D + cv * VEC + e] = vf[e];
      }
    }
    __syncthreads();

    float sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = sq[my_row * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[j] = fmaf(qd, sk[(lane8 + 8 * j) * QS + d], sc[j]);
    }
    float mx = -INFINITY;
    bool ok[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + lane8 + 8 * j;
      if constexpr (QUANT) sc[j] *= s_kcs[lane8 + 8 * j];
      ok[j] = row_ok && col < limit && col <= row_max;
      sc[j] = ok[j] ? sc[j] : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    mx = group_max<8>(mx);
    const float m_new = fmaxf(m, mx);
    const float safe = (m_new == -INFINITY) ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = ok[j] ? expf(sc[j] - safe) : 0.f;
      sum += p;   // l sums the probabilities before any v scale
      sp[my_row * PS + lane8 + 8 * j] = QUANT ? p * s_vcs[lane8 + 8 * j] : p;
    }
    sum = group_sum<8>(sum);
    const float corr = (m == -INFINITY) ? 0.f : expf(m - safe);
    l = corr * l + sum;
    m = m_new;
    __syncwarp();  // a row's 8 threads share a warp: P row visible to them
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= corr;
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const float p = sp[my_row * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(p, sv[kk * D + lane8 + 8 * c], acc[c]);
    }
  }

  if (r_glob < rows) {
    const size_t part = (((size_t)s * hkv + h) * rows + r_glob) * a.n_split + split;
    if (lane8 == 0) {
      a.part_ml[2 * part] = m;
      a.part_ml[2 * part + 1] = l;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) a.part_acc[part * D + lane8 + 8 * c] = acc[c];
  }
}

// One block per query row, one thread per output element: merge the row's
// split partials (rescaled to the largest running max), divide by the
// guarded denominator, write in the q dtype. A row no split saw is 0.
template <typename T, int D>
__global__ void __launch_bounds__(D) combine_kernel(const PagedArgs a) {
  const int rows = (a.hq / a.hkv) * a.t_len;
  const int idx = blockIdx.x;             // ((s * Hkv + h) * rows + r)
  const int r = idx % rows;
  const int h = (idx / rows) % a.hkv;
  const int s = idx / rows / a.hkv;
  const int d = threadIdx.x;
  const float* ml = a.part_ml + (size_t)idx * a.n_split * 2;
  const float* acc = a.part_acc + (size_t)idx * a.n_split * D;
  float m_max = -INFINITY;
  for (int i = 0; i < a.n_split; ++i) m_max = fmaxf(m_max, ml[2 * i]);
  float l = 0.f, sum = 0.f;
  if (m_max != -INFINITY) {
    for (int i = 0; i < a.n_split; ++i) {
      if (ml[2 * i] == -INFINITY) continue;
      const float w = expf(ml[2 * i] - m_max);
      l += ml[2 * i + 1] * w;
      sum += acc[(size_t)i * D + d] * w;
    }
  }
  const int g = r / a.t_len, tok = r % a.t_len;
  T* out = static_cast<T*>(a.out);
  out[((size_t)(s * a.t_len + tok) * a.hq + h * (a.hq / a.hkv) + g) * D + d] =
      from_f<T>(sum / fmaxf(l, 1e-30f));
}

template <typename T, typename P, int D>
cudaError_t launch(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes<D>(std::is_same<P, int8_t>::value);
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem_once(paged_kernel<T, P, D>, smem, configured);
  if (err != cudaSuccess) return err;
  const int rows = (a.hq / a.hkv) * a.t_len;
  dim3 grid(a.slots, a.hkv, ((rows + RT - 1) / RT) * a.n_split);
  paged_kernel<T, P, D><<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T, D><<<a.slots * a.hkv * rows, D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, bool quant, const PagedArgs& a, cudaStream_t stream) {
  if (d != 128) return cudaErrorInvalidValue;  // the text models' width
  if (quant) return launch<T, int8_t, 128>(a, stream);
  return launch<T, T, 128>(a, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = launched). part_acc
// and part_ml are fp32 scratch of S*Hkv*G*T*n_split*D and *2 elements,
// n_split = ceil(W*BS / split_cols); split_cols is a multiple of 64.
// k_scale / v_scale non-null: the pools are int8 and T <= 64.
HOCR_EXPORT int hocr_paged_append_attention(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* tables,
    const void* start, const void* n_valid, void* out, void* part_acc,
    void* part_ml, int slots, int t_len, int hq, int hkv, int d, int width,
    int bs, int n_blocks, int layer, int split_cols, float scale, int dtype,
    void* stream) {
  if (slots == 0 || t_len == 0) return 0;
  if (split_cols <= 0 || split_cols % KT != 0) return cudaErrorInvalidValue;
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr) || (quant && t_len > MAX_NEW_INT8))
    return cudaErrorInvalidValue;
  PagedArgs a;
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.start = static_cast<const int*>(start);
  a.n_valid = static_cast<const int*>(n_valid);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.slots = slots;
  a.t_len = t_len;
  a.hq = hq;
  a.hkv = hkv;
  a.width = width;
  a.bs = bs;
  a.n_blocks = n_blocks;
  a.layer = layer;
  a.split_cols = split_cols;
  a.n_split = (width * bs + split_cols - 1) / split_cols;
  a.scale = scale;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return dispatch_d<__nv_bfloat16>(d, quant, a, stm);
  if (dtype == kFloat32) return dispatch_d<float>(d, quant, a, stm);
  return cudaErrorInvalidValue;
}
