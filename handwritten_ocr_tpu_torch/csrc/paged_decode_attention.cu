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
// cols <= start + i. Scores, softmax and sums in fp32; a slot with
// n_valid == 0 appends nothing, reads no page and outputs 0. Rows i >=
// n_valid output 0 (callers never read them).
//
// THE POOLS ARE UPDATED IN PLACE (the TPU kernel returns them aliased).
//
// Bound: bytes. A decode step reads each live slot's cached K and V once
// (bf16: 2 x 256 bytes per token and kv-head, 1 KB per token per layer at
// 28:4 heads; int8: 2 x 128 bytes + 8 bytes of scales) and does ~4 flops
// per byte. A decode step has few live slots x Hkv kv-heads, too few
// blocks to fill 132 SMs if each walked a whole context, so every body
// splits the context (flash-decoding) over blocks of `split_cols` cols. In
// all of them, the block (row tile 0, split 0) appends the head's new rows
// to the pool, and every block reads the cached cols < start from the pool
// pages and the new cols start .. start+n_valid-1 from the call's own
// rows, so no block reads a pool row another block is writing.
//
// Three bodies:
// - bf16 q over bf16 pools (fp KV, HOCR_KV_INT8=0): paged_bf16_mma_kernel,
//   on the tensor cores, one launch (described above it).
// - int8 pools with bf16 q (both engines' default): paged_int8_mma_kernel,
//   on the tensor cores, one launch (described above it).
// - fp32 q, over fp32 or int8 pools (the card's reference runs):
//   paged_kernel, fp32 FMAs out of shared memory, grid (slot, kv-head, row
//   tile of 16 of the G*T query rows x split); each block writes its
//   partial (m, l, unnormalised acc) and a second kernel combines the
//   splits of each row. Key tiles of 64 cols stream through shared
//   memory: the tile's row addresses are looked up once (one table read
//   per col), then every thread issues all its 16-byte loads of the tile
//   before using any. 128 threads, each owning one query row x 8 strided
//   cols of the scores and D/8 output cols; q is scaled before the dot.
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

#include "hopper.cuh"

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
  int* counters;     // tensor-core bodies: [S, Hkv, row tiles], 0 between launches
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

// Appends the nv new rows of head h of slot s to the pools at pos =
// min(start + i, cap) through the slot's table; int8 pools take the rows
// and scales that quantize_new_rows left in shared memory.
template <typename T, typename P, int D>
__device__ void append_rows(const PagedArgs& a, int s, int h,
                            const int8_t* s_kq, const int8_t* s_vq,
                            const float* s_ks, const float* s_vs) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  const T* k_new = static_cast<const T*>(a.k_new);
  const T* v_new = static_cast<const T*>(a.v_new);
  P* k_pool = static_cast<P*>(a.k_pool);
  P* v_pool = static_cast<P*>(a.v_pool);
  const int st = a.start[s], nv = a.n_valid[s], bs = a.bs, hkv = a.hkv;
  const int* tab = a.tables + (size_t)s * a.width;
  const int cap = a.width * bs - 1;
  const size_t row_elems = (size_t)hkv * D;
  const size_t page_elems = (size_t)bs * row_elems;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * page_elems;
  for (int idx = threadIdx.x; idx < nv * D; idx += NT) {
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
      const size_t src = ((size_t)(s * a.t_len + i) * hkv + h) * D + c;
      k_pool[dst] = k_new[src];
      v_pool[dst] = v_new[src];
    }
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
  const size_t row_elems = (size_t)hkv * D;
  const size_t page_elems = (size_t)bs * row_elems;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * page_elems;

  if constexpr (QUANT)
    quantize_new_rows<T, D>(k_new, v_new, s, h, t_len, hkv, nv, s_kq, s_vq,
                            s_ks, s_vs, s_red);

  if (tile == 0 && split == 0)   // the append: one block per slot and head
    append_rows<T, P, D>(a, s, h, s_kq, s_vq, s_ks, s_vs);

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

// ---- shared by the two tensor-core bodies (bf16 q, D = 128) --------------

constexpr int HD = 128;   // the text models' head width

// Output row r of (slot s, kv-head h): group member r / T, token r % T.
__device__ __forceinline__ __nv_bfloat16* out_row_ptr(const PagedArgs& a, int s, int h,
                                                      int r) {
  return static_cast<__nv_bfloat16*>(a.out) +
         ((size_t)(s * a.t_len + r % a.t_len) * a.hq + h * (a.hq / a.hkv) + r / a.t_len) * HD;
}

// A slot with n_valid == 0: split 0 zeroes the block's output rows.
__device__ void zero_dead_rows(const PagedArgs& a, int s, int h, int rt, int split) {
  if (split != 0) return;
  const int rows = (a.hq / a.hkv) * a.t_len;
  for (int idx = threadIdx.x; idx < RT * HD; idx += NT) {
    const int r = rt * RT + idx / HD;
    if (r < rows) out_row_ptr(a, s, h, r)[idx % HD] = __float2bfloat16(0.f);
  }
}

// The block's four warps have left their (m, l) and unnormalised O rows in
// shared memory at `ring` (s_o [4][RT][HD] fp32, then s_ml [4][RT][2]).
// One thread per d merges the warps in order; with one split the block
// writes its output rows, with several each writes its partials, and the
// last block to arrive merges the splits in split order and resets the
// arrival counter for the next launch.
__device__ void finish_tile(const PagedArgs& a, uint8_t* ring, int s, int h, int rt,
                            int row_tiles, int split, int n_act) {
  static_assert(HD == NT, "one thread per output d");
  __shared__ int s_last;
  const float* s_o = reinterpret_cast<const float*>(ring);
  const float* s_ml = s_o + 4 * RT * HD;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = (a.hq / a.hkv) * a.t_len;
  const int d = tid;
  const int cidx = (s * a.hkv + h) * row_tiles + rt;
  for (int r = 0; r < RT; ++r) {
    const int r_glob = rt * RT + r;
    if (r_glob >= rows) break;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, s_ml[(w * RT + r) * 2]);
    float ll = 0.f, acc = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mw = s_ml[(w * RT + r) * 2];
        if (mw == -INFINITY) continue;
        const float f = expf(mw - mm);
        ll += s_ml[(w * RT + r) * 2 + 1] * f;
        acc += s_o[(w * RT + r) * HD + d] * f;
      }
    }
    if (n_act == 1) {
      out_row_ptr(a, s, h, r_glob)[d] = __float2bfloat16(acc / fmaxf(ll, 1e-30f));
    } else {
      const size_t part = ((size_t)cidx * RT + r) * a.n_split + split;
      a.part_acc[part * HD + d] = acc;
      if (d == 0) {
        a.part_ml[2 * part] = mm;
        a.part_ml[2 * part + 1] = ll;
      }
    }
  }
  if (n_act == 1) return;
  __threadfence();     // this split's partials are visible before it arrives
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + cidx, 1) == n_act - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();     // every split's partials are visible to the last block
  // Each row's split weights exp(m_i - max m) and denominator, one thread
  // per row, into the (free) ring; then 32 threads per row sum the
  // partials in split order, four d each by 16-byte loads.
  const int rows_here = min(RT, rows - rt * RT);
  float* s_wt = reinterpret_cast<float*>(ring);     // [RT][n_act]
  float* s_den = s_wt + RT * n_act;                  // [RT]
  if (tid < rows_here) {
    const size_t base = ((size_t)cidx * RT + tid) * a.n_split;
    float mm = -INFINITY;
    for (int i = 0; i < n_act; ++i) mm = fmaxf(mm, __ldcg(a.part_ml + 2 * (base + i)));
    float ll = 0.f;
    for (int i = 0; i < n_act; ++i) {   // in split order: deterministic
      const float mi = __ldcg(a.part_ml + 2 * (base + i));
      const float w = (mi == -INFINITY) ? 0.f : expf(mi - mm);
      s_wt[tid * n_act + i] = w;
      ll += __ldcg(a.part_ml + 2 * (base + i) + 1) * w;
    }
    s_den[tid] = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  const float4* acc4 = reinterpret_cast<const float4*>(a.part_acc);
  for (int r = warp; r < rows_here; r += NT / 32) {
    const size_t base = ((size_t)cidx * RT + r) * a.n_split;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n_act; ++i) {   // in split order: deterministic
      const float w = s_wt[r * n_act + i];
      const float4 v = __ldcg(acc4 + (base + i) * (HD / 4) + lane);
      acc.x += v.x * w;
      acc.y += v.y * w;
      acc.z += v.z * w;
      acc.w += v.w * w;
    }
    const float den = s_den[r];
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_row_ptr(a, s, h, rt * RT + r) + 4 * lane);
    dst[0] = __floats2bfloat162_rn(acc.x / den, acc.y / den);
    dst[1] = __floats2bfloat162_rn(acc.z / den, acc.w / den);
  }
  if (tid == 0) a.counters[cidx] = 0;   // ready for the next launch
}

// ---- int8 pools, bf16 q: the tensor-core body ----------------------------
//
// One block per (slot, kv-head, row tile of 16 query rows, context split):
// at a decode step (T = 1) the group's G <= 8 rows fit one tile, so K and V
// are read once per split. K/V tiles of 64 cols stay int8 in a 3-stage
// ring of shared memory, filled by 16-byte cp.async from the pages (this
// call's new cols from the block's own quantisation) while the tile before
// computes; scales ride along by 4-byte cp.async. Warp w takes cols 16w ..
// 16w+15 of every tile and keeps its own online softmax; the four warps
// merge at the end, then the splits merge in the same launch (the last
// block to arrive, in split order).
//   S = Q.K^T: mma.sync m16n8k16 with the bf16 q rows as A (from
//   registers, loaded once) and K as B, widened in registers. The sum over
//   d does not care about order, so d is permuted per 64-wide half such
//   that each lane reads 16 contiguous bytes of a K row (as in int8_matmul).
//   The fp32 scores get scale * k_scale[col], then the mask.
//   O += P.V: P (times v_scale[col], after l has summed it) is split into
//   bf16 hi + lo parts, two products, so P keeps ~16 bits as the fp32 p of
//   the TPU kernel does. V's B operand needs a col pair per register, which
//   ldmatrix cannot give for 8-bit data: each lane reads 32-bit words (4
//   d values) of four cols and pairs their bytes by byte permutes. For
//   that, the output columns are permuted: lane g of n-tile 4J+e owns d =
//   32J + 4g + e, so a lane ends with 8 contiguous d of each of its rows.
constexpr int STAGES8 = 3;
constexpr int KV_TILE_BYTES = KT * 128;           // one int8 K or V tile (D = 128)
constexpr int STAGE8_BYTES = 2 * KV_TILE_BYTES + 2 * KT * (int)sizeof(float);

constexpr size_t int8_mma_smem_bytes(int t_len) {
  // the ring (reused for the warps' merge), then the new rows quantised
  return (size_t)STAGES8 * STAGE8_BYTES + (size_t)t_len * (2 * 128 + 2 * sizeof(float));
}
static_assert(4 * RT * 128 * sizeof(float) + 4 * RT * 2 * sizeof(float) <=
                  (size_t)STAGES8 * STAGE8_BYTES, "the merge fits the ring");

// 16-byte chunk j of K col c sits at chunk j ^ 4(c & 1), of V col c at
// chunk j ^ 2((c >> 1) & 3): conflict-free for the reads below.
__device__ __forceinline__ int k_chunk(int c, int j) { return j ^ ((c & 1) << 2); }
__device__ __forceinline__ int v_chunk(int c, int j) { return j ^ (((c >> 1) & 3) << 1); }

// Cols k0 .. k0+63 of head h into one ring stage: cached cols from their
// page, this call's cols from the block's quantisation, the rest zero.
__device__ __forceinline__ void load_kv_tile(const PagedArgs& a, uint8_t* stage, int k0,
                                             int h, int st, int limit, const int* tab,
                                             const int8_t* s_kq, const int8_t* s_vq,
                                             const float* s_ks, const float* s_vs) {
  constexpr int D = 128;
  int8_t* sk = reinterpret_cast<int8_t*>(stage);
  int8_t* sv = sk + KV_TILE_BYTES;
  float* sks = reinterpret_cast<float*>(sv + KV_TILE_BYTES);
  float* svs = sks + KT;
  const int8_t* k_pool = static_cast<const int8_t*>(a.k_pool);
  const int8_t* v_pool = static_cast<const int8_t*>(a.v_pool);
  const int tid = threadIdx.x, bs = a.bs;
  const size_t row_elems = (size_t)a.hkv * D;
  const size_t page_elems = (size_t)bs * row_elems;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * page_elems;
#pragma unroll
  for (int it = 0; it < KT * 8 / NT; ++it) {
    const int idx = it * NT + tid, col = idx / 8, j = idx % 8, c = k0 + col;
    int8_t* dk = sk + col * D + 16 * k_chunk(col, j);
    int8_t* dv = sv + col * D + 16 * v_chunk(col, j);
    if (c < st) {
      const size_t off = layer_off + (size_t)__ldg(tab + c / bs) * page_elems +
                         (size_t)(c % bs) * row_elems + (size_t)h * D + 16 * j;
      cp_async16(dk, k_pool + off);
      cp_async16(dv, v_pool + off);
    } else if (c < limit) {
      *reinterpret_cast<uint4*>(dk) = *reinterpret_cast<const uint4*>(s_kq + (c - st) * D + 16 * j);
      *reinterpret_cast<uint4*>(dv) = *reinterpret_cast<const uint4*>(s_vq + (c - st) * D + 16 * j);
    } else {
      *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
    }
  }
  if (tid < KT) {
    const int c = k0 + tid;
    if (c < st) {
      const size_t sc = (((size_t)a.layer * a.n_blocks + __ldg(tab + c / bs)) * a.hkv + h) * bs + c % bs;
      cp_async4(sks + tid, a.k_scale + sc);
      cp_async4(svs + tid, a.v_scale + sc);
    } else {
      sks[tid] = c < limit ? s_ks[c - st] : 0.f;
      svs[tid] = c < limit ? s_vs[c - st] : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
paged_int8_mma_kernel(const PagedArgs a) {
  static_assert(D == 128, "the text models' head width");
  extern __shared__ __align__(128) uint8_t smem8[];
  __shared__ float s_red[2 * NT / 32];
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const int s = blockIdx.x, h = blockIdx.y;
  const int row_tiles = gridDim.z / a.n_split;
  const int rt = blockIdx.z % row_tiles, split = blockIdx.z / row_tiles;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int t_len = a.t_len, group = a.hq / a.hkv, rows = group * t_len;
  const int st = a.start[s], nv = a.n_valid[s], limit = st + nv;

  if (nv == 0) {   // a dead slot: zero output, no append, no page read
    zero_dead_rows(a, s, h, rt, split);
    return;
  }
  const int n_act = min(a.n_split, (limit + a.split_cols - 1) / a.split_cols);   // splits with cols
  if (split >= n_act) return;
  const int c_begin = split * a.split_cols;
  const int c_end = min(limit, c_begin + a.split_cols);
  const bool append = rt == 0 && split == 0;

  uint8_t* ring = smem8;
  int8_t* s_kq = reinterpret_cast<int8_t*>(smem8 + STAGES8 * STAGE8_BYTES);
  int8_t* s_vq = s_kq + t_len * D;
  float* s_ks = reinterpret_cast<float*>(s_vq + t_len * D);
  float* s_vs = s_ks + t_len;
  if (append || c_end > st) {   // this block appends or reads new cols
    quantize_new_rows<__nv_bfloat16, D>(static_cast<const __nv_bfloat16*>(a.k_new),
                                        static_cast<const __nv_bfloat16*>(a.v_new), s, h,
                                        t_len, a.hkv, nv, s_kq, s_vq, s_ks, s_vs, s_red);
    if (append) append_rows<__nv_bfloat16, int8_t, D>(a, s, h, s_kq, s_vq, s_ks, s_vs);
  }

  // Q as the A operand, rows g (lo) and g+8 (hi) of the tile: qa[half][step]
  // = {row g d 4s..4s+1, row g+8 same, row g d 4s+2..4s+3, row g+8 same} of
  // the lane's 16 d at 64 half + 16t.
  uint32_t qa[2][4][4];
  int row_max[2];
  bool row_ok[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = rt * RT + g + 8 * hi;
    const int tok = r % t_len;
    row_ok[hi] = r < rows && tok < nv;
    row_max[hi] = st + tok;
    const __nv_bfloat16* qrow = q + ((size_t)(s * t_len + tok) * a.hq + h * group + r / t_len) * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 v[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      if (row_ok[hi]) {
        v[0] = __ldg(reinterpret_cast<const uint4*>(qrow + 64 * half + 16 * t));
        v[1] = __ldg(reinterpret_cast<const uint4*>(qrow + 64 * half + 16 * t + 8));
      }
      const uint32_t* w = reinterpret_cast<const uint32_t*>(v);
#pragma unroll
      for (int st4 = 0; st4 < 4; ++st4) {
        qa[half][st4][hi] = w[2 * st4];
        qa[half][st4][2 + hi] = w[2 * st4 + 1];
      }
    }
  }

  float o[16][4];   // O: n-tile 4J+e; [0..1] row g, [2..3] row g+8
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int* tab = a.tables + (size_t)s * a.width;
  const int n_tiles = (c_end - c_begin + KT - 1) / KT;

#pragma unroll
  for (int i = 0; i < STAGES8 - 1; ++i) {
    if (i < n_tiles)
      load_kv_tile(a, ring + i * STAGE8_BYTES, c_begin + i * KT, h, st, limit, tab,
                   s_kq, s_vq, s_ks, s_vs);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES8 - 2>();
    __syncthreads();   // tile i landed for all; stage (i - 1) % STAGES8 is free
    const int nxt = i + STAGES8 - 1;
    if (nxt < n_tiles)
      load_kv_tile(a, ring + (nxt % STAGES8) * STAGE8_BYTES, c_begin + nxt * KT, h, st,
                   limit, tab, s_kq, s_vq, s_ks, s_vs);
    cp_async_commit();

    const uint8_t* stage = ring + (i % STAGES8) * STAGE8_BYTES;
    const int8_t* sk = reinterpret_cast<const int8_t*>(stage);
    const int8_t* sv = sk + KV_TILE_BYTES;
    const float* sks = reinterpret_cast<const float*>(sv + KV_TILE_BYTES);
    const float* svs = sks + KT;
    const int k0 = c_begin + i * KT;

    // S for the warp's 16 cols: sc[nt][0..1] row g, cols 8nt+2t, +1; [2..3] row g+8
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const int col = 16 * warp + 8 * nt + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 kw = *reinterpret_cast<const uint4*>(sk + col * D + 16 * k_chunk(col, 4 * half + t));
        const uint32_t* kwords = &kw.x;
#pragma unroll
        for (int st4 = 0; st4 < 4; ++st4) {
          uint32_t b0, b1;
          i8x4_to_bf16(kwords[st4], b0, b1);
          mma_bf16(sc[nt], qa[half][st4], b0, b1);
        }
      }
    }

    // online softmax per row over the warp's cols; P' = p * v_scale
    float corr[2];
    float pv[2][4];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int colt = 16 * warp + 8 * nt + 2 * t + e;
          const int c = k0 + colt;
          const bool ok = row_ok[hi] && c < limit && c <= row_max[hi];
          float& v = sc[nt][2 * hi + e];
          v = ok ? v * a.scale * sks[colt] : -INFINITY;
          mx = fmaxf(mx, v);
        }
      mx = group_max<4>(mx);
      const float m_new = fmaxf(m_run[hi], mx);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int colt = 16 * warp + 8 * nt + 2 * t + e;
          const float p = expf(sc[nt][2 * hi + e] - safe);
          sum += p;   // l sums the probabilities before any v scale
          pv[nt][2 * hi + e] = p * svs[colt];
        }
      sum = group_sum<4>(sum);
      corr[hi] = (m_run[hi] == -INFINITY) ? 0.f : expf(m_run[hi] - safe);
      l_run[hi] = corr[hi] * l_run[hi] + sum;
      m_run[hi] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // P as the A operand (k = the warp's cols 2t, 2t+1 | 2t+8, 2t+9), hi + lo
    uint32_t pa_hi[4], pa_lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int nt = r / 2, e0 = 2 * (r % 2);   // a0: nt0 row g; a1: nt0 row g+8; ...
      const float x0 = pv[nt][e0], x1 = pv[nt][e0 + 1];
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x0, x1);
      const float2 back = __bfloat1622float2(hi2);
      pa_hi[r] = *reinterpret_cast<const uint32_t*>(&hi2);
      pa_lo[r] = pack_bf16(x0 - back.x, x1 - back.y);
    }
    const uint32_t a_hi[4] = {pa_hi[0], pa_hi[1], pa_hi[2], pa_hi[3]};
    const uint32_t a_lo[4] = {pa_lo[0], pa_lo[1], pa_lo[2], pa_lo[3]};
    // V words: cols 2t, 2t+1, 2t+8, 2t+9 of the warp, word 8J + g (d 32J + 4g ..)
    const int vcols[4] = {16 * warp + 2 * t, 16 * warp + 2 * t + 1,
                          16 * warp + 2 * t + 8, 16 * warp + 2 * t + 9};
#pragma unroll
    for (int J = 0; J < 4; ++J) {
      uint32_t vw[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = vcols[cc];
        vw[cc] = *reinterpret_cast<const uint32_t*>(
            sv + col * D + 16 * v_chunk(col, 2 * J + g / 4) + 4 * (g % 4));
      }
      uint32_t b0[4], b1[4];   // per e: cols (2t, 2t+1) and (2t+8, 2t+9) at d 32J+4g+e
      i8x4_to_bf16(__byte_perm(vw[0], vw[1], 0x5140), b0[0], b0[1]);
      i8x4_to_bf16(__byte_perm(vw[0], vw[1], 0x7362), b0[2], b0[3]);
      i8x4_to_bf16(__byte_perm(vw[2], vw[3], 0x5140), b1[0], b1[1]);
      i8x4_to_bf16(__byte_perm(vw[2], vw[3], 0x7362), b1[2], b1[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mma_bf16(o[4 * J + e], a_hi, b0[e], b1[e]);
        mma_bf16(o[4 * J + e], a_lo, b0[e], b1[e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the warps' merge

  // The warps' (m, l, O) into shared memory; a lane holds d = 32J + 8t +
  // 0..7 of rows g and g+8: o[4J+e][0] is d 32J+8t+e, o[4J+e][1] d +4.
  float* s_o = reinterpret_cast<float*>(smem8);     // [warp][RT][D]
  float* s_ml = s_o + 4 * RT * D;                    // [warp][RT][2]
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = g + 8 * hi;
#pragma unroll
    for (int J = 0; J < 4; ++J) {
      float* dst = s_o + (warp * RT + r) * D + 32 * J + 8 * t;
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[4 * J][2 * hi], o[4 * J + 1][2 * hi], o[4 * J + 2][2 * hi], o[4 * J + 3][2 * hi]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(o[4 * J][2 * hi + 1], o[4 * J + 1][2 * hi + 1], o[4 * J + 2][2 * hi + 1],
                      o[4 * J + 3][2 * hi + 1]);
    }
    if (t == 0) {
      s_ml[(warp * RT + r) * 2] = m_run[hi];
      s_ml[(warp * RT + r) * 2 + 1] = l_run[hi];
    }
  }
  __syncthreads();
  finish_tile(a, smem8, s, h, rt, row_tiles, split, n_act);
}

// ---- bf16 pools, bf16 q: the tensor-core body (fp KV) -------------------
//
// Replaces the TPU kernel's fp-KV branch at bf16. Bound by bytes: 1 KB per
// cached token per layer at 28:4 heads (2 KB at 64:8), read once; the
// products are ~4 flops per byte, far below the tensor cores' rate.
//
// One block per (slot, kv-head, row tile of 16 query rows, context split),
// the grid of the int8 body: at a decode step (T = 1) the group's G <= 8
// rows fit one tile, so K and V are read once per split. bf16 K/V tiles of
// 64 cols (16 KB each) stream through a 3-stage ring of shared memory
// (96 KB: two blocks fit an SM), filled by 16-byte cp.async from the pages
// through the slot's table, this call's new cols straight from k_new /
// v_new, while the tile before computes. A col's 16-byte chunk j sits at
// chunk j ^ (col & 7), so the eight rows an ldmatrix phase reads fall in
// eight distinct bank groups. Warp w takes cols 16w .. 16w+15 of every tile
// and keeps its own online softmax; the four warps merge at the end, then
// the splits merge in the same launch (the last block to arrive, in split
// order, through a self-resetting arrival counter).
//   S = Q.K^T: mma.sync m16n8k16, the bf16 q rows as A (registers, loaded
//   once), K as B by ldmatrix from the ring (no widening); fp32 scores
//   times the softmax scale, then the causal mask per row's token.
//   O += P.V: P in fp32 split into bf16 hi + lo parts, two products, so P
//   keeps ~16 bits as the fp32 p of the TPU kernel does; V as B by
//   ldmatrix.trans (a col pair per register).
constexpr int STAGES16 = 3;
constexpr int KV16_TILE_BYTES = KT * HD * 2;      // one bf16 K or V tile
constexpr int STAGE16_BYTES = 2 * KV16_TILE_BYTES;
constexpr size_t BF16_MMA_SMEM_BYTES = (size_t)STAGES16 * STAGE16_BYTES;
static_assert(4 * RT * HD * sizeof(float) + 4 * RT * 2 * sizeof(float) <= BF16_MMA_SMEM_BYTES,
              "the merge fits the ring");

__device__ __forceinline__ int kv16_chunk(int c, int j) { return j ^ (c & 7); }

// Cols k0 .. k0+63 of head h of slot s into one ring stage: cached cols
// from their page, this call's cols from k_new / v_new, the rest zero.
__device__ __forceinline__ void load_kv16_tile(const PagedArgs& a, uint8_t* stage, int k0,
                                               int s, int h, int st, int limit,
                                               const int* tab) {
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* sv = sk + KT * HD;
  const __nv_bfloat16* k_pool = static_cast<const __nv_bfloat16*>(a.k_pool);
  const __nv_bfloat16* v_pool = static_cast<const __nv_bfloat16*>(a.v_pool);
  const __nv_bfloat16* k_new = static_cast<const __nv_bfloat16*>(a.k_new);
  const __nv_bfloat16* v_new = static_cast<const __nv_bfloat16*>(a.v_new);
  const int tid = threadIdx.x, bs = a.bs;
  const size_t row_elems = (size_t)a.hkv * HD;
  const size_t page_elems = (size_t)bs * row_elems;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * page_elems;
#pragma unroll
  for (int it = 0; it < KT * 16 / NT; ++it) {
    const int idx = it * NT + tid, col = idx / 16, j = idx % 16, c = k0 + col;
    __nv_bfloat16* dk = sk + col * HD + 8 * kv16_chunk(col, j);
    __nv_bfloat16* dv = sv + col * HD + 8 * kv16_chunk(col, j);
    if (c < st) {
      const size_t off = layer_off + (size_t)__ldg(tab + c / bs) * page_elems +
                         (size_t)(c % bs) * row_elems + (size_t)h * HD + 8 * j;
      cp_async16(dk, k_pool + off);
      cp_async16(dv, v_pool + off);
    } else if (c < limit) {
      const size_t src = ((size_t)(s * a.t_len + c - st) * a.hkv + h) * HD + 8 * j;
      cp_async16(dk, k_new + src);
      cp_async16(dv, v_new + src);
    } else {
      *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
    }
  }
}

__global__ void __launch_bounds__(NT)
paged_bf16_mma_kernel(const PagedArgs a) {
  extern __shared__ __align__(128) uint8_t smem16[];
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const int s = blockIdx.x, h = blockIdx.y;
  const int row_tiles = gridDim.z / a.n_split;
  const int rt = blockIdx.z % row_tiles, split = blockIdx.z / row_tiles;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int t_len = a.t_len, group = a.hq / a.hkv, rows = group * t_len;
  const int st = a.start[s], nv = a.n_valid[s], limit = st + nv;

  if (nv == 0) {   // a dead slot: zero output, no append, no page read
    zero_dead_rows(a, s, h, rt, split);
    return;
  }
  const int n_act = min(a.n_split, (limit + a.split_cols - 1) / a.split_cols);   // splits with cols
  if (split >= n_act) return;
  const int c_begin = split * a.split_cols;
  const int c_end = min(limit, c_begin + a.split_cols);
  if (rt == 0 && split == 0) append_rows<__nv_bfloat16, __nv_bfloat16, HD>(
      a, s, h, nullptr, nullptr, nullptr, nullptr);

  // Q as the A operand of k-step ks (d 16ks .. 16ks+15): rows g (lo) and
  // g+8 (hi) at d 16ks+2t, +1 (a0, a1) and 16ks+8+2t, +1 (a2, a3).
  uint32_t qa[8][4];
  int row_max[2];
  bool row_ok[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = rt * RT + g + 8 * hi;
    const int tok = r % t_len;
    row_ok[hi] = r < rows && tok < nv;
    row_max[hi] = st + tok;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(
        q + ((size_t)(s * t_len + tok) * a.hq + h * group + r / t_len) * HD);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      qa[ks][hi] = row_ok[hi] ? __ldg(qw + 8 * ks + t) : 0u;
      qa[ks][2 + hi] = row_ok[hi] ? __ldg(qw + 8 * ks + 4 + t) : 0u;
    }
  }

  float o[16][4];   // O n-tile n: [0..1] row g, d 8n+2t, +1; [2..3] row g+8
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int* tab = a.tables + (size_t)s * a.width;
  const int n_tiles = (c_end - c_begin + KT - 1) / KT;
  uint8_t* ring = smem16;

#pragma unroll
  for (int i = 0; i < STAGES16 - 1; ++i) {
    if (i < n_tiles)
      load_kv16_tile(a, ring + i * STAGE16_BYTES, c_begin + i * KT, s, h, st, limit, tab);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES16 - 2>();
    __syncthreads();   // tile i landed for all; stage (i - 1) % STAGES16 is free
    const int nxt = i + STAGES16 - 1;
    if (nxt < n_tiles)
      load_kv16_tile(a, ring + (nxt % STAGES16) * STAGE16_BYTES, c_begin + nxt * KT, s, h, st,
                     limit, tab);
    cp_async_commit();

    const __nv_bfloat16* sk =
        reinterpret_cast<const __nv_bfloat16*>(ring + (i % STAGES16) * STAGE16_BYTES);
    const __nv_bfloat16* sv = sk + KT * HD;
    const int k0 = c_begin + i * KT;

    // S for the warp's 16 cols: sc[nt][0..1] row g, cols 8nt+2t, +1; [2..3] row g+8.
    // ldmatrix x4: lane l addresses row (col) l % 8 of matrix l / 8, which is
    // d chunk 4kp + l / 8: registers b0, b1 of k-steps 2kp and 2kp+1.
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const int col = 16 * warp + 8 * nt + (lane & 7);
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + col * HD + 8 * kv16_chunk(col, 4 * kp + (lane >> 3)));
        mma_bf16(sc[nt], qa[2 * kp], b[0], b[1]);
        mma_bf16(sc[nt], qa[2 * kp + 1], b[2], b[3]);
      }
    }

    // online softmax per row over the warp's cols
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 16 * warp + 8 * nt + 2 * t + e;
          const bool ok = row_ok[hi] && c < limit && c <= row_max[hi];
          float& v = sc[nt][2 * hi + e];
          v = ok ? v * a.scale : -INFINITY;
          mx = fmaxf(mx, v);
        }
      mx = group_max<4>(mx);
      const float m_new = fmaxf(m_run[hi], mx);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[nt][2 * hi + e];
          v = expf(v - safe);   // the probability, 0 where masked
          sum += v;
        }
      sum = group_sum<4>(sum);
      corr[hi] = (m_run[hi] == -INFINITY) ? 0.f : expf(m_run[hi] - safe);
      l_run[hi] = corr[hi] * l_run[hi] + sum;
      m_run[hi] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // P as the A operand (k = the warp's cols 2t, 2t+1 | 2t+8, 2t+9), hi + lo
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int nt = r / 2, e0 = 2 * (r % 2);   // a0: nt0 row g; a1: nt0 row g+8; ...
      const float x0 = sc[nt][e0], x1 = sc[nt][e0 + 1];
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x0, x1);
      const float2 back = __bfloat1622float2(hi2);
      a_hi[r] = *reinterpret_cast<const uint32_t*>(&hi2);
      a_lo[r] = pack_bf16(x0 - back.x, x1 - back.y);
    }
    // V by ldmatrix.trans: lane l addresses col 16w + l % 8 + 8((l / 8) % 2)
    // at d chunk 2dp + l / 16: b0, b1 of n-tiles 2dp and 2dp+1.
    const int vcol = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int dp = 0; dp < 8; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sv + vcol * HD + 8 * kv16_chunk(vcol, 2 * dp + (lane >> 4)));
      mma_bf16(o[2 * dp], a_hi, b[0], b[1]);
      mma_bf16(o[2 * dp], a_lo, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a_hi, b[2], b[3]);
      mma_bf16(o[2 * dp + 1], a_lo, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the warps' merge

  // The warps' (m, l, O) into shared memory: rows g and g+8, d 8n+2t, +1.
  float* s_o = reinterpret_cast<float*>(smem16);    // [warp][RT][HD]
  float* s_ml = s_o + 4 * RT * HD;                   // [warp][RT][2]
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = g + 8 * hi;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(s_o + (warp * RT + r) * HD + 8 * n + 2 * t) =
          make_float2(o[n][2 * hi], o[n][2 * hi + 1]);
    if (t == 0) {
      s_ml[(warp * RT + r) * 2] = m_run[hi];
      s_ml[(warp * RT + r) * 2 + 1] = l_run[hi];
    }
  }
  __syncthreads();
  finish_tile(a, smem16, s, h, rt, row_tiles, split, n_act);
}

cudaError_t launch_bf16_mma(const PagedArgs& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem_once(paged_bf16_mma_kernel, BF16_MMA_SMEM_BYTES, configured);
  if (err != cudaSuccess) return err;
  const int row_tiles = ((a.hq / a.hkv) * a.t_len + RT - 1) / RT;
  const dim3 grid(a.slots, a.hkv, row_tiles * a.n_split);
  paged_bf16_mma_kernel<<<grid, NT, BF16_MMA_SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_int8_mma(const PagedArgs& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem_once(paged_int8_mma_kernel<128>,
                                  int8_mma_smem_bytes(MAX_NEW_INT8), configured);
  if (err != cudaSuccess) return err;
  const int row_tiles = ((a.hq / a.hkv) * a.t_len + RT - 1) / RT;
  const dim3 grid(a.slots, a.hkv, row_tiles * a.n_split);
  paged_int8_mma_kernel<128><<<grid, NT, int8_mma_smem_bytes(a.t_len), stream>>>(a);
  return cudaGetLastError();
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

// bf16 q: the tensor-core bodies (int8 or bf16 pools); fp32 q: the fp32
// body over int8 or fp32 pools.
cudaError_t dispatch(int dtype, int d, bool quant, const PagedArgs& a, cudaStream_t stream) {
  if (d != HD) return cudaErrorInvalidValue;  // the text models' width
  if (dtype == kBFloat16) {
    if (a.counters == nullptr) return cudaErrorInvalidValue;
    return quant ? launch_int8_mma(a, stream) : launch_bf16_mma(a, stream);
  }
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  return quant ? launch<float, int8_t, HD>(a, stream) : launch<float, float, HD>(a, stream);
}

}  // namespace

// One call's arguments in one record, as the Python wrapper packs them
// (struct format "=15Q10ifi"): one ctypes argument to convert instead of
// 27. part_acc and part_ml are fp32 scratch of S*Hkv*ceil(G*T/16)*16*
// n_split*D and *2 elements, n_split = ceil(W*BS / split_cols);
// split_cols is a multiple of 64. k_scale / v_scale non-null: the pools
// are int8 and T <= 64. bf16 q takes a tensor-core body (one launch, over
// int8 or bf16 pools), which needs `counters`: S*Hkv*ceil(G*T/16) int32
// that are 0 (it leaves them 0). dtype: q's, 0 = float32, 1 = bfloat16.
struct PagedCall {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* k_pool;
  void* v_pool;
  void* k_scale;
  void* v_scale;
  const void* tables;
  const void* start;
  const void* n_valid;
  void* out;
  void* part_acc;
  void* part_ml;
  void* counters;
  void* stream;
  int slots, t_len, hq, hkv, d, width, bs, n_blocks, layer, split_cols;
  float scale;
  int dtype;
};

// Returns cudaGetLastError() after the launches (0 = launched).
HOCR_EXPORT int hocr_paged_append_attention(const PagedCall* call) {
  const PagedCall& c = *call;
  if (c.slots == 0 || c.t_len == 0) return 0;
  if (c.split_cols <= 0 || c.split_cols % KT != 0) return cudaErrorInvalidValue;
  const bool quant = c.k_scale != nullptr;
  if (quant != (c.v_scale != nullptr) || (quant && c.t_len > MAX_NEW_INT8))
    return cudaErrorInvalidValue;
  PagedArgs a;
  a.q = c.q;
  a.k_new = c.k_new;
  a.v_new = c.v_new;
  a.k_pool = c.k_pool;
  a.v_pool = c.v_pool;
  a.k_scale = static_cast<float*>(c.k_scale);
  a.v_scale = static_cast<float*>(c.v_scale);
  a.tables = static_cast<const int*>(c.tables);
  a.start = static_cast<const int*>(c.start);
  a.n_valid = static_cast<const int*>(c.n_valid);
  a.out = c.out;
  a.part_acc = static_cast<float*>(c.part_acc);
  a.part_ml = static_cast<float*>(c.part_ml);
  a.counters = static_cast<int*>(c.counters);
  a.slots = c.slots;
  a.t_len = c.t_len;
  a.hq = c.hq;
  a.hkv = c.hkv;
  a.width = c.width;
  a.bs = c.bs;
  a.n_blocks = c.n_blocks;
  a.layer = c.layer;
  a.split_cols = c.split_cols;
  a.n_split = (c.width * c.bs + c.split_cols - 1) / c.split_cols;
  const size_t ring = quant ? (size_t)STAGES8 * STAGE8_BYTES : BF16_MMA_SMEM_BYTES;
  if (c.dtype == kBFloat16 && (size_t)RT * (a.n_split + 1) * sizeof(float) > ring)
    return cudaErrorInvalidValue;   // the split merge's weights must fit the ring
  a.scale = c.scale;
  return dispatch(c.dtype, c.d, quant, a, static_cast<cudaStream_t>(c.stream));
}
