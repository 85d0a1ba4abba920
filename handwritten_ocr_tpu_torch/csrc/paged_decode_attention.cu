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
// per byte. A decode step has few live slots x Hkv kv-heads, too few to
// fill 132 SMs if each walked a whole context, so every body splits the
// context (flash-decoding) over blocks. One block appends each (slot,
// head)'s new rows to the pool, and every block reads the cached cols <
// start from the pool pages and the new cols start .. start+n_valid-1 from
// the call's own rows, so no block reads a pool row another block is
// writing.
//
// Three bodies:
// - bf16 q over bf16 pools (fp KV, HOCR_KV_INT8=0) and bf16 q over int8
//   pools (both engines' default): paged_mma_kernel, on the tensor cores,
//   one persistent launch over the live work only (described above it).
// - fp32 q, over fp32 or int8 pools (the card's reference runs):
//   paged_f32_kernel, FMAs, the same persistent launch over the live work
//   and the same merge in the launch (described above it).
//
// int8 pools (P = int8_t). Append: per (slot, token, head) amax = max|k|
// over D in fp32, scale = max(amax, 1e-6) / 127 by a true division, q =
// round-half-even(k / scale), no clip: bit-equal to the JAX package's
// _quantize_rows. Each scale goes straight to [layer, block, h, pos % BS]
// (the TPU kernel's whole-page read-modify-write is a VMEM-alignment
// workaround). Every block that reads new cols quantises the step's new
// rows of its head into shared memory the same way and reads them from
// there, so they carry the same quantisation error as the appended rows.
// Scores of the int8 keys are multiplied by k_scale[col] before the mask; p is added to
// l before it is multiplied by v_scale[col] for the P.V product.
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int RT = 16;   // query rows of a tensor-core row tile
constexpr int KT = 64;   // key cols per tile
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
  float* part_acc;   // unnormalised P.V: fp32 [work item, G*T, D]
  float* part_ml;    // running max, denominator: the same rows, 2 each
  int* counters;     // [S, Hkv], 0 between launches
  int slots, t_len, hq, hkv, width, bs, n_blocks, layer;
  int blocks, warps, col_groups, min_chunk_tiles, max_chunks;
  int bs_log2;       // log2(bs) for power-of-two pages, else -1
  float scale;
};

// ---- the tensor-core bodies (bf16 q, D = 128): live work only ------------
//
// paged_mma_kernel<QUANT, C, MAXW>: QUANT = int8 pools (the int8 body, both
// engines' default), else bf16 pools (the fp-KV body, HOCR_KV_INT8=0).
// Replaces the earlier tensor-core bodies (paged_int8_mma_kernel,
// paged_bf16_mma_kernel), whose grid was (slot, kv-head, row tile x
// context split) sized from the shapes alone: at a decode step most
// of its blocks belonged to dead slots or to splits past the context and
// exited at once, each live block streamed one or two 64-col tiles (its
// cp.async ring never filled), the last block merged up to 16 splits one
// row after another, and at a verify round (T = 17) each of the 8-9 row
// tiles of 16 query rows was its own block, so every K/V tile was read 8-9
// times.
//
// Bound: bytes. A decode step reads each live slot's cached K and V once
// (bf16: 2 x 256 bytes per token and kv-head; int8: 2 x 128 + 8 bytes of
// scales) and does ~4 flops per byte at T = 1 (~70 at T = 17), far below
// the tensor cores' rate. At small live counts a call is bound by latency:
// a chain of dependent global round trips (start / n_valid, the page
// table, the first K/V tile, the arrival, the merge), each ~1-2 us on the
// H100 (PERF.md), and each tile a block streams after its first adds ~2 us.
//
// Design:
// - A persistent grid of about one wave (plan() in the wrapper: as many
//   blocks per SM as the shared memory allows, times the SMs). Every block
//   derives the same work list from start / n_valid (no host sync, so a
//   decode step stays capturable in a CUDA graph): a work item is a live
//   (slot, kv-head, chunk of 64-col tiles). The chunk length is the
//   shortest (at least min_chunk_tiles, two ring tiles, and at least
//   tiles / max_chunks, so that a pair's partials fit the merge's buffer)
//   at which the items fit the grid, so they fill it about once; each
//   pair's chunks are then evened out. The work list lives in dynamic
//   shared memory, 5 ints a slot, so any slot count fits. Items go by
//   slot, kv-head, chunk; block b takes items b, b + blocks, ... Dead
//   slots and cols past start + n_valid cost no block; a strided pass of
//   the same launch zeroes the dead slots' output.
// - One block serves every query row of its item: the G*T rows of the
//   kv-head are tiles of 16 (m16n8k16 A fragments), one per warp (C = 1: T
//   > 1, 8-12 warps, up to 12 row tiles in one pass over the chunk, more in
//   further passes; q in registers up to 8 warps, 255 registers a thread,
//   else in shared memory, read by ldmatrix, at 168); at T = 1 the G <= 8
//   rows are one tile and the four warps split each 64-col tile's cols (C =
//   4) and merge their online softmaxes at the end. K/V tiles stream
//   through a 3-stage cp.async ring of shared memory once per pass and feed
//   every row tile (a thread's page-table lookups of a tile in flight
//   together); an int8 tile is widened to bf16 once, not once per row
//   tile: at T > 1 into a tile of its own, at T = 1 (each warp its own
//   cols) in registers (tile_mma_regw), which keeps a block to ~51 KB.
//   bf16 K and V go to the tensor cores by ldmatrix (V transposed);
//   16-byte chunk j of col c sits at chunk j ^ (c & 7), so the eight rows
//   of an ldmatrix phase fall in distinct bank groups. S = Q.K^T in fp32, times the softmax scale (and k_scale[col]),
//   then the causal mask per row's token; P in fp32 (times v_scale[col]
//   after l has summed it) as bf16 hi + lo parts, two products, so P keeps
//   ~16 bits as the fp32 p of the TPU kernel does.
// - The chunks of a (slot, kv-head) merge in the same launch: each writes
//   its (m, l, unnormalised O) rows to the workspace at its item index, one
//   thread releases them (fence.acq_rel) and moves the pair's counter, and
//   the last block to arrive acquires them, brings them into shared memory
//   by bulk asynchronous copies and merges them in chunk order, so two
//   calls are bit-equal; it resets the counter. A pair of one chunk writes
//   its output directly.
// - The pair's last chunk appends the step's new rows (int8: quantised in
//   shared memory as above, 16-byte stores); any chunk that reaches col
//   start reads the new cols from k_new / v_new (int8: the same quantised
//   rows), never from the pool rows being written.

constexpr int HD = 128;          // the text models' head width
constexpr int MMA_STAGES = 3;
constexpr int MAX_WARPS = 12;    // a C = 1 block: up to 12 row tiles a pass
constexpr int FULL_WARPS = 8;    // up to 8 warps: 255 registers a thread (else 168)
constexpr int MIN_WARPS = 8;     // and at least 8 warps
constexpr int KV8_STAGE = 2 * KT * HD + 2 * KT * (int)sizeof(float);   // int8 K, V, scales
constexpr int KV16_STAGE = 2 * KT * HD * 2;                             // bf16 K, V

// Dynamic shared memory of a launch: the ring; over int8 pools widened in
// shared memory (C = 1) the widened bf16 tile; q_warps warps' q tiles (16 x
// HD bf16 each, > 8 warps); over int8 pools the new rows quantised (t_len
// rows of K, V, scales); then, 16-byte aligned, the work list (5 ints a
// slot and one).
__host__ __device__ constexpr size_t mma_smem_bytes(bool quant, bool wide, int t_len,
                                                    int q_warps) {
  return (size_t)MMA_STAGES * (quant ? KV8_STAGE : KV16_STAGE) +
         (size_t)q_warps * RT * HD * 2 +
         (quant ? (wide ? KV16_STAGE : 0) + (size_t)t_len * (2 * HD + 2 * sizeof(float)) : 0);
}
__host__ __device__ constexpr size_t work_list_offset(size_t mma_bytes) {
  return (mma_bytes + 15) & ~(size_t)15;
}
__host__ __device__ constexpr size_t work_list_bytes(int slots) {
  return (size_t)(5 * slots + 1) * sizeof(int);
}

// The chunk merge's buffer: the ring and, over int8 pools at C = 1, the
// widened tile. A pair's chunks come in two rows at a time at least, so a
// launch's max_chunks must keep max_chunks * 2 rows of (HD + 2) floats
// within it (the wrapper's plan sizes it so; the launcher checks).
__host__ __device__ constexpr size_t merge_bytes(bool quant, int col_groups) {
  return (size_t)MMA_STAGES * (quant ? KV8_STAGE : KV16_STAGE) +
         (quant && col_groups == 1 ? KV16_STAGE : 0);
}
constexpr size_t MERGE_ROW_BYTES = (HD + 2) * sizeof(float);
static_assert(4 * RT * (HD + 2) * sizeof(float) <= (size_t)MMA_STAGES * KV8_STAGE,
              "the four warps' merge fits the ring");

__device__ __forceinline__ int kv16_chunk(int c, int j) { return j ^ (c & 7); }

// The table entry of col c: a shift for the engines' power-of-two pages.
__device__ __forceinline__ int page_of(const PagedArgs& a, int c) {
  return a.bs_log2 >= 0 ? c >> a.bs_log2 : c / a.bs;
}

// Output row r of (slot s, kv-head h): group member r / T, token r % T.
template <typename OutT>
__device__ __forceinline__ OutT* out_row_ptr(const PagedArgs& a, int s, int h, int r) {
  return static_cast<OutT*>(a.out) +
         ((size_t)(s * a.t_len + r % a.t_len) * a.hq + h * (a.hq / a.hkv) + r / a.t_len) * HD;
}

// The pool element of a tensor-core body: int8 or bf16.
template <bool QUANT> using Pool16 = std::conditional_t<QUANT, int8_t, __nv_bfloat16>;

// The launch's work list, the same in every block, in the block's shared
// memory (work_list_bytes(slots) at work_list_offset).
struct WorkList {
  int* base;      // [slots + 1] first item of each slot (items of slot s: base[s] .. base[s+1]-1)
  int* start;     // [slots]
  int* n_valid;   // [slots]
  int* chunks;    // [slots] chunks of each (slot, kv-head); 0 for a dead slot
  int* len;       // [slots] tiles of each chunk of the slot (its last: what is left)
};

__device__ void build_work_list(const PagedArgs& a, const WorkList& w) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, blocks = gridDim.x;
    int most = 0;
    for (int s0 = 0; s0 < a.slots; s0 += 32) {
      const int s = s0 + lane;
      if (s < a.slots) {
        const int st = a.start[s], nv = a.n_valid[s];
        w.start[s] = st;
        w.n_valid[s] = nv;
        w.chunks[s] = nv > 0 ? (st + nv + KT - 1) / KT : 0;   // tiles for now (same lane)
        most = max(most, w.chunks[s]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
    // The shortest chunk (>= min_chunk_tiles, and long enough that no
    // pair has more than max_chunks for the merge's buffer) whose items
    // fit the grid: a binary search, every lane on the same values.
    auto items_at = [&](int len) {
      int n = 0;
      for (int s = lane; s < a.slots; s += 32) n += (w.chunks[s] + len - 1) / len;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) n += __shfl_xor_sync(0xffffffffu, n, off);
      return n * a.hkv;
    };
    int lo = max(a.min_chunk_tiles, (most + a.max_chunks - 1) / a.max_chunks);
    int hi = max(lo, most);
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (items_at(mid) <= blocks) hi = mid;
      else lo = mid + 1;
    }
    int running = 0;
    for (int s0 = 0; s0 < a.slots; s0 += 32) {
      const int s = s0 + lane;
      int items = 0;
      if (s < a.slots) {
        const int tiles = w.chunks[s];
        const int n = (tiles + lo - 1) / lo;
        w.chunks[s] = n;
        w.len[s] = n ? (tiles + n - 1) / n : 0;   // the pair's chunks evened out
        items = n * a.hkv;
      }
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {   // inclusive scan over the lanes
        const int v = __shfl_up_sync(0xffffffffu, items, off);
        if (lane >= off) items += v;
      }
      if (s < a.slots) w.base[s + 1] = running + items;
      running += __shfl_sync(0xffffffffu, items, 31);
    }
    if (lane == 0) w.base[0] = 0;
  }
  __syncthreads();
}

// The slot of item `item`: the largest s with base[s] <= item.
__device__ __forceinline__ int slot_of(const WorkList& w, int slots, int item) {
  int lo = 0, hi = slots - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (w.base[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Every dead slot's output rows are 0, written by all blocks in a strided
// pass (16 bytes a store).
template <typename OutT>
__device__ void zero_dead_slots(const PagedArgs& a, const WorkList& w) {
  const size_t per_slot = (size_t)a.t_len * a.hq * HD * sizeof(OutT) / 16;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  uint4* out = static_cast<uint4*>(a.out);
  for (int s = 0; s < a.slots; ++s) {
    if (w.n_valid[s] != 0) continue;
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < per_slot; e += stride)
      out[s * per_slot + e] = make_uint4(0, 0, 0, 0);
  }
}

// Elements 0..3 of p (bf16 or fp32) as floats.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

// The nv new rows (of type T: q's dtype) of head h of slot s quantised
// into shared memory, one warp per row (lane: d 4 lane .. 4 lane + 3):
// int8 rows s_kq / s_vq [nv][HD] and scales s_ks / s_vs [nv]: scale =
// max(amax, 1e-6) / 127 by a true division, q = round-half-even(x /
// scale), bit-equal to the wrapper's quantize_rows and JAX's
// _quantize_rows.
template <typename T>
__device__ void quantize_rows_warp(const PagedArgs& a, int s, int h, int nv, int8_t* s_kq,
                                   int8_t* s_vq, float* s_ks, float* s_vs) {
  const T* k_new = static_cast<const T*>(a.k_new);
  const T* v_new = static_cast<const T*>(a.v_new);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  for (int i = warp; i < nv; i += warps) {
    const size_t src = ((size_t)(s * a.t_len + i) * a.hkv + h) * HD + 4 * lane;
    float kx[4], vx[4];
    load4(k_new + src, kx);
    load4(v_new + src, vx);
    float ka = 0.f, va = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ka = fmaxf(ka, fabsf(kx[e]));
      va = fmaxf(va, fabsf(vx[e]));
    }
    ka = group_max<32>(ka);
    va = group_max<32>(va);
    const float ksc = __fdiv_rn(fmaxf(ka, 1e-6f), 127.f);
    const float vsc = __fdiv_rn(fmaxf(va, 1e-6f), 127.f);
    uint32_t kq = 0, vq = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kq |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(kx[e], ksc)) << (8 * e);
      vq |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(vx[e], vsc)) << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(s_kq + i * HD + 4 * lane) = kq;
    *reinterpret_cast<uint32_t*>(s_vq + i * HD + 4 * lane) = vq;
    if (lane == 0) {
      s_ks[i] = ksc;
      s_vs[i] = vsc;
    }
  }
}

// Appends the nv new rows of head h of slot s at pos = min(start + i,
// cap) through the slot's table, 16 bytes a store: int8 pools (P = int8_t)
// take the rows and scales quantised in shared memory, bf16 and fp32
// pools k_new / v_new.
template <typename P>
__device__ void append_new_rows(const PagedArgs& a, const int* tab, int s, int h, int st, int nv,
                                const int8_t* s_kq, const int8_t* s_vq, const float* s_ks,
                                const float* s_vs) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int ELT = sizeof(P);
  constexpr int CPR = HD * ELT / 16;   // 16-byte chunks per row
  const int cap = a.width * a.bs - 1;
  const size_t row_elems = (size_t)a.hkv * HD;
  const size_t page_elems = (size_t)a.bs * row_elems;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * page_elems;
  for (int idx = threadIdx.x; idx < nv * CPR; idx += blockDim.x) {
    const int i = idx / CPR, j = idx % CPR;
    const int pos = min(st + i, cap);
    const int blk = tab[pos / a.bs];
    const size_t dst = (layer_off + (size_t)blk * page_elems + (size_t)(pos % a.bs) * row_elems +
                        (size_t)h * HD) * ELT + 16 * j;
    uint8_t* kp = static_cast<uint8_t*>(a.k_pool) + dst;
    uint8_t* vp = static_cast<uint8_t*>(a.v_pool) + dst;
    if constexpr (QUANT) {
      *reinterpret_cast<uint4*>(kp) = *reinterpret_cast<const uint4*>(s_kq + i * HD + 16 * j);
      *reinterpret_cast<uint4*>(vp) = *reinterpret_cast<const uint4*>(s_vq + i * HD + 16 * j);
      if (j == 0) {
        const size_t sc = (((size_t)a.layer * a.n_blocks + blk) * a.hkv + h) * a.bs + pos % a.bs;
        a.k_scale[sc] = s_ks[i];
        a.v_scale[sc] = s_vs[i];
      }
    } else {
      const size_t src = (((size_t)(s * a.t_len + i) * a.hkv + h) * HD) * ELT + 16 * j;
      *reinterpret_cast<uint4*>(kp) =
          *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(a.k_new) + src);
      *reinterpret_cast<uint4*>(vp) =
          *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(a.v_new) + src);
    }
  }
}

// Cols k0 .. k0+63 of head h of slot s into one ring stage: cached cols
// from their page, this call's cols from the new rows, the rest zero.
// int8 (P = int8_t): K [64][HD], V [64][HD] row-major, then k/v scales
// [64] each; bf16: K, V [64][HD] with chunk j of col c at kv16_chunk(c,
// j); fp32: K, V [64][HD] row-major.
// REGW (int8 at T = 1): chunk j of K col c sits at chunk j ^ 4(c & 1), of
// V col c at j ^ 2((c >> 1) & 3), conflict-free for tile_mma_regw's reads;
// else int8 tiles are row-major (widen_tile reads them).
__device__ __forceinline__ int k_chunk(int c, int j) { return j ^ ((c & 1) << 2); }
__device__ __forceinline__ int v_chunk(int c, int j) { return j ^ (((c >> 1) & 3) << 1); }

template <typename P, int MIN_THREADS, bool REGW>
__device__ __forceinline__ void load_tile(const PagedArgs& a, uint8_t* stage, int k0, int s,
                                          int h, int st, int limit, const int* tab,
                                          const int8_t* s_kq, const int8_t* s_vq,
                                          const float* s_ks, const float* s_vs) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int ELT = sizeof(P);
  constexpr int CPR = HD * ELT / 16;          // 16-byte chunks per col
  constexpr int TOTAL = KT * CPR;
  constexpr int MAXIT = TOTAL / MIN_THREADS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t row_elems = (size_t)a.hkv * HD;
  const size_t page_elems = (size_t)a.bs * row_elems;
  const size_t layer_off = (size_t)a.layer * a.n_blocks * page_elems;
  uint8_t* sk = stage;
  uint8_t* sv = stage + KT * HD * ELT;
  const uint8_t* k_pool = static_cast<const uint8_t*>(a.k_pool);
  const uint8_t* v_pool = static_cast<const uint8_t*>(a.v_pool);
  // Every table lookup of the thread first, so they are in flight together.
  int blk[MAXIT];
#pragma unroll
  for (int it = 0; it < MAXIT; ++it) {
    const int idx = tid + it * nth, c = k0 + idx / CPR;
    blk[it] = (idx < TOTAL && c < st) ? __ldg(tab + page_of(a, c)) : 0;
  }
#pragma unroll
  for (int it = 0; it < MAXIT; ++it) {
    const int idx = tid + it * nth;
    if (idx >= TOTAL) break;
    const int col = idx / CPR, j = idx % CPR, c = k0 + col;
    const int kslot = QUANT ? (REGW ? k_chunk(col, j) : j) : ELT == 2 ? kv16_chunk(col, j) : j;
    const int vslot = QUANT ? (REGW ? v_chunk(col, j) : j) : ELT == 2 ? kv16_chunk(col, j) : j;
    uint8_t* dk = sk + (col * CPR + kslot) * 16;
    uint8_t* dv = sv + (col * CPR + vslot) * 16;
    if (c < st) {
      const size_t off = (layer_off + (size_t)blk[it] * page_elems +
                          (size_t)(c - page_of(a, c) * a.bs) * row_elems + (size_t)h * HD) *
                             ELT + 16 * j;
      cp_async16(dk, k_pool + off);
      cp_async16(dv, v_pool + off);
    } else if (c < limit) {
      if constexpr (QUANT) {
        *reinterpret_cast<uint4*>(dk) = *reinterpret_cast<const uint4*>(s_kq + (c - st) * HD + 16 * j);
        *reinterpret_cast<uint4*>(dv) = *reinterpret_cast<const uint4*>(s_vq + (c - st) * HD + 16 * j);
      } else {
        const size_t src = (((size_t)(s * a.t_len + c - st) * a.hkv + h) * HD) * ELT + 16 * j;
        cp_async16(dk, static_cast<const uint8_t*>(a.k_new) + src);
        cp_async16(dv, static_cast<const uint8_t*>(a.v_new) + src);
      }
    } else {
      *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
    }
  }
  if constexpr (QUANT) {
    float* sks = reinterpret_cast<float*>(sv + KT * HD);
    float* svs = sks + KT;
    if (tid < KT) {
      const int c = k0 + tid;
      if (c < st) {
        const int pg = page_of(a, c);
        const size_t sc = (((size_t)a.layer * a.n_blocks + __ldg(tab + pg)) * a.hkv + h) * a.bs +
                          (c - pg * a.bs);
        cp_async4(sks + tid, a.k_scale + sc);
        cp_async4(svs + tid, a.v_scale + sc);
      } else {
        sks[tid] = c < limit ? s_ks[c - st] : 0.f;
        svs[tid] = c < limit ? s_vs[c - st] : 0.f;
      }
    }
  }
}

// An int8 ring stage widened, exactly, into the bf16 tile `wide` (K, then
// V, laid out as a bf16 stage): once per tile, for every row tile.
__device__ __forceinline__ void widen_tile(const uint8_t* stage, uint8_t* wide) {
#pragma unroll
  for (int it = 0; it < 2 * KT * 8 / 128; ++it) {   // a block has >= 128 threads
    const int idx = threadIdx.x + it * blockDim.x;
    if (idx >= 2 * KT * 8) break;
    const int kv = idx / (KT * 8), col = (idx / 8) % KT, j = idx % 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(stage + kv * KT * HD + col * HD + 16 * j);
    uint32_t b[8];
    i8x4_to_bf16(raw.x, b[0], b[1]);
    i8x4_to_bf16(raw.y, b[2], b[3]);
    i8x4_to_bf16(raw.z, b[4], b[5]);
    i8x4_to_bf16(raw.w, b[6], b[7]);
    uint8_t* dst = wide + kv * KT * HD * 2 + col * HD * 2;
    *reinterpret_cast<uint4*>(dst + 16 * kv16_chunk(col, 2 * j)) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(dst + 16 * kv16_chunk(col, 2 * j + 1)) = make_uint4(b[4], b[5], b[6], b[7]);
  }
}

// One warp's rows g and g+8 of its row tile against cols cb .. cb+NC-1 of
// the bf16 tile (sk, sv), NC a multiple of SW, in steps of SW (16 or 32) cols:
// S, the online softmax, O += P.V. ks / vs: the int8 tile's scales. q as
// the A operand: in registers (qa) or, where a block holds more than 8
// warps and registers are scarce (168 a thread), the warp's 16 x 128 tile
// in shared memory (sq, chunk j of row r at j ^ (r & 7)), read by ldmatrix.
template <bool QUANT, int NC, bool QSMEM, int SW>
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* sk, const __nv_bfloat16* sv,
                                         const float* ks, const float* vs, int cb, int k0,
                                         int limit, float scale, const uint32_t (&qa)[8][4],
                                         const __nv_bfloat16* sq,
                                         const int (&row_max)[2], const bool (&row_ok)[2],
                                         float (&o)[16][4], float (&m_run)[2],
                                         float (&l_run)[2]) {
  const int lane = threadIdx.x % 32, t = lane % 4;
#pragma unroll
  for (int sub = 0; sub < NC / SW; ++sub) {
    const int c0 = cb + sub * SW;
    // S: sc[nt][0..1] row g, cols c0+8nt+2t, +1; [2..3] row g+8. ldmatrix
    // x4: lane l addresses col l % 8 of the n-tile at d chunk 4kp + l / 8.
    float sc[SW / 8][4];
#pragma unroll
    for (int nt = 0; nt < SW / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      uint32_t q0[4], q1[4];
      if constexpr (QSMEM) {   // lane l: row l % 16 at d chunk 2ks + l / 16
        const int qr = lane & 15;
        ldmatrix_x4(q0, sq + qr * HD + 8 * ((4 * kp + (lane >> 4)) ^ (qr & 7)));
        ldmatrix_x4(q1, sq + qr * HD + 8 * ((4 * kp + 2 + (lane >> 4)) ^ (qr & 7)));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q0[e] = qa[2 * kp][e];
          q1[e] = qa[2 * kp + 1][e];
        }
      }
#pragma unroll
      for (int nt = 0; nt < SW / 8; ++nt) {
        const int col = c0 + 8 * nt + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4(b, sk + col * HD + 8 * kv16_chunk(col, 4 * kp + (lane >> 3)));
        mma_bf16(sc[nt], q0, b[0], b[1]);
        mma_bf16(sc[nt], q1, b[2], b[3]);
      }
    }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < SW / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int colt = c0 + 8 * nt + 2 * t + e;
          const int c = k0 + colt;
          const bool ok = row_ok[hi] && c < limit && c <= row_max[hi];
          float& v = sc[nt][2 * hi + e];
          v = ok ? v * (QUANT ? scale * ks[colt] : scale) : -INFINITY;
          mx = fmaxf(mx, v);
        }
      mx = group_max<4>(mx);
      const float m_new = fmaxf(m_run[hi], mx);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < SW / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[nt][2 * hi + e];
          const float p = expf(v - safe);   // 0 where masked
          sum += p;                         // l sums p before any v scale
          v = QUANT ? p * vs[c0 + 8 * nt + 2 * t + e] : p;
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
#pragma unroll
    for (int kk = 0; kk < SW / 16; ++kk) {
      // P as the A operand (k = cols 2t, 2t+1 | 2t+8, 2t+9 of the step), hi + lo
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int nt = 2 * kk + r / 2, e0 = 2 * (r % 2);   // a0: row g; a1: row g+8; ...
        const float x0 = sc[nt][e0], x1 = sc[nt][e0 + 1];
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x0, x1);
        const float2 back = __bfloat1622float2(hi2);
        a_hi[r] = *reinterpret_cast<const uint32_t*>(&hi2);
        a_lo[r] = pack_bf16(x0 - back.x, x1 - back.y);
      }
      // V by ldmatrix.trans: lane l addresses col 16kk + l % 8 + 8((l / 8) % 2)
      // at d chunk 2dp + l / 16: b0, b1 of n-tiles 2dp and 2dp+1.
      const int vcol = c0 + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
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
  }
}

// REGW: an int8 tile at T = 1, where the four warps each take 16 distinct
// cols, so each K/V byte is widened once anyway: in registers, straight
// from the int8 ring, with no widened tile and no barrier for it.
//   S = Q.K^T: K as B, widened by i8x4_to_bf16. The sum over d does not
//   care about order, so d is permuted per 64-wide half such that each
//   lane reads 16 contiguous bytes of a K row; q's A fragments (qa[4 half
//   + s4]) follow the same permutation.
//   O += P.V: V's B operand needs a col pair per register, which ldmatrix
//   cannot give for 8-bit data: each lane reads 32-bit words (4 d values)
//   of four cols and pairs their bytes by byte permutes. The output
//   columns are permuted for that: lane g of n-tile 4J+e owns d = 32J + 4g
//   + e, so o[4J+e][0..1] (row g) are d 32J+8t+e and 32J+8t+4+e.
__device__ __forceinline__ void tile_mma_regw(const int8_t* sk, const int8_t* sv,
                                              const float* ks, const float* vs, int cb, int k0,
                                              int limit, float scale, const uint32_t (&qa)[8][4],
                                              const int (&row_max)[2], const bool (&row_ok)[2],
                                              float (&o)[16][4], float (&m_run)[2],
                                              float (&l_run)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float sc[2][4];   // sc[nt][0..1] row g, cols cb+8nt+2t, +1; [2..3] row g+8
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    const int col = cb + 8 * nt + g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint4 kw = *reinterpret_cast<const uint4*>(sk + col * HD + 16 * k_chunk(col, 4 * half + t));
      const uint32_t* kwords = &kw.x;
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        uint32_t b0, b1;
        i8x4_to_bf16(kwords[s4], b0, b1);
        mma_bf16(sc[nt], qa[4 * half + s4], b0, b1);
      }
    }
  }
  float corr[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int colt = cb + 8 * nt + 2 * t + e;
        const int c = k0 + colt;
        const bool ok = row_ok[hi] && c < limit && c <= row_max[hi];
        float& v = sc[nt][2 * hi + e];
        v = ok ? v * (scale * ks[colt]) : -INFINITY;
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
        const float p = expf(v - safe);   // 0 where masked
        sum += p;                         // l sums p before any v scale
        v = p * vs[cb + 8 * nt + 2 * t + e];
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
  uint32_t a_hi[4], a_lo[4];   // P (k = cols 2t, 2t+1 | 2t+8, 2t+9), hi + lo
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int nt = r / 2, e0 = 2 * (r % 2);
    const float x0 = sc[nt][e0], x1 = sc[nt][e0 + 1];
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x0, x1);
    const float2 back = __bfloat1622float2(hi2);
    a_hi[r] = *reinterpret_cast<const uint32_t*>(&hi2);
    a_lo[r] = pack_bf16(x0 - back.x, x1 - back.y);
  }
  // V words: cols 2t, 2t+1, 2t+8, 2t+9 of the warp's 16, word 8J + g (d 32J + 4g ..)
  const int vcols[4] = {cb + 2 * t, cb + 2 * t + 1, cb + 2 * t + 8, cb + 2 * t + 9};
#pragma unroll
  for (int J = 0; J < 4; ++J) {
    uint32_t vw[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = vcols[cc];
      vw[cc] = *reinterpret_cast<const uint32_t*>(sv + col * HD + 16 * v_chunk(col, 2 * J + g / 4) +
                                                  4 * (g % 4));
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

// Row r of item `item` in the workspace (rows padded to an even count per
// item, so every bulk copy below is a whole number of 16 bytes).
__device__ __forceinline__ size_t part_index(const PagedArgs& a, int item, int r) {
  return (size_t)item * ((((a.hq / a.hkv) * a.t_len) + 1) & ~1) + r;
}

// The last block of a (slot, kv-head) to arrive merges its chunks' partials
// (items first .. first + chunks - 1) in chunk order. Batches of rows that
// fit `buf` (the block's free shared memory) come in by bulk asynchronous
// copies, every chunk's O rows and (m, l) at once on one mbarrier, so a
// batch costs one round trip and no registers; then one thread per output
// quad (four d) of a row weighs the chunks in order.
template <typename OutT>
__device__ void merge_chunks(const PagedArgs& a, uint8_t* buf, int buf_bytes, int s, int h,
                             int first, int chunks) {
  constexpr int QD = HD / 4;
  __shared__ __align__(8) uint64_t s_bar;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int rows = (a.hq / a.hkv) * a.t_len;
  const int batch = max(2, (buf_bytes / (chunks * (HD + 2) * (int)sizeof(float))) & ~1);
  if (tid == 0) {
    mbar_init(&s_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  uint32_t phase = 0;
  for (int r0 = 0; r0 < rows; r0 += batch) {
    const int rb = min(batch, rows - r0), rb2 = (rb + 1) & ~1;   // rows copied: even
    float* s_o = reinterpret_cast<float*>(buf);            // [chunks][rb2][HD]
    float* s_ml = s_o + (size_t)chunks * rb2 * HD;         // [chunks][rb2][2]
    if (tid == 0) {
      // the other blocks' partials (acquired at the arrival) and this
      // block's earlier use of buf, ordered before the async copies
      asm volatile("fence.proxy.async;\n" ::: "memory");
      mbar_expect_tx(&s_bar, (uint32_t)(chunks * rb2 * (HD + 2) * sizeof(float)));
      for (int c = 0; c < chunks; ++c) {
        const size_t p = part_index(a, first + c, r0);
        bulk_load(s_o + (size_t)c * rb2 * HD, a.part_acc + p * HD, rb2 * HD * sizeof(float), &s_bar);
        bulk_load(s_ml + (size_t)c * rb2 * 2, a.part_ml + p * 2, rb2 * 2 * sizeof(float), &s_bar);
      }
    }
    mbar_wait(&s_bar, phase);
    phase ^= 1;
    for (int idx = tid; idx < rb * QD; idx += nth) {
      const int r = idx / QD, q = idx % QD;
      float mm = -INFINITY;
      for (int c = 0; c < chunks; ++c) mm = fmaxf(mm, s_ml[(c * rb2 + r) * 2]);
      float ll = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (mm != -INFINITY) {
        for (int c = 0; c < chunks; ++c) {   // in chunk order: deterministic
          const float mi = s_ml[(c * rb2 + r) * 2];
          if (mi == -INFINITY) continue;
          const float wt = expf(mi - mm);
          ll += s_ml[(c * rb2 + r) * 2 + 1] * wt;
          const float4 v = *reinterpret_cast<const float4*>(s_o + (size_t)(c * rb2 + r) * HD + 4 * q);
          acc.x += v.x * wt;
          acc.y += v.y * wt;
          acc.z += v.z * wt;
          acc.w += v.w * wt;
        }
      }
      const float den = fmaxf(ll, 1e-30f);
      OutT* dst = out_row_ptr<OutT>(a, s, h, r0 + r) + 4 * q;
      if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
      } else {
        __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
        d2[0] = __floats2bfloat162_rn(acc.x / den, acc.y / den);
        d2[1] = __floats2bfloat162_rn(acc.z / den, acc.w / den);
      }
    }
    __syncthreads();   // buf is refilled by the next batch
  }
}

// The end of a chunk's item of a pair of `chunks` chunks: its partials
// are released at GPU scope before the pair's counter moves; the last
// block to arrive acquires every chunk's, merges them (merge_chunks, in
// `buf`) and resets the counter for the next launch.
template <typename OutT>
__device__ void arrive_and_merge(const PagedArgs& a, uint8_t* buf, int buf_bytes,
                                 const WorkList& w, int s, int h, int chunks) {
  __shared__ int s_last;
  __syncthreads();
  const int pair = s * a.hkv + h;
  if (threadIdx.x == 0) {
    fence_acq_rel_gpu();
    s_last = atomicAdd(a.counters + pair, 1) == chunks - 1;
    if (s_last) fence_acq_rel_gpu();
  }
  __syncthreads();
  if (!s_last) return;
  merge_chunks<OutT>(a, buf, buf_bytes, s, h, w.base[s] + h * chunks, chunks);
  if (threadIdx.x == 0) a.counters[pair] = 0;   // ready for the next launch
}

// One work item: every query row of (slot s, kv-head h) against the cols
// of chunk `chunk`.
template <bool QUANT, int C, bool QREG>
__device__ void run_item(const PagedArgs& a, uint8_t* smem, const WorkList& w, int item,
                         int s) {
  constexpr int NC = KT / C;   // cols of a tile per warp
  constexpr int STAGE = QUANT ? KV8_STAGE : KV16_STAGE;
  constexpr int MIN_THREADS = C == 4 ? 128 : 32 * MIN_WARPS;
  constexpr bool REGW = QUANT && C == 4;   // int8 widened in registers (tile_mma_regw)
  using P = Pool16<QUANT>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int chunks = w.chunks[s];
  const int local = item - w.base[s];
  const int h = local / chunks, chunk = local % chunks;
  const int st = w.start[s], nv = w.n_valid[s], limit = st + nv;
  const int c_begin = chunk * w.len[s] * KT;
  const int c_end = min(limit, c_begin + w.len[s] * KT);
  const int n_tiles = (c_end - c_begin + KT - 1) / KT;
  const int t_len = a.t_len, group = a.hq / a.hkv, rows = group * t_len;
  const int row_tiles = (rows + RT - 1) / RT;
  const int* tab = a.tables + (size_t)s * a.width;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);

  uint8_t* ring = smem;
  uint8_t* wide = smem + MMA_STAGES * STAGE;                          // int8, C = 1 only
  __nv_bfloat16* s_q =
      reinterpret_cast<__nv_bfloat16*>(wide + (QUANT && !REGW ? KV16_STAGE : 0));
  int8_t* s_kq = reinterpret_cast<int8_t*>(s_q + (QREG ? 0 : warps * RT * HD));   // int8 only
  int8_t* s_vq = s_kq + t_len * HD;
  float* s_ks = reinterpret_cast<float*>(s_vq + t_len * HD);
  float* s_vs = s_ks + t_len;

  __syncthreads();   // the block's previous item is done with shared memory
  if (QUANT && c_end > st) {
    quantize_rows_warp<__nv_bfloat16>(a, s, h, nv, s_kq, s_vq, s_ks, s_vs);
    __syncthreads();
  }
  if (chunk == chunks - 1)   // the pair's last chunk appends the new rows
    append_new_rows<P>(a, tab, s, h, st, nv, s_kq, s_vq, s_ks, s_vs);

  const int per_pass = warps / C;
  for (int rt0 = 0; rt0 < row_tiles; rt0 += per_pass) {
    const int rt = rt0 + warp / C, cg = warp % C;
    // Q as the A operand of k-step ks (d 16ks .. 16ks+15): rows g (lo) and
    // g+8 (hi) at d 16ks+2t, +1 (a0, a1) and 16ks+8+2t, +1 (a2, a3); or
    // (!QREG) the warp's 16 rows into its tile of shared memory.
    uint32_t qa[8][4];
    __nv_bfloat16* sq = QREG ? nullptr : s_q + warp * RT * HD;
    int row_max[2];
    bool row_ok[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = rt * RT + g + 8 * hi;
      const int tok = r % t_len;
      row_ok[hi] = rt < row_tiles && r < rows && tok < nv;
      row_max[hi] = st + tok;
      if constexpr (REGW) {   // qa[4 half + s4]: the lane's 16 d at 64 half + 16t
        const __nv_bfloat16* qrow =
            q + ((size_t)(s * t_len + tok) * a.hq + h * group + r / t_len) * HD;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 v[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
          if (row_ok[hi]) {
            v[0] = __ldg(reinterpret_cast<const uint4*>(qrow + 64 * half + 16 * t));
            v[1] = __ldg(reinterpret_cast<const uint4*>(qrow + 64 * half + 16 * t + 8));
          }
          const uint32_t* qw = reinterpret_cast<const uint32_t*>(v);
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4) {
            qa[4 * half + s4][hi] = qw[2 * s4];
            qa[4 * half + s4][2 + hi] = qw[2 * s4 + 1];
          }
        }
      } else if constexpr (QREG) {
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(
            q + ((size_t)(s * t_len + tok) * a.hq + h * group + r / t_len) * HD);
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          qa[ks][hi] = row_ok[hi] ? __ldg(qw + 8 * ks + t) : 0u;
          qa[ks][2 + hi] = row_ok[hi] ? __ldg(qw + 8 * ks + 4 + t) : 0u;
        }
      }
    }
    if constexpr (!QREG) {   // lane: chunks lane / 16 + 2k of row lane % 16
      const int qr = lane & 15, r = rt * RT + qr, tok = r % t_len;
      const bool ok = rt < row_tiles && r < rows && tok < nv;
      const uint4* src = reinterpret_cast<const uint4*>(
          q + ((size_t)(s * t_len + tok) * a.hq + h * group + r / t_len) * HD);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = (lane >> 4) + 2 * k;
        *reinterpret_cast<uint4*>(sq + qr * HD + 8 * (j ^ (qr & 7))) =
            ok ? __ldg(src + j) : make_uint4(0, 0, 0, 0);
      }
      __syncwarp();
    }
    float o[16][4];   // O n-tile n: [0..1] row g, d 8n+2t, +1; [2..3] row g+8
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

#pragma unroll
    for (int i = 0; i < MMA_STAGES - 1; ++i) {
      if (i < n_tiles)
        load_tile<P, MIN_THREADS, REGW>(a, ring + i * STAGE, c_begin + i * KT, s, h, st, limit, tab, s_kq, s_vq,
                         s_ks, s_vs);
      cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<MMA_STAGES - 2>();
      __syncthreads();   // tile i landed for all; stage (i - 1) % STAGES is free
      const int nxt = i + MMA_STAGES - 1;
      if (nxt < n_tiles)
        load_tile<P, MIN_THREADS, REGW>(a, ring + (nxt % MMA_STAGES) * STAGE, c_begin + nxt * KT, s, h, st,
                         limit, tab, s_kq, s_vq, s_ks, s_vs);
      cp_async_commit();
      const uint8_t* stage = ring + (i % MMA_STAGES) * STAGE;
      const uint8_t* tile = stage;
      const float* ks = nullptr;
      const float* vs = nullptr;
      if constexpr (REGW) {
        ks = reinterpret_cast<const float*>(stage + 2 * KT * HD);
        tile_mma_regw(reinterpret_cast<const int8_t*>(stage),
                      reinterpret_cast<const int8_t*>(stage) + KT * HD, ks, ks + KT, cg * NC,
                      c_begin + i * KT, limit, a.scale, qa, row_max, row_ok, o, m_run, l_run);
        continue;
      } else if constexpr (QUANT) {
        widen_tile(stage, wide);
        ks = reinterpret_cast<const float*>(stage + 2 * KT * HD);
        vs = ks + KT;
        tile = wide;
        __syncthreads();   // the widened tile is complete
      }
      if (rt < row_tiles)
        tile_mma<QUANT, NC, !QREG, (QREG && NC >= 32) ? 32 : 16>(reinterpret_cast<const __nv_bfloat16*>(tile),
                            reinterpret_cast<const __nv_bfloat16*>(tile) + KT * HD, ks, vs,
                            cg * NC, c_begin + i * KT, limit, a.scale, qa, sq, row_max, row_ok,
                            o, m_run, l_run);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the merge below

    if constexpr (C == 1) {
      // The warp's rows straight out: final rows of a one-chunk pair, else
      // this chunk's partials.
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = rt * RT + g + 8 * hi;
        if (rt >= row_tiles || r >= rows) continue;
        if (chunks == 1) {
          const float den = fmaxf(l_run[hi], 1e-30f);
          __nv_bfloat16* dst = out_row_ptr<__nv_bfloat16>(a, s, h, r);
#pragma unroll
          for (int n = 0; n < 16; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * t) =
                __floats2bfloat162_rn(o[n][2 * hi] / den, o[n][2 * hi + 1] / den);
        } else {
          const size_t p = part_index(a, item, r);
#pragma unroll
          for (int n = 0; n < 16; ++n)
            *reinterpret_cast<float2*>(a.part_acc + p * HD + 8 * n + 2 * t) =
                make_float2(o[n][2 * hi], o[n][2 * hi + 1]);
          if (t == 0) {
            a.part_ml[2 * p] = m_run[hi];
            a.part_ml[2 * p + 1] = l_run[hi];
          }
        }
      }
    } else {
      // The four warps hold the same 16 rows over different cols: their
      // (m, l, O) through shared memory, merged in warp order, one thread
      // per d.
      static_assert(C == 4, "col groups: 1 or 4");
      float* s_o = reinterpret_cast<float*>(smem);   // [warp][RT][HD]
      float* s_ml = s_o + 4 * RT * HD;               // [warp][RT][2]
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = g + 8 * hi;
        if constexpr (REGW) {   // o[4J+e][2hi] is d 32J+8t+e, [2hi+1] d 32J+8t+4+e
#pragma unroll
          for (int J = 0; J < 4; ++J) {
            float* dst = s_o + (warp * RT + r) * HD + 32 * J + 8 * t;
            *reinterpret_cast<float4*>(dst) = make_float4(
                o[4 * J][2 * hi], o[4 * J + 1][2 * hi], o[4 * J + 2][2 * hi], o[4 * J + 3][2 * hi]);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(o[4 * J][2 * hi + 1], o[4 * J + 1][2 * hi + 1],
                            o[4 * J + 2][2 * hi + 1], o[4 * J + 3][2 * hi + 1]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < 16; ++n)
            *reinterpret_cast<float2*>(s_o + (warp * RT + r) * HD + 8 * n + 2 * t) =
                make_float2(o[n][2 * hi], o[n][2 * hi + 1]);
        }
        if (t == 0) {
          s_ml[(warp * RT + r) * 2] = m_run[hi];
          s_ml[(warp * RT + r) * 2 + 1] = l_run[hi];
        }
      }
      __syncthreads();
      for (int r = 0; r < RT; ++r) {
        const int r_glob = rt0 * RT + r;
        if (r_glob >= rows) break;
        float mm = -INFINITY;
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) mm = fmaxf(mm, s_ml[(w4 * RT + r) * 2]);
        float ll = 0.f, acc = 0.f;
        if (mm != -INFINITY) {
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) {
            const float mw = s_ml[(w4 * RT + r) * 2];
            if (mw == -INFINITY) continue;
            const float f = expf(mw - mm);
            ll += s_ml[(w4 * RT + r) * 2 + 1] * f;
            acc += s_o[(w4 * RT + r) * HD + tid] * f;
          }
        }
        if (chunks == 1) {
          out_row_ptr<__nv_bfloat16>(a, s, h, r_glob)[tid] =
              __float2bfloat16(acc / fmaxf(ll, 1e-30f));
        } else {
          const size_t p = part_index(a, item, r_glob);
          a.part_acc[p * HD + tid] = acc;
          if (tid == 0) {
            a.part_ml[2 * p] = mm;
            a.part_ml[2 * p + 1] = ll;
          }
        }
      }
      __syncthreads();   // s_o is read before the next pass's ring fills it
    }
  }
  if (chunks == 1) return;
  arrive_and_merge<__nv_bfloat16>(a, smem, (int)merge_bytes(QUANT, C), w, s, h, chunks);
}

// MAXW: the most warps a launch may have (4 when C == 4); the SM's four
// schedulers each hold ceil(MAXW / 4) warps, which bounds the registers.
template <bool QUANT, int C, int MAXW>
__global__ void __launch_bounds__(32 * MAXW, 1)
paged_mma_kernel(const PagedArgs a) {
  extern __shared__ __align__(128) uint8_t smem_mma[];
  int* list = reinterpret_cast<int*>(
      smem_mma + work_list_offset(mma_smem_bytes(QUANT, C == 1, a.t_len,
                                                 MAXW <= FULL_WARPS ? 0 : a.warps)));
  const WorkList w{list, list + a.slots + 1, list + 2 * a.slots + 1, list + 3 * a.slots + 1,
                   list + 4 * a.slots + 1};
  build_work_list(a, w);
  const int total = w.base[a.slots];
  for (int item = blockIdx.x; item < total; item += gridDim.x)
    run_item<QUANT, C, MAXW <= FULL_WARPS>(a, smem_mma, w, item, slot_of(w, a.slots, item));
  zero_dead_slots<__nv_bfloat16>(a, w);   // last: no fence of an item waits for these stores
}

// ---- the fp32 body (fp32 q, D = 128): live work only, FMAs ---------------
//
// paged_f32_kernel<P, RPL>: fp32 q over fp32 pools (P = float) or int8
// pools (P = int8_t), the reference runs' decode attention. Replaces an
// earlier fp32 body with the faults the earlier tensor-core bodies had:
// a grid of (slot, kv-head, row tile of 16 x context split of 256
// cols) sized from the shapes, so that at a decode step nearly every
// block belonged to a dead slot or to a split past the context and exited
// at once; a row tile of its own per block, so every K/V tile was read once
// per row tile; synchronous loads into registers and then shared memory;
// and a second kernel that merged the splits one row a block, through
// device memory.
//
// Bound: bytes at T = 1 (fp32 pools: 2 x 512 bytes per cached token and
// kv-head; int8: 2 x 128 + 8), and at few live slots the same chain of
// dependent round trips as the tensor-core bodies; operations at T = 17
// (~70 flops per byte, FMAs at 67 TFLOP/s).
//
// Design, the tensor-core bodies' where it can be:
// - The same persistent grid of live work (build_work_list, one wave of
//   blocks), the same chunk merge in the launch (arrive_and_merge,
//   merge_chunks: the fp32 partials rows merged in chunk order, so two
//   calls are bit-equal) and the same pass over the dead slots. 256 threads
//   (8 warps), one block an SM.
// - One block serves every query row of its item. A warp takes a row tile
//   of 8 RPL rows (RPL = 1 where G*T <= 8, the decode step; 2 else); lane
//   (r8 = lane / 4, dq = lane % 4) holds rows r8 + 8e (e < RPL) with q
//   (times the softmax scale) at d 16j + 4dq .. +3 (j < 8) in registers and
//   O at the same d. A pass gives each of its n <= 8 row tiles 8 / n warps
//   (rounded down to a power of 2), which split each 64-col tile's cols and
//   run online softmaxes of their own, merged in warp order through shared
//   memory at the pass's end; more than 8 row tiles take more passes.
// - K/V tiles stream through a 3-stage cp.async ring once a pass (load_tile,
//   its table lookups in flight together); an int8 tile is widened to fp32
//   once, in shared memory, by the whole block.
// - For each col, a lane reads its quarter of the K row as 8 float4s (the
//   four dq lanes 64 contiguous bytes, conflict-free; the eight row lanes
//   the same bytes), 32 FMAs a row; two shuffles sum the quarters, so every
//   lane holds its rows' scores, times k_scale[col] over int8 pools, masked
//   per row's token. The online softmax runs in steps of 8 cols, p summed
//   into l before it is multiplied by v_scale[col]; P.V reads V as K is
//   read. Shared memory hands an SM 128 bytes a clock, shared or not, so at
//   2 bytes a lane per FMA (RPL = 2) a verify round runs at half the FMA
//   rate at most.
// - The pair's last chunk appends the new rows (int8: quantised in shared
//   memory by quantize_rows_warp); every chunk reads the new cols from
//   k_new / v_new (int8: those quantised rows), never from the pool rows
//   being written.
constexpr int F32_WARPS = 8;
constexpr int KV32_STAGE = 2 * KT * HD * (int)sizeof(float);   // fp32 K, V
constexpr int WIDE32_BYTES = KV32_STAGE;                       // an int8 tile widened

// Dynamic shared memory of an fp32 launch before the work list: the ring;
// over int8 pools the widened tile and the new rows quantised.
__host__ __device__ constexpr size_t f32_smem_bytes(bool quant, int t_len) {
  return (size_t)MMA_STAGES * (quant ? KV8_STAGE : KV32_STAGE) +
         (quant ? WIDE32_BYTES + (size_t)t_len * (2 * HD + 2 * sizeof(float)) : 0);
}
// The merges' buffer: the ring and, over int8 pools, the widened tile.
__host__ __device__ constexpr size_t f32_merge_bytes(bool quant) {
  return (size_t)MMA_STAGES * (quant ? KV8_STAGE : KV32_STAGE) + (quant ? WIDE32_BYTES : 0);
}
static_assert((size_t)F32_WARPS * 16 * (HD + 2) * sizeof(float) <= f32_merge_bytes(true),
              "the col groups' merge fits the buffer");

// An int8 ring stage's K and V ([64][HD] each) widened, exactly, to fp32.
__device__ __forceinline__ void widen_tile_f32(const uint8_t* stage, float* wide) {
  for (int idx = threadIdx.x; idx < 2 * KT * HD / 16; idx += blockDim.x) {
    float f[16];
    unpack16(*reinterpret_cast<const uint4*>(stage + 16 * idx), f, int8_t());
    float4* dst = reinterpret_cast<float4*>(wide + 16 * idx);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
  }
}

// One warp's rows against cols cb .. cb + nc - 1 of the fp32 tile (kt,
// vt), 8 cols a step: S, the mask, the online softmax, O += P.V. ks / vs:
// the int8 tile's scales.
template <bool QUANT, int RPL>
__device__ __forceinline__ void tile_f32(const float* kt, const float* vt, const float* ks,
                                         const float* vs, int cb, int nc, int k0, int limit,
                                         const float (&qr)[RPL][32], const int (&row_max)[RPL],
                                         const bool (&row_ok)[RPL], float (&o)[RPL][32],
                                         float (&m_run)[RPL], float (&l_run)[RPL]) {
  const int dq = threadIdx.x % 4;
  for (int c0 = cb; c0 < cb + nc; c0 += 8) {
    float sc[RPL][8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float* krow = kt + (c0 + c) * HD + 4 * dq;
      float acc[RPL];
#pragma unroll
      for (int e = 0; e < RPL; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + 16 * j);
#pragma unroll
        for (int e = 0; e < RPL; ++e) {
          acc[e] = fmaf(qr[e][4 * j], k4.x, acc[e]);
          acc[e] = fmaf(qr[e][4 * j + 1], k4.y, acc[e]);
          acc[e] = fmaf(qr[e][4 * j + 2], k4.z, acc[e]);
          acc[e] = fmaf(qr[e][4 * j + 3], k4.w, acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < RPL; ++e) sc[e][c] = acc[e];
    }
#pragma unroll
    for (int e = 0; e < RPL; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {   // the four d quarters' sums
        float x = sc[e][c];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const int col = k0 + c0 + c;
        const bool ok = row_ok[e] && col < limit && col <= row_max[e];
        sc[e][c] = ok ? (QUANT ? x * ks[c0 + c] : x) : -INFINITY;
        mx = fmaxf(mx, sc[e][c]);
      }
      const float m_new = fmaxf(m_run[e], mx);
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = (m_run[e] == -INFINITY) ? 0.f : expf(m_run[e] - safe);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(sc[e][c] - safe);   // 0 where masked
        sum += p;                                 // l sums p before any v scale
        sc[e][c] = QUANT ? p * vs[c0 + c] : p;
      }
      l_run[e] = corr * l_run[e] + sum;
      m_run[e] = m_new;
#pragma unroll
      for (int d = 0; d < 32; ++d) o[e][d] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float* vrow = vt + (c0 + c) * HD + 4 * dq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + 16 * j);
#pragma unroll
        for (int e = 0; e < RPL; ++e) {
          o[e][4 * j] = fmaf(sc[e][c], v4.x, o[e][4 * j]);
          o[e][4 * j + 1] = fmaf(sc[e][c], v4.y, o[e][4 * j + 1]);
          o[e][4 * j + 2] = fmaf(sc[e][c], v4.z, o[e][4 * j + 2]);
          o[e][4 * j + 3] = fmaf(sc[e][c], v4.w, o[e][4 * j + 3]);
        }
      }
    }
  }
}

// One work item of the fp32 body: every query row of (slot s, kv-head h)
// against the cols of chunk `chunk`.
template <typename P, int RPL>
__device__ void run_item_f32(const PagedArgs& a, uint8_t* smem, const WorkList& w, int item,
                             int s) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  constexpr int STAGE = QUANT ? KV8_STAGE : KV32_STAGE;
  constexpr int TR = 8 * RPL;   // rows of a warp's row tile
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r8 = lane / 4, dq = lane % 4;
  const int chunks = w.chunks[s];
  const int local = item - w.base[s];
  const int h = local / chunks, chunk = local % chunks;
  const int st = w.start[s], nv = w.n_valid[s], limit = st + nv;
  const int c_begin = chunk * w.len[s] * KT;
  const int c_end = min(limit, c_begin + w.len[s] * KT);
  const int n_tiles = (c_end - c_begin + KT - 1) / KT;
  const int t_len = a.t_len, group = a.hq / a.hkv, rows = group * t_len;
  const int row_tiles = (rows + TR - 1) / TR;
  const int* tab = a.tables + (size_t)s * a.width;
  const float* q = static_cast<const float*>(a.q);

  uint8_t* ring = smem;
  float* wide = reinterpret_cast<float*>(smem + MMA_STAGES * STAGE);   // int8 pools only
  int8_t* s_kq = reinterpret_cast<int8_t*>(smem + MMA_STAGES * STAGE + (QUANT ? WIDE32_BYTES : 0));
  int8_t* s_vq = s_kq + t_len * HD;
  float* s_ks = reinterpret_cast<float*>(s_vq + t_len * HD);
  float* s_vs = s_ks + t_len;

  __syncthreads();   // the block's previous item is done with shared memory
  if (QUANT && c_end > st) {
    quantize_rows_warp<float>(a, s, h, nv, s_kq, s_vq, s_ks, s_vs);
    __syncthreads();
  }
  if (chunk == chunks - 1)   // the pair's last chunk appends the new rows
    append_new_rows<P>(a, tab, s, h, st, nv, s_kq, s_vq, s_ks, s_vs);

  for (int rt0 = 0; rt0 < row_tiles; rt0 += F32_WARPS) {
    const int n_rt = min(F32_WARPS, row_tiles - rt0);
    const int groups = n_rt == 1 ? 8 : n_rt == 2 ? 4 : n_rt <= 4 ? 2 : 1;   // warps a row tile
    const bool active = warp / groups < n_rt;
    const int rt = rt0 + warp / groups, nc = KT / groups;
    float qr[RPL][32], o[RPL][32], m_run[RPL], l_run[RPL];
    int row_max[RPL];
    bool row_ok[RPL];
#pragma unroll
    for (int e = 0; e < RPL; ++e) {
      const int r = rt * TR + r8 + 8 * e, tok = r % t_len;
      row_ok[e] = active && r < rows && tok < nv;
      row_max[e] = st + tok;
      const float* qrow =
          q + ((size_t)(s * t_len + tok) * a.hq + h * group + r / t_len) * HD + 4 * dq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = row_ok[e] ? __ldg(reinterpret_cast<const float4*>(qrow + 16 * j))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[e][4 * j] = x.x * a.scale;
        qr[e][4 * j + 1] = x.y * a.scale;
        qr[e][4 * j + 2] = x.z * a.scale;
        qr[e][4 * j + 3] = x.w * a.scale;
      }
#pragma unroll
      for (int d = 0; d < 32; ++d) o[e][d] = 0.f;
      m_run[e] = -INFINITY;
      l_run[e] = 0.f;
    }

#pragma unroll
    for (int i = 0; i < MMA_STAGES - 1; ++i) {
      if (i < n_tiles)
        load_tile<P, 32 * F32_WARPS, false>(a, ring + i * STAGE, c_begin + i * KT, s, h, st,
                                            limit, tab, s_kq, s_vq, s_ks, s_vs);
      cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<MMA_STAGES - 2>();
      __syncthreads();   // tile i landed for all; stage (i - 1) % STAGES is free
      const int nxt = i + MMA_STAGES - 1;
      if (nxt < n_tiles)
        load_tile<P, 32 * F32_WARPS, false>(a, ring + (nxt % MMA_STAGES) * STAGE,
                                            c_begin + nxt * KT, s, h, st, limit, tab, s_kq,
                                            s_vq, s_ks, s_vs);
      cp_async_commit();
      const uint8_t* stage = ring + (i % MMA_STAGES) * STAGE;
      const float* kt = reinterpret_cast<const float*>(stage);
      const float* ks = nullptr;
      const float* vs = nullptr;
      if constexpr (QUANT) {
        widen_tile_f32(stage, wide);
        ks = reinterpret_cast<const float*>(stage + 2 * KT * HD);
        vs = ks + KT;
        kt = wide;
        __syncthreads();   // the widened tile is complete
      }
      if (active)
        tile_f32<QUANT, RPL>(kt, kt + KT * HD, ks, vs, (warp % groups) * nc, nc,
                             c_begin + i * KT, limit, qr, row_max, row_ok, o, m_run, l_run);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the merges below

    if (groups == 1) {
      // The warp's rows straight out: final rows of a one-chunk pair, else
      // this chunk's partials.
#pragma unroll
      for (int e = 0; e < RPL; ++e) {
        const int r = rt * TR + r8 + 8 * e;
        if (!active || r >= rows) continue;
        if (chunks == 1) {
          const float den = fmaxf(l_run[e], 1e-30f);
          float* dst = out_row_ptr<float>(a, s, h, r) + 4 * dq;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float4*>(dst + 16 * j) =
                make_float4(o[e][4 * j] / den, o[e][4 * j + 1] / den, o[e][4 * j + 2] / den,
                            o[e][4 * j + 3] / den);
        } else {
          const size_t p = part_index(a, item, r);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float4*>(a.part_acc + p * HD + 16 * j + 4 * dq) =
                make_float4(o[e][4 * j], o[e][4 * j + 1], o[e][4 * j + 2], o[e][4 * j + 3]);
          if (dq == 0) {
            a.part_ml[2 * p] = m_run[e];
            a.part_ml[2 * p + 1] = l_run[e];
          }
        }
      }
    } else {
      // The warps of a row tile hold its rows over different cols: their
      // (m, l, O) through shared memory, merged in warp order, one thread
      // per quad of d of a row.
      float* s_o = reinterpret_cast<float*>(smem);        // [warp][TR][HD]
      float* s_ml = s_o + F32_WARPS * TR * HD;            // [warp][TR][2]
      if (active) {
#pragma unroll
        for (int e = 0; e < RPL; ++e) {
          const int rr = r8 + 8 * e;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float4*>(s_o + (warp * TR + rr) * HD + 16 * j + 4 * dq) =
                make_float4(o[e][4 * j], o[e][4 * j + 1], o[e][4 * j + 2], o[e][4 * j + 3]);
          if (dq == 0) {
            s_ml[(warp * TR + rr) * 2] = m_run[e];
            s_ml[(warp * TR + rr) * 2 + 1] = l_run[e];
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < n_rt * TR * (HD / 4); idx += blockDim.x) {
        const int rl = idx / (HD / 4), qd = idx % (HD / 4);
        const int t = rl / TR, rr = rl % TR, r = (rt0 + t) * TR + rr;
        if (r >= rows) continue;
        float mm = -INFINITY;
        for (int g = 0; g < groups; ++g) mm = fmaxf(mm, s_ml[((t * groups + g) * TR + rr) * 2]);
        float ll = 0.f;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (mm != -INFINITY) {
          for (int g = 0; g < groups; ++g) {   // in warp order: deterministic
            const int wr = (t * groups + g) * TR + rr;
            const float mw = s_ml[wr * 2];
            if (mw == -INFINITY) continue;
            const float f = expf(mw - mm);
            ll += s_ml[wr * 2 + 1] * f;
            const float4 x = *reinterpret_cast<const float4*>(s_o + wr * HD + 4 * qd);
            acc.x += x.x * f;
            acc.y += x.y * f;
            acc.z += x.z * f;
            acc.w += x.w * f;
          }
        }
        if (chunks == 1) {
          const float den = fmaxf(ll, 1e-30f);
          *reinterpret_cast<float4*>(out_row_ptr<float>(a, s, h, r) + 4 * qd) =
              make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
        } else {
          const size_t p = part_index(a, item, r);
          *reinterpret_cast<float4*>(a.part_acc + p * HD + 4 * qd) = acc;
          if (qd == 0) {
            a.part_ml[2 * p] = mm;
            a.part_ml[2 * p + 1] = ll;
          }
        }
      }
      __syncthreads();   // s_o is read before the next pass's ring fills it
    }
  }
  if (chunks == 1) return;
  arrive_and_merge<float>(a, smem, (int)f32_merge_bytes(QUANT), w, s, h, chunks);
}

template <typename P, int RPL>
__global__ void __launch_bounds__(32 * F32_WARPS, 1)
paged_f32_kernel(const PagedArgs a) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  extern __shared__ __align__(128) uint8_t smem_f32[];
  int* list = reinterpret_cast<int*>(smem_f32 + work_list_offset(f32_smem_bytes(QUANT, a.t_len)));
  const WorkList w{list, list + a.slots + 1, list + 2 * a.slots + 1, list + 3 * a.slots + 1,
                   list + 4 * a.slots + 1};
  build_work_list(a, w);
  const int total = w.base[a.slots];
  for (int item = blockIdx.x; item < total; item += gridDim.x)
    run_item_f32<P, RPL>(a, smem_f32, w, item, slot_of(w, a.slots, item));
  zero_dead_slots<float>(a, w);   // last: no fence of an item waits for these stores
}

// Opts the kernel into `bytes` of dynamic shared memory where no earlier
// launch on this device needed as much (the work list grows with the
// slots, the quantised rows with T): `allowed` is the launcher's own.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

template <bool QUANT, int C, int MAXW>
cudaError_t launch_mma(const PagedArgs& a, cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  constexpr bool QREG = MAXW <= FULL_WARPS;   // q in registers, else in shared memory
  constexpr bool WIDE = C == 1;               // int8 widened in shared memory
  if ((size_t)a.max_chunks * 2 * MERGE_ROW_BYTES > merge_bytes(QUANT, C))
    return cudaErrorInvalidValue;
  const size_t smem =
      work_list_offset(mma_smem_bytes(QUANT, WIDE, a.t_len, QREG ? 0 : a.warps)) +
      work_list_bytes(a.slots);
  cudaError_t err = allow_smem(paged_mma_kernel<QUANT, C, MAXW>, smem, allowed);
  if (err != cudaSuccess) return err;
  paged_mma_kernel<QUANT, C, MAXW><<<a.blocks, 32 * a.warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t dispatch_mma(const PagedArgs& a, cudaStream_t stream) {
  if (a.col_groups == 4) return launch_mma<QUANT, 4, 4>(a, stream);
  if (a.warps <= FULL_WARPS) return launch_mma<QUANT, 1, FULL_WARPS>(a, stream);
  return launch_mma<QUANT, 1, MAX_WARPS>(a, stream);
}

template <typename P, int RPL>
cudaError_t launch_f32(const PagedArgs& a, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<P, int8_t>::value;
  static size_t allowed[kMaxDevices] = {};
  if ((size_t)a.max_chunks * 2 * MERGE_ROW_BYTES > f32_merge_bytes(QUANT))
    return cudaErrorInvalidValue;
  const size_t smem = work_list_offset(f32_smem_bytes(QUANT, a.t_len)) + work_list_bytes(a.slots);
  cudaError_t err = allow_smem(paged_f32_kernel<P, RPL>, smem, allowed);
  if (err != cudaSuccess) return err;
  paged_f32_kernel<P, RPL><<<a.blocks, 32 * F32_WARPS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename P>
cudaError_t dispatch_f32(const PagedArgs& a, cudaStream_t stream) {
  if ((a.hq / a.hkv) * a.t_len <= 8) return launch_f32<P, 1>(a, stream);
  return launch_f32<P, 2>(a, stream);
}

// bf16 q: the tensor-core bodies (int8 or bf16 pools); fp32 q: the fp32
// body over int8 or fp32 pools.
cudaError_t dispatch(int dtype, int d, bool quant, const PagedArgs& a, cudaStream_t stream) {
  if (d != HD) return cudaErrorInvalidValue;  // the text models' width
  if (dtype == kBFloat16)
    return quant ? dispatch_mma<true>(a, stream) : dispatch_mma<false>(a, stream);
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  return quant ? dispatch_f32<int8_t>(a, stream) : dispatch_f32<float>(a, stream);
}

}  // namespace

// One call's arguments in one record, as the Python wrapper packs them
// (struct format "=15Q15ifi"): one ctypes argument to convert instead of
// 32. k_scale / v_scale non-null: the pools are int8 and T <= 64. Every
// body is one launch of `blocks` blocks of `warps` warps, chunks of at
// least min_chunk_tiles 64-col tiles and at most max_chunks a (slot,
// kv-head) (max_chunks * 2 * (D + 2) floats fit the body's merge buffer);
// part_acc / part_ml of max_items*G*T*D and *2 fp32 (max_items >= blocks
// + S*Hkv), `counters`: S*Hkv int32 that are 0 (it leaves them 0). bf16
// q (dtype 1) takes a tensor-core body (over int8 or bf16 pools):
// col_groups 4 (warps == 4) or 1 (8 <= warps <= 12); fp32 q (dtype 0)
// the fp32 body (over int8 or fp32 pools): 8 warps.
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
  int slots, t_len, hq, hkv, d, width, bs, n_blocks, layer;
  int blocks, warps, col_groups, min_chunk_tiles, max_items, max_chunks;
  float scale;
  int dtype;
};

// Returns cudaGetLastError() after the launches (0 = launched).
HOCR_EXPORT int hocr_paged_append_attention(const PagedCall* call) {
  const PagedCall& c = *call;
  if (c.slots == 0 || c.t_len == 0) return 0;
  const bool quant = c.k_scale != nullptr;
  if (quant != (c.v_scale != nullptr) || (quant && c.t_len > MAX_NEW_INT8))
    return cudaErrorInvalidValue;
  const bool shape_ok =
      c.dtype != kBFloat16 ? c.warps == F32_WARPS
      : c.col_groups == 4  ? c.warps == 4
                           : c.col_groups == 1 && c.warps >= MIN_WARPS && c.warps <= MAX_WARPS;
  if (!shape_ok || c.blocks < 1 || c.min_chunk_tiles < 1 || c.max_chunks < 1 ||
      c.max_items < c.blocks + c.slots * c.hkv || c.counters == nullptr)
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
  a.blocks = c.blocks;
  a.warps = c.warps;
  a.col_groups = c.col_groups;
  a.min_chunk_tiles = c.min_chunk_tiles;
  a.max_chunks = c.max_chunks;
  a.bs_log2 = -1;
  for (int k = 0; k < 31; ++k)
    if (c.bs == (1 << k)) a.bs_log2 = k;
  a.scale = c.scale;
  return dispatch(c.dtype, c.d, quant, a, static_cast<cudaStream_t>(c.stream));
}
