// Flash attention (GQA, optional causal, per-key mask) for Hopper.
//
// Replaces the Pallas kernel handwritten_ocr_tpu/ops/flash_attention.py:
// _flash_kernel. The TPU grid walks (batch*head, q block, k block) with the
// k axis sequential and carries m / l / acc in VMEM scratch across it; here
// a work item is one (batch*q-head, q tile), whose k tiles a block walks in
// an in-block loop, so nothing carries between blocks.
//
// Layout: q [B, T, Hq, D], k/v [B, S, Hkv, D], mask [M, S] uint8 (M = 1 or
// B, optional; the bf16 body takes it padded to a multiple of 128 keys),
// out [B, T, Hq, D]; q-head h reads kv-head h / (Hq / Hkv).
// Math: scores in fp32 from the input dtype, scaled after the dot; masked
// keys (col >= S, mask 0, or col > row when causal) get -inf; online softmax
// with the TPU kernel's guards (m == -inf rows contribute 0, denominator
// max(l, 1e-30)), so an all-masked row gives exactly 0. P is rounded to the
// value dtype before the P.V product, as the TPU kernel does; accumulation
// is fp32.
//
// What bounds it: operations. At the paths' shapes (vision [8, 3456, 16,
// 80] with a key mask, causal prefill [8, 1024-1280, 28/4 or 64/8, 128]) it
// does 4.T.S.D flops per head against a few bytes per flop, so only the
// tensor cores at their wgmma rate can approach the bound.
//
// Two bodies, one function:
// - bf16 (the model's dtype): warp-specialised wgmma + TMA, persistent.
//   One block of 384 threads per SM walks work items of 128 q rows.
//   Warpgroup 0 is the producer (setmaxnreg 24): one thread loads each
//   item's Q and streams its 128-key K/V tiles (with the tile's 128 mask
//   bytes, by a bulk copy) into a 3-stage shared-memory ring with TMA, each
//   stage completing on a `full` mbarrier; it runs ahead into the next
//   item, so the next Q and K/V tiles load while the consumers finish.
//   Warpgroups 1-2 are the consumers (setmaxnreg 240), 64 q rows each:
//   S = Q.K^T by wgmma m64n128k16 with Q and K from shared memory (K-major,
//   128-byte swizzle), then the softmax, then O += P.V. The two
//   warpgroups run unsynchronised, so one's products overlap the other's
//   softmax; neither turn-taking barriers between them nor issuing the next
//   tile's Q.K^T ahead of this tile's softmax (a second schedule, with Q
//   double-buffered and K and V in rings of their own) ran faster on the
//   H100, so the simpler schedule stays. The softmax runs in registers in
//   the exp2 domain (scale.log2e folded into one FMA), with the row max
//   and row sum over four partial values each, and masks elementwise only
//   the tiles that need it (a key mask, the ragged last tile, the causal
//   diagonal): the tile's 128 mask bytes come into shared memory with it
//   and become four warp ballots, then one 32-bit word per thread with a
//   bit per column it holds, so a masked element costs a bit test. P
//   rounded to bf16 in place becomes the register A operand of O += P.V
//   (wgmma rs), V read MN-major from shared memory with the transpose bit;
//   one arrive per warp on the stage's `empty` mbarrier hands the stage
//   back, and the last tile of an item hands Q back (`q_empty`). Causal key
//   tiles above the diagonal are never loaded, and causal items are taken
//   heaviest first across all heads, so every SM gets an even share and
//   the long rows do not finish last. Head width 80: Q/K rows are 160
//   bytes, more than one 128-byte swizzle row, so they load as two 64-wide
//   boxes (the second zero-filled past column 80) and Q.K^T runs only the
//   5 k-steps that hold data; V loads as five 16-wide boxes with 32-byte
//   swizzle, so P.V runs at N = 80 over whole swizzle atoms and does no
//   padded work. TMA zero-fills rows past T and S; the stores of rows past
//   T are skipped.
// - fp32 (the reference runs' dtype): FMAs, bound by the FMA pipe (67
//   TFLOP/s) and, one step before it, by shared memory, which hands an SM
//   128 bytes a clock whether or not lanes share an address: a thread must
//   read at most 1 byte per FMA to let the FMA pipe set the pace.
//   Persistent like the bf16 body: one block of 256 threads per SM walks
//   work items of 128 q rows, causal items heaviest first and in a snake
//   over the rounds (a block with a heavy item takes a light one next),
//   their tiles aligned to the last row so the ragged tile is the first
//   rows', which see the fewest keys. A thread owns rows ty + 16i (i < 8; ty =
//   2 warp + lane / 16) and keys tx + 16j (tx = lane % 16) of each key
//   tile's scores, and the same 8 rows x D/16 columns of O (4tx .. 4tx+3
//   and 64 + 4tx .. 64 + 4tx+3; at D = 80, 64 + tx). At D = 80 a key tile
//   is 128 keys, j < 8 (8 x 8 scores: 8 q and 8 k float4s a 4-d step for
//   256 FMAs, 1 byte an FMA), in a 2-stage ring; at D = 128 the shared
//   memory holds 64 keys, j < 4 (8 x 4: 1.5 bytes an FMA), in 3 stages. Q
//   sits in shared memory for the whole item and K and V stream through
//   a cp.async ring in stages of their own (K0, V0, K1, V1, ...: one
//   barrier a stage, the next stages in flight during the math; a K stage
//   carries the tile's mask bytes). Layout: Q, K and V row-major with rows
//   of D + 4 floats, read as float4 along d (lanes of one ty read the same
//   q address; the 16 tx lanes read 16 consecutive K rows, which the
//   4-float pad spreads over distinct 16-byte bank groups, eight rows at
//   a time). P goes through a buffer of the warp's own ([keys][16 rows +
//   4 pad], the 16 rows of its two ty, so no block barrier), read back as
//   two float4s per key beside V's float4s, consecutive across tx. The
//   softmax runs in registers in the exp2 domain, scale.log2e folded into
//   one FMA, row max over the 16 lanes of a ty by shuffles, the row sum
//   per thread until the end.
#include "hopper.cuh"

namespace {

// ---- bf16 body: wgmma + TMA, warp-specialised ----------------------------
constexpr int WQ = 128;        // q rows per block: two consumer warpgroups
constexpr int WK = 128;        // keys per tile
constexpr int STAGES = 3;      // K/V ring depth
constexpr int WTHREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int CONSUMER_WARPS = 8;
static_assert(WQ == WK, "Q and K boxes share one offset per k-step");

template <int D> struct Tiles {
  static constexpr int NQB = (D + 63) / 64;        // 64-wide Q/K boxes
  static constexpr int KSTEPS = D / 16;            // Q.K^T k-steps with data
  static constexpr int VA = D % 64 == 0 ? 64 : 16; // V swizzle atom width
  static constexpr int NVB = (D + VA - 1) / VA;    // V boxes
  static constexpr uint32_t Q_BYTES = NQB * WQ * 128;
  static constexpr uint32_t K_BYTES = NQB * WK * 128;
  static constexpr uint32_t V_BYTES = NVB * WK * VA * 2;
  static constexpr uint32_t OFF_K = Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * K_BYTES;
  static constexpr uint32_t OFF_MASK = OFF_V + STAGES * V_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_MASK + STAGES * WK;
  // + slack to align the base to the 1024-byte swizzle atom
  static constexpr size_t SMEM = OFF_BAR + 8 * (2 + 2 * STAGES) + 1024;
  static_assert(V_BYTES % 1024 == 0, "V stages must keep 1024-byte alignment");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

// Per-block state of a consumer warpgroup.
struct Consumer {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_empty;
  const unsigned char* sq;  // this warpgroup's 64 Q rows
  int lane, t, row0, wg_row, s_len, causal, has_mask;
  float scale_log2;
};

// One work item: a 128-row q tile of one (batch, q-head), and the key
// tiles it needs (causal: none above the diagonal). Item order: without
// causal every item has the same work, and the q tiles of one head come
// together so that their K/V reads meet in L2; causal items come heaviest
// first across all heads (the last q tile of every head, then the one
// before, ...), so the round-robin over blocks hands each SM an even share
// and the long rows do not finish last.
struct Work {
  int b, h, hk, q0, n_tiles;
  __device__ __forceinline__ Work(int w, int n_qt, int n_bh, int hq, int hkv,
                                  int s_len, int causal) {
    const int bh = causal ? w % n_bh : w / n_qt;
    const int qt = causal ? w / n_bh : w % n_qt;
    b = bh / hq;
    h = bh % hq;
    hk = h / (hq / hkv);
    q0 = (n_qt - 1 - qt) * WQ;
    const int k_end = causal ? min(s_len, q0 + WQ) : s_len;
    n_tiles = (k_end + WK - 1) / WK;
  }
};

// 2^x by the MUFU unit (denormal results flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Key tile `it` of the work item, in ring slot gi. `last` hands Q back to
// the producer, which then loads the next item's Q during this tile.
template <int D>
__device__ __forceinline__ void consume_tile(const Consumer& c, int it, int gi,
                                             bool last,
                                             float (&o)[D / 2], float (&m)[2],
                                             float (&l)[2]) {
  using L = Tiles<D>;
  const int st = gi % STAGES;
  const int k0 = it * WK;
  mbar_wait(&c.full[st], (gi / STAGES) & 1);

  // S = Q.K^T: k-step ks reads 32 bytes into box ks / 4 of each row.
  const unsigned char* sk = c.smem + L::OFF_K + st * L::K_BYTES;
  float s[WK / 2];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < L::KSTEPS; ++ks) {
    const int off = (ks / 4) * (WQ * 128) + (ks % 4) * 32;
    wgmma_ss_n128(s, smem_desc(c.sq + off, 16, 1024, kSwizzle128B),
                  smem_desc(sk + off, 16, 1024, kSwizzle128B), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  if (last) {
    __syncwarp();
    if (c.lane == 0) mbar_arrive(c.q_empty);
  }

  float corr[2];
  const bool edge = k0 + WK > c.s_len || (c.causal && k0 + WK - 1 > c.wg_row);
  if (c.has_mask || edge) {
    // keep bit 2j + e: col 8j + 2t + e of the tile (this thread's cols).
    uint32_t keep = ~0u;
    if (c.has_mask) {
      // The tile's 128 mask bytes as four ballots: ballot k holds col
      // 4i + k at bit i, so col 8j + 2t + e sits in ballot 2(t & 1) + e at
      // bit 2j + t / 2.
      const uint32_t word = reinterpret_cast<const uint32_t*>(
          c.smem + L::OFF_MASK + st * WK)[c.lane];
      uint32_t bits[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bits[k] = __ballot_sync(0xffffffffu, (word >> (8 * k)) & 0xffu);
      const uint32_t x0 = bits[2 * (c.t & 1)] >> (c.t / 2);
      const uint32_t x1 = bits[2 * (c.t & 1) + 1] >> (c.t / 2);
      keep = (x0 & 0x55555555u) | ((x1 & 0x55555555u) << 1);
    }
    if (edge) {
      // Last valid col of each of this thread's rows, relative to 2t.
      int last_col[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lim = c.causal ? min(c.s_len - 1, c.row0 + 8 * r) : c.s_len - 1;
        last_col[r] = lim - k0 - 2 * c.t;
      }
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(keep & (1u << (2 * j + (e & 1)))) || 8 * j + (e & 1) > last_col[e >> 1])
            s[4 * j + e] = -INFINITY;
    } else {
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(keep & (1u << (2 * j + (e & 1))))) s[4 * j + e] = -INFINITY;
    }
  }

  // Row max and row sum over four partial values each (short chains).
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[r][k] = -INFINITY;
#pragma unroll
  for (int i = 0; i < WK / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float row_max = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    const float m_new = fmaxf(m[r], group_max<4>(row_max) * c.scale_log2);
    safe[r] = (m_new == -INFINITY) ? 0.f : m_new;
    corr[r] = (m[r] == -INFINITY) ? 0.f : fast_exp2(m[r] - safe[r]);
    m[r] = m_new;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < WK / 2; ++i) {
    s[i] = fast_exp2(fmaf(s[i], c.scale_log2, -safe[(i >> 1) & 1]));
    sum[(i >> 1) & 1][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = corr[r] * l[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * r] *= corr[r];
      o[4 * j + 2 * r + 1] *= corr[r];
    }

  // P as the A operand of P.V: k-step kk takes score tiles 2kk, 2kk+1.
  uint32_t pa[WK / 16][4];
#pragma unroll
  for (int j = 0; j < WK / 8; ++j) {
    pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }

  // O += P.V: V MN-major, swizzle atoms VA wide, 8-row groups along keys.
  const unsigned char* sv = c.smem + L::OFF_V + st * L::V_BYTES;
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WK / 16; ++kk)
    WgmmaRS<D>::run(o, pa[kk],
                    smem_desc(sv + kk * 16 * L::VA * 2, WK * L::VA * 2,
                              8 * L::VA * 2,
                              L::VA == 64 ? kSwizzle128B : kSwizzle32B));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);
  __syncwarp();
  if (c.lane == 0) mbar_arrive(&c.empty[st]);
}

// Persistent: one block per SM walks the work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ... (in the order of Work), so the producer
// loads the next item's Q and first K/V tiles while the consumers finish
// the current one.
template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const uint8_t* __restrict__ mask, int mask_stride,
                   __nv_bfloat16* __restrict__ out, int t_len, int s_len,
                   int hq, int hkv, int n_work, int mask_rows, int causal,
                   float scale_log2) {
  using L = Tiles<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + STAGES;
  const int n_qt = (t_len + WQ - 1) / WQ;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load -------------------------
    regs_dec<24>();
    if (threadIdx.x == 0) {
      int gi = 0;  // ring slot of the next K/V tile, across work items
      int local = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++local) {
        const Work wk(w, n_qt, n_work / n_qt, hq, hkv, s_len, causal);
        if (local > 0) mbar_wait(q_empty, (local - 1) & 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int i = 0; i < L::NQB; ++i)
          tma_load_4d(smem + i * WQ * 128, &map_q, q_full, i * 64, wk.h, wk.q0, wk.b);
        const uint8_t* mrow =
            mask ? mask + (size_t)(mask_rows == 1 ? 0 : wk.b) * mask_stride : nullptr;
        for (int it = 0; it < wk.n_tiles; ++it, ++gi) {
          const int st = gi % STAGES;
          const int k0 = it * WK;
          if (gi >= STAGES) mbar_wait(&empty[st], ((gi / STAGES) - 1) & 1);
          mbar_expect_tx(&full[st], L::K_BYTES + L::V_BYTES + (mrow ? WK : 0));
          unsigned char* sk = smem + L::OFF_K + st * L::K_BYTES;
          for (int i = 0; i < L::NQB; ++i)
            tma_load_4d(sk + i * WK * 128, &map_k, &full[st], i * 64, wk.hk, k0, wk.b);
          unsigned char* sv = smem + L::OFF_V + st * L::V_BYTES;
          for (int i = 0; i < L::NVB; ++i)
            tma_load_4d(sv + i * WK * L::VA * 2, &map_v, &full[st], i * L::VA,
                        wk.hk, k0, wk.b);
          if (mrow) bulk_load(smem + L::OFF_MASK + st * WK, mrow + k0, WK, &full[st]);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ------------------------------
    regs_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    Consumer c;
    c.smem = smem;
    c.full = full;
    c.empty = empty;
    c.q_empty = q_empty;
    c.sq = smem + cw * 64 * 128;
    c.lane = lane;
    c.t = lane % 4;
    c.s_len = s_len;
    c.causal = causal;
    c.has_mask = mask != nullptr;
    c.scale_log2 = scale_log2;

    int gi = 0;
    int local = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++local) {
      const Work wk(w, n_qt, n_work / n_qt, hq, hkv, s_len, causal);
      c.wg_row = wk.q0 + cw * 64;
      c.row0 = c.wg_row + warp * 16 + lane / 4;  // rows row0 and row0 + 8
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      mbar_wait(q_full, local & 1);
      const int n = wk.n_tiles;
      for (int it = 0; it < n; ++it)
        consume_tile<D>(c, it, gi + it, it + 1 == n, o, m, l);
      if (n == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }
      gi += n;

      const int t = c.t;
      __nv_bfloat16* ob = out + (size_t)wk.b * t_len * hq * D + (size_t)wk.h * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float denom = fmaxf(group_sum<4>(l[r]), 1e-30f);
        const int row = c.row0 + r * 8;
        if (row >= t_len) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * hq * D + j * 8 + 2 * t) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                    o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

// ---- fp32 body: register-tiled FMAs, persistent ---------------------------
constexpr int FQ = 128;        // q rows per work item
constexpr int F_THREADS = 256;
constexpr int F_PW = 16 + 4;   // a warp's P rows: its 16 q rows and a pad

// BK keys a K / V tile: 64 at D = 128 (a thread's score block 8 x 4, 3
// ring stages), 128 at D = 80 (8 x 8, 2 stages), as the shared memory
// allows.
template <int D> struct F32Tiles {
  static constexpr int BK = D == 80 ? 128 : 64;
  static constexpr int NJ = BK / 16;                    // a thread's keys
  static constexpr int STAGES = D == 80 ? 2 : 3;        // each a K or a V tile
  static constexpr int LD = D + 4;                      // floats a Q / K / V row
  static constexpr int CH = D / 4;                      // 16-byte chunks a row
  static constexpr int NOB = D == 128 ? 4 : 1;          // O cols past 64
  static constexpr int Q_BYTES = FQ * LD * 4;
  static constexpr int STAGE_BYTES = BK * LD * 4 + BK;  // a tile; K's mask bytes
  static constexpr int P_BYTES = (F_THREADS / 32) * BK * F_PW * 4;
  static constexpr size_t SMEM = (size_t)Q_BYTES + STAGES * STAGE_BYTES + P_BYTES;
  static_assert(D == 80 || D == 128, "head widths 80 and 128");
  static_assert(STAGE_BYTES % 16 == 0, "stages keep 16-byte alignment");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

// One fp32 work item: rows q0 .. q0 + 127 of (batch, q-head), of which
// those in 0 .. T-1 are real, and the key tiles they need. Causal items
// come heaviest first across all heads, and their tiles are aligned to
// the last row, so the ragged tile is the first rows', which see the
// fewest keys, not the last rows', which see them all.
struct F32Work {
  int b, h, hk, q0, n_tiles;
  __device__ __forceinline__ F32Work(int w, int n_qt, int n_bh, int hq, int hkv,
                                     int t_len, int s_len, int causal, int bk) {
    const int bh = causal ? w % n_bh : w / n_qt;
    const int qt = causal ? w / n_bh : w % n_qt;
    b = bh / hq;
    h = bh % hq;
    hk = h / (hq / hkv);
    q0 = causal ? t_len - (qt + 1) * FQ : qt * FQ;
    const int k_end = causal ? min(s_len, q0 + FQ) : s_len;
    n_tiles = (k_end + bk - 1) / bk;
  }
};

// Persistent: block b takes items in a snake over the rounds (b, then 2G
// - 1 - b, then 2G + b, ...; G blocks), so a block that took one of the
// heaviest causal items takes one of the lightest next.
template <int D>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 int mask_stride, float* __restrict__ out, int t_len, int s_len,
                 int hq, int hkv, int n_work, int mask_rows, int causal,
                 float scale_log2) {
  using L = F32Tiles<D>;
  constexpr int LD = L::LD, CH = L::CH, NOB = L::NOB, BK = L::BK, NJ = L::NJ;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* sq = reinterpret_cast<float*>(smem_f32);
  unsigned char* ring = smem_f32 + L::Q_BYTES;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % 16, tyl = lane / 16, ty = 2 * warp + tyl;
  float* sp = reinterpret_cast<float*>(ring + STAGES * L::STAGE_BYTES) + warp * BK * F_PW;
  const int n_qt = (t_len + FQ - 1) / FQ;
  const size_t q_row = (size_t)hq * D, kv_row = (size_t)hkv * D;

  for (int round = 0;; ++round) {
    const int w = round * gridDim.x +
                  ((round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (w >= n_work) break;
    const F32Work wk(w, n_qt, n_work / n_qt, hq, hkv, t_len, s_len, causal, BK);
    const float* qb = q + (size_t)wk.b * t_len * q_row + (size_t)wk.h * D;
    const float* kb = k + (size_t)wk.b * s_len * kv_row + (size_t)wk.hk * D;
    const float* vb = v + (size_t)wk.b * s_len * kv_row + (size_t)wk.hk * D;
    const uint8_t* mb =
        mask ? mask + (size_t)(mask_rows == 1 ? 0 : wk.b) * mask_stride : nullptr;
    const int n_loads = 2 * wk.n_tiles;   // K0, V0, K1, V1, ...
    // Load j (K of tile j / 2 if j is even, else its V) into its stage;
    // rows past S arrive as zeros.
    auto load = [&](int j) {
      unsigned char* st = ring + (j % STAGES) * L::STAGE_BYTES;
      float* dst = reinterpret_cast<float*>(st);
      const int k0 = (j / 2) * BK;
      const float* src = (j & 1) ? vb : kb;
      for (int i = tid; i < BK * CH; i += F_THREADS) {
        const int r = i / CH, c = i % CH;
        const bool ok = k0 + r < s_len;
        cp_async16_zfill(dst + r * LD + 4 * c,
                         src + (ok ? (size_t)(k0 + r) * kv_row + 4 * c : 0), ok);
      }
      if (!(j & 1) && mb != nullptr && tid < BK / 16)
        cp_async16(st + BK * LD * 4 + 16 * tid, mb + k0 + 16 * tid);
    };

    __syncthreads();   // the block's previous item is done with Q and the ring
    for (int i = tid; i < FQ * CH; i += F_THREADS) {   // Q, rows outside 0 .. T-1 as zeros
      const int r = i / CH, c = i % CH;
      const bool ok = wk.q0 + r >= 0 && wk.q0 + r < t_len;
      cp_async16_zfill(sq + r * LD + 4 * c,
                       qb + (ok ? (size_t)(wk.q0 + r) * q_row + 4 * c : 0), ok);
    }
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {   // group 0 holds Q too
      if (j < n_loads) load(j);
      cp_async_commit();
    }

    float o[8][4 + NOB], m[8], l[8], s[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4 + NOB; ++c) o[i][c] = 0.f;
    }

    for (int j = 0; j < n_loads; ++j) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // load j landed for all; the stage of load j - 1 is free
      if (j + STAGES - 1 < n_loads) load(j + STAGES - 1);
      cp_async_commit();
      const unsigned char* st = ring + (j % STAGES) * L::STAGE_BYTES;
      const float* kv = reinterpret_cast<const float*>(st);
      const int k0 = (j / 2) * BK;
      if (!(j & 1)) {
        // S = Q.K^T: rows ty + 16i, keys tx + 16jj, 4 d a step.
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) s[i][jj] = 0.f;
#pragma unroll(NJ == 4 ? 2 : 1)
        for (int d = 0; d < D; d += 4) {
          float4 a[8], b[NJ];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * LD + d);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            b[jj] = *reinterpret_cast<const float4*>(kv + (tx + 16 * jj) * LD + d);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
              s[i][jj] = fmaf(a[i].x, b[jj].x, s[i][jj]);
              s[i][jj] = fmaf(a[i].y, b[jj].y, s[i][jj]);
              s[i][jj] = fmaf(a[i].z, b[jj].z, s[i][jj]);
              s[i][jj] = fmaf(a[i].w, b[jj].w, s[i][jj]);
            }
        }
        // Masked keys (col >= S, mask 0, col > row when causal) at -inf;
        // only a key mask, the ragged last tile and the diagonal need it.
        const bool edge = k0 + BK > s_len || (causal && k0 + BK - 1 > wk.q0);
        if (mb != nullptr || edge) {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const int col = k0 + tx + 16 * jj;
            const bool key_ok = col < s_len && (mb == nullptr || st[BK * LD * 4 + tx + 16 * jj] != 0);
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (!key_ok || (causal && col > wk.q0 + ty + 16 * i)) s[i][jj] = -INFINITY;
          }
        }
        // Online softmax in the exp2 domain; P into the warp's buffer.
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float mx = s[i][0];
#pragma unroll
          for (int jj = 1; jj < NJ; ++jj) mx = fmaxf(mx, s[i][jj]);
          const float m_new = fmaxf(m[i], group_max<16>(mx) * scale_log2);
          const float safe = (m_new == -INFINITY) ? 0.f : m_new;
          const float corr = (m[i] == -INFINITY) ? 0.f : fast_exp2(m[i] - safe);
          m[i] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            s[i][jj] = fast_exp2(fmaf(s[i][jj], scale_log2, -safe));   // 0 where masked
            sum += s[i][jj];
          }
          l[i] = corr * l[i] + sum;
#pragma unroll
          for (int c = 0; c < 4 + NOB; ++c) o[i][c] *= corr;
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          float* dst = sp + (tx + 16 * jj) * F_PW + 8 * tyl;
          *reinterpret_cast<float4*>(dst) = make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][jj], s[5][jj], s[6][jj], s[7][jj]);
        }
      } else {
        // O += P.V over the tile's keys (P written by this warp at load
        // j - 1, behind this stage's barrier).
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          const float4 p0 = *reinterpret_cast<const float4*>(sp + kk * F_PW + 8 * tyl);
          const float4 p1 = *reinterpret_cast<const float4*>(sp + kk * F_PW + 8 * tyl + 4);
          const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          const float4 va = *reinterpret_cast<const float4*>(kv + kk * LD + 4 * tx);
          float vb4[NOB];
          if constexpr (NOB == 4) {
            const float4 x = *reinterpret_cast<const float4*>(kv + kk * LD + 64 + 4 * tx);
            vb4[0] = x.x; vb4[1] = x.y; vb4[2] = x.z; vb4[3] = x.w;
          } else {
            vb4[0] = kv[kk * LD + 64 + tx];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[i][0] = fmaf(p[i], va.x, o[i][0]);
            o[i][1] = fmaf(p[i], va.y, o[i][1]);
            o[i][2] = fmaf(p[i], va.z, o[i][2]);
            o[i][3] = fmaf(p[i], va.w, o[i][3]);
#pragma unroll
            for (int e = 0; e < NOB; ++e) o[i][4 + e] = fmaf(p[i], vb4[e], o[i][4 + e]);
          }
        }
      }
    }

    float* ob = out + (size_t)wk.b * t_len * q_row + (size_t)wk.h * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float den = fmaxf(group_sum<16>(l[i]), 1e-30f);
      const int row = wk.q0 + ty + 16 * i;
      if (row < 0 || row >= t_len) continue;
      float* dst = ob + (size_t)row * q_row;
      *reinterpret_cast<float4*>(dst + 4 * tx) =
          make_float4(o[i][0] / den, o[i][1] / den, o[i][2] / den, o[i][3] / den);
      if constexpr (NOB == 4)
        *reinterpret_cast<float4*>(dst + 64 + 4 * tx) =
            make_float4(o[i][4] / den, o[i][5] / den, o[i][6] / den, o[i][7] / den);
      else
        dst[64 + tx] = o[i][4] / den;
    }
  }
}

// The device's SM count, looked up once per device.
cudaError_t sm_count(int& sms) {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  sms = dev < kMaxDevices ? counts[dev] : 0;
  if (sms != 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) counts[dev] = sms;
  return err;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const uint8_t* mask, int mask_stride, void* out, int b,
                        int t_len, int s_len, int hq, int hkv, int mask_rows,
                        int causal, float scale, cudaStream_t stream) {
  using L = Tiles<D>;
  if (mask != nullptr && mask_stride % WK != 0) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_map_4d(&map_q, q, D, hq, t_len, b, 64, WQ,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map_4d(&map_k, k, D, hkv, s_len, b, 64, WK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_map_4d(&map_v, v, D, hkv, s_len, b, L::VA, WK,
                      L::VA == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != cudaSuccess) return err;
  static bool configured[kMaxDevices] = {};
  err = set_smem_once(flash_wgmma_kernel<D>, L::SMEM, configured);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const int n_work = (t_len + WQ - 1) / WQ * b * hq;
  flash_wgmma_kernel<D><<<min(n_work, sms), WTHREADS, L::SMEM, stream>>>(
      map_q, map_k, map_v, mask, mask_stride,
      static_cast<__nv_bfloat16*>(out), t_len, s_len, hq, hkv, n_work,
      mask_rows, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const uint8_t* mask, int mask_stride, void* out, int b,
                        int t_len, int s_len, int hq, int hkv, int mask_rows,
                        int causal, float scale, cudaStream_t stream) {
  using L = F32Tiles<D>;
  if (mask != nullptr && (mask_stride % L::BK != 0 || mask_stride < s_len))
    return cudaErrorInvalidValue;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem_once(flash_f32_kernel<D>, L::SMEM, configured);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const int n_work = (t_len + FQ - 1) / FQ * b * hq;
  flash_f32_kernel<D><<<min(n_work, sms), F_THREADS, L::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, mask_stride, static_cast<float*>(out),
      t_len, s_len, hq, hkv, n_work, mask_rows, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `mask_stride`
// is the row stride of the mask in bytes, S rounded up to a multiple of
// 128.
HOCR_EXPORT int hocr_flash_attention(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     int mask_stride, void* out, int b,
                                     int t_len, int s_len, int hq, int hkv,
                                     int d, int mask_rows, int causal,
                                     float scale, int dtype, void* stream) {
  if (t_len == 0 || b == 0) return 0;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && d == 80)
    return launch_bf16<80>(q, k, v, m, mask_stride, out, b, t_len, s_len, hq,
                           hkv, mask_rows, causal, scale, st);
  if (dtype == kBFloat16 && d == 128)
    return launch_bf16<128>(q, k, v, m, mask_stride, out, b, t_len, s_len, hq,
                            hkv, mask_rows, causal, scale, st);
  if (dtype == kFloat32 && d == 80)
    return launch_fp32<80>(q, k, v, m, mask_stride, out, b, t_len, s_len, hq,
                           hkv, mask_rows, causal, scale, st);
  if (dtype == kFloat32 && d == 128)
    return launch_fp32<128>(q, k, v, m, mask_stride, out, b, t_len, s_len, hq,
                            hkv, mask_rows, causal, scale, st);
  return cudaErrorInvalidValue;
}
