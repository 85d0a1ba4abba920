"""Host-side launch plans of the int8 matmul and the paged kernel, and the
kernels' workspace: pure Python, no card.

The plans are what the wrappers cache per shape (splits, tiles, grid,
workspace sizes); the kernels trust them, so a plan that left a k tile or
a context col uncovered, or a split empty, would compute a wrong result on
the card without any error. Every body of the paged kernel derives its
work list on the card from start / n_valid (``build_work_list`` in
``csrc/paged_decode_attention.cu``); ``work_items`` below is the same rule
in Python, held here against every live pattern.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.models.qwen25vl.config import TextConfig
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
from handwritten_ocr_tpu_torch.ops import build
from handwritten_ocr_tpu_torch.ops import int8_matmul as int8_mod
from handwritten_ocr_tpu_torch.ops import paged_decode_attention as paged_mod

H100_SMS = 132


def decode_products(cfg, vocab):
    """(name, d_in, d_out) of every decode-shaped product of a text model."""
    d, hd = cfg.hidden_size, getattr(cfg, "head_dim", None) or (
        cfg.hidden_size // cfg.num_attention_heads)
    return [("q", d, cfg.num_attention_heads * hd),
            ("k", d, cfg.num_key_value_heads * hd),
            ("o", cfg.num_attention_heads * hd, d),
            ("gate", d, cfg.intermediate_size),
            ("down", cfg.intermediate_size, d),
            ("lm_head", d, vocab)]


QWEN3 = Qwen3Config()
TEXT_7B = TextConfig()
PRODUCTS = ([("qwen3:32b", *p) for p in decode_products(QWEN3, QWEN3.vocab_size)]
            + [("7b", *p) for p in decode_products(TEXT_7B, TEXT_7B.vocab_size)])


@pytest.mark.parametrize("m", [1, 8, 24, 32])
@pytest.mark.parametrize("model,name,d_in,d_out", PRODUCTS)
def test_int8_plan_covers_k_and_fills_the_card(model, name, d_in, d_out, m):
    p = int8_mod.plan(m, d_out, d_in, H100_SMS)
    # the splits cover K exactly once, none is empty, each a whole number
    # of 64-wide pieces when K is split
    check_int8_splits(p, d_in)
    assert p.split == 1 or p.k_per_split % 64 == 0
    assert p.block_channels in (64, 128)
    blocks = -(-d_out // p.block_channels)
    assert p.grid == (blocks, p.split)
    assert blocks * p.split >= H100_SMS
    if p.split > 1:
        assert p.partial == blocks * p.split * m * p.block_channels
        assert p.counters == blocks
    else:
        assert p.partial == p.counters == 0


def check_int8_splits(p, d_in):
    """The splits cover K exactly once and none is empty."""
    ranges = [(y * p.k_per_split, min(d_in, (y + 1) * p.k_per_split))
              for y in range(p.split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == d_in
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_int8_plan_fp32_x_takes_one_split():
    # where 128-channel blocks already spread evenly over the SMs (the
    # lm_head), the fp32-x body does not split K
    p = int8_mod.plan(24, 151936, 5120, H100_SMS, bf16=False)
    assert p.split == 1 and p.k_per_split == 5120 and p.partial == 0
    assert p.block_channels == 128 and p.grid == (1187, 1)


@pytest.mark.parametrize("m", [1, 8, 24, 32])
@pytest.mark.parametrize("model,name,d_in,d_out", PRODUCTS)
def test_int8_plan_fp32_x_splits_cover_k(model, name, d_in, d_out, m):
    """The fp32-x body: blocks of 128 channels, splits of K that cover it
    in 64-wide pieces of at least 1024 (or all of K), the workspace of
    the split merge, and no split that leaves its busiest SM more work."""
    p = int8_mod.plan(m, d_out, d_in, H100_SMS, bf16=False)
    check_int8_splits(p, d_in)
    blocks = -(-d_out // 128)
    assert p.block_channels == 128 and p.grid == (blocks, p.split)
    if p.split > 1:
        assert p.k_per_split % 64 == 0 and p.k_per_split >= 1024
        assert p.partial == blocks * p.split * m * 128
        assert p.counters == blocks
        busiest = -(-blocks * p.split // H100_SMS) * p.k_per_split
        assert busiest <= -(-blocks // H100_SMS) * d_in
    else:
        assert p.partial == p.counters == 0


class Item(NamedTuple):
    """A work item of a paged launch: cols ``begin`` .. ``end`` - 1
    of (``slot``, ``head``), chunk ``chunk`` of the pair's ``chunks``."""
    slot: int
    head: int
    chunk: int
    chunks: int
    begin: int
    end: int


def work_items(p, start, n_valid, hkv: int) -> list[Item]:
    """The work list of a paged launch of plan ``p``, as every block
    of the kernel derives it from ``start`` and ``n_valid`` (the rule of
    :func:`paged_mod.plan`'s docstring). Items go by slot, then kv-head,
    then chunk; block b takes items b, b + blocks, ..."""
    tiles = [-(-(int(st) + int(nv)) // 64) if nv > 0 else 0
             for st, nv in zip(start, n_valid)]
    most = max(tiles, default=0)
    lo = max(p.min_chunk_tiles, -(-most // p.max_chunks))
    hi = max(lo, most)
    while lo < hi:
        mid = (lo + hi) // 2
        if hkv * sum(-(-n // mid) for n in tiles) <= p.grid[0]:
            hi = mid
        else:
            lo = mid + 1
    items = []
    for s, n in enumerate(tiles):
        chunks = -(-n // lo)
        size = -(-n // chunks) * 64 if chunks else 0
        limit = int(start[s]) + int(n_valid[s])
        for h in range(hkv):
            for c in range(chunks):
                items.append(Item(s, h, c, chunks, c * size,
                                  min(limit, (c + 1) * size)))
    return items


def live_patterns(slots, t, width_cols, seed):
    """(start, n_valid) of a decode or verify step over tables of
    ``width_cols`` cols: one slot at the table's end, every slot live at
    random contexts, half of them dead, all dead, and two slots ending on
    a tile boundary."""
    rng = np.random.default_rng(seed)
    top = width_cols - t

    def rand(n):
        return [int(x) for x in rng.integers(0, top + 1, n)]

    patterns = [([top] + [0] * (slots - 1), [t] + [0] * (slots - 1)),
                (rand(slots), [t] * slots),
                (rand(slots), [t if i % 2 else 0 for i in range(slots)]),
                ([0] * slots, [0] * slots)]
    if slots >= 2 and width_cols >= 128:
        patterns.append(([64 - t, 128 - t] + [0] * (slots - 2),
                         [t, t] + [0] * (slots - 2)))
    return patterns


def check_paged_plan(p, s, t, hq, hkv, width_cols, kind):
    """Every body: one 1-D wave at most, its shared memory and workspace
    within bounds, and for every live pattern its work items cover every
    live col of every (slot, kv-head) exactly once, none of a dead slot,
    no more than ``max_items``, and no pair more chunks than the merge's
    buffer holds two rows of. The fp32 body: one block of 8 warps an SM,
    the shared memory of its fp32 ring and work list."""
    rows = (hq // hkv) * t
    assert (p.row_tiles - 1) * 16 < rows <= p.row_tiles * 16
    (blocks,) = p.grid
    warps = p.threads // 32
    if kind == "fp32":
        per_sm = 1
        assert warps == 8 and p.col_groups == 0
        assert p.smem == paged_mod.f32_smem(s)
    else:
        per_sm = paged_mod.blocks_per_sm(kind, t, p.col_groups, s)
        q_warps = warps if warps > 8 else 0
        assert p.smem == paged_mod.mma_smem(kind, t, p.col_groups, q_warps, s)
        assert p.col_groups in (1, 4) and warps % p.col_groups == 0
        assert (warps == 4) if p.col_groups == 4 else 8 <= warps <= 12
    assert 1 <= blocks <= H100_SMS * per_sm
    assert p.smem + paged_mod._STATIC_SMEM <= paged_mod._SMEM_PER_BLOCK
    assert per_sm * (p.smem + paged_mod._BLOCK_RESERVE) <= paged_mod._SMEM_PER_SM
    assert p.min_chunk_tiles >= 2
    assert p.max_items == blocks + s * hkv
    assert p.partials == p.max_items * (rows + rows % 2) and p.counters == s * hkv
    # the merge brings a pair's partials in two rows at a time at least
    assert p.max_chunks >= 1
    assert p.max_chunks * 2 * (128 + 2) * 4 <= paged_mod.merge_bytes(kind, p.col_groups)
    for start, n_valid in live_patterns(s, t, width_cols, s * t + width_cols):
        items = work_items(p, start, n_valid, hkv)
        assert len(items) <= p.max_items
        assert all(it.chunks <= p.max_chunks for it in items)
        if hkv * sum(1 for n in n_valid if n) <= blocks:
            assert len(items) <= blocks       # one item a block at most
        assert all(n_valid[it.slot] > 0 for it in items)
        for slot in range(s):
            for head in range(hkv):
                mine = [it for it in items if (it.slot, it.head) == (slot, head)]
                cols = [c for it in mine for c in range(it.begin, it.end)]
                limit = start[slot] + n_valid[slot] if n_valid[slot] else 0
                assert cols == list(range(limit))
                assert [it.chunk for it in mine] == list(range(len(mine)))
                assert all(it.chunks == len(mine) for it in mine)
                assert all(it.begin % 64 == 0 for it in mine)
                assert all(it.end - it.begin >= 64 * p.min_chunk_tiles
                           for it in mine[:-1])


@pytest.mark.parametrize("s", [1, 8, 24, 32])
@pytest.mark.parametrize("model,hq,hkv", [("qwen3:32b", 64, 8),
                                          ("7b", 28, 4)])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("width_cols", [128, 1280, 2048])
def test_paged_plan_covers_the_table(model, hq, hkv, t, s, width_cols):
    for kind in ("int8", "bf16", "fp32"):
        p = paged_mod.plan(s, t, hq, hkv, width_cols, kind, H100_SMS)
        check_paged_plan(p, s, t, hq, hkv, width_cols, kind)


@pytest.mark.parametrize("model,hq,hkv", [("qwen3:32b", 64, 8),
                                          ("7b", 28, 4)])
@pytest.mark.parametrize("t", [1, 17])
@pytest.mark.parametrize("width_cols", [512, 1024, 1280, 2048, 4096])
def test_bf16_paged_plan_covers_the_table(model, hq, hkv, t, width_cols):
    """The fp-KV tensor-core body at the engines' decode and verify
    shapes (24 slots, 1 to 24 of them given): the work items cover the
    live cols, and where there is live work for two waves the items fill
    at least half the grid (a chunk one tile shorter would not fit it)."""
    for s in (1, 8, 24):
        p = paged_mod.plan(s, t, hq, hkv, width_cols, "bf16", H100_SMS)
        check_paged_plan(p, s, t, hq, hkv, width_cols, "bf16")
        start = [width_cols - t] * s
        items = work_items(p, start, [t] * s, hkv)
        tiles = s * hkv * (width_cols // 64)
        if tiles >= 2 * p.grid[0]:
            assert 2 * len(items) >= p.grid[0]


def test_paged_body_follows_q_and_the_pools():
    assert paged_mod.body(torch.bfloat16, quant=False) == "bf16"
    assert paged_mod.body(torch.bfloat16, quant=True) == "int8"
    assert paged_mod.body(torch.float32, quant=False) == "fp32"
    assert paged_mod.body(torch.float32, quant=True) == "fp32"


def test_paged_plan_one_row_tile_at_decode():
    # a decode step's G query rows of a kv-head fit one tile, which the
    # block's four warps share (each a quarter of every 64-col tile)
    for kind in ("int8", "bf16"):
        for hq, hkv in ((64, 8), (28, 4)):
            p = paged_mod.plan(24, 1, hq, hkv, 2048, kind, H100_SMS)
            assert p.row_tiles == 1 and p.col_groups == 4
            assert p.threads == 128


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("model,hq,hkv", [("qwen3:32b", 64, 8),
                                          ("7b", 28, 4)])
@pytest.mark.parametrize("width_cols", [1024, 4096])
def test_paged_plan_serves_every_row_in_one_pass(kind, model, hq, hkv,
                                                 width_cols):
    """A verify round (T = 17): all G*T rows of a kv-head fall in one
    item, one row tile per warp, so each K/V tile is read once per
    chunk."""
    p = paged_mod.plan(24, 17, hq, hkv, width_cols, kind, H100_SMS)
    assert p.col_groups == 1
    assert p.threads // 32 == max(8, p.row_tiles) <= 12
    assert p.grid == (H100_SMS,)


@pytest.mark.parametrize("kind", ["int8", "bf16", "fp32"])
@pytest.mark.parametrize("t", [1, 17])
@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("width_cols", [8192, 16384])
def test_paged_plan_caps_the_chunks_for_the_merge(kind, t, hkv, width_cols):
    """Long tables with few live slots: the chunk rule alone would give
    one pair more chunks than the merge's buffer holds (at T = 1 over
    int8 pools 64 of 2-tile chunks at 8192 cols against 48; the fp32
    body's smaller buffer, int8 tiles and the widened fp32 tile, holds
    111: 128 chunks at 16384 cols and Hkv 1); the cap lengthens the
    chunks instead, and the work items still cover every live col."""
    hq = 7 * hkv
    p = paged_mod.plan(24, t, hq, hkv, width_cols, kind, H100_SMS)
    check_paged_plan(p, 24, t, hq, hkv, width_cols, kind)
    start, n_valid = [width_cols - t] + [0] * 23, [t] + [0] * 23
    assert max(it.chunks for it in work_items(p, start, n_valid, hkv)) <= p.max_chunks
    uncapped = work_items(p._replace(max_chunks=width_cols), start, n_valid, hkv)
    if kind == "int8" and t == 1:   # the smallest buffer: the cap binds
        assert max(it.chunks for it in uncapped) > p.max_chunks == 48
    if kind == "fp32":
        assert p.max_chunks == 111
        if width_cols == 16384 and hkv == 1:
            assert max(it.chunks for it in uncapped) > p.max_chunks


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("model,hq,hkv", [("qwen3:32b", 64, 8),
                                          ("7b", 28, 4)])
@pytest.mark.parametrize("t", [33, 64])
def test_paged_plan_serves_more_row_tiles_in_passes(kind, model, hq, hkv, t):
    """More than 12 row tiles (T = 33, 64): 12 warps, each with its q tile
    in shared memory, walk the chunk once per 12 row tiles."""
    p = paged_mod.plan(24, t, hq, hkv, 2048, kind, H100_SMS)
    assert p.row_tiles > 12 and p.col_groups == 1 and p.threads == 384
    assert p.smem == paged_mod.mma_smem(kind, t, 1, 12, 24)
    check_paged_plan(p, 24, t, hq, hkv, 2048, kind)


@pytest.mark.parametrize("kind", ["int8", "bf16", "fp32"])
@pytest.mark.parametrize("slots", [129, 512])
def test_paged_plan_takes_any_slot_count_that_fits(kind, slots):
    """The work list grows with the slots (5 ints each) in the block's
    shared memory; a count whose list cannot fit is refused."""
    p = paged_mod.plan(slots, 1, 28, 4, 2048, kind, H100_SMS)
    check_paged_plan(p, slots, 1, 28, 4, 2048, kind)
    assert p.smem - paged_mod.plan(24, 1, 28, 4, 2048, kind, H100_SMS).smem == 20 * (slots - 24)
    with pytest.raises(ValueError, match="slots"):
        paged_mod.plan(slots * 100, 17, 28, 4, 2048, kind, H100_SMS)


def test_workspace_grows_and_is_reused():
    ws = build.Workspace()
    a = ws.take("cpu", torch.int32, 5)
    assert a.numel() >= 5 and bool((a == 0).all())
    assert ws.take("cpu", torch.int32, 3).data_ptr() == a.data_ptr()
    assert ws.take("cpu", torch.int32, a.numel()).data_ptr() == a.data_ptr()
    assert ws.allocations == 1
    b = ws.take("cpu", torch.int32, a.numel() + 1)
    assert b.numel() > a.numel() and bool((b == 0).all())
    assert ws.allocations == 2
    f = ws.take("cpu", torch.float32, 7)        # its own buffer per dtype
    assert f.dtype == torch.float32 and ws.allocations == 3
    assert ws.take("cpu", torch.int32, 2).data_ptr() == b.data_ptr()
    assert ws.take("cpu", torch.float32, 7).data_ptr() == f.data_ptr()


def test_held_buffers_outlive_their_replacement():
    """What a CUDA graph's capture keeps (``Workspace.held``): every
    buffer of every workspace, the very tensors a replaced buffer's
    launches wrote, so that a growth after the capture frees none of
    them."""
    ws, other = build.Workspace(), build.Workspace()
    a = ws.take("cpu", torch.float32, 9)
    c = other.take("cpu", torch.int32, 3)
    held = build.Workspace.held()
    assert any(buf is a for buf in held) and any(buf is c for buf in held)
    b = ws.take("cpu", torch.float32, a.numel() + 1)
    assert b.data_ptr() != a.data_ptr()
    assert any(buf is a for buf in held)             # still the graph's
    now = build.Workspace.held()
    assert any(buf is b for buf in now) and not any(buf is a for buf in now)


def test_entry_point_types_are_set_once(monkeypatch):
    """``build.function`` configures a C entry point on its first call and
    hands the same object to every later call, without loading again."""
    class Fn:
        pass

    class Lib:
        hocr_fake = Fn()

    loads = []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or Lib)
    types = (build.ctypes.c_void_p, build.ctypes.c_int)
    fn = build.function("fake_kernel_for_test", "hocr_fake", types)
    assert fn is Lib.hocr_fake and fn.argtypes == list(types)
    assert fn.restype is build.ctypes.c_int
    assert build.function("fake_kernel_for_test", "hocr_fake", types) is fn
    assert loads == ["fake_kernel_for_test"]
    assert int8_mod.plan.cache_info().maxsize is None
    assert paged_mod.plan.cache_info().maxsize is None
