"""Host-side launch plans of the int8 matmul and the paged kernel, and the
kernels' workspace: pure Python, no card.

The plans are what the wrappers cache per shape (splits, tiles, grid,
workspace sizes); the kernels trust them, so a plan that left a k tile or
a context col uncovered, or a split empty, would compute a wrong result on
the card without any error.
"""

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
    ranges = [(y * p.k_per_split, min(d_in, (y + 1) * p.k_per_split))
              for y in range(p.split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == d_in
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
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


def test_int8_plan_fp32_x_takes_one_split():
    p = int8_mod.plan(4, 1024, 5120, H100_SMS, bf16=False)
    assert p.split == 1 and p.k_per_split == 5120 and p.partial == 0


def check_paged_plan(p, s, t, hq, hkv, width_cols, kind):
    """The splits cover the table, the grid and workspace match them, and
    a tensor-core body's merge weights fit its ring."""
    assert p.split_cols % 64 == 0
    assert p.n_split * p.split_cols >= width_cols
    assert (p.n_split - 1) * p.split_cols < width_cols
    rows = (hq // hkv) * t
    assert (p.row_tiles - 1) * 16 < rows <= p.row_tiles * 16
    assert p.grid == (s, hkv, p.row_tiles * p.n_split)
    assert p.partials == s * hkv * p.row_tiles * 16 * p.n_split
    mma = kind != "fp32"
    assert p.counters == (s * hkv * p.row_tiles if mma else 0)
    if mma:
        assert 16 * (p.n_split + 1) * 4 <= paged_mod._RING_BYTES[kind]


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
    shapes (24 slots, 1 to 24 of them given): the plan covers the table,
    fills the card and stays within the workspace."""
    for s in (1, 8, 24):
        p = paged_mod.plan(s, t, hq, hkv, width_cols, "bf16", H100_SMS)
        check_paged_plan(p, s, t, hq, hkv, width_cols, "bf16")
        tiles = -(-width_cols // 64)
        assert p.n_split == tiles or \
            s * hkv * p.row_tiles * p.n_split >= H100_SMS


def test_paged_body_follows_q_and_the_pools():
    assert paged_mod.body(torch.bfloat16, quant=False) == "bf16"
    assert paged_mod.body(torch.bfloat16, quant=True) == "int8"
    assert paged_mod.body(torch.float32, quant=False) == "fp32"
    assert paged_mod.body(torch.float32, quant=True) == "fp32"


def test_paged_plan_one_row_tile_at_decode():
    # a decode step's G query rows of a kv-head fit one tile: K and V are
    # read once per split
    for kind in ("int8", "bf16"):
        assert paged_mod.plan(24, 1, 64, 8, 2048, kind, H100_SMS).row_tiles == 1
        assert paged_mod.plan(24, 1, 28, 4, 2048, kind, H100_SMS).row_tiles == 1


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
