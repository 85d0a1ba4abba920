"""The work counts behind the rooflines and mfu, against hand counts at
one shape each; the count does not depend on which kernel is timed."""

import pytest

from benchmark import peaks, tracing, work
from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig

VL = VLConfig()


def test_decode_counts_of_one_step_by_hand():
    t = VL.text
    w = work.Work()
    w.step([1000, 3000])                        # two live slots
    # q 3584x3584, k and v 3584x512, o 3584x3584, MLP 3 x 3584x18944
    layer = 3584 * 3584 + 2 * 3584 * 512 + 3584 * 3584 + 3 * 3584 * 18944
    assert work.layer_params(t) == layer == 233_046_016
    head = 152064 * 3584
    assert work.decode_flops(t, w) == \
        2 * 2 * (28 * layer + head) + 4 * 28 * 28 * 128 * 4000
    flops, n_bytes = work.paged_attention(t, w)
    assert flops == 4 * 28 * 28 * 128 * 4000
    assert n_bytes == 28 * (4000 * 4 * 132 * 2 + 2 * 2 * 28 * 128 * 2)
    assert work.decode_weight_bytes(t) == (28 * layer + head) * 2
    assert work.kv_bytes_per_token(t) == 2 * 28 * 4 * 132
    assert work.decode_floor_seconds(t, w, 1.0) == \
        (28 * layer + head) * 2 + 4000 * 2 * 28 * 4 * 132


def test_prefill_and_vision_counts_by_hand():
    t = VL.text
    flops, n_bytes = work.flash_prefill(t, 914)
    assert flops == 4 * 28 * 28 * 128 * (914 * 915 // 2)
    assert n_bytes == 28 * 914 * 128 * 2 * (2 * 28 + 2 * 4)
    grid = (1, 66, 48)                         # a 924x672 page
    sizes = work.windows(VL.vision, grid)
    # 33 x 24 cells in 4x4-cell windows: 8 rows of 6 full windows and a
    # last row of 6 windows one cell high
    assert len(sizes) == 54 and sum(sizes) == 3168
    assert sizes.count(64) == 48 and sizes.count(16) == 6
    flops, n_bytes = work.flash_vision(VL.vision, grid)
    assert flops == 4 * 4 * 1280 * 3168 ** 2
    assert n_bytes == 4 * 4 * 3168 * 1280 * 2
    flops, n_bytes = work.window_attention(VL.vision, grid)
    assert flops == 28 * 4 * 1280 * (48 * 64 ** 2 + 6 * 16 ** 2)
    assert n_bytes == 28 * (3168 * 4 * 1280 * 2 + 2 * 3168 * 80 * 4)


def test_the_least_time_is_the_larger_bound():
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(989e12, 6.7e12) == pytest.approx(2.0)


def test_the_same_count_whatever_kernel_is_timed():
    w = work.Work()
    w.step([500] * 24)
    least = peaks.least_seconds(*work.paged_attention(VL.text, w))
    for name in ("void paged_mma_kernel<4>(PagedArgs)", "sdpa_flash_fwd"):
        summary = {"kernels": {name: 2 * least}}
        seconds = tracing.kernel_seconds(summary, (name.split("(")[0][-16:],))
        assert least / seconds == pytest.approx(0.5)
    assert tracing.kernel_seconds({"kernels": {"gemm": 1.0}},
                                  ("paged_mma_kernel",)) is None


def test_model_flops_add_the_window_s_work():
    w = work.Work(prompts=[914], grids=[(1, 66, 48)])
    w.step([915])
    total = work.model_flops(VL, w)
    assert total == (work.prefill_flops(VL.text, 914)
                     + work.decode_flops(VL.text, w)
                     + work.vision_flops(VL.vision, (1, 66, 48)))
    # ~7.6B parameters in the text stack and head: ~15 GFLOP a token
    assert 14e9 < work.decode_flops(VL.text, w) < 16.5e9


def test_busy_time_is_a_union_and_gaps_take_the_host_s_range():
    ns = 1_000_000
    events = [("a", 0, 4 * ns), ("b", 2 * ns, 6 * ns), ("a", 8 * ns, 9 * ns)]
    spans = [("batcher.run", 0, 10 * ns), ("decode_chunk", 5 * ns, 9 * ns)]
    summary = tracing.summarize(events, spans, (0, 10 * ns))
    assert summary["busy_s"] == pytest.approx(7e-3)
    assert summary["kernels"]["a"] == pytest.approx(5e-3)
    assert summary["idle"] == pytest.approx({"decode_chunk": 2e-3,
                                             "batcher.run": 1e-3})
