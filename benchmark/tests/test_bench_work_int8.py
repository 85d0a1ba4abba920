"""The int8 products' counts behind ``int8_matmul_roofline.agents``,
against hand counts at the reasoner's widths."""

import pytest

from benchmark import peaks, work, work_int8


@pytest.fixture
def q3():
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    return Qwen3Config()


def test_one_step_by_hand(q3):
    # q 5120x8192, k and v 5120x1024, o 8192x5120, MLP 3 x 5120x25600
    layer = 5120 * 8192 + 2 * 5120 * 1024 + 8192 * 5120 + 3 * 5120 * 25600
    assert sum(i * o for i, o in work_int8.projections(q3)) == layer \
        == work.layer_params(q3) == 487_587_840
    outs = 8192 + 2 * 1024 + 5120 + 2 * 25600 + 5120
    ins = 3 * 5120 + 8192 + 2 * 5120 + 25600
    rows = 24
    flops, n_bytes = work_int8.step(q3, rows)
    head = 151936 * 5120
    assert flops == 2 * rows * (64 * layer + head)
    assert n_bytes == (64 * (layer + 4 * outs + rows * (2 * ins + 2 * outs))
                       + head + 4 * 151936 + rows * (2 * 5120 + 4 * 151936))
    # 32.0 GB of int8 weights and 0.4 GB of rows a step: bound by bytes
    assert 32.3e9 < n_bytes < 32.5e9
    assert peaks.least_seconds(flops, n_bytes) == n_bytes / peaks.HBM_BYTES_PER_S


def test_the_window_adds_steps_and_prefill_heads(q3):
    w = work.Work(prompts=[2000, 3000, 2500])
    w.step([2001, 3001])
    w.step([2002])
    least = work_int8.least_seconds_int8(q3, w, prefill_calls=2)
    head_bytes = 151936 * 5120 + 4 * 151936
    expect = (peaks.least_seconds(*work_int8.step(q3, 2))
              + peaks.least_seconds(*work_int8.step(q3, 1))
              + (2 * head_bytes + 3 * (2 * 5120 + 4 * 151936))
              / peaks.HBM_BYTES_PER_S)
    assert least == pytest.approx(expect, rel=1e-12)
    assert work_int8.least_seconds_int8(q3, work.Work(), 0) == 0
