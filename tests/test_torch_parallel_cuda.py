"""Every kernel at the shapes one tensor-parallel rank gives it, on the
card (``-m cuda``; skipped without one). No JAX here, so the file runs on
the card's machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_parallel_cuda.py``. ``chip_smoke.py``'s kernels_tp phase
holds paged attention too, at the full shapes, with times.
"""

import numpy as np
import pytest
import torch

TP_SHAPES = {2: dict(vis_heads=8, vl_q=14, vl_kv=2, q3_q=32, q3_kv=4),
             4: dict(vis_heads=4, vl_q=7, vl_kv=1, q3_q=16, q3_kv=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_kernels_at_the_rank_shapes_on_cuda(tp):
    """The int8 matmul at the rank's qwen3:32b widths (the lm_head at
    151936 / tp channels, not a multiple of 128), flash attention at the
    rank's head counts and the window kernel at the rank's packed qkv
    width, each against its plain version (bf16: two ulps of the plain
    output's largest magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from handwritten_ocr_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                           int8_matmul_plain)
    from handwritten_ocr_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(tp)
    shapes = TP_SHAPES[tp]

    def close(got, want):
        peak = float(want.abs().max())
        tol = 2 * 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert float((got.float() - want.float()).abs().max()) <= tol

    for n, k in ((8192 // tp, 5120), (1024 // tp, 5120),
                 (25600 // tp, 5120), (5120, 8192 // tp), (5120, 25600 // tp),
                 (151936 // tp, 5120)):
        x = torch.randn((24, k), generator=gen, device="cuda").bfloat16()
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
        close(int8_matmul(x, w, s, out_dtype=torch.float32),
              int8_matmul_plain(x, w, s, torch.float32))
    for hq, hkv, t, hd in ((shapes["vl_q"], shapes["vl_kv"], 1024, 128),
                           (shapes["q3_q"], shapes["q3_kv"], 1280, 128),
                           (shapes["vis_heads"], shapes["vis_heads"], 3456, 80)):
        q = torch.randn((2, t, hq, hd), generator=gen, device="cuda").bfloat16()
        kv = [torch.randn((2, t, hkv, hd), generator=gen,
                          device="cuda").bfloat16() for _ in range(2)]
        close(flash_attention(q, *kv, causal=True, scale=hd ** -0.5),
              flash_attention_plain(q, *kv, causal=True, scale=hd ** -0.5))
    heads, p = shapes["vis_heads"], 1024
    qkv = torch.randn((2, p, 3 * heads * 80), generator=gen,
                      device="cuda").bfloat16()
    angles = torch.rand((p, 80), generator=gen, device="cuda") * 6
    valid = torch.ones(p, dtype=torch.bool, device="cuda")
    args = (qkv, angles.cos(), angles.sin(), valid)
    kw = dict(num_heads=heads, window_len=64, scale=80 ** -0.5)
    close(window_attention(*args, **kw), window_attention_plain(*args, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_sharded_train_step_equals_single_card_step_on_cuda(mesh):
    """Two ranks on the card (NCCL with a card each, else gloo on
    cuda:0): a narrow fp32 VL's train step at (data, model) = (1, 2) TP
    and (2, 1) FSDP against the same step on one card (flash and window
    kernels forward, autograd through their reference forms backward):
    the loss, every gradient the update gets and every updated leaf
    within 2e-4 absolute and relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch_port_dist import run_group, train_cuda_cases
    data, model = mesh
    for result in run_group(data * model, train_cuda_cases, model,
                            timeout=600):
        loss, want = result["loss"]
        assert abs(loss - want) <= 2e-4 * (1 + abs(want))
        assert result["grads"] <= 2e-4
        assert result["params"] <= 2e-4
