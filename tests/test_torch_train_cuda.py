"""The training path's autograd on the card (``-m cuda``; skipped without
a CUDA card). JAX is not imported, so these run where it is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_train_cuda.py``.

The flash and window wrappers under autograd must launch their kernel in
the forward, and their gradients (autograd through the reference forms)
must equal autograd through the plain versions on the card; the bf16
fp32-accumulated LM-head product must be differentiable, with bf16
gradients. Tolerances in ``_check_grads``.
"""

import pytest
import torch

from handwritten_ocr_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain)
from handwritten_ocr_tpu_torch.ops.window_attention import (
    window_attention, window_attention_plain)


def _rel_rms(got, want):
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def _check_grads(got, want, dtype):
    """fp32: 1e-4 absolute and relative (fp32 sums in another order).
    bf16: RMS of the error within 1% of RMS(want) (the kernel path's
    forward and the plain one round to bf16 at other points, and the
    plain backward rounds dP to bf16 where the reference keeps fp32)."""
    for ours, theirs in zip(got, want):
        ours, theirs = ours.float(), theirs.float()
        assert bool(torch.isfinite(ours).all())
        if dtype == torch.float32:
            torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)
        else:
            assert _rel_rms(ours, theirs) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,masked", [
    ((1, 1024, 16, 16, 80), False, True),        # vision global, key mask
    ((1, 570, 28, 4, 128), True, False)])        # text causal, GQA 7
def test_flash_function_on_cuda(dtype, shape, causal, masked):
    """The Function's forward launches the kernel once; its gradients
    equal autograd through the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, t, hq, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)

    q, k, v = randn(b, t, hq, d), randn(b, t, hkv, d), randn(b, t, hkv, d)
    g = randn(b, t, hq, d)
    mask = torch.ones(t, dtype=torch.bool, device="cuda")
    if masked:
        mask[[5, 17, 500, 501]] = False
    mask = mask if masked else None
    kw = dict(causal=causal)
    inputs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention(*inputs, mask, **kw)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, inputs, g)
    plain_inputs = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        flash_attention_plain(*plain_inputs, mask, **kw), plain_inputs, g)
    _check_grads(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_function_on_cuda(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    p, heads, hd = 16 * 64, 16, 80
    qkv = torch.randn((1, p, 3 * heads * hd), generator=gen,
                      device="cuda").to(dtype)
    g = torch.randn((1, p, heads * hd), generator=gen, device="cuda").to(dtype)
    pos = torch.randn((p, hd), generator=gen, device="cuda")
    cos, sin = pos.cos(), pos.sin()
    valid = torch.ones(p, dtype=torch.bool, device="cuda")
    valid[100:128] = False
    kw = dict(num_heads=heads, window_len=64, scale=hd ** -0.5)
    x = qkv.clone().requires_grad_()
    before = window_attention.launches
    out = window_attention(x, cos, sin, valid, **kw)
    assert window_attention.launches == before + 1
    (got,) = torch.autograd.grad(out, (x,), g)
    y = qkv.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        window_attention_plain(y, cos, sin, valid, **kw), (y,), g)
    _check_grads([got], [want], dtype)


@pytest.mark.cuda
def test_lm_logits_bf16_gradients_on_cuda():
    """The bf16 fp32-accumulated product is differentiable on the card:
    gradients come back in bf16 and agree with fp32 autograd within 1%
    RMS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import TextConfig
    from handwritten_ocr_tpu_torch.models.qwen25vl.language import lm_logits
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg = TextConfig()
    w = (torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen,
                     device="cuda") * 0.02).to(torch.bfloat16)
    h = torch.randn((1, 64, cfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16)
    g = torch.randn((1, 64, cfg.vocab_size), generator=gen, device="cuda")
    tw, th = w.clone().requires_grad_(), h.clone().requires_grad_()
    out = lm_logits({"lm_head": {"w": tw}}, cfg, th)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, (tw, th), g)
    assert all(x.dtype == torch.bfloat16 for x in got)
    fw, fh = w.float().requires_grad_(), h.float().requires_grad_()
    want = torch.autograd.grad(
        lm_logits({"lm_head": {"w": fw}}, cfg, fh), (fw, fh), g)
    _check_grads(got, want, torch.bfloat16)
