"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the device, and ``nvidia-smi``'s name and power limit of the card;
  2. build the CUDA kernels from ``handwritten_ocr_tpu_torch/csrc`` (one
     ``nvcc`` per source, all started together);
  3. each kernel at the main path's shapes against its plain PyTorch
     version on the card, with its time, the plain version's time, the
     time of one PyTorch library call where one computes the same
     attention, and the least time the card could take (bound);
  4. the main path: Qwen2.5-VL at the olmOCR-2-7B widths and depth, bf16,
     random weights from a seed; four synthetic 924x672 pages through
     ``TorchPreprocessor`` with the two initial strategies into
     ``TorchOCRBackend.read_batch(..., max_new_tokens=128)``; the launch
     counts of every kernel are set to 0 just before this run and read
     just after, and each must be > 0;
  5. two more reads under ``torch.profiler`` (8 and 40 new tokens): the
     device's busy share of a read and of a decode step, and the kernels
     that take its time;
  6. a small reference check: a narrow model read on the card (kernels)
     and on the CPU (plain versions) in fp32 must give the same tokens.

Every failed check raises, so the script exits non-zero and prints no
result. Without a CUDA card it exits non-zero at once. The last line is
``{"ok": true, "device": {...}}``; the kernels line and the card's name
and power limit come before it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
SEED = 0
# A kernel agrees with its plain version when its largest error is within
# BF16_ULPS bf16 ulps of the plain output's largest magnitude, and the RMS
# of its error within REL_RMS_TOL of the plain output's RMS.
BF16_ULPS = 2
REL_RMS_TOL = 1e-2


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def bound_ms(n_bytes: float, flops: float, flops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_pages(n_pages: int, height: int = 924, width: int = 672):
    """Paper-like pages with dark strokes (as ``bench.py``)."""
    rng = np.random.default_rng(SEED)
    pages = []
    for _ in range(n_pages):
        page = np.clip(rng.normal(235, 8, (height, width, 3)), 180, 255)
        for _ in range(40):
            y = rng.integers(20, height - 20)
            x = rng.integers(10, width - 120)
            page[y:y + 3, x:x + rng.integers(30, 110)] = rng.integers(10, 60)
        pages.append(page.astype(np.uint8))
    return pages


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    index = torch.cuda.current_device()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit(phase="device", **device, torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi[index])
    return {"device": device, "smi": smi[index]}


def phase_build() -> None:
    from handwritten_ocr_tpu_torch.ops import build
    t0 = time.perf_counter()
    report = build.build_all()
    usage = {name: [line.split("info    : ")[-1].strip()
                    for line in info["ptxas"].splitlines()
                    if "registers" in line]
             for name, info in report.items()}
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3),
         built={n: round(r["seconds"], 3) for n, r in report.items()},
         ptxas=usage)


def _compare(name: str, got, want) -> dict:
    """Kernel output against its plain version, at the plain output's own
    scale. A bf16 value carries 8 significant bits: two fp32 sums of the
    same terms in another order round to bf16 values at most one ulp
    apart, and one more ulp covers the fp32 difference of the sums. The
    largest error must stay within BF16_ULPS ulps of max|want|, which
    bounds the worst element, and RMS(error) within REL_RMS_TOL of
    RMS(want), which catches a fault that moves many outputs smaller
    than the largest."""
    got, want = got.float(), want.float()
    diff = got - want
    err = float(diff.abs().max())
    peak = float(want.abs().max())
    if not (math.isfinite(peak) and peak > 0):
        raise AssertionError(f"{name}: plain output has max|value| {peak}")
    tol = BF16_ULPS * 2.0 ** (math.floor(math.log2(peak)) - 7)
    rel_rms = float(diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    if not (err <= tol and rel_rms <= REL_RMS_TOL):      # also catches NaN
        raise AssertionError(
            f"{name}: kernel vs plain max_abs_err {err} (tolerance {tol}), "
            f"rel_rms_err {rel_rms} (tolerance {REL_RMS_TOL})")
    return dict(max_abs_err=err, tolerance=tol, rel_rms_err=rel_rms,
                rel_rms_tolerance=REL_RMS_TOL)


def phase_kernels(cfg, prompt_len: int) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid
    from handwritten_ocr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention, paged_append_attention_plain)
    from handwritten_ocr_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)

    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    vis = cfg.vision
    plan = plan_grid(vis, (1, 924 // 14, 672 // 14))
    batch = 8                                  # 4 pages x 2 strategies
    p_len, heads, hd = len(plan.valid), vis.num_heads, vis.head_dim
    valid = torch.as_tensor(plan.valid, device=dev)
    live = int(plan.valid.sum())

    # -- flash, vision global layers: [8, P, 16, 80], dead-slot key mask
    q, k, v = (randn(batch, p_len, heads, hd) for _ in range(3))
    scale = hd ** -0.5
    got = flash_attention(q, k, v, valid, scale=scale)
    want = flash_attention_plain(q, k, v, valid, scale=scale)
    cmp = _compare("flash_attention vision", got, want)
    q_t, k_t, v_t = (x.transpose(1, 2) for x in (q, k, v))
    n_bytes = 4 * q.numel() * 2 + p_len
    flops = 4 * batch * heads * hd * live * live
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    rows.append(dict(
        name="flash_attention", case="vision_global", route="cuda",
        source="handwritten_ocr_tpu_torch/csrc/flash_attention.cu",
        replaces="handwritten_ocr_tpu/ops/flash_attention.py:30",
        shape=[batch, p_len, heads, hd], dtype="bf16", **cmp,
        ms=time_ms(lambda: flash_attention(q, k, v, valid, scale=scale)),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, valid,
                                                       scale=scale), iters=3),
        library="F.scaled_dot_product_attention (bool key mask)",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q_t, k_t, v_t, attn_mask=valid[None, :], scale=scale)),
        bound_ms=bound, bound_by=by))
    del q, k, v, q_t, k_t, v_t, got, want

    # -- window attention: qkv [8, P, 3*1280], 28 window layers
    d = heads * hd
    qkv = randn(batch, p_len, 3 * d)
    cos = torch.as_tensor(plan.cos_pad, device=dev)
    sin = torch.as_tensor(plan.sin_pad, device=dev)
    kw = dict(num_heads=heads, window_len=plan.window_len, scale=scale)
    got = window_attention(qkv, cos, sin, valid, **kw)
    want = window_attention_plain(qkv, cos, sin, valid, **kw)
    cmp = _compare("window_attention", got, want)
    n_win, wl = plan.n_windows, plan.window_len
    live_per_win = plan.valid.reshape(n_win, wl).sum(axis=1)
    flops = 4 * batch * heads * hd * float((live_per_win ** 2).sum())
    n_bytes = qkv.numel() * 2 + batch * p_len * d * 2 + 2 * cos.numel() * 4 + p_len
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    qw = qkv.reshape(batch, n_win, wl, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    qw = qw.reshape(3, batch * n_win, heads, wl, hd)
    win_mask = valid.reshape(n_win, 1, 1, wl).repeat(batch, 1, 1, 1)
    rows.append(dict(
        name="window_attention", case="vision_window", route="cuda",
        source="handwritten_ocr_tpu_torch/csrc/window_attention.cu",
        replaces="handwritten_ocr_tpu/ops/window_attention.py:194",
        shape=[batch, p_len, 3 * d], dtype="bf16", **cmp,
        ms=time_ms(lambda: window_attention(qkv, cos, sin, valid, **kw)),
        plain_ms=time_ms(lambda: window_attention_plain(qkv, cos, sin, valid,
                                                        **kw), iters=3),
        library="F.scaled_dot_product_attention per window (q/k not roped)",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qw[0], qw[1], qw[2], attn_mask=win_mask, scale=scale)),
        bound_ms=bound, bound_by=by))
    del qkv, got, want, qw

    # -- flash, causal prefill: q [8, T, 28, 128], k/v [8, T, 4, 128]
    txt = cfg.text
    bucket = -(-prompt_len // cfg_mod.SERVE_PREFILL_BUCKET) * cfg_mod.SERVE_PREFILL_BUCKET
    hq, hkv, thd = txt.num_attention_heads, txt.num_key_value_heads, txt.head_dim
    q = randn(batch, bucket, hq, thd)
    k, v = randn(batch, bucket, hkv, thd), randn(batch, bucket, hkv, thd)
    tscale = thd ** -0.5
    got = flash_attention(q, k, v, causal=True, scale=tscale)
    want = flash_attention_plain(q, k, v, causal=True, scale=tscale)
    cmp = _compare("flash_attention prefill", got, want)
    n_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    flops = 4 * batch * hq * thd * bucket * (bucket + 1) / 2
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    q_t, k_t, v_t = (x.transpose(1, 2) for x in (q, k, v))
    rows.append(dict(
        name="flash_attention", case="prefill_causal", route="cuda",
        source="handwritten_ocr_tpu_torch/csrc/flash_attention.cu",
        replaces="handwritten_ocr_tpu/ops/flash_attention.py:30",
        shape=[batch, bucket, hq, thd], dtype="bf16", **cmp,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True, scale=tscale)),
        plain_ms=time_ms(lambda: flash_attention_plain(
            q, k, v, causal=True, scale=tscale), iters=3),
        library="F.scaled_dot_product_attention (is_causal, enable_gqa)",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q_t, k_t, v_t, is_causal=True, scale=tscale, enable_gqa=True)),
        bound_ms=bound, bound_by=by))
    del q, k, v, q_t, k_t, v_t, got, want

    # -- paged append + attention: one decode step, 8 live of 24 slots
    slots, bs = cfg_mod.SERVE_SLOTS, cfg_mod.SERVE_BLOCK_SIZE
    context = 512
    while context < prompt_len + 128:
        context *= 2
    width = context // bs
    n_blocks = 1 + slots * width
    layers = txt.num_hidden_layers
    k_pool = randn(layers, n_blocks, bs, hkv, thd)
    v_pool = randn(layers, n_blocks, bs, hkv, thd)
    tables = torch.zeros((slots, width), dtype=torch.int32, device=dev)
    start = torch.zeros(slots, dtype=torch.int32, device=dev)
    n_valid = torch.zeros(slots, dtype=torch.int32, device=dev)
    for s in range(batch):
        tables[s] = torch.arange(1 + s * width, 1 + (s + 1) * width)
        start[s] = prompt_len + 64
        n_valid[s] = 1
    q = randn(slots, 1, hq, thd)
    k_new, v_new = randn(slots, 1, hkv, thd), randn(slots, 1, hkv, thd)
    k_ref, v_ref = k_pool.clone(), v_pool.clone()
    got = paged_append_attention(q, k_new, v_new, k_pool, v_pool, tables,
                                 start, n_valid, layer=5, scale=tscale)
    want = paged_append_attention_plain(q, k_new, v_new, k_ref, v_ref, tables,
                                        start, n_valid, layer=5, scale=tscale)
    cmp = _compare("paged_append_attention", got[:batch], want[:batch])
    if not (torch.equal(k_pool, k_ref) and torch.equal(v_pool, v_ref)):
        raise AssertionError("paged_append_attention: pools differ from plain")
    if not bool((got[batch:] == 0).all()):
        raise AssertionError("paged_append_attention: dead slots not zero")
    del k_ref, v_ref, want
    ctx = int(start[:batch].sum())
    row = hkv * thd * 2
    n_bytes = (2 * ctx * row                 # cached K and V of live slots
               + 4 * batch * row             # new rows read, then written
               + batch * hq * thd * 2        # q of live slots
               + slots * hq * thd * 2        # every slot's output
               + tables.numel() * 4 + 2 * slots * 4)
    flops = 4 * hq * thd * (ctx + batch)
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    layer_cycle = iter(range(10 ** 9))

    def paged_step():   # a new layer each call: cold pages, as in decode
        paged_append_attention(q, k_new, v_new, k_pool, v_pool, tables, start,
                               n_valid, layer=next(layer_cycle) % layers,
                               scale=tscale)

    def paged_plain_step():
        paged_append_attention_plain(q, k_new, v_new, k_pool, v_pool, tables,
                                     start, n_valid,
                                     layer=next(layer_cycle) % layers,
                                     scale=tscale)

    rows.append(dict(
        name="paged_append_attention", case="decode_step", route="cuda",
        source="handwritten_ocr_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="handwritten_ocr_tpu/ops/paged_decode_attention.py:64",
        shape=[slots, 1, hq, thd], live_slots=batch, context=int(start[0]),
        pool=list(k_pool.shape), dtype="bf16", **cmp,
        ms=time_ms(paged_step, iters=56), plain_ms=time_ms(paged_plain_step,
                                                           iters=10),
        library=None, library_ms=None, bound_ms=bound, bound_by=by))
    del k_pool, v_pool, q, k_new, v_new, got
    torch.cuda.empty_cache()
    for r in rows:
        emit(phase="kernel", **r)
    return rows


def reset_launches() -> None:
    from handwritten_ocr_tpu_torch.ops import (flash_attention,
                                               paged_decode_attention,
                                               window_attention)
    flash_attention.flash_attention.launches = 0
    window_attention.window_attention.launches = 0
    paged_decode_attention.paged_append_attention.launches = 0


def read_launches() -> dict:
    from handwritten_ocr_tpu_torch.ops import (flash_attention,
                                               paged_decode_attention,
                                               window_attention)
    return {"flash_attention": flash_attention.flash_attention.launches,
            "window_attention": window_attention.window_attention.launches,
            "paged_append_attention":
                paged_decode_attention.paged_append_attention.launches}


def phase_main_path(cfg, prompt_len: int, max_new_tokens: int = 128) -> dict:
    from handwritten_ocr_tpu_torch.config import (OCR_PROMPT,
                                                  PREPROCESSING_STRATEGIES)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel

    t0 = time.perf_counter()
    params = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    backend = TorchOCRBackend(VLModel(params, cfg), ByteTokenizer())
    prep = TorchPreprocessor()
    pages = synthetic_pages(4)
    strategies = PREPROCESSING_STRATEGIES[:2]

    def read(budget):
        images = [prep.apply(page, s) for page in pages for s in strategies]
        return images, backend.read_batch(images, OCR_PROMPT, budget)

    read(max_new_tokens)          # warm-up: cuBLAS, kernel libraries, pools
    batcher = backend._batcher
    backend.stats["vision_s"] = 0.0
    batcher.stats.update(prefill_s=0.0, decode_s=0.0, decode_tokens=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    images = [prep.apply(page, s) for page in pages for s in strategies]
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    texts = backend.read_batch(images, OCR_PROMPT, max_new_tokens)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    launches = read_launches()

    if len(texts) != len(images) or not all(isinstance(t, str) for t in texts):
        raise AssertionError("read_batch returned the wrong number of texts")
    if backend._batcher is not batcher:
        raise AssertionError("the timed read rebuilt the batcher")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    cache = batcher.cache
    if not (torch.isfinite(cache.k[:, 1:].float()).all()
            and torch.isfinite(cache.v[:, 1:].float()).all()):
        raise AssertionError("non-finite values in the KV pools")
    stats = {**backend.stats, **batcher.stats}
    record = dict(
        phase="main_path", params=n_params, init_s=init_s, pages=len(pages),
        reads=len(images), max_new_tokens=max_new_tokens,
        grid=[1, 66, 48], prompt_tokens=prompt_len, read_s=read_s,
        preprocess_s=prep_s, vision_s=stats["vision_s"],
        prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
        pages_per_s=len(pages) / read_s, reads_per_s=len(images) / read_s,
        decode_tokens=stats["decode_tokens"],
        decode_tokens_per_s=stats["decode_tokens"] / stats["decode_s"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches)
    emit(**record)
    phase_trace(backend, images, OCR_PROMPT)
    del backend, params, batcher, cache
    torch.cuda.empty_cache()
    return record


def _profiled_read(backend, images, prompt: str, budget: int):
    """(wall s, device-busy s, device events) of one read under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        backend.read_batch(images, prompt, budget)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    return wall, sum(e.self_device_time_total for e in device) / 1e6, device


def phase_trace(backend, images, prompt: str, short: int = 8,
                long: int = 40) -> dict:
    """Two more reads of the same images under ``torch.profiler`` (after
    the timed read, so the timed numbers carry no tracing cost), with
    ``short`` and ``long`` new tokens. Their difference isolates decode
    steps: device time and wall time per step and the device's busy share
    of a decode step. The profiler slows the host, so under tracing the
    busy share is a lower bound. None where the profiler saw no device
    time."""
    w_short, b_short, _ = _profiled_read(backend, images, prompt, short)
    w_long, b_long, device = _profiled_read(backend, images, prompt, long)
    steps = long - short
    seen = bool(device)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    record = dict(
        phase="trace", max_new_tokens=[short, long],
        read_wall_s=w_long, read_device_busy_s=b_long if seen else None,
        read_busy_share=b_long / w_long if seen else None,
        decode_step_wall_ms=(w_long - w_short) / steps * 1e3,
        decode_step_device_ms=(b_long - b_short) / steps * 1e3 if seen else None,
        decode_busy_share=(b_long - b_short) / (w_long - w_short) if seen else None,
        top_kernels=[{"name": e.key[:70], "count": e.count,
                      "ms": e.self_device_time_total / 1e3} for e in top])
    emit(**record)
    return record


def _tensors(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, list):
        for value in tree:
            yield from _tensors(value)
    else:
        yield tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_reference() -> dict:
    """A narrow model (the kernels' head widths: vision 80, text 128) in
    fp32 reads two small pages on the card and on the CPU; the greedy
    tokens must be equal."""
    from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel

    class Spelling(ByteTokenizer):
        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)

    cfg = VLConfig(
        vision=VisionConfig(depth=4, hidden_size=160, intermediate_size=320,
                            num_heads=2, fullatt_block_indexes=(1, 3),
                            out_hidden_size=256),
        text=TextConfig(hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=2,
                        num_key_value_heads=1))
    cpu_params = init_vl(cfg, dtype=torch.float32, device="cpu", seed=SEED + 1)
    pages = [p[:168, :224] for p in synthetic_pages(2)]
    strategies = PREPROCESSING_STRATEGIES[:2]
    out = {}
    for device, params in (("cuda", _to(cpu_params, "cuda")),
                           ("cpu", cpu_params)):
        prep = TorchPreprocessor(min_pixels=28 * 28, device=device)
        images = [prep.apply(np.ascontiguousarray(p), s)
                  for p in pages for s in strategies]
        backend = TorchOCRBackend(VLModel(params, cfg), Spelling(),
                                  device=device)
        out[device] = backend.read_batch(images, "Read the page.", 16)
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"card and CPU reads differ: {out}")
    record = dict(phase="reference", reads=len(out["cpu"]),
                  tokens=sum(len(t.split()) for t in out["cpu"]),
                  equal=True)
    emit(**record)
    return record


def main() -> int:
    from handwritten_ocr_tpu_torch.config import OCR_PROMPT
    from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                            vlm_chat_prompt)
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig

    info = phase_device()
    t_start = time.perf_counter()
    phase_build()
    cfg = VLConfig()                        # olmOCR-2-7B / Qwen2.5-VL-7B widths
    n_image = (924 // 14) * (672 // 14) // 4
    prompt_len = (len(ByteTokenizer().encode(vlm_chat_prompt(OCR_PROMPT, 1)))
                  - 1 + n_image)
    rows = phase_kernels(cfg, prompt_len)
    main_path = phase_main_path(cfg, prompt_len)
    phase_reference()
    kernels = []
    for r in rows:
        kernels.append({key: r[key] for key in (
            "name", "case", "route", "source", "replaces")}
            | {"launches": main_path["launches"][r["name"]]}
            | {key: r[key] for key in ("max_abs_err", "tolerance",
                                       "rel_rms_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")})
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": info["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
