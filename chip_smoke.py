"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the device, and ``nvidia-smi``'s name and power limit of the card;
  2. build the CUDA kernels from ``handwritten_ocr_tpu_torch/csrc`` (one
     ``nvcc`` per source, all started together);
  3. each kernel at the two paths' shapes against its plain PyTorch
     version on the card, with its time, the plain version's time, the
     time of one PyTorch library call where one computes the same
     function, the kernel's time over that call's (library_ratio), and
     the least time the card could take (bound): flash, window and paged
     attention (fp KV and int8 KV) at the read's shapes; flash prefill,
     int8 paged attention and the int8 matmul at the reasoner's; the paged
     and int8 cases also with their device time alone (graph_ms, from a
     CUDA graph of launches over cold pages or weights), and the int8
     cases with the device time of their torch.mm yardstick
     (library_graph_ms);
  4. the OCR read: Qwen2.5-VL at the olmOCR-2-7B widths and depth, bf16,
     random weights from a seed; four synthetic 924x672 pages through
     ``TorchPreprocessor`` with the two initial strategies into
     ``TorchOCRBackend.read_batch(..., max_new_tokens=128)``, decoding
     over the int8 KV cache (the default); the launch counts of every
     kernel are set to 0 just before this run and read just after, and
     each kernel of the path must be > 0; then two more reads under
     ``torch.profiler`` (8 and 40 new tokens): the device's busy share of
     a read and of a decode step, and each kernel's device ms and launches
     per decode step;
  5. the reasoning engine: qwen3:32b at its published widths and depth
     with int8 weights (random, from a seed) through
     ``TorchReasoningBackend.chat_batch`` on 8 editor-style turns of ~1k
     tokens, 128 new tokens, over the int8 KV cache; counts set to 0
     before and read after as in 4, then two traced calls;
  6. reference checks: narrow models in fp32 on the card (kernels) and on
     the CPU (plain versions) must give the same tokens: the VL read and a
     Qwen3 with int8 weights, each with the int8 and the fp KV cache (the
     fp-KV read's launch counts are those of the fp-KV paged branch).

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


def graph_ms(fns, launches: int = 24) -> float:
    """Device time of one call without the host: ``launches`` calls (cycling
    through ``fns``) captured in one CUDA graph, CUDA events around three
    replays of it."""
    for fn in fns:
        fn()                                  # build, allocator warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * launches)


def with_ratio(row: dict) -> dict:
    """The kernel's time over the library call's, in the same run."""
    lib = row.get("library_ms")
    return row | {"library_ratio": row["ms"] / lib if lib else None}


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


def _paged_case(name: str, case: str, slots: int, live: int, context: int,
                layers: int, hq: int, hkv: int, hd: int, kv_quant: bool,
                gen, path: str) -> dict:
    """One decode step of the paged kernel (``live`` of ``slots`` slots at
    ``context`` cached tokens) against its plain version: outputs within
    tolerance, pools (and scale pools) bit-equal after the append. ``ms``
    times a loop of wrapper calls, ``graph_ms`` the device time alone (a
    CUDA graph); both cycle over the layers, so every call finds its
    pages cold, as in decode."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention, paged_append_attention_plain)
    dev, bf16 = "cuda", torch.bfloat16
    bs = cfg_mod.SERVE_BLOCK_SIZE
    total = 512
    while total < context + 128:
        total *= 2
    width = total // bs
    n_blocks = 1 + slots * width
    shape = (layers, n_blocks, bs, hkv, hd)
    if kv_quant:
        k_pool = torch.randint(-127, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8)
        v_pool = torch.randint(-127, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8)
        scale_shape = (layers, n_blocks, hkv, bs)
        scales = [torch.rand(scale_shape, generator=gen, device=dev) * 0.02
                  + 0.001 for _ in range(2)]
    else:
        k_pool = torch.randn(shape, generator=gen, device=dev).to(bf16)
        v_pool = torch.randn(shape, generator=gen, device=dev).to(bf16)
        scales = []
    tables = torch.zeros((slots, width), dtype=torch.int32, device=dev)
    start = torch.zeros(slots, dtype=torch.int32, device=dev)
    n_valid = torch.zeros(slots, dtype=torch.int32, device=dev)
    for s in range(live):
        tables[s] = torch.arange(1 + s * width, 1 + (s + 1) * width)
        start[s] = context
        n_valid[s] = 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q = randn(slots, 1, hq, hd)
    k_new, v_new = randn(slots, 1, hkv, hd), randn(slots, 1, hkv, hd)
    pools = [k_pool, v_pool, *scales]
    refs = [x.clone() for x in pools]
    tscale = hd ** -0.5
    layer = min(5, layers - 1)
    got = paged_append_attention(q, k_new, v_new, k_pool, v_pool, tables,
                                 start, n_valid, *scales, layer=layer,
                                 scale=tscale)
    want = paged_append_attention_plain(q, k_new, v_new, refs[0], refs[1],
                                        tables, start, n_valid, *refs[2:],
                                        layer=layer, scale=tscale)
    cmp = _compare(f"{name} {case}", got[:live], want[:live])
    if not all(torch.equal(a, b) for a, b in zip(pools, refs)):
        raise AssertionError(f"{name} {case}: pools differ from plain")
    if not bool((got[live:] == 0).all()):
        raise AssertionError(f"{name} {case}: dead slots not zero")
    del refs, want, got
    ctx = live * context
    # bytes of one token's K (or V) row of one layer, with its scales
    row = hkv * hd * (1 if kv_quant else 2) + (hkv * 4 if kv_quant else 0)
    n_bytes = (2 * ctx * row                 # cached K and V of live slots
               + 2 * live * hkv * hd * 2     # new rows read (bf16)
               + 2 * live * row              # new rows written
               + live * hq * hd * 2          # q of live slots
               + slots * hq * hd * 2         # every slot's output
               + tables.numel() * 4 + 2 * slots * 4)
    flops = 4 * hq * hd * (ctx + live)
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    layer_cycle = iter(range(10 ** 9))

    def step(fn):   # a new layer each call: cold pages, as in decode
        return lambda: fn(q, k_new, v_new, k_pool, v_pool, tables, start,
                          n_valid, *scales, layer=next(layer_cycle) % layers,
                          scale=tscale)

    row_out = dict(
        name=name, case=case, route="cuda", path=path,
        counter=("paged_append_attention_int8" if kv_quant
                 else "paged_append_attention"),
        source="handwritten_ocr_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="handwritten_ocr_tpu/ops/paged_decode_attention.py:64",
        shape=[slots, 1, hq, hd], live_slots=live, context=context,
        pool=list(k_pool.shape), dtype="int8 KV, bf16 q" if kv_quant else "bf16",
        **cmp, ms=time_ms(step(paged_append_attention), iters=56),
        graph_ms=graph_ms([step(paged_append_attention)]),
        plain_ms=time_ms(step(paged_append_attention_plain), iters=10),
        library=None, library_ms=None, library_graph_ms=None,
        bound_ms=bound, bound_by=by)
    del k_pool, v_pool, scales, pools, q, k_new, v_new
    torch.cuda.empty_cache()
    return row_out


def _int8_matmul_case(case: str, m: int, d_in: int, d_out: int,
                      out_dtype, gen, path: str) -> dict:
    """The int8 matmul at a decode shape against its plain version; the
    library yardstick is ``torch.mm`` on the bf16 dequantised weight (it
    reads 2 bytes per weight where the kernel reads 1). ``ms`` times a
    back-to-back loop of wrapper calls, which the host can set at small N;
    ``graph_ms`` is the kernel's device time alone, from a CUDA graph of
    launches cycling through enough copies of the weight (>= 60 MB) that
    each launch reads it from device memory, as a decode step does;
    ``library_graph_ms`` the same for ``torch.mm`` over copies of the
    dequantised weight."""
    from handwritten_ocr_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                           int8_matmul_plain)
    dev = "cuda"
    x = torch.randn((m, d_in), generator=gen, device=dev).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, (d_out, d_in), generator=gen, device=dev,
                        dtype=torch.int8)
    scale = torch.rand(d_out, generator=gen, device=dev) * 1e-3 + 1e-4
    got = int8_matmul(x, w_q, scale, out_dtype=out_dtype)
    want = int8_matmul_plain(x, w_q, scale, out_dtype)
    cmp = _compare(f"int8_matmul {case}", got, want)
    del got, want
    out_bytes = 4 if out_dtype == torch.float32 else 2
    n_bytes = d_in * d_out + m * d_in * 2 + d_out * 4 + m * d_out * out_bytes
    bound, by = bound_ms(n_bytes, 2 * m * d_in * d_out, BF16_FLOPS_PER_S)
    w_deq = (w_q.to(torch.bfloat16) * scale[:, None].to(torch.bfloat16))
    copies = [w_q] + [w_q.clone() for _ in range(
        min(23, math.ceil(60e6 / w_q.numel()) - 1))]
    device_ms = graph_ms([lambda w=w: int8_matmul(x, w, scale, out_dtype=out_dtype)
                          for w in copies])
    del copies
    deq_copies = [w_deq] + [w_deq.clone() for _ in range(
        min(23, math.ceil(60e6 / (2 * w_deq.numel())) - 1))]
    library_device_ms = graph_ms([lambda w=w: torch.mm(x, w.t())
                                  for w in deq_copies])
    del deq_copies
    record = dict(
        name="int8_matmul", case=case, route="cuda", path=path,
        counter="int8_matmul",
        source="handwritten_ocr_tpu_torch/csrc/int8_matmul.cu",
        replaces="handwritten_ocr_tpu/ops/int8_matmul.py:25",
        shape=[m, d_in, d_out], dtype=f"bf16 x, int8 W, "
        f"{'fp32' if out_dtype == torch.float32 else 'bf16'} out", **cmp,
        ms=time_ms(lambda: int8_matmul(x, w_q, scale, out_dtype=out_dtype),
                   iters=20),
        graph_ms=device_ms,
        plain_ms=time_ms(lambda: int8_matmul_plain(x, w_q, scale, out_dtype),
                         iters=3),
        library="torch.mm on the bf16 dequantised weight",
        library_ms=time_ms(lambda: torch.mm(x, w_deq.t()), iters=20),
        library_graph_ms=library_device_ms,
        bound_ms=bound, bound_by=by)
    del x, w_q, scale, w_deq
    torch.cuda.empty_cache()
    return record


def phase_kernels_reasoning(qcfg, prompt_len: int) -> list[dict]:
    """The reasoner's kernel cases: flash prefill, int8 paged attention,
    the int8 matmul at the decode shapes (24 rows: every decode step runs
    all 24 slots' rows through the projections; 8: the live turns)."""
    import torch.nn.functional as F

    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    batch = 8
    hq, hkv, hd = (qcfg.num_attention_heads, qcfg.num_key_value_heads,
                   qcfg.head_dim)
    bucket = -(-prompt_len // cfg_mod.SERVE_PREFILL_BUCKET) * cfg_mod.SERVE_PREFILL_BUCKET
    q = torch.randn((batch, bucket, hq, hd), generator=gen, device=dev).to(bf16)
    k = torch.randn((batch, bucket, hkv, hd), generator=gen, device=dev).to(bf16)
    v = torch.randn((batch, bucket, hkv, hd), generator=gen, device=dev).to(bf16)
    tscale = hd ** -0.5
    got = flash_attention(q, k, v, causal=True, scale=tscale)
    want = flash_attention_plain(q, k, v, causal=True, scale=tscale)
    cmp = _compare("flash_attention qwen3 prefill", got, want)
    n_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    flops = 4 * batch * hq * hd * bucket * (bucket + 1) / 2
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    q_t, k_t, v_t = (x.transpose(1, 2) for x in (q, k, v))
    rows.append(dict(
        name="flash_attention", case="qwen3_prefill_causal", route="cuda",
        path="reasoning", counter="flash_attention",
        source="handwritten_ocr_tpu_torch/csrc/flash_attention.cu",
        replaces="handwritten_ocr_tpu/ops/flash_attention.py:30",
        shape=[batch, bucket, hq, hd], dtype="bf16", **cmp,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True, scale=tscale)),
        plain_ms=time_ms(lambda: flash_attention_plain(
            q, k, v, causal=True, scale=tscale), iters=3),
        library="F.scaled_dot_product_attention (is_causal, enable_gqa)",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q_t, k_t, v_t, is_causal=True, scale=tscale, enable_gqa=True)),
        bound_ms=bound, bound_by=by))
    del q, k, v, q_t, k_t, v_t, got, want
    torch.cuda.empty_cache()
    rows.append(_paged_case(
        "paged_append_attention", "qwen3_decode_int8", cfg_mod.SERVE_SLOTS,
        batch, prompt_len + 64, qcfg.num_hidden_layers, hq, hkv, hd, True,
        gen, "reasoning"))
    d, ffn, vocab = qcfg.hidden_size, qcfg.intermediate_size, qcfg.vocab_size
    slots = cfg_mod.SERVE_SLOTS
    for case, m, d_in, d_out, out_dtype in (
            ("gate_m8", 8, d, ffn, bf16), ("gate_m24", slots, d, ffn, bf16),
            ("down_m24", slots, ffn, d, bf16),
            ("k_m24", slots, d, hkv * hd, bf16),
            ("lm_head_m8", 8, d, vocab, torch.float32),
            ("lm_head_m24", slots, d, vocab, torch.float32)):
        rows.append(_int8_matmul_case(case, m, d_in, d_out, out_dtype, gen,
                                      "reasoning"))
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


def phase_kernels(cfg, prompt_len: int) -> list[dict]:
    """Each kernel against its plain version at the read's shapes."""
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
        path="ocr_read", counter="flash_attention",
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
        path="ocr_read", counter="window_attention",
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
        path="ocr_read", counter="flash_attention",
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

    # -- paged append + attention: one decode step, 8 live of 24 slots,
    # over int8 pools (the read's default) and over bf16 pools
    for kv_quant, case, path in ((True, "decode_step_int8", "ocr_read"),
                                 (False, "decode_step", "reference_fp_kv")):
        rows.append(_paged_case(
            "paged_append_attention", case, cfg_mod.SERVE_SLOTS, batch,
            prompt_len + 64, txt.num_hidden_layers, hq, hkv, thd, kv_quant,
            gen, path))
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


def _counters():
    """(counter name, wrapper, attribute) of every kernel launch count."""
    from handwritten_ocr_tpu_torch.ops.flash_attention import flash_attention
    from handwritten_ocr_tpu_torch.ops.int8_matmul import int8_matmul
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention)
    from handwritten_ocr_tpu_torch.ops.window_attention import (
        window_attention)
    return (("flash_attention", flash_attention, "launches"),
            ("window_attention", window_attention, "launches"),
            ("paged_append_attention", paged_append_attention, "launches"),
            ("paged_append_attention_int8", paged_append_attention,
             "int8_launches"),
            ("int8_matmul", int8_matmul, "launches"))


def reset_launches() -> None:
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def require_launches(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {path} path")


def check_pools(cache, what: str) -> None:
    """Finite pools: the fp pools themselves, or the scale pools of an
    int8 cache (an int8 value is always finite); block 0 is the trash
    sink."""
    pools = ((cache.k_scale, cache.v_scale) if cache.quantized
             else (cache.k, cache.v))
    if not all(bool(torch.isfinite(p[:, 1:].float()).all()) for p in pools):
        raise AssertionError(f"non-finite values in the {what} KV pools")
    if cache.quantized and not bool((cache.k_scale[:, 1:] > 0).any()):
        raise AssertionError(f"the {what} scale pools were never written")


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
    n_params = _count_params(params)
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
    require_launches("OCR read", launches, (
        "flash_attention", "window_attention", "paged_append_attention_int8"))
    cache = batcher.cache
    if not cache.quantized:
        raise AssertionError("the read did not decode over the int8 KV cache")
    check_pools(cache, "read's")
    stats = {**backend.stats, **batcher.stats}
    record = dict(
        phase="main_path", kv_cache="int8", params=n_params, init_s=init_s,
        pages=len(pages),
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
    phase_trace("ocr_read", lambda budget: backend.read_batch(
        images, OCR_PROMPT, budget))
    del backend, params, batcher, cache
    torch.cuda.empty_cache()
    return record


def _profiled(run, budget: int):
    """(wall s, device-busy s, {kernel: (launches, device s)}) of one call
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(budget)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = {e.key: (e.count, e.self_device_time_total / 1e6)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}
    return wall, sum(t for _, t in device.values()), device


def phase_trace(path: str, run, short: int = 8, long: int = 40) -> dict:
    """Two more calls of the same inputs under ``torch.profiler`` (after
    the timed call, so the timed numbers carry no tracing cost), with
    ``short`` and ``long`` new tokens. Their difference isolates decode
    steps: device time and wall time per step, the device's busy share of
    a decode step, and each kernel's device ms and launches per step. The
    profiler slows the host, so under tracing the busy share is a lower
    bound. None where the profiler saw no device time."""
    w_short, b_short, k_short = _profiled(run, short)
    w_long, b_long, k_long = _profiled(run, long)
    steps = long - short
    seen = bool(k_long)
    per_step = []
    for name, (count, secs) in k_long.items():
        count0, secs0 = k_short.get(name, (0, 0.0))
        per_step.append({"name": name[:80],
                         "launches": (count - count0) / steps,
                         "ms": (secs - secs0) / steps * 1e3})
    per_step.sort(key=lambda k: -k["ms"])
    record = dict(
        phase="trace", path=path, max_new_tokens=[short, long],
        read_wall_s=w_long, read_device_busy_s=b_long if seen else None,
        read_busy_share=b_long / w_long if seen else None,
        decode_step_wall_ms=(w_long - w_short) / steps * 1e3,
        decode_step_device_ms=(b_long - b_short) / steps * 1e3 if seen else None,
        decode_busy_share=(b_long - b_short) / (w_long - w_short) if seen else None,
        decode_step_kernels=per_step[:16])
    emit(**record)
    return record


def _count_params(tree) -> int:
    """Parameters of a tree; the fp32 scales of int8 weights are not
    parameters."""
    if isinstance(tree, dict):
        return sum(_count_params(v) for k, v in tree.items() if k != "w_scale")
    if isinstance(tree, list):
        return sum(_count_params(v) for v in tree)
    return tree.numel()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def spelling_tokenizer():
    """A ByteTokenizer whose decode spells every id, so that compared
    texts carry the whole greedy token stream."""
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer

    class Spelling(ByteTokenizer):
        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)
    return Spelling()


class Turn:
    def __init__(self, system: str, user: str):
        self.system, self.user = system, user


EDITOR_SYSTEM = ("You are a careful editor of handwritten-page "
                 "transcriptions. Correct obvious OCR errors, keep the "
                 "author's wording, and return the whole corrected page.")


def editor_turns(n: int, user_chars: int = 950) -> list[Turn]:
    """``n`` editor-style turns: the system prompt and a transcription of
    ~``user_chars`` characters (one token each under ``ByteTokenizer``),
    words drawn from a seed."""
    rng = np.random.default_rng(SEED + 3)
    words = ("the", "letter", "was", "written", "in", "march", "and",
             "sent", "to", "my", "dear", "sister", "who", "lived", "near",
             "old", "mill", "road", "we", "had", "rain", "for", "days")
    turns = []
    for _ in range(n):
        text = []
        while sum(len(w) + 1 for w in text) < user_chars:
            text.append(str(rng.choice(words)))
        turns.append(Turn(EDITOR_SYSTEM,
                          "Correct this transcription:\n" + " ".join(text)))
    return turns


def phase_reasoning(qcfg, turns: list[Turn], max_new_tokens: int = 128) -> dict:
    """qwen3:32b (published widths and depth, int8 weights drawn from a
    seed) through ``TorchReasoningBackend.chat_batch`` over the int8 KV
    cache: one warm-up call, then the timed call with every launch count
    set to 0 before it and read after it; then two traced calls."""
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    from handwritten_ocr_tpu_torch.models.quant import quantized_bytes
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_qwen3(qcfg, dtype=torch.bfloat16, device="cuda", seed=SEED,
                        quantize="int8")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = _count_params(params)
    weight_bytes = quantized_bytes(params)
    backend = TorchReasoningBackend(Qwen3Model(params, qcfg), ByteTokenizer(),
                                    kv_quant=True)
    kw = dict(temperature=0.1, max_tokens=max_new_tokens)
    backend.chat_batch(turns, **kw)          # warm-up: cuBLAS, pools
    batcher = backend._batcher
    batcher.stats.update(prefill_s=0.0, decode_s=0.0, decode_tokens=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    texts = backend.chat_batch(turns, **kw)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_launches()
    if len(texts) != len(turns) or not all(isinstance(t, str) for t in texts):
        raise AssertionError("chat_batch returned the wrong number of texts")
    if backend._batcher is not batcher:
        raise AssertionError("the timed call rebuilt the batcher")
    require_launches("reasoning", launches, (
        "flash_attention", "paged_append_attention_int8", "int8_matmul"))
    cache = batcher.cache
    if not cache.quantized:
        raise AssertionError("the reasoner did not decode over int8 KV")
    check_pools(cache, "reasoner's")
    stats = batcher.stats
    steps = stats["decode_tokens"] / len(turns)
    step_ms = stats["decode_s"] / steps * 1e3
    prompt_tokens = [len(backend._encode(t.system, t.user)) for t in turns]
    # The least time of a decode step: every int8 weight read once (the
    # embedding is a row gather) plus the live slots' int8 KV window.
    read_bytes = weight_bytes - params["embed"]["w"].numel() * 2
    layers, hkv, hd = (qcfg.num_hidden_layers, qcfg.num_key_value_heads,
                       qcfg.head_dim)
    kv_per_token = layers * 2 * (hkv * hd + hkv * 4)
    mean_ctx = float(np.mean(prompt_tokens)) + max_new_tokens / 2
    floor_ms = (read_bytes + len(turns) * mean_ctx * kv_per_token) \
        / HBM_BYTES_PER_S * 1e3
    record = dict(
        phase="reasoning", model="qwen3:32b (Qwen3Config())", weights="int8",
        kv_cache="int8", params=n_params, weight_bytes=weight_bytes,
        init_s=init_s, init_peak_memory_gb=init_peak, turns=len(turns),
        prompt_tokens=prompt_tokens, max_new_tokens=max_new_tokens,
        call_s=call_s, prefill_s=stats["prefill_s"],
        decode_s=stats["decode_s"], decode_tokens=stats["decode_tokens"],
        decode_tokens_per_s=stats["decode_tokens"] / stats["decode_s"],
        decode_step_ms=step_ms, step_floor_ms=floor_ms,
        kv_bytes_per_token=kv_per_token,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        scale_pools_finite=True, launches=launches)
    emit(**record)
    phase_trace("reasoning", lambda budget: backend.chat_batch(
        turns, temperature=0.1, max_tokens=budget))
    del backend, params, batcher, cache
    torch.cuda.empty_cache()
    return record


def _reference_vl(kv_quant: bool) -> dict:
    from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel

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
    out, launches = {}, None
    for device, params in (("cuda", _to(cpu_params, "cuda")),
                           ("cpu", cpu_params)):
        prep = TorchPreprocessor(min_pixels=28 * 28, device=device)
        images = [prep.apply(np.ascontiguousarray(p), s)
                  for p in pages for s in strategies]
        backend = TorchOCRBackend(VLModel(params, cfg), spelling_tokenizer(),
                                  device=device, kv_quant=kv_quant)
        if device == "cuda":
            reset_launches()
        out[device] = backend.read_batch(images, "Read the page.", 16)
        if device == "cuda":
            launches = read_launches()
    return dict(texts=out, launches=launches)


def _reference_qwen3(kv_quant: bool) -> dict:
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    cfg = Qwen3Config(vocab_size=152000, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1,
                      head_dim=128, eos_token_id=-1)
    cpu_params = init_qwen3(cfg, dtype=torch.float32, device="cpu",
                            seed=SEED + 4, quantize="int8")
    turns = [Turn("sys", "Correct: teh cat sat"), Turn(
        EDITOR_SYSTEM, "Correct this transcription:\nwe had rain for days")]
    out, launches = {}, None
    for device, params in (("cuda", _to(cpu_params, "cuda")),
                           ("cpu", cpu_params)):
        backend = TorchReasoningBackend(Qwen3Model(params, cfg),
                                        spelling_tokenizer(), device=device,
                                        kv_quant=kv_quant)
        if device == "cuda":
            reset_launches()
        out[device] = backend.chat_batch(turns, temperature=0.1,
                                         max_tokens=16)
        if device == "cuda":
            launches = read_launches()
    return dict(texts=out, launches=launches)


def phase_reference() -> dict:
    """Narrow models at the kernels' head widths (vision 80, text 128) in
    fp32, each run on the card (kernels) and on the CPU (plain versions)
    with the int8 and with the fp KV cache; the greedy tokens must be
    equal. The VL read reads two small pages; the Qwen3 (QK-norm, int8
    weights) answers two chat turns. Returns the launch counts of each
    card run."""
    record = dict(phase="reference", equal=True)
    launches = {}
    for name, run in (("vl", _reference_vl), ("qwen3", _reference_qwen3)):
        for kv_quant in (True, False):
            key = f"{name}_{'int8' if kv_quant else 'fp'}_kv"
            result = run(kv_quant)
            texts = result["texts"]
            if texts["cuda"] != texts["cpu"]:
                raise AssertionError(f"{key}: card and CPU differ: {texts}")
            record[f"{key}_tokens"] = sum(len(t.split()) for t in texts["cpu"])
            launches[key] = result["launches"]
    require_launches("fp-KV read", launches["vl_fp_kv"],
                     ("paged_append_attention",))
    require_launches("int8 Qwen3 reference", launches["qwen3_int8_kv"],
                     ("paged_append_attention_int8", "int8_matmul"))
    record["launches"] = launches
    emit(**record)
    return record


def main() -> int:
    from handwritten_ocr_tpu_torch.config import OCR_PROMPT
    from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                            llm_chat_prompt,
                                                            vlm_chat_prompt)
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config

    info = phase_device()
    t_start = time.perf_counter()
    phase_build()
    cfg = VLConfig()                        # olmOCR-2-7B / Qwen2.5-VL-7B widths
    n_image = (924 // 14) * (672 // 14) // 4
    prompt_len = (len(ByteTokenizer().encode(vlm_chat_prompt(OCR_PROMPT, 1)))
                  - 1 + n_image)
    # qwen3:32b at its published widths and depth; no EOS id, so random
    # weights decode to the budget (as bench.py does)
    qcfg = Qwen3Config(eos_token_id=-1)
    turns = editor_turns(8)
    q_prompt_len = max(len(ByteTokenizer().encode(llm_chat_prompt(
        t.system, t.user))) for t in turns)
    rows = phase_kernels(cfg, prompt_len)
    rows += phase_kernels_reasoning(qcfg, q_prompt_len)
    paths = {"ocr_read": phase_main_path(cfg, prompt_len)["launches"]}
    paths["reasoning"] = phase_reasoning(qcfg, turns)["launches"]
    reference = phase_reference()
    # The fp-KV paged branch runs on no default path any more (both
    # engines default to int8 KV): its count is the fp-KV reference read's.
    paths["reference_fp_kv"] = reference["launches"]["vl_fp_kv"]
    kernels = []
    for r in rows:
        kernels.append({key: r[key] for key in (
            "name", "case", "route", "source", "replaces", "path")}
            | {"launches": paths[r["path"]][r["counter"]]}
            | {key: r[key] for key in ("max_abs_err", "tolerance",
                                       "rel_rms_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_ratio")}
            | {key: r.get(key) for key in ("graph_ms", "library_graph_ms")})
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": info["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
