"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the device, and ``nvidia-smi``'s name and power limit of the card;
  2. build the CUDA kernels from ``handwritten_ocr_tpu_torch/csrc`` (one
     ``nvcc`` per source, all started together);
  3. each kernel at the read's and the reasoner's shapes against its
     plain PyTorch version on the card, with its time, the plain
     version's time, the time of one PyTorch library call where one
     computes the same function, the kernel's time over that call's
     (library_ratio), and the least time the card could take (bound):
     flash, window and paged
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
  6. guided: qwen3:32b at int8 (as 5, built anew and kept) answers the
     critic's and the editor's prompts for 8 transcriptions through
     schema-guided ``chat_batch`` at a 256-token budget; every text must
     parse and validate against its contract; counts set to 0 before and
     read after;
  7. pool_plan: olmOCR-2-7B (bf16) joins the resident qwen3:32b; one
     ``coresident_plan`` for the card (``plan_pools``: both resident
     trees, the card's memory, ``config.ACTIVATION_RESERVE_BYTES``) hands
     each engine its pool budget, and both batchers are built at the
     default budgets' context bounds (OCR: prompt + 2048 new tokens;
     reasoner: the agents' prompts + 4096, 16384 for the arbitrator); the
     plan must fit and the allocated peak stay under the card's memory;
     also the full pools' plan at the same bounds (``pipeline_plan``),
     which does not fit;
  8. cli: the port's CLI (``cli.transcribe.main(argv, pipeline=...)``)
     with those engines and pools over a folder of the four contract
     pages (PNG files read without PIL through ``TorchPreprocessor``),
     128 OCR and 256 agent tokens: ``--lockstep --max-iterations 2``
     (also the pipeline path's ``LockstepPipeline.run_many``: every page
     must end at a terminal node by a legal walk of ``graph/routing.py``
     and its four artifacts must be its final state's), then
     ``--skip-existing`` (no read, no launch), then one page in
     single-file mode with ``--snapshot`` (one iteration), then
     ``cli.eval_final``; the
     counts are set to 0 before the CLI calls and read after them;
  9. pipeline: ``OCRPipeline.run`` resumes one page from a snapshot at
     its re-OCR node (re-OCR read, arbitrator, critic again) with the
     same engines and pools; the walk must pass through reocr;
 10. loaders: narrow VL and Qwen3 snapshots in HF layout (config.json,
     sharded safetensors + index, a hand-written byte-level
     tokenizer.json) written with the port's writer and loaded through
     ``from_pretrained`` on the card (the Qwen3 one quantised at load);
     trees and greedy tokens must equal engines built from the in-memory
     trees; a 1600x1200 PNG page (not 28-aligned) is resized on the card
     bit-equal to the CPU, and ``_pack_one`` packs it on the host;
 11. reference checks: narrow models in fp32 on the card (kernels) and on
     the CPU (plain versions) must give the same tokens: the VL read and a
     Qwen3 with int8 weights, each with the int8 and the fp KV cache (the
     fp-KV read's launch counts are those of the fp-KV paged branch); the
     same int8 Qwen3 through ``run_guided`` for the three agent schemas
     (the same committed tokens and objects); and sharpen, denoise and
     remove_lines on one ruled page (sharpen bit-equal, denoise within 3
     levels, remove_lines' mask bit-equal and its page within 1 level; the
     mask must hold the ruled lines), with the card's time of each
     transform;
 12. each kernel again at the shapes the guided and pipeline runs gave
     it, taken from those runs: flash prefill at each agent's largest
     prefill group, int8 paged attention at its longest prompt plus the
     budget, and vision flash, window, the VL prefill and the read's
     paged attention at every read batch other than 8.

Phases 6-9 and 11 decode through ``DenseTokenizer``: every id decodes to one
character, so random weights write texts of their budget's length (with
quotes, digits and braces among them) as a real tokenizer would, where
``ByteTokenizer`` decodes the ids above 255 to nothing.

Every failed check raises, so the script exits non-zero and prints no
result. Without a CUDA card it exits non-zero at once. The last line is
``{"ok": true, "device": {...}}``; the kernels line (each kernel's
launches on its own path and on the guided, pipeline and cli paths) and
the card's name and power limit come before it.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
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


def _flash_case(case: str, path: str, batch: int, t: int, hq: int,
                hkv: int, hd: int, gen, *, causal: bool = False,
                valid=None) -> dict:
    """Flash attention at q ``[batch, t, hq, hd]``, k/v ``[batch, t, hkv,
    hd]`` (bf16) against its plain version: ``valid`` ``[t]`` masks the
    vision tower's dead slots, ``causal`` is the prefill. The plain
    version holds several fp32 copies of the scores, so it runs a few
    batch rows at a time (at most 2 GiB of scores per call); its output
    and ``plain_ms`` cover the whole batch."""
    import torch.nn.functional as F

    from handwritten_ocr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    dev, bf16 = "cuda", torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v = randn(batch, t, hq, hd), randn(batch, t, hkv, hd), \
        randn(batch, t, hkv, hd)
    scale = hd ** -0.5
    kw = dict(causal=causal, scale=scale)
    step = max(1, int(2 * 2 ** 30 // (hq * t * t * 4)))

    def plain():
        return torch.cat([flash_attention_plain(
            q[i:i + step], k[i:i + step], v[i:i + step], valid, **kw)
            for i in range(0, batch, step)])

    got = flash_attention(q, k, v, valid, **kw)
    cmp = _compare(f"flash_attention {case}", got, plain())
    del got
    n_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    if valid is not None:
        live = int(valid.sum())
        n_bytes += t
        flops = 4 * batch * hq * hd * live * live
    elif causal:
        flops = 4 * batch * hq * hd * t * (t + 1) / 2
    else:
        flops = 4 * batch * hq * hd * t * t
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    q_t, k_t, v_t = (x.transpose(1, 2) for x in (q, k, v))
    if valid is not None:
        library = "F.scaled_dot_product_attention (bool key mask)"
        sdpa = dict(attn_mask=valid[None, :])
    else:
        library = "F.scaled_dot_product_attention (is_causal, enable_gqa)"
        sdpa = dict(is_causal=causal, enable_gqa=True)
    row = dict(
        name="flash_attention", case=case, route="cuda", path=path,
        counter="flash_attention",
        source="handwritten_ocr_tpu_torch/csrc/flash_attention.cu",
        replaces="handwritten_ocr_tpu/ops/flash_attention.py:30",
        shape=[batch, t, hq, hd], kv_heads=hkv, dtype="bf16", **cmp,
        ms=time_ms(lambda: flash_attention(q, k, v, valid, **kw)),
        plain_ms=time_ms(plain, iters=3), plain_rows_per_call=step,
        library=library,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q_t, k_t, v_t, scale=scale, **sdpa)),
        bound_ms=bound, bound_by=by)
    del q, k, v, q_t, k_t, v_t
    torch.cuda.empty_cache()
    return row


def _window_case(case: str, path: str, batch: int, plan, num_heads: int,
                 head_dim: int, gen) -> dict:
    """Window attention at qkv ``[batch, P, 3 * heads * head_dim]`` (bf16,
    the vision tower's window layers, rope on load) against its plain
    version; the library yardstick is SDPA per window over q/k that are
    not roped."""
    import torch.nn.functional as F

    from handwritten_ocr_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)
    dev = "cuda"
    valid = torch.as_tensor(plan.valid, device=dev)
    p_len, d = len(plan.valid), num_heads * head_dim
    scale = head_dim ** -0.5
    qkv = torch.randn((batch, p_len, 3 * d), generator=gen,
                      device=dev).to(torch.bfloat16)
    cos = torch.as_tensor(plan.cos_pad, device=dev)
    sin = torch.as_tensor(plan.sin_pad, device=dev)
    kw = dict(num_heads=num_heads, window_len=plan.window_len, scale=scale)
    got = window_attention(qkv, cos, sin, valid, **kw)
    want = window_attention_plain(qkv, cos, sin, valid, **kw)
    cmp = _compare(f"window_attention {case}", got, want)
    del got, want
    n_win, wl = plan.n_windows, plan.window_len
    live_per_win = plan.valid.reshape(n_win, wl).sum(axis=1)
    flops = 4 * batch * num_heads * head_dim * float((live_per_win ** 2).sum())
    n_bytes = qkv.numel() * 2 + batch * p_len * d * 2 + 2 * cos.numel() * 4 + p_len
    bound, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    qw = qkv.reshape(batch, n_win, wl, 3, num_heads, head_dim)
    qw = qw.permute(3, 0, 1, 4, 2, 5).reshape(3, batch * n_win, num_heads,
                                              wl, head_dim)
    win_mask = valid.reshape(n_win, 1, 1, wl).repeat(batch, 1, 1, 1)
    row = dict(
        name="window_attention", case=case, route="cuda", path=path,
        counter="window_attention",
        source="handwritten_ocr_tpu_torch/csrc/window_attention.cu",
        replaces="handwritten_ocr_tpu/ops/window_attention.py:194",
        shape=[batch, p_len, 3 * d], dtype="bf16", **cmp,
        ms=time_ms(lambda: window_attention(qkv, cos, sin, valid, **kw)),
        plain_ms=time_ms(lambda: window_attention_plain(qkv, cos, sin, valid,
                                                        **kw), iters=3),
        library="F.scaled_dot_product_attention per window (q/k not roped)",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qw[0], qw[1], qw[2], attn_mask=win_mask, scale=scale)),
        bound_ms=bound, bound_by=by)
    del qkv, qw
    torch.cuda.empty_cache()
    return row


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
    from handwritten_ocr_tpu_torch import config as cfg_mod
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    batch = 8
    hq, hkv, hd = (qcfg.num_attention_heads, qcfg.num_key_value_heads,
                   qcfg.head_dim)
    bucket = -(-prompt_len // cfg_mod.SERVE_PREFILL_BUCKET) * cfg_mod.SERVE_PREFILL_BUCKET
    rows = [_flash_case("qwen3_prefill_causal", "reasoning", batch, bucket,
                        hq, hkv, hd, gen, causal=True)]
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
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    vis, txt = cfg.vision, cfg.text
    plan = plan_grid(vis, (1, 924 // 14, 672 // 14))
    batch = 8                                  # 4 pages x 2 strategies
    valid = torch.as_tensor(plan.valid, device="cuda")
    bucket = -(-prompt_len // cfg_mod.SERVE_PREFILL_BUCKET) * cfg_mod.SERVE_PREFILL_BUCKET
    hq, hkv, thd = txt.num_attention_heads, txt.num_key_value_heads, txt.head_dim
    rows = [
        # vision global layers: [8, P, 16, 80], dead-slot key mask
        _flash_case("vision_global", "ocr_read", batch, len(plan.valid),
                    vis.num_heads, vis.num_heads, vis.head_dim, gen,
                    valid=valid),
        # window layers: qkv [8, P, 3*1280]
        _window_case("vision_window", "ocr_read", batch, plan, vis.num_heads,
                     vis.head_dim, gen),
        # causal prefill: q [8, T, 28, 128], k/v [8, T, 4, 128]
        _flash_case("prefill_causal", "ocr_read", batch, bucket, hq, hkv, thd,
                    gen, causal=True)]

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


def _prefill_group(prompt_tokens: list[int]) -> tuple[int, int]:
    """(bucket, rows) of the largest prefill call the batcher makes for
    one call's prompts (``ContinuousBatcher._prefill_groups``: prompts pad
    to a multiple of SERVE_PREFILL_BUCKET and group by bucket, each group
    capped at PREFILL_GROUP_TOKENS padded tokens)."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.engine.serving import ContinuousBatcher
    unit = cfg_mod.SERVE_PREFILL_BUCKET
    buckets = [max(unit, -(-n // unit) * unit) for n in prompt_tokens]
    bucket = max(buckets)
    rows = min(buckets.count(bucket),
               max(1, ContinuousBatcher.PREFILL_GROUP_TOKENS // bucket))
    return bucket, rows


def phase_kernels_paths(cfg, qcfg, prompt_len: int, seen: dict) -> list[dict]:
    """Each kernel again at the shapes the guided and pipeline runs gave
    it, taken from those runs (``seen[path]``): for every agent, flash
    prefill at the bucket and rows of its longest call's largest prefill
    group, and int8 paged attention with that call's turns live at the
    longest prompt plus the agent budget (64:8 heads); for every OCR read
    batch other than the read phase's 8, vision flash, window, the VL
    prefill and int8 paged attention (28:4 heads, prompt plus the OCR
    budget) at that batch. Runs last, when no model is resident."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid

    emit(phase="kernels_paths", resident_gb=torch.cuda.memory_allocated()
         / 2 ** 30)             # what is left of the models, if anything
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    vis, txt = cfg.vision, cfg.text
    plan = plan_grid(vis, (1, 924 // 14, 672 // 14))
    valid = torch.as_tensor(plan.valid, device="cuda")
    unit = cfg_mod.SERVE_PREFILL_BUCKET
    vl_bucket = -(-prompt_len // unit) * unit
    slots = cfg_mod.SERVE_SLOTS
    rows = []
    for path, run in seen.items():
        for agent, calls in run["agent_prompt_tokens"].items():
            longest = max(calls, key=max)
            bucket, n = _prefill_group(longest)
            rows.append(_flash_case(
                f"qwen3_{agent}_prefill_causal", path, n, bucket,
                qcfg.num_attention_heads, qcfg.num_key_value_heads,
                qcfg.head_dim, gen, causal=True))
            rows.append(_paged_case(
                "paged_append_attention", f"qwen3_{agent}_decode_int8", slots,
                min(len(longest), slots), max(longest) + run["llm_budget"],
                qcfg.num_hidden_layers, qcfg.num_attention_heads,
                qcfg.num_key_value_heads, qcfg.head_dim, True, gen, path))
        for b in sorted(set(run.get("read_batches", ())) - {8}):
            rows += [
                _flash_case(f"vision_global_b{b}", path, b, len(plan.valid),
                            vis.num_heads, vis.num_heads, vis.head_dim, gen,
                            valid=valid),
                _window_case(f"vision_window_b{b}", path, b, plan,
                             vis.num_heads, vis.head_dim, gen),
                _flash_case(f"prefill_causal_b{b}", path, b, vl_bucket,
                            txt.num_attention_heads, txt.num_key_value_heads,
                            txt.head_dim, gen, causal=True),
                _paged_case("paged_append_attention", f"decode_step_int8_b{b}",
                            slots, b, prompt_len + run["ocr_budget"],
                            txt.num_hidden_layers, txt.num_attention_heads,
                            txt.num_key_value_heads, txt.head_dim, True, gen,
                            path)]
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


def dense_tokenizer():
    """A ByteTokenizer (same prompts, same special ids) whose decode gives
    one character per id (id mod 256)."""
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer

    class DenseTokenizer(ByteTokenizer):
        def decode(self, ids):
            return "".join(chr(int(i) % 256) for i in ids)
    return DenseTokenizer()


def guided_requests(turns: list[Turn]):
    """The critic's and the editor's requests (``agents/runners.py``) for
    the transcriptions of ``turns``."""
    from handwritten_ocr_tpu_torch.agents.runners import (critic_request,
                                                          editor_request)
    from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
    texts = [t.user.split("\n", 1)[1] for t in turns]
    return {"critic": [critic_request(t) for t in texts],
            "editor": [editor_request(t, CriticResult()) for t in texts]}


def _guided_stats(batcher) -> dict:
    keys = ("prefill_s", "decode_s", "topk_steps", "string_steps",
            "guided_tokens", "session_s", "sessions", "sessions_complete")
    return {key: batcher.stats[key] for key in keys}


def _reset_guided_stats(batcher) -> None:
    for key in _guided_stats(batcher):
        batcher.stats[key] = 0.0 if key.endswith("_s") else 0


def phase_guided(qcfg, turns: list[Turn], card: str,
                 max_new_tokens: int = 256):
    """qwen3:32b (published widths and depth, int8 weights from a seed,
    int8 KV) answers the critic's and then the editor's prompts for the 8
    transcriptions through schema-guided ``chat_batch``; each text must
    parse and validate against its contract. One short warm-up call
    first; the launch counts are set to 0 before the two timed calls and
    read after them. ``card`` (nvidia-smi's name and power limit) goes
    into every record. Returns (the backend, kept for the pipeline; the
    path's launches; its prompt lengths per agent call and budget, for
    ``phase_kernels_paths``)."""
    from handwritten_ocr_tpu_torch.agents.schemas import (CriticResult,
                                                          EditorResult)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.utils.jsonio import extract_json

    params = init_qwen3(qcfg, dtype=torch.bfloat16, device="cuda", seed=SEED,
                        quantize="int8")
    backend = TorchReasoningBackend(Qwen3Model(params, qcfg),
                                    dense_tokenizer(), kv_quant=True)
    requests = guided_requests(turns)
    contracts = {"critic": CriticResult, "editor": EditorResult}
    kw = dict(temperature=0.1, max_tokens=max_new_tokens)
    backend.chat_batch(requests["critic"], temperature=0.1, max_tokens=8,
                       json_schema=requests["critic"][0].schema)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    total, prompts = {}, {}
    for agent in ("critic", "editor"):
        batch = requests[agent]
        batcher = backend._batcher
        _reset_guided_stats(batcher)
        t0 = time.perf_counter()
        texts = backend.chat_batch(batch, json_schema=batch[0].schema, **kw)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        if backend._batcher is not batcher:
            raise AssertionError("the timed guided call rebuilt the batcher")
        stats = _guided_stats(batcher)
        for text in texts:
            parsed = extract_json(text)
            if parsed is None:
                raise AssertionError(f"guided {agent} text does not parse: "
                                     f"{text[:200]!r}")
            contracts[agent].validate(parsed)
        prompts[agent] = [[len(backend._encode(r.system, r.user))
                           for r in batch]]
        emit(phase="guided", card=card, agent=agent,
             model="qwen3:32b (Qwen3Config())",
             weights="int8", kv_cache="int8", tokenizer="DenseTokenizer",
             turns=len(batch), max_new_tokens=max_new_tokens,
             prompt_tokens=prompts[agent][0],
             call_s=call_s, **stats,
             tokens_per_s=stats["guided_tokens"] / call_s,
             validated=len(texts), sample=texts[0][:160])
        for key, value in stats.items():
            total[key] = total.get(key, 0) + value
    launches = read_launches()
    require_launches("guided", launches, (
        "flash_attention", "paged_append_attention_int8", "int8_matmul"))
    if total["sessions_complete"] != total["sessions"]:
        raise AssertionError(f"guided sessions not complete: {total}")
    emit(phase="guided_path", card=card, **total,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    return backend, launches, dict(agent_prompt_tokens=prompts,
                                   llm_budget=max_new_tokens)


class PagePreprocessor:
    """The pipeline's preprocessor over in-memory pages: maps a page's
    name (the state's ``image_path``) to its array and runs the strategy
    chain through ``TorchPreprocessor`` (the card's machine has no PIL to
    read files with)."""

    def __init__(self, pages: dict):
        from handwritten_ocr_tpu_torch.engine.torch_engines import (
            TorchPreprocessor)
        self.pages = pages
        self.torch_prep = TorchPreprocessor()

    def apply(self, image_path: str, strategy):
        prepared = self.torch_prep.apply(self.pages[image_path], strategy)
        prepared.source_path = image_path
        return prepared


def _observe(obj, name: str, on_call):
    """Wrap the method ``name`` of ``obj`` (an instance or a class): it
    runs unchanged, and ``on_call(seconds, args, kwargs)`` sees each call's
    host seconds. Returns a function that takes the wrapper off again."""
    method = getattr(obj, name)
    original = obj.__dict__.get(name)

    @functools.wraps(method)       # keeps the signature callers inspect
    def observed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return method(*args, **kwargs)
        finally:
            on_call(time.perf_counter() - t0, args, kwargs)
    setattr(obj, name, observed)

    def restore():
        if original is None:
            delattr(obj, name)
        else:
            setattr(obj, name, original)
    return restore


def instrument(pipeline, nodes, llm=None, ocr=None) -> tuple[dict, object]:
    """Per-node-kind seconds and calls of ``pipeline`` (an instance, or
    the pipeline class when the CLI builds the instance), agent calls by
    contract and OCR reads by strategy, observed on its methods and on the
    backends (``llm`` / ``ocr``, default the pipeline's): also each agent
    call's prompt lengths and each read's batch size, the shapes its
    kernels ran at. Returns (the record, a function that takes every
    observer off again)."""
    record = {"node_s": {}, "node_calls": {}, "agent_rows": {},
              "agent_calls": {}, "agent_prompt_tokens": {}, "ocr_reads": {},
              "ocr_calls": 0, "read_batches": []}
    llm = llm or pipeline.llm
    ocr = ocr or pipeline.ocr

    def node_hook(kind):
        def on_call(seconds, args, kwargs):
            record["node_s"][kind] = record["node_s"].get(kind, 0.0) + seconds
            record["node_calls"][kind] = record["node_calls"].get(kind, 0) + 1
        return on_call

    restores = [_observe(pipeline, method, node_hook(kind))
                for method, kind in nodes.items()]

    def on_chat(seconds, args, kwargs):
        schema = kwargs.get("json_schema")
        name = schema.get("title", "?") if schema else "free"
        turns = ([(r.system, r.user) for r in args[0]]
                 if isinstance(args[0], list) else [args[:2]])
        record["agent_calls"][name] = record["agent_calls"].get(name, 0) + 1
        record["agent_rows"][name] = (record["agent_rows"].get(name, 0)
                                      + len(turns))
        record["agent_prompt_tokens"].setdefault(name, []).append(
            [len(llm._encode(system, user)) for system, user in turns])

    def on_read(seconds, args, kwargs):
        record["ocr_calls"] += 1
        record["read_batches"].append(len(args[0]))
        for image in args[0]:
            label = image.strategy_label
            record["ocr_reads"][label] = record["ocr_reads"].get(label, 0) + 1

    restores += [_observe(llm, "chat_batch", on_chat),
                 _observe(llm, "chat", on_chat),
                 _observe(ocr, "read_batch", on_read)]

    def restore():     # also breaks the pipeline -> wrapper -> pipeline cycles
        for undo in restores:
            undo()
    return record, restore


def run_from_reocr(pipeline, state: dict, snapshot_path: str) -> dict:
    """One page through ``OCRPipeline.run`` resumed at its re-OCR node.
    The page's real initial reads and first critique run through the
    pipeline's nodes; the critique's verdict is set to ``needs_reocr``
    (with random weights the critic's enum step answers it on no page),
    and the state is saved as the snapshot a run leaves before that node.
    ``run(resume=True)`` then reads the page with the next unused
    strategy, arbitrates the two versions, critiques again and ends."""
    from pathlib import Path

    from handwritten_ocr_tpu_torch.graph.routing import route_after_critic
    state = dict(state)
    state.update(pipeline.node_initial_ocr(state))
    state.update(pipeline.node_critic(state))
    state["critiques"] = state["critiques"][:-1] + [
        dict(state["critiques"][-1], verdict="needs_reocr")]
    if route_after_critic(state) != "reocr":
        raise AssertionError(f"{state['image_path']}: the snapshot routes to "
                             f"{route_after_critic(state)}, not reocr")
    Path(snapshot_path).write_text(json.dumps(
        {"next_node": "reocr", "state": state}), encoding="utf-8")
    return pipeline.run(state, snapshot_path=snapshot_path, resume=True)


def check_walk(state: dict) -> list[str]:
    """The node walk of a finished page, checked against
    ``graph/routing.py``: after the initial reads, every critique routes
    as ``route_after_critic`` says for the critiques so far (plateau
    count replayed), each edit and each re-OCR returns to the critic, and
    the walk ends at the terminal node its last route names. Returns the
    node sequence."""
    from handwritten_ocr_tpu_torch.graph.routing import route_after_critic

    actions = [e["action"] for e in state["trace_events"]]
    if "merge" not in actions:
        raise AssertionError(f"{state['image_path']}: no initial merge")
    rest = actions[actions.index("merge") + 1:]
    walk, critiques, plateau, prev = ["initial_ocr"], [], 0, 0.0
    terminal = {"accept": "accept", "plateau": "plateau",
                "max_iterations": "max_iterations",
                "strategies_exhausted": "max_iterations"}
    i = 0
    while i < len(rest):
        if rest[i] != "critique":
            raise AssertionError(f"{state['image_path']}: expected a "
                                 f"critique at {rest[i:]}")
        critique = state["critiques"][len(critiques)]
        critiques.append(critique)
        confidence = critique["overall_confidence"]
        plateau = plateau + 1 if confidence <= prev else 0
        prev = confidence
        route = route_after_critic({
            "critiques": critiques, "config": state["config"],
            "plateau_count": plateau, "iteration": len(critiques),
            "max_iterations": state["max_iterations"]})
        walk.append("critic")
        i += 1
        if route in ("accept", "plateau", "max_iterations"):
            if rest[i:] != [route]:
                raise AssertionError(f"{state['image_path']}: route {route} "
                                     f"but the walk goes on {rest[i:]}")
            walk.append(route)
            break
        if route == "edit":
            expect = ["edit"]
        elif rest[i:i + 1] == ["strategies_exhausted"]:
            walk.append("reocr")
            walk.append(terminal[rest[i]])
            if rest[i + 1:]:
                raise AssertionError(f"{state['image_path']}: walk goes on "
                                     "after strategies ran out")
            break
        else:
            expect = ["preprocess", "ocr", "arbitrate"]
        if rest[i:i + len(expect)] != expect:
            raise AssertionError(f"{state['image_path']}: route {route} "
                                 f"expects {expect}, got {rest[i:]}")
        walk.append("editor" if route == "edit" else "reocr")
        i += len(expect)
    if walk[-1] not in terminal.values():
        raise AssertionError(f"{state['image_path']}: no terminal node")
    if state["status"] not in ("completed", "max_iterations") or \
            not state["reason"] or not isinstance(state["current_best"], str):
        raise AssertionError(f"{state['image_path']}: bad final state")
    return walk


def _kv_bytes_per_token(layers: int, kv_heads: int, head_dim: int) -> int:
    """int8 K and V rows of one token over all layers, with their fp32
    per-head scales."""
    return layers * 2 * kv_heads * (head_dim + 4)


def planned_pool_bytes(layers: int, kv_heads: int, head_dim: int,
                       needed_context: int) -> int:
    """Bytes of the int8 KV pools an engine allocates for
    ``needed_context`` (the context bound rounds up to a power of two,
    floor 512; 24 slots; block 0 the trash sink), worked out from the
    config without allocating."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    context = 512
    while context < needed_context:
        context *= 2
    bs = cfg_mod.SERVE_BLOCK_SIZE
    blocks = 1 + cfg_mod.SERVE_SLOTS * (-(-context // bs))
    return blocks * bs * _kv_bytes_per_token(layers, kv_heads, head_dim)


class BudgetCap:
    """An engine whose token budgets are capped at ``cap``: the CLI's
    ``RunConfig`` carries the default budgets (2048 OCR / 4096 agent
    tokens), and the smoke run decodes at the pipeline phase's 128 / 256
    over pools planned for the defaults. Everything else is the engine's."""

    def __init__(self, engine, cap: int):
        self.engine, self.cap = engine, cap

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def read_batch(self, images, prompt, max_new_tokens):
        return self.engine.read_batch(images, prompt,
                                      min(max_new_tokens, self.cap))

    def read(self, image, prompt, max_new_tokens):
        return self.read_batch([image], prompt, max_new_tokens)[0]

    def chat(self, system_prompt, user_message, *, temperature, max_tokens,
             json_schema=None):
        return self.engine.chat(system_prompt, user_message,
                                temperature=temperature,
                                max_tokens=min(max_tokens, self.cap),
                                json_schema=json_schema)

    def chat_batch(self, requests, *, temperature, max_tokens,
                   json_schema=None):
        return self.engine.chat_batch(requests, temperature=temperature,
                                      max_tokens=min(max_tokens, self.cap),
                                      json_schema=json_schema)


BUDGETS = dict(ocr_max_new_tokens=128, llm_max_tokens=256)


def _default_contexts(reasoner, prompt_len: int) -> tuple[int, dict]:
    """The context each engine needs at the default budgets: the OCR
    read's prompt + OCR_MAX_NEW_TOKENS; each agent's prompt with
    full-budget transcriptions (its template's tokens + OCR_MAX_NEW_TOKENS
    per transcription it quotes) + LLM_MAX_TOKENS."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.agents.runners import (arbitrator_request,
                                                          critic_request,
                                                          editor_request)
    from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
    templates = {
        "critic": (critic_request(""), 1),
        "editor": (editor_request("", CriticResult()), 1),
        "arbitrator": (arbitrator_request([
            {"text": "", "source": "current_best", "score": 0},
            {"text": "", "source": "ocr_deskew+high_contrast+sharpen"}]), 2)}
    llm_context = {
        agent: len(reasoner._encode(r.system, r.user))
        + n * cfg_mod.OCR_MAX_NEW_TOKENS + cfg_mod.LLM_MAX_TOKENS
        for agent, (r, n) in templates.items()}
    return prompt_len + cfg_mod.OCR_MAX_NEW_TOKENS, llm_context


def _pool_bytes(cache) -> int:
    pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                  if cache.quantized else [])
    return sum(p.numel() * p.element_size() for p in pools)


def phase_pool_plan(cfg, reasoner, prompt_len: int, card: str):
    """olmOCR-2-7B (bf16, random from a seed) joins the guided phase's
    resident qwen3:32b. One ``coresident_plan`` for the card hands each
    engine its pool budget (``plan_pools``); then both batchers are built
    at the default budgets' context bounds: the OCR read's prompt +
    OCR_MAX_NEW_TOKENS, and the agents' prompts + LLM_MAX_TOKENS (the
    arbitrator's, the largest, rounds to 16384). Requires the plan to fit
    and the allocated peak with both models and both pools in place to
    stay under the card's memory. Also the old ``pipeline_plan`` record:
    full pools (1 + slots x blocks) at the same bounds, which do not fit.
    Returns the OCR engine."""
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, plan_pools)
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.quant import quantized_bytes
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel

    params = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED)
    ocr = TorchOCRBackend(VLModel(params, cfg), reasoner.tokenizer)
    ocr_context, llm_context = _default_contexts(reasoner, prompt_len)

    txt, q = cfg.text, reasoner.model.config
    ocr_pools = planned_pool_bytes(
        txt.num_hidden_layers, txt.num_key_value_heads, txt.head_dim,
        ocr_context)
    llm_pools = {agent: planned_pool_bytes(
        q.num_hidden_layers, q.num_key_value_heads, q.head_dim, needed)
        for agent, needed in llm_context.items()}
    weights = _count_params(params) * 2 + quantized_bytes(reasoner.model.params)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    total = weights + ocr_pools + max(llm_pools.values())
    emit(phase="pipeline_plan", card=card, weight_bytes=weights,
         ocr_pool_bytes=ocr_pools, llm_needed_context=llm_context,
         llm_pool_bytes=llm_pools, total_bytes=total, card_bytes=card_bytes,
         fits=total < card_bytes)

    plan = plan_pools(ocr, reasoner)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batchers = {"ocr": ocr._ensure_batcher(ocr_context),
                "reasoner": reasoner._ensure_batcher(max(llm_context.values()))}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engines = {"ocr": ocr, "reasoner": reasoner}
    pools = {}
    for name, batcher in batchers.items():
        full = 1 + batcher.n_slots * batcher.max_blocks
        pools[name] = dict(
            max_context=batcher.max_context, n_blocks=batcher.n_blocks,
            full_n_blocks=full, slots_at_full_context=(batcher.n_blocks - 1)
            / batcher.max_blocks, budget_bytes=engines[name].pool_bytes,
            pool_bytes=_pool_bytes(batcher.cache))
        if pools[name]["pool_bytes"] > engines[name].pool_bytes:
            raise AssertionError(f"{name} pools exceed their budget: "
                                 f"{pools[name]}")
    record = dict(
        phase="pool_plan", card=card, card_bytes=card_bytes,
        plan=plan.components, plan_total_bytes=plan.total_per_chip,
        fits=plan.fits, report=plan.report().splitlines(),
        ocr_needed_context=ocr_context, llm_needed_context=llm_context,
        pools=pools, build_s=build_s,
        memory_allocated=torch.cuda.memory_allocated(),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(**record)
    if not plan.fits:
        raise AssertionError(f"the pool plan does not fit the card: {record}")
    if record["max_memory_allocated"] >= card_bytes:
        raise AssertionError(f"peak memory above the card's: {record}")
    return ocr, record


def _capture(cls, name: str, out: list):
    """Wrap ``cls.name``: each call's return value is appended to
    ``out``. Returns the function that takes the wrapper off."""
    method = getattr(cls, name)

    @functools.wraps(method)
    def captured(*args, **kwargs):
        result = method(*args, **kwargs)
        out.append(result)
        return result
    setattr(cls, name, captured)
    return lambda: setattr(cls, name, method)


def _check_artifacts(out_dir, stems, finals=None) -> None:
    """Every page's four artifacts: a str transcription, a trace that is
    the state's trace (when ``finals`` are given), a summary, and an eval
    that parses."""
    from pathlib import Path
    out_dir = Path(out_dir)
    for i, stem in enumerate(stems):
        paths = {kind: out_dir / f"{stem}_{kind}" for kind in (
            "transcription.txt", "trace.json", "trace_summary.txt",
            "eval.json")}
        missing = [str(p) for p in paths.values() if not p.exists()]
        if missing:
            raise AssertionError(f"missing artifacts: {missing}")
        # bytes, not read_text: that would turn a "\r" of the text into "\n"
        text = paths["transcription.txt"].read_bytes().decode("utf-8")
        trace = json.loads(paths["trace.json"].read_text(encoding="utf-8"))
        evaluation = json.loads(paths["eval.json"].read_text(encoding="utf-8"))
        if not isinstance(text, str) or "pipeline_status" not in evaluation \
                or "tier1_raw_vs_gt" not in evaluation:
            raise AssertionError(f"{stem}: bad transcription or eval")
        if finals is not None:
            if text != finals[i]["current_best"] or \
                    [e["action"] for e in trace] != \
                    [e["action"] for e in finals[i]["trace_events"]]:
                raise AssertionError(f"{stem}: artifacts differ from the "
                                     "final state")


def phase_cli(ocr, reasoner, card: str) -> dict:
    """The port's CLI (``cli.transcribe.main(argv, pipeline=...)``) over
    a folder of the four contract pages (924x672 PNG files, the pixels of
    ``synthetic_pages(4)``), with the engines and pools of ``pool_plan``
    and the pipeline phase's budgets (``BudgetCap``): the pages are read
    from the files through ``TorchPreprocessor``, so the PNG reader and
    the card's resize path run. In order:
    1. ``--lockstep --max-iterations 2`` with a ground-truth file per page:
       this run is also the pipeline path's ``run_many`` (its record keeps
       the pipeline phase's keys); every page must end by a legal walk and
       its four artifacts must be the final state's;
    2. the same command with ``--skip-existing``: no read, no launch;
    3. one page in single-file mode with ``--snapshot`` and
       ``--max-iterations 1`` (initial reads and one critique);
    4. ``cli.eval_final`` over the folder's results.
    Counts set to 0 before the CLI calls and read after them (the cli
    path's launches: all three calls); flash, window, paged int8 and the
    int8 matmul must be launched. Returns the records and the shapes the
    lockstep run gave the kernels."""
    import shutil
    import tempfile
    from pathlib import Path

    from handwritten_ocr_tpu_torch.cli import eval_final, transcribe
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchPreprocessor)
    from handwritten_ocr_tpu_torch.graph.batch_driver import LockstepPipeline
    from handwritten_ocr_tpu_torch.graph.driver import OCRPipeline
    from handwritten_ocr_tpu_torch.models.processor import load_image_rgb

    work = tempfile.TemporaryDirectory()
    root = Path(work.name)
    pages, gt, out, single = (root / d for d in ("pages", "gt", "out",
                                                 "single"))
    pages.mkdir()
    gt.mkdir()
    stems = [f"page{i}" for i in range(4)]
    source = Path(__file__).resolve().parent / ".contract_pages"
    decode_ms = []
    for stem in stems:
        shutil.copy(source / f"{stem}.png", pages / f"{stem}.png")
        (gt / f"{stem}.md").write_text(
            "## Ground Truth\nthe letter was written in march\n",
            encoding="utf-8")
        t0 = time.perf_counter()
        load_image_rgb(pages / f"{stem}.png")
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    ocr_c = BudgetCap(ocr, BUDGETS["ocr_max_new_tokens"])
    llm_c = BudgetCap(reasoner, BUDGETS["llm_max_tokens"])
    pipeline = OCRPipeline(ocr_c, llm_c, preprocessor=TorchPreprocessor(),
                           quiet=True)
    argv = [str(pages), "--output-dir", str(out), "--ground-truth-dir",
            str(gt), "--lockstep", "--max-iterations", "2", "--quiet"]
    nodes = {"_initial_ocr_all": "initial_ocr", "_critic_round": "critic",
             "_editor_round": "editor", "_reocr_round": "reocr"}

    finals: list = []
    undo_capture = _capture(LockstepPipeline, "run_many", finals)
    record, restore = instrument(LockstepPipeline, nodes, llm=llm_c,
                                 ocr=ocr_c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):    # its chatter
            transcribe.main(argv, pipeline=pipeline)
        torch.cuda.synchronize()
    finally:
        restore()
        undo_capture()
    lockstep_s = time.perf_counter() - t0
    lockstep_launches = read_launches()
    [finals] = finals
    walks = [check_walk(state) for state in finals]
    require_launches("cli lockstep", lockstep_launches, (
        "flash_attention", "window_attention",
        "paged_append_attention_int8", "int8_matmul"))
    _check_artifacts(out, stems, finals)
    run_many = dict(
        pages=len(finals), pipeline_s=lockstep_s,
        pages_per_s=len(finals) / lockstep_s, **record, walks=walks,
        reasons=[s["reason"] for s in finals],
        iterations=[s["iteration"] for s in finals],
        transcription_chars=[len(s["current_best"]) for s in finals],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=lockstep_launches)
    emit(phase="pipeline", card=card, run="run_many", max_iterations=2,
         accept_threshold=finals[0]["config"]["accept_threshold"], **BUDGETS,
         driven_by="cli --lockstep",
         **run_many)

    # 2. --skip-existing: every page's transcription exists
    reads = {"n": 0}
    undo = _observe(ocr_c, "read_batch",
                    lambda *_: reads.__setitem__("n", reads["n"] + 1))
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as said:
            transcribe.main(argv + ["--skip-existing"], pipeline=pipeline)
    finally:
        undo()
    skip_s = time.perf_counter() - t0
    skip_launches = read_launches()
    if reads["n"] or any(skip_launches.values()) or \
            said.getvalue().count("(transcription exists)") != len(stems):
        raise AssertionError(f"--skip-existing read pages again: {reads}, "
                             f"{skip_launches}, {said.getvalue()!r}")

    # 3. one page, single-file mode, with snapshots
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        transcribe.main([str(pages / "page0.png"), "--output-dir",
                         str(single), "--ground-truth", str(gt / "page0.md"),
                         "--max-iterations", "1", "--snapshot", "--quiet"],
                        pipeline=pipeline)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_launches = read_launches()
    _check_artifacts(single, ["page0"])
    if (single / "page0_state.json").exists():     # removed once finished
        raise AssertionError("the single page left its snapshot behind")
    require_launches("cli single page", single_launches, (
        "flash_attention", "window_attention",
        "paged_append_attention_int8", "int8_matmul"))

    # 4. the standalone evaluator over the folder's results
    eval_path = root / "eval_all.json"
    with contextlib.redirect_stdout(io.StringIO()):
        eval_final.main([str(out), "--ground-truth-dir", str(gt),
                         "--output", str(eval_path)])
    evaluated = json.loads(eval_path.read_text())
    if len(evaluated) != len(stems) or not all(
            "tier1_raw_vs_gt" in r for r in evaluated):
        raise AssertionError(f"eval_final: {evaluated}")
    work.cleanup()
    launches = {name: lockstep_launches[name] + skip_launches[name]
                + single_launches[name] for name in lockstep_launches}
    cli = dict(phase="cli", card=card, pages=len(stems), **BUDGETS,
               lockstep_s=lockstep_s, seconds_per_page=lockstep_s / len(stems),
               skip_existing_s=skip_s, single_page_s=single_s,
               png_decode_ms=decode_ms, artifacts_per_page=4,
               cer=[r["tier1_raw_vs_gt"]["cer"] for r in evaluated],
               launches=launches, lockstep_launches=lockstep_launches,
               single_launches=single_launches)
    emit(**cli)
    seen = {"agent_prompt_tokens": {}, "read_batches": record["read_batches"],
            "llm_budget": BUDGETS["llm_max_tokens"],
            "ocr_budget": BUDGETS["ocr_max_new_tokens"]}
    for name, calls in record["agent_prompt_tokens"].items():
        seen["agent_prompt_tokens"].setdefault(
            name.removesuffix("Result").lower(), []).extend(calls)
    return {"cli": cli, "run_many": run_many, "seen": seen}


def phase_pipeline(ocr, reasoner, card: str, seen: dict) -> dict:
    """Both models resident, with the pools of ``pool_plan``:
    ``OCRPipeline.run`` on one page resumed at its re-OCR node
    (``run_from_reocr``; max_iterations 2, no accept by confidence alone,
    128 OCR and 256 agent tokens), so the re-OCR read, the arbitrator and
    the re-OCR strategies run at full width. (The pipeline path's
    ``run_many`` is the CLI's lockstep run, ``phase_cli``.) Launch counts
    set to 0 before the run and read after it; the walk must be legal and
    pass through reocr. ``card`` (nvidia-smi's name and power limit) goes
    into the record. Adds the run's kernel shapes to ``seen`` (for
    ``phase_kernels_paths``) and returns the run."""
    import tempfile

    from handwritten_ocr_tpu_torch.config import RunConfig
    from handwritten_ocr_tpu_torch.graph.driver import OCRPipeline
    from handwritten_ocr_tpu_torch.state import initial_state

    pages = {f"page{i}": p for i, p in enumerate(synthetic_pages(4))}
    prep = PagePreprocessor(pages)
    # 101: no confidence accepts on its own, only the verdict does
    run_cfg = RunConfig(max_iterations=2, accept_threshold=101, **BUDGETS)
    snapshot_dir = tempfile.TemporaryDirectory()
    pipeline = OCRPipeline(ocr, reasoner, preprocessor=prep, quiet=True)
    nodes = {f"node_{k}": k for k in ("initial_ocr", "critic", "editor",
                                      "reocr")}
    record, restore = instrument(pipeline, nodes)
    state = initial_state("page0", config=run_cfg.as_state_dict(),
                          max_iterations=run_cfg.max_iterations)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    final = run_from_reocr(pipeline, state, snapshot_dir.name + "/page0.json")
    torch.cuda.synchronize()
    pipeline_s = time.perf_counter() - t0
    launches = read_launches()
    restore()
    snapshot_dir.cleanup()
    walk = check_walk(final)
    require_launches("pipeline run", launches, (
        "flash_attention", "window_attention",
        "paged_append_attention_int8", "int8_matmul"))
    if "reocr" not in walk or "ArbitratorResult" not in record["agent_calls"]:
        raise AssertionError(f"the resumed page did not re-OCR and "
                             f"arbitrate: {walk}, {record['agent_calls']}")
    for name, calls in record["agent_prompt_tokens"].items():
        seen["agent_prompt_tokens"].setdefault(
            name.removesuffix("Result").lower(), []).extend(calls)
    seen["read_batches"] = seen["read_batches"] + record["read_batches"]
    run = dict(pages=1, pipeline_s=pipeline_s, pages_per_s=1 / pipeline_s,
               **record, walks=[walk], reasons=[final["reason"]],
               iterations=[final["iteration"]],
               transcription_chars=[len(final["current_best"])],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    emit(phase="pipeline", card=card, run="run",
         max_iterations=run_cfg.max_iterations,
         accept_threshold=run_cfg.accept_threshold, **BUDGETS, **run)
    return run


def byte_level_tokenizer_json() -> dict:
    """A hand-written byte-level BPE ``tokenizer.json`` in the Qwen2
    layout: the 256 byte symbols (id = byte), a few merges, and the chat
    template's added tokens at Qwen's ids (specials and the non-special
    think tags)."""
    from handwritten_ocr_tpu_torch.models.tokenizer import bytes_to_unicode
    table = bytes_to_unicode()
    vocab = {table[b]: b for b in range(256)}
    merges = []
    for pair in ("Ġ t", "h e", "Ġt he", "i n", "e r", "Ġ a", "o n", "r e",
                 "Ġ w", "a n", "e n", "Ċ Ċ"):
        left, right = pair.split(" ")
        vocab[left + right] = len(vocab)
        merges.append(pair)
    pattern = ("(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|"
               "\\p{N}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|"
               "\\s+(?!\\S)|\\s+")
    specials = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
                "<|im_end|>": 151645, "<|vision_start|>": 151652,
                "<|vision_end|>": 151653, "<|image_pad|>": 151655}
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for c, i in specials.items()]
    added += [{"id": i, "content": c, "single_word": False, "lstrip": False,
               "rstrip": False, "normalized": False, "special": False}
              for c, i in (("<think>", 151667), ("</think>", 151668))]
    return {"version": "1.0", "added_tokens": added,
            "normalizer": {"type": "NFC"},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": pattern},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "trim_offsets": False, "use_regex": False}]},
            "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                        "trim_offsets": False, "use_regex": False},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "",
                      "end_of_word_suffix": "", "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


class SpelledTokens:
    """Encodes with ``tokenizer``, decodes to the ids themselves, so that
    compared texts carry the whole greedy token stream."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def encode(self, text):
        return self.tokenizer.encode(text)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def phase_loaders(card: str) -> dict:
    """Snapshots and page files on the card, with narrow models (the
    reference phase's widths, bf16 as checkpoints ship):
    - a VL and a Qwen3 snapshot in HF layout (``config.json``, two
      ``*.safetensors`` shards and their index, a hand-written byte-level
      ``tokenizer.json``), written with the port's safetensors writer and
      loaded through ``from_pretrained`` on the card (the Qwen3 one
      quantised to int8 at load); each tree must equal the in-memory one
      (int8: ``quantize_tree`` of it), and one greedy read / one chat
      batch must give the same tokens as engines built from the in-memory
      trees;
    - a 1600x1200 PNG page (not 28-aligned) written with the port's PNG
      writer and read back: its smart resize on the card must be
      bit-equal to the CPU's, ``_pack_one`` of the unaligned page must
      take the host path (``pack_image``'s patches and grid), and a read
      of the unaligned page must run."""
    import tempfile
    from pathlib import Path

    from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
    from handwritten_ocr_tpu_torch.engine.protocols import PreparedImage
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
    from handwritten_ocr_tpu_torch.models.png import write_png
    from handwritten_ocr_tpu_torch.models.processor import (
        aligned_smart_size, load_image_rgb, pack_image)
    from handwritten_ocr_tpu_torch.models.quant import quantize_tree
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
    from handwritten_ocr_tpu_torch.models.tokenizer import BPETokenizer
    from handwritten_ocr_tpu_torch.models.weights import save_snapshot

    work = tempfile.TemporaryDirectory()
    root = Path(work.name)
    spec = json.dumps(byte_level_tokenizer_json())
    vl_cfg = VLConfig(
        vision=VisionConfig(depth=4, hidden_size=160, intermediate_size=320,
                            num_heads=2, fullatt_block_indexes=(1, 3),
                            out_hidden_size=256),
        text=TextConfig(hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=2,
                        num_key_value_heads=1))
    q_cfg = Qwen3Config(vocab_size=152000, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=1,
                        head_dim=128)
    record = dict(phase="loaders", card=card)
    t0 = time.perf_counter()
    vl_tree = init_vl(vl_cfg, dtype=torch.bfloat16, device="cpu", seed=SEED + 8)
    q_tree = init_qwen3(q_cfg, dtype=torch.bfloat16, device="cpu", seed=SEED + 9)
    for name, tree, cfg in (("vl", vl_tree, vl_cfg), ("qwen3", q_tree, q_cfg)):
        save_snapshot(root / name, tree, cfg, shards=2)
        (root / name / "tokenizer.json").write_text(spec, encoding="utf-8")
    record["write_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vl_loaded = TorchOCRBackend.from_pretrained(root / "vl")
    q_loaded = TorchReasoningBackend.from_pretrained(root / "qwen3",
                                                     quantize="int8")
    record["load_s"] = time.perf_counter() - t0
    tokenizer = BPETokenizer.from_dir(root / "vl")
    vl_memory = TorchOCRBackend(VLModel(_to(vl_tree, "cuda"), vl_cfg),
                                SpelledTokens(tokenizer))
    q_memory = TorchReasoningBackend(
        Qwen3Model(quantize_tree(_to(q_tree, "cuda")), q_cfg),
        SpelledTokens(tokenizer))
    if not (_trees_equal(vl_loaded.model.params, vl_memory.model.params)
            and _trees_equal(q_loaded.model.params, q_memory.model.params)):
        raise AssertionError("trees loaded from the snapshots differ from "
                             "the in-memory trees")
    vl_loaded.tokenizer = SpelledTokens(vl_loaded.tokenizer)
    q_loaded.tokenizer = SpelledTokens(q_loaded.tokenizer)

    page_path = Path(__file__).resolve().parent / ".contract_pages/page0.png"
    prep = TorchPreprocessor()
    images = [prep.apply(str(page_path), s)
              for s in PREPROCESSING_STRATEGIES[:2]]
    reads = {name: engine.read_batch(images, "Read the page.", 16)
             for name, engine in (("snapshot", vl_loaded),
                                  ("memory", vl_memory))}
    turns = [Turn("sys", "Correct: teh cat sat"),
             Turn(EDITOR_SYSTEM, "Correct this transcription:\nthe letter")]
    chats = {name: engine.chat_batch(turns, temperature=0.1, max_tokens=16)
             for name, engine in (("snapshot", q_loaded),
                                  ("memory", q_memory))}
    if reads["snapshot"] != reads["memory"] or \
            chats["snapshot"] != chats["memory"]:
        raise AssertionError(f"snapshot and in-memory engines differ: "
                             f"{reads}, {chats}")
    record.update(read_tokens=sum(len(t.split()) for t in reads["memory"]),
                  chat_tokens=sum(len(t.split()) for t in chats["memory"]),
                  prompt_tokens=len(q_loaded._encode("sys",
                                                     "Correct: teh cat sat")))

    # an unaligned page file
    big = synthetic_pages(1, 1600, 1200)[0]
    big_path = root / "big.png"
    write_png(big_path, big)
    t0 = time.perf_counter()
    pixels = load_image_rgb(big_path)
    record["png_decode_ms_1600x1200"] = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(pixels, big):
        raise AssertionError("the PNG page does not read back")
    target = aligned_smart_size(1600, 1200)
    card_page = TorchPreprocessor()._load_aligned(str(big_path))
    cpu_page = TorchPreprocessor(device="cpu")._load_aligned(str(big_path))
    if tuple(card_page.shape[:2]) != target or \
            not torch.equal(card_page.cpu(), cpu_page):
        raise AssertionError("the card's resize differs from the CPU's")
    patches, grid = vl_memory._pack_one(pixels)
    host = pack_image(pixels)
    if grid != host.grid or not torch.equal(
            patches.cpu(), torch.from_numpy(host.patches)):
        raise AssertionError("_pack_one did not take the host path")
    raw = PreparedImage(data=pixels, strategy_label="original",
                        source_path=str(big_path))
    [text] = vl_memory.read_batch([raw], "Read the page.", 16)
    record.update(unaligned_page=[1600, 1200], resized_to=list(target),
                  grid=list(grid), resize_bit_equal=True, host_pack=True,
                  unaligned_read_tokens=len(text.split()))
    work.cleanup()
    emit(**record)
    return record


def _reference_guided() -> dict:
    """A narrow Qwen3 with int8 weights in fp32 over the int8 KV cache
    through ``ContinuousBatcher.run_guided`` (2 slots, 3 requests) on the
    card and on the CPU, for the three agent schemas: the objects,
    complete flags and committed tokens must be equal."""
    from handwritten_ocr_tpu_torch.agents.schemas import (ArbitratorResult,
                                                          CriticResult,
                                                          EditorResult)
    from handwritten_ocr_tpu_torch.engine.serving import (ContinuousBatcher,
                                                          GenRequest,
                                                          PagedProgram)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.processor import llm_chat_prompt
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config

    cfg = Qwen3Config(vocab_size=152000, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1,
                      head_dim=128)
    cpu_params = init_qwen3(cfg, dtype=torch.float32, device="cpu",
                            seed=SEED + 5, quantize="int8")
    tokenizer = dense_tokenizer()
    prompts = [tokenizer.encode(llm_chat_prompt(system, user)) for system, user
               in (("Return JSON.", "Correct: teh cat sat"),
                   ("Review the page.", "we had rain for days"),
                   ("sys", "the letter was written in march"))]
    record, launches = {}, {}
    for contract in (CriticResult, EditorResult, ArbitratorResult):
        out = {}
        for device, params in (("cuda", _to(cpu_params, "cuda")),
                               ("cpu", cpu_params)):
            batcher = ContinuousBatcher(
                PagedProgram(params, cfg), n_slots=2, block_size=128,
                max_context=512, chunk=8, prefill_bucket=128,
                dtype=torch.float32, device=device, kv_quant=True)
            requests = [GenRequest(np.asarray(ids, np.int32), 48)
                        for ids in prompts]
            if device == "cuda":
                reset_launches()
            results = batcher.run_guided(requests, contract.json_schema(),
                                         tokenizer)
            if device == "cuda":
                launches[contract.__name__] = read_launches()
            out[device] = (results, [r.tokens for r in requests])
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"guided {contract.__name__}: card and CPU "
                                 f"differ: {out}")
        record[contract.__name__] = dict(
            committed_tokens=sum(len(t) for t in out["cpu"][1]),
            complete=[c for _, c in out["cpu"][0]])
    return dict(record=record, launches=launches)


def ruled_page():
    """A synthetic 924x672 page ruled like notebook paper: 13 lines of 624
    px, longer than ``line_mask``'s width // 4 opening, so it finds them."""
    page = synthetic_pages(1)[0].copy()
    for y in range(90, 900, 64):
        page[y:y + 2, 24:-24] = 70
    return torch.from_numpy(page)


def _reference_transforms() -> dict:
    """sharpen, denoise and remove_lines on one ruled 924x672 page, on the
    card and on the CPU: sharpen bit-equal, denoise within 3 levels
    (PARITY.md's colored bound), remove_lines' mask bit-equal and its page
    within 1 level. The mask must hold the ruled lines and remove_lines
    must change the page. With the card's time of each transform."""
    from handwritten_ocr_tpu_torch.ops.bank import TRANSFORMS
    from handwritten_ocr_tpu_torch.ops.gray import rgb_to_gray
    from handwritten_ocr_tpu_torch.ops.lines import line_mask

    page = ruled_page()
    mask = line_mask(rgb_to_gray(page))
    if not bool(mask[90:92, 200:400].all()):
        raise AssertionError("line_mask misses the ruled lines")
    if torch.equal(TRANSFORMS["remove_lines"](page), page):
        raise AssertionError("remove_lines left the ruled page unchanged")
    cases = (("sharpen", TRANSFORMS["sharpen"], 0),
             ("denoise", TRANSFORMS["denoise"], 3),
             ("remove_lines", TRANSFORMS["remove_lines"], 1),
             ("line_mask", lambda x: line_mask(rgb_to_gray(x)), 0))
    out = {}
    for name, fn, tol in cases:
        gpu = fn(page.cuda()).cpu()
        cpu = fn(page)
        err = int((gpu.int() - cpu.int()).abs().max())
        if err > tol:
            raise AssertionError(f"{name}: card and CPU differ by {err} "
                                 f"levels (tolerance {tol})")
        iters = 2 if name == "denoise" else 10
        out[name] = dict(max_abs_err=err, tolerance=tol,
                         differing_pixels=int((gpu != cpu).sum()),
                         ms=time_ms(lambda: fn(page.cuda()), iters=iters,
                                    warmup=1))
    return out


def phase_reference(card: str) -> dict:
    """Narrow models at the kernels' head widths (vision 80, text 128) in
    fp32, each run on the card (kernels) and on the CPU (plain versions)
    with the int8 and with the fp KV cache; the greedy tokens must be
    equal. The VL read reads two small pages; the Qwen3 (QK-norm, int8
    weights) answers two chat turns. Returns the launch counts of each
    card run."""
    record = dict(phase="reference", card=card, equal=True)
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
    guided = _reference_guided()
    for name, counts in guided["launches"].items():
        require_launches(f"guided {name} reference", counts,
                         ("paged_append_attention_int8", "int8_matmul"))
    record["guided"] = guided["record"]
    launches["guided"] = guided["launches"]
    record["transforms"] = _reference_transforms()
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
    # The guided and pipeline phases decode with the published EOS id.
    reasoner, paths["guided"], guided_seen = phase_guided(
        Qwen3Config(), turns, info["smi"])
    ocr, _ = phase_pool_plan(cfg, reasoner, prompt_len, info["smi"])
    cli = phase_cli(ocr, reasoner, info["smi"])
    paths["cli"] = cli["cli"]["launches"]
    run = phase_pipeline(ocr, reasoner, info["smi"], cli["seen"])
    # the pipeline path: the CLI's lockstep run and the resumed run, each
    # counted from 0
    paths["pipeline"] = {name: cli["run_many"]["launches"][name]
                         + run["launches"][name] for name in run["launches"]}
    del reasoner, ocr
    gc.collect()                # both models go before the last phases
    torch.cuda.empty_cache()
    phase_loaders(info["smi"])
    reference = phase_reference(info["smi"])
    # The fp-KV paged branch runs on no default path any more (both
    # engines default to int8 KV): its count is the fp-KV reference read's.
    paths["reference_fp_kv"] = reference["launches"]["vl_fp_kv"]
    rows += phase_kernels_paths(cfg, Qwen3Config(), prompt_len, {
        "guided": guided_seen, "pipeline": cli["seen"]})
    kernels = []
    for r in rows:
        kernels.append({key: r[key] for key in (
            "name", "case", "route", "source", "replaces", "path")}
            | {"launches": paths[r["path"]][r["counter"]]}
            | {key: r[key] for key in ("max_abs_err", "tolerance",
                                       "rel_rms_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_ratio")}
            | {key: r.get(key) for key in ("graph_ms", "library_graph_ms")}
            | {f"{path}_launches": paths[path][r["counter"]]
               for path in ("guided", "pipeline", "cli")})
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": info["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
