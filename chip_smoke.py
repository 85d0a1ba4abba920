"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

The read, reasoning, pool_plan and train phases and every kernel row run
at full size; the other phases run at the depths (and, where listed, the
token counts) of ``REDUCED``, the table at the top, at every published
width, and print their cut as ``reduced``. On an NVIDIA H100 80GB HBM3 at
700 W the whole run takes six to eight minutes of its 1200 s limit.

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
     paged attention (int8 KV and fp KV) and the int8 matmul at the
     reasoner's; the paged and int8 cases also with their device time
     alone (graph_ms, from a CUDA graph of launches over cold pages or
     weights), the int8 cases with the device time of their torch.mm
     yardstick and the paged cases with that of SDPA over K/V already
     gathered contiguous (library_graph_ms);
  4. the OCR read: Qwen2.5-VL at the olmOCR-2-7B widths and depth, bf16,
     random weights from a seed; four synthetic 924x672 pages through
     ``TorchPreprocessor`` with the two initial strategies into
     ``TorchOCRBackend.read_batch(..., max_new_tokens=128)``, decoding
     over the int8 KV cache (the default); the launch counts of every
     kernel are set to 0 just before this run and read just after, and
     each kernel of the path must be > 0; then two more reads under
     ``torch.profiler`` (8 and 24 new tokens): the device's busy share of
     a read and of a decode step, and each kernel's device ms and launches
     per decode step;
  5. the reasoning engine: qwen3:32b at its published widths and depth
     with int8 weights (random, from a seed) through
     ``TorchReasoningBackend.chat_batch`` on 8 editor-style turns of ~1k
     tokens, 128 new tokens, over the int8 KV cache; counts set to 0
     before and read after as in 4, then two traced calls;
  6. guided: qwen3:32b at int8 (as 5, drawn anew with the published EOS
     id; resident from here to phase 9c) cut to its first layers answers
     the critic's and the editor's prompts for 8 transcriptions through
     schema-guided ``chat_batch`` at a 256-token budget; every text must
     parse and validate against its contract; counts set to 0 before and
     read after;
  6b. speculative: prompt-lookup speculative decoding on that depth-cut
     qwen3:32b (a second backend on the same weights, no EOS id): 8
     editor turns x 128 tokens plain, then with drafts read from the
     plain streams (``GenRequest.draft_oracle``; counts set to 0 before
     and read after: the int8 paged kernel must launch at 17 query
     tokens), then ``chat_batch`` with ``HOCR_SPEC=1``; each speculative
     stream must equal the plain one up to a near-tie (``TIE_GAP``); a
     verify round against a decode step (wall and device ms); one guided
     editor round with ``HOCR_SPEC=1`` beside phase 6's;
  7. pool_plan: olmOCR-2-7B (bf16) joins the whole resident qwen3:32b; one
     ``coresident_plan`` for the card (``plan_pools``: both resident
     trees, the card's memory, ``config.ACTIVATION_RESERVE_BYTES``) hands
     each engine its pool budget, and both batchers are built at the
     default budgets' context bounds (OCR: prompt + 2048 new tokens;
     reasoner: the agents' prompts + 4096, 16384 for the arbitrator); the
     plan must fit and the allocated peak stay under the card's memory;
     also the full pools' plan at the same bounds (``pipeline_plan``),
     which does not fit;
  8. cli: the port's CLI (``cli.transcribe.main(argv, pipeline=...)``)
     with depth-cut engines over those two resident models, their pools
     holding the plan's blocks (``cut_engines``), over a folder of the
     four contract pages (PNG files read without PIL through
     ``TorchPreprocessor``),
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
     cli phase's engines; the walk must pass through reocr;
  9a. parity: the whole resident olmOCR-2-7B reads one contract page
     through ``OCRPipeline(ocr, OllamaBackend(host=stub))``: every agent
     call goes over HTTP to an in-process ``/api/chat`` stub
     (``OllamaStub``) that the port's ``ScriptedReasoningBackend``
     answers (``PARITY_SCRIPT``: a critic that answers ``needs_reocr``
     after one free-text retry streamed as NDJSON, the arbitrator, the
     editor, acceptance); the walk, the fake's calls against what the
     agents asked, the stub's requests and bytes, the reads' launches
     (counted from 0); ``tier1_metrics`` / ``merge_versions`` host ms
     with the C++ text engine (required) beside the NumPy engines (equal
     results); ``build_pipeline("ollama")``: its ``FilePreprocessor``
     writes a file from the card and, where transformers is missing, its
     first read raises the ImportError that names it (where it is
     installed, phase 9d reads through ``HFTorchOCRBackend`` on the
     card);
  9b. dense: both resident models, cut to their first layers, with the
     pools dropped, through
     ``serving="dense"`` engines: the read phase's 8 reads, the 8 editor
     turns left-padded, one critic call through ``generate_json``; wall
     s, peak memory and launches per call (flash, window and the int8
     matmul must launch), finite ``forward_logits``, and the first token
     where each row leaves the paged fp-KV path's;
  9c. fp_kv: the same reads and turns through paged engines over the
     dense phase's depth-cut models, built with
     ``HOCR_KV_INT8=0`` (bf16 pools, the paged kernel's tensor-core fp-KV
     body): the first call's tokens against the dense path's, then a
     timed call counted from 0 (the bf16 body must launch, the fp32 body
     and the int8 branch must not), wall, prefill, decode and ms per
     decode step, two traced calls, beside the int8 path's figures from
     phases 4 and 5 (full depth);
  9d. convert (after both resident models are dropped): full-width
     random snapshots (olmOCR-2-7B widths at 1 text layer and 8 vision
     blocks, qwen3:32b widths at 1 layer) converted on the card by
     ``python -m handwritten_ocr_tpu_torch.cli.convert``, two subprocesses
     at once (``vl`` bf16, ``qwen3 --quantize int8``); each engine loaded from
     the snapshot and from the checkpoint (``load_s`` each): equal trees
     and equal greedy tokens (two reads of page0, 32 tokens; 8 editor
     turns, 16 tokens); convert seconds, snapshot and checkpoint bytes;
     where transformers is installed, ``HFTorchOCRBackend`` reads page0
     from the VL snapshot on the card through transformers' model and
     must give the tokens of ``TorchOCRBackend`` on the same snapshot
     (both fp32); counts set to 0 before the engine calls and read
     after;
  9e. tp: both models whole on the card at 4 layers (the VL with 8
     vision blocks) and full width, 32 new tokens: the single-card
     streams; then two spawned ranks
     join one process group through ``initialize_from_env``
     (HOCR_DIST_*): a card each over NCCL where there are two cards,
     else both on cuda:0 over gloo. Each rank draws the same models from
     the single-card phases' seeds one matrix at a time and keeps its
     tensor-parallel slices (``init_*(mesh=...)``), then serves through
     ``shard(mesh)``: qwen3:32b at int8 (the reasoning cell's 8 turns)
     and olmOCR-2-7B in bf16 (the read cell's 8 reads), 32 new tokens
     each, pools for a 2048-token bound, counted from 0 (flash, window,
     the int8 paged kernel and the int8 matmul must launch); the ranks'
     ids must be equal, and each row's first token that differs from the
     single-card streams is reported (bf16 / int8 partial sums
     round otherwise). call_s, ms a decode step, all-reduces a step and
     the time of one at the step's shapes, each rank's peak memory. Then
     the reference phase's narrow fp32 models with doubled head counts,
     whole and sliced on the card: the tokens must be equal. A rank's
     exception or silence (TP_TIMEOUT_S) fails the script;
  9f. ring: ring attention over two cards (NCCL) at [1, 8192, 64/8, 128],
     causal, against plain attention, where there are two cards; on one
     card a line that says why it did not run;
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
     fp-KV read runs the paged kernel's fp32 body); the
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
     paged attention at every read batch other than 8 (at the
     pipeline's shapes over bf16 pools too); then paged attention over
     int8 and over bf16 pools at 17 query tokens (a verify round,
     appends across a page boundary) at 64:8 and 28:4 heads, flash at
     the dense prefills and the int8 matmul at one row; then paged
     attention over both pools at the qwen3:32b decode shapes of
     PERF.md section 6 that no run fixes (``PAGED_TABLE_ROWS``); every
     paged and int8 row also holds two calls bit-equal;
 13. train (after both serving models are dropped; less than 1 GiB may
     be resident): olmOCR-2-7B (``VLConfig()``, full width and depth) in
     bf16; the plan (params, grads, mu, nu) against the card; one
     448x448 PNG page with a 200-character ground truth through
     ``discover_examples`` / ``batches_by_grid``; three
     ``make_train_step(cfg, grid)`` steps (default ``adamw(1e-5)``), each
     counted from 0: flash 32 and window 28 launches, every gradient
     finite and not all zero, peak memory below the card; wall, forward,
     backward and update ms, tokens per second, the share of elements
     the first step changed; a fourth step under the profiler (the
     reference backward passes' share of the backward); then
     train_grad_check: gradients through the kernels against gradients
     through their plain versions at full width and depth 2+2, in fp32
     and in bf16; and, last, flash and window at the train shapes with
     their backward's time beside SDPA's backward and the backward's
     bound;
 13b. train_sharded (right after train): the single-card first-step
     loss of olmOCR-2-7B at 4 text layers and 8 vision blocks; then two
     spawned ranks (NCCL with
     a card each where there are two cards, else both on cuda:0 over
     gloo): the narrow fp32 VL's step at TP = 2 and at FSDP over 2 data
     ranks against its single-card step on the card (loss, every
     gradient, every updated leaf within 2e-4); then that olmOCR-2-7B at
     full width in bf16, TP = 2 (two steps) and FSDP (2, 1) (one
     step), one 448x448 page per data rank: each rank's planned bytes
     (printed before it allocates), peak, step ms, all-reduces with
     bytes and ms, flash 5 / window 7 launches a rank and step, and
     the first step's loss within 1e-2 of the single card's;
 13c. fsdp_serving: the read cell's 8 reads and the reasoning cell's 8
     turns (int8) through engines built with ``shard(mesh, fsdp=True)``
     over 2 data ranks, at full width, 1 text layer and 2 vision blocks
     (each decode step gathers the whole model through gloo), 4 new
     tokens, beside the
     same models' single-card streams; flash, window, the int8 paged
     kernel and the int8 matmul must launch;
 14. kernels_tp: each kernel at the shapes one rank of TP = 2 and of
     TP = 4 gives it (heads and channels split; the int8 lm_head at
     75968 and 37984 channels), against its plain version; flash and
     window at a TP = 2 rank's train shapes (path train_sharded);
 15. kernels_fp32: every fp32 body at full width: flash (the vision
     global layer and the causal prefill), window and paged attention at
     the shapes the convert phase's fp32 read gives them (path
     convert_fp32), the int8 matmul with fp32 x at a 24-row qwen3:32b
     gate projection (path reference: the reference phase's fp32 Qwen3
     runs it); each held at the fp32 tolerance (FP32_REL_MAX,
     FP32_REL_RMS), which its plain version run with TF32 products must
     fail.

Phases 6-9 and 11 decode through ``DenseTokenizer``: every id decodes to one
character, so random weights write texts of their budget's length (with
quotes, digits and braces among them) as a real tokenizer would, where
``ByteTokenizer`` decodes the ids above 255 to nothing.

Every failed check raises, so the script exits non-zero and prints no
result. Without a CUDA card it exits non-zero at once. The last line is
``{"ok": true, "device": {...}}``; the kernels line (each kernel's
launches on its own path and on the guided, pipeline, cli, parity,
speculative, dense, fp-KV read and chat, convert, the convert phase's
fp32 read, train, tp, train_sharded, fsdp_serving and reference paths)
and the card's name and power limit come before it.

``HOCR_SPEC`` is set only inside the speculative phase and
``HOCR_KV_INT8=0`` only while phase 9c builds its engines; every other
phase runs with both unset, and every engine but the dense phase's serves
paged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter, deque

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12           # float32 outside the tensor cores
SEED = 0
# A kernel agrees with its plain version when its largest error is within
# BF16_ULPS bf16 ulps of the plain output's largest magnitude, and the RMS
# of its error within REL_RMS_TOL of the plain output's RMS. An fp32 body
# is held closer: its largest error within FP32_REL_MAX of max|want| and
# its RMS error within FP32_REL_RMS of RMS(want), which a TF32 product
# (10 mantissa bits, ~5e-4 relative) cannot meet.
BF16_ULPS = 2
REL_RMS_TOL = 1e-2
FP32_REL_MAX = 2.0 ** -14
FP32_REL_RMS = 1e-5

# Every cut below the cell a phase drives: phase function -> {what: [used,
# full]}. Depth, which brings the phases inside half the script's limit,
# and the token counts listed (each from an earlier PR); every width (hidden
# sizes, heads, head_dim, vocab, intermediate sizes) stays as published.
# A cut VL keeps its first text layers and its first vision blocks with
# the global blocks among them (8 where it can: 7 windowed and the global
# block 7, the tower's repeating unit); a cut qwen3:32b its first layers.
# Phases that run in this process build their engines over the resident
# weights (``depth_cut``); spawned ranks draw the cut model from the same
# seed.
# The read, reasoning, train and pool_plan phases and every kernel row
# run at full size and are not listed. The narrow fp32 models of the
# reference, loaders, tp and train_sharded checks are small models the
# card and the CPU (or one card and two ranks) must agree on, not cuts of
# a cell. Each listed phase prints its entry as ``reduced``.
_VL_UNIT = {"vl_vision_blocks": [8, 32],
            "vl_global_blocks": [[7], [7, 15, 23, 31]]}
_DEPTH_8 = {"qwen3_layers": [8, 64], "vl_text_layers": [8, 28], **_VL_UNIT}
REDUCED = {
    "phase_guided": {"qwen3_layers": [16, 64]},
    "phase_speculative": {"qwen3_layers": [16, 64]},
    "phase_cli": _DEPTH_8,
    "phase_pipeline": _DEPTH_8,            # the cli phase's engines
    "phase_dense": _DEPTH_8,
    "phase_fp_kv": _DEPTH_8,               # the dense phase's models
    "phase_convert": {"qwen3_layers": [1, 64], "vl_text_layers": [1, 28],
                      **_VL_UNIT, "read_tokens": [32, 128],
                      "chat_tokens": [16, 128]},
    "phase_tp": {"qwen3_layers": [4, 64], "vl_text_layers": [4, 28],
                 **_VL_UNIT, "new_tokens": [32, 128]},
    "phase_train_sharded": {"vl_text_layers": [4, 28], **_VL_UNIT},
    # every decode step gathers the whole model through gloo's host copies
    "phase_fsdp_serving": {"qwen3_layers": [1, 64], "vl_text_layers": [1, 28],
                           "vl_vision_blocks": [2, 32],
                           "vl_global_blocks": [[1], [7, 15, 23, 31]],
                           "new_tokens": [4, 128]},
    # kernels against plain versions through the backward, fp32 and bf16
    "phase_train_grad_check": {"vl_text_layers": [2, 28],
                               "vl_vision_blocks": [2, 32],
                               "vl_global_blocks": [[1], [7, 15, 23, 31]]},
}


def reduced_configs(phase: str) -> dict:
    """The configs ``phase`` builds: ``VLConfig()`` (key "vl") and
    ``Qwen3Config()`` (key "qwen3") with the depths REDUCED lists for it,
    every other field as published."""
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    cut, out = REDUCED[phase], {}
    if "vl_text_layers" in cut:
        full = VLConfig()
        out["vl"] = dataclasses.replace(
            full, text=dataclasses.replace(
                full.text, num_hidden_layers=cut["vl_text_layers"][0]),
            vision=dataclasses.replace(
                full.vision, depth=cut["vl_vision_blocks"][0],
                fullatt_block_indexes=tuple(cut["vl_global_blocks"][0])))
    if "qwen3_layers" in cut:
        out["qwen3"] = dataclasses.replace(
            Qwen3Config(), num_hidden_layers=cut["qwen3_layers"][0])
    return out


def depth_cut(params: dict, cfg) -> dict:
    """The first layers (and, for a VL tree, vision blocks) of a resident
    parameter tree that ``cfg`` names: the same tensors, no copy, so a
    depth-cut engine adds only its KV pools to the card."""
    if hasattr(cfg, "vision"):
        return {"vision": {**params["vision"], "blocks": params["vision"][
                    "blocks"][:cfg.vision.depth]},
                "text": depth_cut(params["text"], cfg.text)}
    return {**params, "layers": params["layers"][:cfg.num_hidden_layers]}


T_START = time.perf_counter()


def emit(**record) -> None:
    """One JSON line; ``at_s`` is the script's seconds so far, so each
    phase's wall time is the gap to the line before it."""
    record["at_s"] = time.perf_counter() - T_START
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


def _dtype_terms(dtype) -> tuple:
    """(bytes an element, the card's peak operations a second, name) of
    a kernel case's dtype: bf16 on the tensor cores, fp32 outside them
    (the kernels' fp32 bodies run FMAs)."""
    if dtype == torch.float32:
        return 4, FP32_FLOPS_PER_S, "fp32"
    return 2, BF16_FLOPS_PER_S, "bf16"


def _body(dtype) -> dict:
    """The ``body`` key of an fp32 case (bf16 cases name theirs only where
    a kernel has several bf16 bodies)."""
    return {"body": "fp32"} if dtype == torch.float32 else {}


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


def _errors(got, want) -> tuple[float, float, float]:
    """(max |got - want|, RMS(got - want) / RMS(want), max |want|)."""
    got, want = got.float(), want.float()
    diff = got - want
    return (float(diff.abs().max()),
            float(diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()),
            float(want.abs().max()))


def _compare(name: str, got, want, fp32: bool = False) -> dict:
    """Kernel output against its plain version, at the plain output's own
    scale. A bf16 value carries 8 significant bits: two fp32 sums of the
    same terms in another order round to bf16 values at most one ulp
    apart, and one more ulp covers the fp32 difference of the sums. The
    largest error must stay within BF16_ULPS ulps of max|want|, which
    bounds the worst element, and RMS(error) within REL_RMS_TOL of
    RMS(want), which catches a fault that moves many outputs smaller
    than the largest. ``fp32``: the kernel computes in fp32 (an fp32
    body), so the bounds are FP32_REL_MAX and FP32_REL_RMS: two fp32
    sums of the same terms in another order."""
    err, rel_rms, peak = _errors(got, want)
    if not (math.isfinite(peak) and peak > 0):
        raise AssertionError(f"{name}: plain output has max|value| {peak}")
    if fp32:
        tol, rms_tol = FP32_REL_MAX * peak, FP32_REL_RMS
    else:
        tol = BF16_ULPS * 2.0 ** (math.floor(math.log2(peak)) - 7)
        rms_tol = REL_RMS_TOL
    if not (err <= tol and rel_rms <= rms_tol):      # also catches NaN
        raise AssertionError(
            f"{name}: kernel vs plain max_abs_err {err} (tolerance {tol}), "
            f"rel_rms_err {rel_rms} (tolerance {rms_tol})")
    return dict(max_abs_err=err, tolerance=tol, rel_rms_err=rel_rms,
                rel_rms_tolerance=rms_tol)


def _refuses_tf32(name: str, plain, want) -> dict:
    """The fp32 check against a stand-in for a TF32 body: ``plain()`` run
    with TF32 matrix products allowed must fail ``_compare(..., fp32=
    True)`` against ``want`` (the plain version in full fp32). Returns
    the stand-in's errors; raises if the check would pass it."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    err, rel_rms, _ = _errors(tf32, want)
    try:
        _compare(name, tf32, want, fp32=True)
    except AssertionError:
        return dict(tf32_max_abs_err=err, tf32_rel_rms_err=rel_rms)
    raise AssertionError(f"{name}: the fp32 check passes a TF32 computation "
                         f"(max_abs_err {err}, rel_rms_err {rel_rms})")


def _backward_ms(fn, inputs, library=None) -> dict:
    """Device time of the backward alone, of ``fn(*inputs)`` (the kernel
    wrapper under autograd: its Function's backward, autograd through the
    reference form) and of ``library(*inputs)`` (SDPA's own backward), for
    a seeded cotangent; CUDA events around ``torch.autograd.grad`` over a
    retained graph."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def one(f):
        xs = [x.detach().requires_grad_() for x in inputs]
        out = f(*xs)
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        return time_ms(lambda: torch.autograd.grad(out, xs, g,
                                                   retain_graph=True),
                       iters=5)

    return dict(backward_ms=one(fn),
                library_backward_ms=None if library is None else one(library))


def _backward_bound(n_bytes: float, flops: float) -> dict:
    """The least time of an attention backward from its forward's bytes
    and operations: it reads q, k, v, the output and its cotangent and
    writes dq, dk, dv (twice the forward's bytes), and runs five products
    of the forward's size where the forward runs two (S = QK^T again,
    dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q)."""
    bound, by = bound_ms(2 * n_bytes, 2.5 * flops, BF16_FLOPS_PER_S)
    return dict(backward_bound_ms=bound, backward_bound_by=by)


def _flash_case(case: str, path: str, batch: int, t: int, hq: int,
                hkv: int, hd: int, gen, *, causal: bool = False,
                valid=None, backward: bool = False,
                dtype=torch.bfloat16) -> dict:
    """Flash attention at q ``[batch, t, hq, hd]``, k/v ``[batch, t, hkv,
    hd]`` (bf16, or fp32: the fp32 body) against its plain version:
    ``valid`` ``[t]`` masks the
    vision tower's dead slots, ``causal`` is the prefill. The plain
    version holds several fp32 copies of the scores, so it runs a few
    batch rows at a time (at most 2 GiB of scores per call); its output
    and ``plain_ms`` cover the whole batch. ``backward``: also the
    training backward's time (``_backward_ms``)."""
    import torch.nn.functional as F

    from handwritten_ocr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    dev = "cuda"
    size, peak, name = _dtype_terms(dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

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
    want = plain()
    fp32 = dtype == torch.float32
    cmp = _compare(f"flash_attention {case}", got, want, fp32=fp32)
    if fp32:
        cmp |= _refuses_tf32(f"flash_attention {case}", plain, want)
    del got, want
    n_bytes = 2 * q.numel() * size + 2 * k.numel() * size
    if valid is not None:
        live = int(valid.sum())
        n_bytes += t
        flops = 4 * batch * hq * hd * live * live
    elif causal:
        flops = 4 * batch * hq * hd * t * (t + 1) / 2
    else:
        flops = 4 * batch * hq * hd * t * t
    bound, by = bound_ms(n_bytes, flops, peak)
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
        shape=[batch, t, hq, hd], kv_heads=hkv, dtype=name, **_body(dtype),
        **cmp,
        ms=time_ms(lambda: flash_attention(q, k, v, valid, **kw)),
        plain_ms=time_ms(plain, iters=3), plain_rows_per_call=step,
        library=library,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q_t, k_t, v_t, scale=scale, **sdpa)),
        bound_ms=bound, bound_by=by)
    if backward:
        row |= _backward_ms(
            lambda *x: flash_attention(*x, valid, **kw), (q, k, v),
            lambda *x: F.scaled_dot_product_attention(
                *(y.transpose(1, 2) for y in x), scale=scale, **sdpa))
        row |= _backward_bound(n_bytes, flops)
    del q, k, v, q_t, k_t, v_t
    torch.cuda.empty_cache()
    return row


def _window_case(case: str, path: str, batch: int, plan, num_heads: int,
                 head_dim: int, gen, backward: bool = False,
                 dtype=torch.bfloat16) -> dict:
    """Window attention at qkv ``[batch, P, 3 * heads * head_dim]`` (bf16,
    or fp32: the fp32 body; the vision tower's window layers, rope on
    load) against its plain
    version; the library yardstick is SDPA per window over q/k that are
    not roped. ``graph_ms``: the kernel's device time without the host's
    per-call work. ``backward``: also the training backward's time."""
    import torch.nn.functional as F

    from handwritten_ocr_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain)
    dev = "cuda"
    valid = torch.as_tensor(plan.valid, device=dev)
    p_len, d = len(plan.valid), num_heads * head_dim
    scale = head_dim ** -0.5
    size, peak, name = _dtype_terms(dtype)
    qkv = torch.randn((batch, p_len, 3 * d), generator=gen,
                      device=dev).to(dtype)
    cos = torch.as_tensor(plan.cos_pad, device=dev)
    sin = torch.as_tensor(plan.sin_pad, device=dev)
    kw = dict(num_heads=num_heads, window_len=plan.window_len, scale=scale)
    got = window_attention(qkv, cos, sin, valid, **kw)
    want = window_attention_plain(qkv, cos, sin, valid, **kw)
    fp32 = dtype == torch.float32
    cmp = _compare(f"window_attention {case}", got, want, fp32=fp32)
    if fp32:
        cmp |= _refuses_tf32(f"window_attention {case}", lambda: (
            window_attention_plain(qkv, cos, sin, valid, **kw)), want)
    del got, want
    n_win, wl = plan.n_windows, plan.window_len
    live_per_win = plan.valid.reshape(n_win, wl).sum(axis=1)
    flops = 4 * batch * num_heads * head_dim * float((live_per_win ** 2).sum())
    n_bytes = (qkv.numel() * size + batch * p_len * d * size
               + 2 * cos.numel() * 4 + p_len)
    bound, by = bound_ms(n_bytes, flops, peak)
    qw = qkv.reshape(batch, n_win, wl, 3, num_heads, head_dim)
    qw = qw.permute(3, 0, 1, 4, 2, 5).reshape(3, batch * n_win, num_heads,
                                              wl, head_dim)
    win_mask = valid.reshape(n_win, 1, 1, wl).repeat(batch, 1, 1, 1)
    row = dict(
        name="window_attention", case=case, route="cuda", path=path,
        counter="window_attention",
        source="handwritten_ocr_tpu_torch/csrc/window_attention.cu",
        replaces="handwritten_ocr_tpu/ops/window_attention.py:194",
        shape=[batch, p_len, 3 * d], dtype=name, **_body(dtype), **cmp,
        ms=time_ms(lambda: window_attention(qkv, cos, sin, valid, **kw)),
        graph_ms=graph_ms([lambda: window_attention(qkv, cos, sin, valid,
                                                    **kw)]),
        plain_ms=time_ms(lambda: window_attention_plain(qkv, cos, sin, valid,
                                                        **kw), iters=3),
        library="F.scaled_dot_product_attention per window (q/k not roped)",
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qw[0], qw[1], qw[2], attn_mask=win_mask, scale=scale)),
        bound_ms=bound, bound_by=by)
    if backward:
        def sdpa_windows(x):
            xw = x.reshape(batch, n_win, wl, 3, num_heads, head_dim)
            xw = xw.permute(3, 0, 1, 4, 2, 5).reshape(
                3, batch * n_win, num_heads, wl, head_dim)
            return F.scaled_dot_product_attention(
                xw[0], xw[1], xw[2], attn_mask=win_mask, scale=scale)

        row |= _backward_ms(
            lambda x: window_attention(x, cos, sin, valid, **kw), (qkv,),
            sdpa_windows)
        row |= _backward_bound(n_bytes, flops)
    del qkv, qw
    torch.cuda.empty_cache()
    return row


def _paged_case(name: str, case: str, slots: int, live: int, context: int,
                layers: int, hq: int, hkv: int, hd: int, kv_quant: bool,
                gen, path: str, t: int = 1, dtype=torch.bfloat16) -> dict:
    """One call of the paged kernel (``live`` of ``slots`` slots at
    ``context`` cached tokens, ``t`` new tokens a slot; q, new rows and fp
    pools in ``dtype``: fp32 q runs the fp32 body) against its plain
    version: outputs within tolerance, pools (and scale pools) bit-equal
    after the append. With ``t`` > 1 (a speculative verify round) slot s
    starts 1 + s rows before a page boundary and appends t - s rows, so
    every live slot's append crosses into the next page with its own
    count of real rows. ``ms`` times a loop of wrapper calls,
    ``graph_ms`` the device time alone (a CUDA graph); both cycle over
    the layers, so every call finds its pages cold, as in decode."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention, paged_append_attention_plain)
    dev = "cuda"
    size, peak, type_name = _dtype_terms(dtype)
    bs = cfg_mod.SERVE_BLOCK_SIZE
    if t > 1:
        context = -(-context // bs) * bs       # the next page boundary
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
        k_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
        scales = []
    tables = torch.zeros((slots, width), dtype=torch.int32, device=dev)
    start = torch.zeros(slots, dtype=torch.int32, device=dev)
    n_valid = torch.zeros(slots, dtype=torch.int32, device=dev)
    for s in range(live):
        tables[s] = torch.arange(1 + s * width, 1 + (s + 1) * width)
        start[s] = context if t == 1 else context - 1 - s
        n_valid[s] = 1 if t == 1 else t - s

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q = randn(slots, t, hq, hd)
    k_new, v_new = randn(slots, t, hkv, hd), randn(slots, t, hkv, hd)
    pools = [k_pool, v_pool, *scales]
    refs = [x.clone() for x in pools]
    tscale = hd ** -0.5
    layer = min(5, layers - 1)
    got = paged_append_attention(q, k_new, v_new, k_pool, v_pool, tables,
                                 start, n_valid, *scales, layer=layer,
                                 scale=tscale)
    again = paged_append_attention(q, k_new, v_new, k_pool, v_pool, tables,
                                   start, n_valid, *scales, layer=layer,
                                   scale=tscale)
    if not torch.equal(got, again):   # the merge's fixed order
        raise AssertionError(f"{name} {case}: two calls differ")
    del again
    want = paged_append_attention_plain(q, k_new, v_new, refs[0], refs[1],
                                        tables, start, n_valid, *refs[2:],
                                        layer=layer, scale=tscale)
    real = torch.arange(t, device=dev)[None] < n_valid[:, None]   # [S, t]
    fp32 = dtype == torch.float32
    cmp = _compare(f"{name} {case}", got[real], want[real], fp32=fp32)
    if fp32:   # the pools hold the appended rows: a second append rewrites them
        cmp |= _refuses_tf32(f"{name} {case}", lambda: (
            paged_append_attention_plain(
                q, k_new, v_new, refs[0], refs[1], tables, start, n_valid,
                *refs[2:], layer=layer, scale=tscale)[real]), want[real])
    if not all(torch.equal(a, b) for a, b in zip(pools, refs)):
        raise AssertionError(f"{name} {case}: pools differ from plain")
    if not bool((got[~real] == 0).all()):
        raise AssertionError(f"{name} {case}: dead slots or rows not zero")
    del refs, want, got
    library = _sdpa_yardstick(q, k_pool, v_pool, tables, start, n_valid,
                              live, layers, *scales, dtype=dtype)
    ctx = int(start[:live].sum())
    new = int(n_valid.sum())                 # real new rows
    # bytes of one token's K (or V) row of one layer, with its scales
    row = hkv * hd * (1 if kv_quant else size) + (hkv * 4 if kv_quant else 0)
    n_bytes = (2 * ctx * row                 # cached K and V of live slots
               + 2 * new * hkv * hd * size   # new rows read
               + 2 * new * row               # new rows written
               + new * hq * hd * size        # q of the real rows
               + slots * t * hq * hd * size  # every slot's output
               + tables.numel() * 4 + 2 * slots * 4)
    # query row i of a slot attends start + i + 1 cols (causal)
    attended = sum(int(n) * int(st) + int(n) * (int(n) + 1) // 2
                   for st, n in zip(start[:live], n_valid[:live]))
    flops = 4 * hq * hd * attended
    bound, by = bound_ms(n_bytes, flops, peak)
    layer_cycle = iter(range(10 ** 9))

    def step(fn):   # a new layer each call: cold pages, as in decode
        return lambda: fn(q, k_new, v_new, k_pool, v_pool, tables, start,
                          n_valid, *scales, layer=next(layer_cycle) % layers,
                          scale=tscale)

    body = ("fp32" if dtype == torch.float32 else "int8" if kv_quant
            else "bf16")
    row_out = dict(
        name=name, case=case, route="cuda", path=path, body=body,
        counter={"fp32": "paged_append_attention_fp32",
                 "int8": "paged_append_attention_int8",
                 "bf16": "paged_append_attention"}[body],
        source="handwritten_ocr_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="handwritten_ocr_tpu/ops/paged_decode_attention.py:64",
        shape=[slots, t, hq, hd], live_slots=live, context=context,
        starts=start[:live].tolist(), new_rows=n_valid[:live].tolist(),
        pool=list(k_pool.shape),
        dtype=(f"int8 KV, {type_name} q" if kv_quant
               else f"{type_name} KV, {type_name} q"),
        **cmp, ms=time_ms(step(paged_append_attention), iters=56),
        graph_ms=graph_ms([step(paged_append_attention)]),
        plain_ms=time_ms(step(paged_append_attention_plain), iters=10),
        **library, bound_ms=bound, bound_by=by)
    del k_pool, v_pool, scales, pools, q, k_new, v_new
    torch.cuda.empty_cache()
    return row_out


def _sdpa_yardstick(q, k_pool, v_pool, tables, start, n_valid, live: int,
                    layers: int, *scales, dtype=torch.bfloat16) -> dict:
    """One ``F.scaled_dot_product_attention(..., enable_gqa=True)`` call
    over the live slots' K and V already gathered into contiguous
    ``dtype`` ``[live, Hkv, C, D]`` (C: the longest slot's cols after the
    append; a boolean mask gives each query token its own cols when T > 1), int8
    pools dequantised first: the library's time for the attention alone,
    without the gather or the append. Cycles over copies from successive
    layers (>= 64 MB together), so every call finds its K and V cold, as
    the kernel's timing does."""
    import torch.nn.functional as F
    s, t, hq, hd = q.shape
    hkv, bs = k_pool.shape[3], k_pool.shape[2]
    width = tables.shape[1] * bs
    ends = (start[:live] + n_valid[:live]).long()
    cols = int(ends.max())
    idx = tables[:live].long()

    def gather(pool, scale_pool, layer):
        x = pool[layer][idx].reshape(live, width, hkv, hd)[:, :cols]
        if scale_pool is not None:      # [L, N, Hkv, BS] -> [live, C, Hkv]
            sc = scale_pool[layer][idx].permute(0, 1, 3, 2).reshape(
                live, width, hkv)[:, :cols]
            x = x.float() * sc[..., None]
        return x.to(dtype).permute(0, 2, 1, 3).contiguous()

    per_copy = 2 * live * hkv * cols * hd * _dtype_terms(dtype)[0]
    copies = min(layers, max(2, -(-64 * 2 ** 20 // per_copy)))
    k_scale, v_scale = scales if scales else (None, None)
    kv = [(gather(k_pool, k_scale, layer), gather(v_pool, v_scale, layer))
          for layer in range(copies)]
    qs = q[:live].permute(0, 2, 1, 3).contiguous()           # [live, hq, t, hd]
    tok = torch.arange(t, device=q.device)
    col = torch.arange(cols, device=q.device)
    mask = None
    if t > 1 or bool((ends != cols).any()):
        mask = (col[None, None, :] <= start[:live, None, None].long()
                + tok[None, :, None])[:, None]                # [live, 1, t, C]
    cycle = iter(range(10 ** 9))

    def call():
        k, v = kv[next(cycle) % copies]
        return F.scaled_dot_product_attention(qs, k, v, attn_mask=mask,
                                              scale=hd ** -0.5,
                                              enable_gqa=True)

    record = dict(
        library=f"SDPA, enable_gqa, K/V pre-gathered contiguous "
                f"{_dtype_terms(dtype)[2]} [live, Hkv, C, D] (gather and "
                "append not timed)",
        library_ms=time_ms(call, iters=56), library_graph_ms=graph_ms([call]))
    del kv
    return record


def _int8_matmul_case(case: str, m: int, d_in: int, d_out: int,
                      out_dtype, gen, path: str,
                      x_dtype=torch.bfloat16) -> dict:
    """The int8 matmul at a decode shape against its plain version (x in
    ``x_dtype``: fp32 x runs the fp32-x body), two calls bit-equal; the
    library yardstick is ``torch.mm`` on the weight dequantised to
    ``x_dtype`` (it reads 2 or 4 bytes per weight where the kernel reads
    1). ``ms`` times a back-to-back loop of wrapper calls, which the host can set at small N;
    ``graph_ms`` is the kernel's device time alone, from a CUDA graph of
    launches cycling through enough copies of the weight (>= 60 MB) that
    each launch reads it from device memory, as a decode step does;
    ``library_graph_ms`` the same for ``torch.mm`` over copies of the
    dequantised weight."""
    from handwritten_ocr_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                           int8_matmul_plain)
    dev = "cuda"
    size, peak, x_name = _dtype_terms(x_dtype)
    x = torch.randn((m, d_in), generator=gen, device=dev).to(x_dtype)
    w_q = torch.randint(-127, 128, (d_out, d_in), generator=gen, device=dev,
                        dtype=torch.int8)
    scale = torch.rand(d_out, generator=gen, device=dev) * 1e-3 + 1e-4
    got = int8_matmul(x, w_q, scale, out_dtype=out_dtype)
    if not torch.equal(got, int8_matmul(x, w_q, scale, out_dtype=out_dtype)):
        raise AssertionError(f"int8_matmul {case}: two calls differ")
    want = int8_matmul_plain(x, w_q, scale, out_dtype)
    fp32 = x_dtype == torch.float32
    cmp = _compare(f"int8_matmul {case}", got, want, fp32=fp32)
    if fp32:
        cmp |= _refuses_tf32(f"int8_matmul {case}", lambda: (
            int8_matmul_plain(x, w_q, scale, out_dtype)), want)
    del got, want
    out_bytes = 4 if out_dtype == torch.float32 else 2
    n_bytes = (d_in * d_out + m * d_in * size + d_out * 4
               + m * d_out * out_bytes)
    bound, by = bound_ms(n_bytes, 2 * m * d_in * d_out, peak)
    w_deq = (w_q.to(x_dtype) * scale[:, None].to(x_dtype))
    copies = [w_q] + [w_q.clone() for _ in range(
        min(23, math.ceil(60e6 / w_q.numel()) - 1))]
    device_ms = graph_ms([lambda w=w: int8_matmul(x, w, scale, out_dtype=out_dtype)
                          for w in copies])
    del copies
    deq_copies = [w_deq] + [w_deq.clone() for _ in range(
        min(23, math.ceil(60e6 / (size * w_deq.numel())) - 1))]
    library_device_ms = graph_ms([lambda w=w: torch.mm(x, w.t())
                                  for w in deq_copies])
    del deq_copies
    record = dict(
        name="int8_matmul", case=case, route="cuda", path=path,
        counter="int8_matmul",
        source="handwritten_ocr_tpu_torch/csrc/int8_matmul.cu",
        replaces="handwritten_ocr_tpu/ops/int8_matmul.py:25",
        shape=[m, d_in, d_out], dtype=f"{x_name} x, int8 W, "
        f"{'fp32' if out_dtype == torch.float32 else 'bf16'} out",
        **_body(x_dtype), **cmp,
        ms=time_ms(lambda: int8_matmul(x, w_q, scale, out_dtype=out_dtype),
                   iters=20),
        graph_ms=device_ms,
        plain_ms=time_ms(lambda: int8_matmul_plain(x, w_q, scale, out_dtype),
                         iters=3),
        library=f"torch.mm on the {x_name} dequantised weight",
        library_ms=time_ms(lambda: torch.mm(x, w_deq.t()), iters=20),
        library_graph_ms=library_device_ms,
        bound_ms=bound, bound_by=by)
    del x, w_q, scale, w_deq
    torch.cuda.empty_cache()
    return record


def phase_kernels_reasoning(qcfg, prompt_len: int) -> list[dict]:
    """The reasoner's kernel cases: flash prefill, paged attention over
    int8 and over bf16 pools, the int8 matmul at the decode shapes (24 rows: every decode step runs
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
    for kv_quant, case, path in ((True, "qwen3_decode_int8", "reasoning"),
                                 (False, "qwen3_decode", "fp_kv_chat")):
        rows.append(_paged_case(
            "paged_append_attention", case, cfg_mod.SERVE_SLOTS, batch,
            prompt_len + 64, qcfg.num_hidden_layers, hq, hkv, hd, kv_quant,
            gen, path))
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
    # over int8 pools (the read's default) and over bf16 pools (the read
    # under HOCR_KV_INT8=0)
    for kv_quant, case, path in ((True, "decode_step_int8", "ocr_read"),
                                 (False, "decode_step", "fp_kv_read")):
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
    budget) at that batch. At the pipeline's shapes (1-4 live slots) the
    paged kernel also runs its bf16-pool body (path fp_kv_chat / fp_kv_read:
    the fp-KV paths that launch it). Runs last, when no model is
    resident."""
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
            for kv_quant in ((True, False) if path == "pipeline" else (True,)):
                # the pipeline's 1-4 live shapes also over bf16 pools (the
                # fp-KV body, which the fp_kv chat path runs)
                rows.append(_paged_case(
                    "paged_append_attention",
                    f"qwen3_{agent}_decode{'_int8' if kv_quant else ''}", slots,
                    min(len(longest), slots), max(longest) + run["llm_budget"],
                    qcfg.num_hidden_layers, qcfg.num_attention_heads,
                    qcfg.num_key_value_heads, qcfg.head_dim, kv_quant, gen,
                    path if kv_quant else "fp_kv_chat"))
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
                *[_paged_case("paged_append_attention",
                              f"decode_step{'_int8' if kv_quant else ''}_b{b}",
                              slots, b, prompt_len + run["ocr_budget"],
                              txt.num_hidden_layers, txt.num_attention_heads,
                              txt.num_key_value_heads, txt.head_dim, kv_quant,
                              gen, path if kv_quant else "fp_kv_read")
                  for kv_quant in ((True, False) if path == "pipeline"
                                   else (True,))]]
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


def reset_launches() -> None:
    from handwritten_ocr_tpu_torch.ops import launch_counters
    for _, fn, attr in launch_counters():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    from handwritten_ocr_tpu_torch.ops import launch_counters
    return {name: getattr(fn, attr) for name, fn, attr in launch_counters()}


def require_launches(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {path} path")


def check_pools(cache, what: str) -> None:
    """Finite pools: the fp pools themselves, or the scale pools of an
    int8 cache (an int8 value is always finite); block 0 is the trash
    sink. One layer at a time: a full-width bf16 pool is most of the
    card's free memory."""
    pools = ((cache.k_scale, cache.v_scale) if cache.quantized
             else (cache.k, cache.v))
    if not all(bool(torch.isfinite(p[layer, 1:]).all())
               for p in pools for layer in range(p.shape[0])):
        raise AssertionError(f"non-finite values in the {what} KV pools")
    if cache.quantized and not bool((cache.k_scale[:, 1:] > 0).any()):
        raise AssertionError(f"the {what} scale pools were never written")


def phase_main_path(cfg, prompt_len: int, max_new_tokens: int = 128) -> dict:
    from handwritten_ocr_tpu_torch.config import (OCR_PROMPT,
                                                  PREPROCESSING_STRATEGIES)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel

    t0 = time.perf_counter()
    params = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _count_params(params)
    backend = TorchOCRBackend(VLModel(params, cfg), spelling_tokenizer())
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
    record["streams"] = [[int(t) for t in text.split()] for text in texts]
    record["trace"] = phase_trace("ocr_read", lambda budget: backend.read_batch(
        images, OCR_PROMPT, budget))
    del backend, params, batcher, cache
    torch.cuda.empty_cache()
    return record


def _profiled(run, budget: int):
    """(wall s, device-busy s, {kernel: (launches, device s)}) of one call
    under the profiler, tracing the device only and summed from its raw
    events (``key_averages`` over a decode call's host and device events
    took tens of seconds a call; ranges' device-side annotations are left
    out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(budget)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                not e.is_user_annotation() and e.duration_ns() > 0:
            count, secs = device.get(e.name(), (0, 0.0))
            device[e.name()] = (count + 1, secs + e.duration_ns() / 1e9)
    return wall, sum(t for _, t in device.values()), device


def phase_trace(path: str, run, short: int = 8, long: int = 24) -> dict:
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
    backend = TorchReasoningBackend(Qwen3Model(params, qcfg),
                                    spelling_tokenizer(), kv_quant=True)
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
    record["streams"] = [[int(t) for t in text.split()] for text in texts]
    record["trace"] = phase_trace("reasoning", lambda budget: backend.chat_batch(
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


def _reset_stats(batcher) -> None:
    """Every serving count of the batcher to 0, and no cooldown."""
    for key, value in batcher.stats.items():
        batcher.stats[key] = 0.0 if isinstance(value, float) else 0
    batcher.spec_stats.update(rounds=0, drafted=0, accepted=0)
    batcher._spec_cooldown = 0


def phase_guided(params: dict, turns: list[Turn], card: str,
                 max_new_tokens: int = 256):
    """qwen3:32b (published widths, int8 weights from a seed, int8 KV; the
    first layers of the resident tree, ``REDUCED``) answers the critic's
    and then the editor's prompts for the 8 transcriptions through
    schema-guided ``chat_batch``; each text must parse and validate
    against its contract. One short warm-up call first; the launch counts
    are set to 0 before the two timed calls and read after them. ``card``
    (nvidia-smi's name and power limit) goes into every record. Returns
    (the backend, kept for the speculative phase; the path's launches;
    its prompt lengths per agent call and budget, for
    ``phase_kernels_paths``, and each agent's texts and stats, for
    ``phase_speculative``)."""
    from handwritten_ocr_tpu_torch.agents.schemas import (CriticResult,
                                                          EditorResult)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.utils.jsonio import extract_json

    qcfg = reduced_configs("phase_guided")["qwen3"]
    reduced = REDUCED["phase_guided"]
    backend = TorchReasoningBackend(Qwen3Model(depth_cut(params, qcfg), qcfg),
                                    dense_tokenizer(), kv_quant=True)
    requests = guided_requests(turns)
    contracts = {"critic": CriticResult, "editor": EditorResult}
    kw = dict(temperature=0.1, max_tokens=max_new_tokens)
    backend.chat_batch(requests["critic"], temperature=0.1, max_tokens=8,
                       json_schema=requests["critic"][0].schema)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    total, prompts, agents = {}, {}, {}
    for agent in ("critic", "editor"):
        batch = requests[agent]
        batcher = backend._batcher
        _reset_stats(batcher)
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
        agents[agent] = dict(texts=texts, stats=stats,
                             max_new_tokens=max_new_tokens)
        emit(phase="guided", card=card, agent=agent,
             model="qwen3:32b (Qwen3Config() widths)", reduced=reduced,
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
    emit(phase="guided_path", card=card, reduced=reduced, **total,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    return backend, launches, dict(agent_prompt_tokens=prompts,
                                   llm_budget=max_new_tokens, agents=agents)


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
    """olmOCR-2-7B (bf16, random from a seed) joins the resident
    qwen3:32b (``reasoner``: the whole model, whose first layers the
    guided phase ran). One ``coresident_plan`` for the card hands each
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


def cut_engines(ocr, reasoner, phase: str) -> tuple:
    """Depth-cut engines over ``pool_plan``'s resident weights
    (``REDUCED[phase]``), with their tokenizers and KV form: each pool
    holds the blocks its full engine's planned budget holds, at the cut
    depth's bytes a block, so requests are admitted as in the planned
    deployment. The full engines' pools are dropped first."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.models.paged import PagedKVCache

    def per_block(text_cfg, kv_quant: bool) -> int:
        return PagedKVCache.block_bytes(
            text_cfg.num_hidden_layers, cfg_mod.SERVE_BLOCK_SIZE,
            text_cfg.num_key_value_heads, text_cfg.head_dim, kv_quant=kv_quant)

    cfgs = reduced_configs(phase)
    cut = []
    for engine, cfg in ((ocr, cfgs["vl"]), (reasoner, cfgs["qwen3"])):
        engine._batcher = None
        full_text = getattr(engine.model.config, "text", engine.model.config)
        blocks = engine.pool_bytes // per_block(full_text, engine.kv_quant)
        cut.append(type(engine)(
            type(engine.model)(depth_cut(engine.model.params, cfg), cfg),
            engine.tokenizer, kv_quant=engine.kv_quant,
            pool_bytes=blocks * per_block(getattr(cfg, "text", cfg),
                                          engine.kv_quant)))
    gc.collect()
    torch.cuda.empty_cache()
    return tuple(cut)


def _require_depth(phase: str, *models) -> None:
    """The models run the depths ``REDUCED[phase]`` names."""
    for model in models:
        cfg = model.config
        got = (dict(vl_text_layers=cfg.text.num_hidden_layers,
                    vl_vision_blocks=cfg.vision.depth,
                    vl_global_blocks=list(cfg.vision.fullatt_block_indexes))
               if hasattr(cfg, "vision")
               else dict(qwen3_layers=cfg.num_hidden_layers))
        want = {what: REDUCED[phase][what][0] for what in got}
        if got != want:
            raise AssertionError(f"{phase} runs {got}, REDUCED names {want}")


def phase_cli(ocr, reasoner, card: str) -> dict:
    """The port's CLI (``cli.transcribe.main(argv, pipeline=...)``) over
    a folder of the four contract pages (924x672 PNG files, the pixels of
    ``synthetic_pages(4)``), with depth-cut engines over ``pool_plan``'s
    weights and its pools' block counts (``cut_engines``, ``REDUCED``)
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

    _require_depth("phase_cli", ocr.model, reasoner.model)
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
         driven_by="cli --lockstep", reduced=REDUCED["phase_cli"],
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
    cli = dict(phase="cli", card=card, reduced=REDUCED["phase_cli"],
               pages=len(stems), **BUDGETS,
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
    """The cli phase's depth-cut engines (``REDUCED``) over both resident
    models: ``OCRPipeline.run`` on one page resumed at its re-OCR node
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

    _require_depth("phase_pipeline", ocr.model, reasoner.model)
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
         reduced=REDUCED["phase_pipeline"],
         max_iterations=run_cfg.max_iterations,
         accept_threshold=run_cfg.accept_threshold, **BUDGETS, **run)
    return run


class OllamaStub:
    """Ollama's ``/api/chat`` on 127.0.0.1 (an ephemeral port), served
    from a thread and answered by ``backend.chat`` (the port's
    ``ScriptedReasoningBackend``): one JSON body for a request that does
    not stream, NDJSON (a line per four characters, then a done line) for
    one that does. Counts requests, streamed requests and bytes each way;
    an exception while answering is kept in ``errors`` and answered 500."""

    def __init__(self, backend):
        import http.server
        import threading
        stub = self
        self.backend = backend
        self.requests = self.streamed = self.bytes_in = self.bytes_out = 0
        self.errors: list[str] = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                try:
                    body = json.loads(raw)
                    data, kind = stub.answer(body)
                except Exception as exc:     # reported by the phase
                    stub.errors.append(repr(exc))
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                stub.requests += 1
                stub.streamed += bool(body["stream"])
                stub.bytes_in += len(raw)
                stub.bytes_out += len(data)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def answer(self, body: dict) -> tuple[bytes, str]:
        messages = body["messages"]
        system = messages[0]["content"] if len(messages) == 2 else ""
        text = self.backend.chat(system, messages[-1]["content"],
                                 temperature=body["options"]["temperature"],
                                 max_tokens=body["options"]["num_predict"],
                                 json_schema=body.get("format"))
        if not body["stream"]:
            return json.dumps({"message": {"role": "assistant",
                                           "content": text},
                               "done": True}).encode(), "application/json"
        lines = [json.dumps({"message": {"role": "assistant",
                                         "content": text[i:i + 4]},
                             "done": False}) for i in range(0, len(text), 4)]
        lines.append(json.dumps({"message": {"role": "assistant",
                                             "content": ""}, "done": True}))
        return ("\n".join(lines) + "\n").encode(), "application/x-ndjson"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        if self.thread.is_alive():
            raise AssertionError("the Ollama stub did not stop")


def _critique(confidence: int, verdict: str) -> dict:
    return {"overall_confidence": confidence, "verdict": verdict,
            "segments": [{"text": "march", "confidence": 40, "issues": [
                {"description": "unclear word", "severity": "minor",
                 "suggestion": "march"}]}],
            "reasoning": "scripted"}


# The parity run's scripted agents: the critic's first structured answer
# does not parse, so its JSON ladder asks again in free text (streamed as
# NDJSON); then re-OCR, arbitration, one editor round and acceptance.
PARITY_SCRIPT = (
    "no JSON in this answer",
    _critique(40, "needs_reocr"),
    {"final_text": "the letter was written in march", "decisions": [],
     "confidence": 80, "uncertain_segments": []},
    _critique(60, "needs_editing"),
    {"corrected_text": "the letter was written in March", "changes": [
        {"original": "march", "corrected": "March", "reason": "a month",
         "confidence": 90}], "unresolved": []},
    _critique(95, "accept"),
)


def _host_ms(fn, repeats: int = 20) -> tuple[object, float]:
    """(fn's result, host ms a call over ``repeats`` calls)."""
    result = fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return result, (time.perf_counter() - t0) * 1e3 / repeats


def phase_parity(ocr, card: str) -> dict:
    """The parity stack's reasoner (``engine/ollama_client.py``) with the
    resident olmOCR-2-7B of ``pool_plan`` reading on the card:
    ``OCRPipeline(ocr, OllamaBackend(host=stub))`` over the contract page
    ``page0.png`` (read from its file through ``TorchPreprocessor``, 128
    OCR and 256 agent tokens), every agent call going over HTTP to an
    ``OllamaStub`` that the port's ``ScriptedReasoningBackend`` answers
    with ``PARITY_SCRIPT``. The walk must be initial reads, critic
    (``needs_reocr``), re-OCR with its reads on the card and the
    arbitrator, critic, editor, critic, accept; the fake's recorded calls
    must equal what the agents asked the client, and the stub must have
    answered one NDJSON stream. Launch counts set to 0 before the run and
    read after it (flash, window and the int8 paged kernel must launch).
    Then ``tier1_metrics`` / ``merge_versions`` on the run's texts with the
    C++ text engine (required) and with the NumPy engines: equal results,
    host ms each; and ``build_pipeline("ollama")`` on this machine: its
    ``FilePreprocessor`` writes the first strategy's file from the card,
    and, where transformers is missing, the first read must raise the
    ImportError that names it (where it is installed, ``phase_convert``
    reads through the backend on the card instead)."""
    import importlib.metadata
    import importlib.util
    import tempfile
    from pathlib import Path

    from handwritten_ocr_tpu_torch import native
    from handwritten_ocr_tpu_torch.cli import transcribe
    from handwritten_ocr_tpu_torch.config import (PREPROCESSING_STRATEGIES,
                                                  RunConfig)
    from handwritten_ocr_tpu_torch.engine.fakes import ScriptedReasoningBackend
    from handwritten_ocr_tpu_torch.engine.ollama_client import OllamaBackend
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchPreprocessor)
    from handwritten_ocr_tpu_torch.graph.driver import OCRPipeline
    from handwritten_ocr_tpu_torch.state import initial_state
    from handwritten_ocr_tpu_torch.text import merge_versions, tier1_metrics

    page = Path(__file__).resolve().parent / ".contract_pages" / "page0.png"
    fake = ScriptedReasoningBackend(list(PARITY_SCRIPT))
    stub = OllamaStub(fake)
    llm = OllamaBackend(host=stub.url)
    pipeline = OCRPipeline(ocr, llm, preprocessor=TorchPreprocessor(),
                           quiet=True)
    node_s: dict = {}
    asked: list[dict] = []
    read_batches: list[int] = []

    def node_hook(kind):
        return lambda seconds, args, kwargs: node_s.update(
            {kind: node_s.get(kind, 0.0) + seconds})
    restores = [_observe(pipeline, f"node_{kind}", node_hook(kind))
                for kind in ("initial_ocr", "critic", "editor", "reocr")]
    restores.append(_observe(llm, "chat", lambda s, args, kwargs: asked.append(
        {"system": args[0], "user": args[1],
         "temperature": kwargs["temperature"],
         "max_tokens": kwargs["max_tokens"],
         "json_schema": kwargs.get("json_schema")})))
    restores.append(_observe(ocr, "read_batch", lambda s, args, kwargs:
                             read_batches.append(len(args[0]))))
    run_cfg = RunConfig(max_iterations=4, **BUDGETS)
    state = initial_state(str(page), config=run_cfg.as_state_dict(),
                          max_iterations=run_cfg.max_iterations)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as echoed:
            final = pipeline.run(state)
        torch.cuda.synchronize()
    finally:
        for undo in restores:
            undo()
        stub.close()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    if stub.errors or fake.queue:
        raise AssertionError(f"the stub failed or the script was not used "
                             f"up: {stub.errors}, {len(fake.queue)} left")
    walk = check_walk(final)
    if walk != ["initial_ocr", "critic", "reocr", "critic", "editor",
                "critic", "accept"]:
        raise AssertionError(f"the parity walk is {walk}")
    if fake.calls != asked:
        raise AssertionError("the fake's calls differ from what the agents "
                             "asked the Ollama client")
    if stub.requests != len(PARITY_SCRIPT) or stub.streamed != 1 or \
            echoed.getvalue() != json.dumps(PARITY_SCRIPT[1]) + "\n":
        raise AssertionError(f"{stub.requests} requests, {stub.streamed} "
                             "streamed; the stream echoed "
                             f"{echoed.getvalue()!r}")
    require_launches("parity", launches, (
        "flash_attention", "window_attention", "paged_append_attention_int8"))

    if native.engine() != "cpp":
        raise AssertionError(f"the C++ text engine did not build: "
                             f"{native.build_error()}")
    texts = [c["text"] for c in final["candidates"]] + [final["current_best"]]
    text_engines = {}
    for name, switch in (("cpp", None), ("numpy", "1")):
        with _env("HOCR_TPU_NO_NATIVE", switch):
            if native.engine() != name:
                raise AssertionError(f"the {name} text engine is not in use")
            metrics, metrics_ms = _host_ms(lambda: [
                tier1_metrics(texts[0], t) for t in texts[1:]])
            merged, merge_ms = _host_ms(lambda: merge_versions(texts))
        text_engines[name] = dict(tier1_metrics_ms=metrics_ms,
                                  merge_versions_ms=merge_ms,
                                  result=(metrics, merged))
    if text_engines["cpp"].pop("result") != text_engines["numpy"].pop("result"):
        raise AssertionError("the C++ and NumPy text engines disagree")

    installed = (importlib.metadata.version("transformers")
                 if importlib.util.find_spec("transformers") else None)
    hf_pipeline = transcribe.build_pipeline("ollama", quiet=True)
    prepared = hf_pipeline.preprocessor.apply(str(page),
                                              PREPROCESSING_STRATEGIES[0])
    written = Path(prepared.data)
    if not (written.name.startswith(f"ocr_{prepared.strategy_label}_")
            and written.parent == Path(tempfile.gettempdir())
            and written.suffix == ".png"):
        raise AssertionError(f"FilePreprocessor wrote {written}")
    written.unlink()
    import_error = None
    if installed is None:
        try:
            hf_pipeline.ocr.read(prepared, "Read the page.", 8)
        except ImportError as exc:
            import_error = str(exc)
        else:
            raise AssertionError("HFTorchOCRBackend read without "
                                 "transformers")
        if "transformers" not in import_error:
            raise AssertionError(f"the ImportError does not name "
                                 f"transformers: {import_error}")
    record = dict(
        phase="parity", card=card, page="page0.png", **BUDGETS,
        max_iterations=run_cfg.max_iterations, run_s=run_s, walk=walk,
        node_s=node_s, read_batches=read_batches, reads=sum(read_batches),
        stub=dict(requests=stub.requests, streamed=stub.streamed,
                  bytes_in=stub.bytes_in, bytes_out=stub.bytes_out),
        fake_calls=len(fake.calls),
        schema_calls=sum(c["json_schema"] is not None for c in fake.calls),
        fake_calls_equal_asked=True, status=final["status"],
        text_engine=native.engine(), text_chars=[len(t) for t in texts],
        text_engines=text_engines, hf_import_error=import_error,
        transformers_installed=installed,
        file_preprocessor=prepared.strategy_label, launches=launches)
    emit(**record)
    return record


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


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _wants_mm_token_types() -> bool:
    """Whether this transformers' Qwen2.5-VL takes ``mm_token_type_ids``."""
    import importlib
    import inspect

    modeling_qwen2_5_vl = importlib.import_module(
        "transformers.models.qwen2_5_vl.modeling_qwen2_5_vl")
    return "mm_token_type_ids" in inspect.signature(
        modeling_qwen2_5_vl.Qwen2_5_VLModel.get_rope_index).parameters


class PortProcessor:
    """Stands in for transformers' Qwen2.5-VL processor, whose video half
    needs torchvision: the chat template's ids (``engine._prompt_ids``)
    and the packed patches of the page a message names, as a
    ``BatchFeature``; ``decode`` spells the ids. A copy of
    ``tests/test_torch_hf_ocr.py``'s."""

    def __init__(self, engine, min_pixels, max_pixels):
        self.engine = engine
        self.pixels = dict(min_pixels=min_pixels, max_pixels=max_pixels)
        self.mm_token_types = _wants_mm_token_types()

    def apply_chat_template(self, messages, *, add_generation_prompt,
                            tokenize, return_dict, return_tensors):
        import importlib

        from handwritten_ocr_tpu_torch.models.processor import (
            load_image_rgb, pack_image)
        assert add_generation_prompt and tokenize and return_dict
        assert return_tensors == "pt"
        (message,) = messages
        image, text = message["content"]
        assert message["role"] == "user" and image["type"] == "image"
        packed = pack_image(load_image_rgb(image["url"]), **self.pixels)
        ids = self.engine._prompt_ids(text["text"], packed.num_llm_tokens)
        feature = {
            "input_ids": torch.tensor(ids[None].astype(np.int64)),
            "attention_mask": torch.ones(1, len(ids), dtype=torch.long),
            "pixel_values": torch.from_numpy(packed.patches),
            "image_grid_thw": torch.tensor([packed.grid])}
        if self.mm_token_types:
            # transformers 5 places the image's M-RoPE ids by these (1 at
            # the image tokens), which its own processor returns
            feature["mm_token_type_ids"] = (
                feature["input_ids"] == self.engine.model.config.image_token_id
            ).to(torch.int32)
        return importlib.import_module("transformers").BatchFeature(feature)

    def decode(self, ids, skip_special_tokens):
        assert skip_special_tokens
        return " ".join(str(int(i)) for i in ids)


def _hf_read(snapshot, page, new_tokens: int) -> dict:
    """``HFTorchOCRBackend(model_id=snapshot)`` reads ``page`` on the card
    (transformers' Qwen2.5-VL model moved to the card, ``generate``)
    against ``TorchOCRBackend`` loaded from the same snapshot: both in
    fp32 (the backend's bf16 load widened by a wrapper around
    ``from_pretrained``; TF32 off, so HF's patch convolution is fp32 as
    the port's patch product is), equal greedy tokens required.

    transformers' ``get_rope_index`` is recorded during the read and held
    against the port's M-RoPE ids (``rope_index_for_prompt``, equal to
    transformers 4.57's). Where they differ (transformers 5.5 multiplies
    the image's temporal ids, start offset included, by
    ``tokens_per_second``), the record says where, and the read is made
    again with ``get_rope_index`` returning the port's ids: its tokens
    must then equal the port's. transformers is imported here, only where
    it is installed, as the backend imports it at its first read."""
    import importlib

    transformers = importlib.import_module("transformers")

    from handwritten_ocr_tpu_torch.config import (OCR_MAX_PIXELS,
                                                  OCR_MIN_PIXELS, OCR_PROMPT)
    from handwritten_ocr_tpu_torch.engine.hf_ocr import HFTorchOCRBackend
    from handwritten_ocr_tpu_torch.engine.torch_engines import TorchOCRBackend
    from handwritten_ocr_tpu_torch.models.processor import load_image_rgb

    pixels = dict(min_pixels=OCR_MIN_PIXELS, max_pixels=OCR_MAX_PIXELS)
    port = TorchOCRBackend.from_pretrained(snapshot, dtype=torch.float32,
                                           kv_quant=False,
                                           pool_bytes=2 ** 30, **pixels)
    port.tokenizer = SpelledTokens(port.tokenizer)
    asked, rope = [], []

    def processor(original):
        return lambda model_id, **kw: PortProcessor(port, **kw)

    def model(original):
        def load(model_id, **kw):
            asked.append({k: str(v) for k, v in kw.items()})
            return original(model_id, **(kw | {"torch_dtype": torch.float32}))
        return load

    def port_ids(input_ids):
        grid = tuple(pack_grid)
        ids, delta = port.model._positions(input_ids.cpu().numpy(), grid)
        return ids.to(input_ids.device), torch.tensor(
            [[delta]], device=input_ids.device)

    def recorded(original):
        def get_rope_index(self, input_ids, *args, **kwargs):
            out = original(self, input_ids, *args, **kwargs)
            rope.append((out[0].cpu(), port_ids(input_ids)[0].cpu()))
            return out
        return get_rope_index

    def replaced(original):
        return lambda self, input_ids, *args, **kwargs: port_ids(input_ids)

    from handwritten_ocr_tpu_torch.models.processor import pack_image
    pack_grid = pack_image(load_image_rgb(page), **pixels).grid
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = HFTorchOCRBackend(model_id=str(snapshot), **pixels)
    eos = str(port.model.config.eos_token_id)
    try:
        with _patched(transformers.AutoProcessor, "from_pretrained",
                      processor), \
                _patched(transformers.AutoModelForImageTextToText,
                         "from_pretrained", model), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            backend._load()
            load_s = time.perf_counter() - t0
            inner = type(backend._model.model)
            t0 = time.perf_counter()
            with _patched(inner, "get_rope_index", recorded):
                got = backend.read(str(page), OCR_PROMPT, new_tokens)
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            hf_ids, ours = rope[0]
            rope_equal = torch.equal(hf_ids, ours)
            if not rope_equal:
                with _patched(inner, "get_rope_index", replaced):
                    got_port_rope = backend.read(str(page), OCR_PROMPT,
                                                 new_tokens)
        placed = {str(p.device) for p in backend._model.parameters()}
        dtypes = {str(p.dtype) for p in backend._model.parameters()}
        before = read_launches()
        want = port.read_batch([load_image_rgb(page)], OCR_PROMPT,
                               new_tokens)[0]
        torch.cuda.synchronize()
        port_launches = {k: v - before[k] for k, v in read_launches().items()}
    finally:
        with contextlib.redirect_stdout(io.StringIO()):
            backend.release()
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
    if placed != {str(backend.device)} or dtypes != {"torch.float32"}:
        raise AssertionError(f"the HF model is on {placed} in {dtypes}")
    got = got.removesuffix(" " + eos)
    record = dict(transformers=transformers.__version__, asked=asked,
                  device=sorted(placed), load_s=load_s, read_s=read_s,
                  rope_index_equal=rope_equal, tokens=len(want.split()),
                  tokens_equal=got == want, port_launches=port_launches)
    if rope_equal:
        if got != want or not want:
            raise AssertionError(f"HF read {got!r}, the port read {want!r}")
    else:
        column = int((hf_ids != ours).any(0).any(0).nonzero()[0])
        record.update(
            rope_first_difference=dict(
                column=column, transformers=hf_ids[:, 0, column].tolist(),
                port=ours[:, 0, column].tolist()),
            hf_tokens=got.split(), port_tokens=want.split(),
            tokens_equal_with_port_rope=(
                got_port_rope.removesuffix(" " + eos) == want))
        if not record["tokens_equal_with_port_rope"] or not want:
            raise AssertionError(
                f"HF read with the port's M-RoPE ids {got_port_rope!r}, "
                f"the port read {want!r}")
    del port
    return record


def phase_convert(card: str) -> dict:
    """``python -m handwritten_ocr_tpu_torch.cli.convert`` at full width.
    Random-weight HF snapshots (bf16, 4 shards + index, the byte-level
    ``tokenizer.json``) written with ``save_snapshot``: olmOCR-2-7B's and
    qwen3:32b's widths at the depths ``REDUCED`` names (the VL's 8
    vision blocks end with the global block 7). The CLI converts each in
    a subprocess on the card, its default device (``vl`` in bf16,
    ``qwen3 --quantize int8``); the two converters run at once, each
    ``convert_s`` its own wall, CUDA start-up included. Each engine is
    then loaded twice on the card, from the snapshot (the reasoner
    quantised at load) and from the checkpoint, with ``load_s`` for each
    way: the trees must be equal, and the greedy tokens too: two reads of
    page0 (the two initial strategies) and the 8 editor turns, at the
    token counts ``REDUCED`` names. Where transformers is installed, the
    VL snapshot is also read through ``HFTorchOCRBackend`` (``_hf_read``:
    32 tokens, equal to the port's in fp32). Launch counts set to 0
    before the phase and read after it (flash, window, the int8 paged
    kernel, the int8 matmul and, with the fp32 read, the fp32 paged body
    must launch; writing, converting, loading and transformers' model
    launch none); the fp32 read's own launches are kept apart
    (``fp32_launches``: the fp32 bodies' path)."""
    import importlib.util
    import tempfile
    from pathlib import Path

    from handwritten_ocr_tpu_torch.config import (OCR_PROMPT,
                                                  PREPROCESSING_STRATEGIES)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
    from handwritten_ocr_tpu_torch.models.weights import save_snapshot

    repo = Path(__file__).resolve().parent
    cfgs, reduced = reduced_configs("phase_convert"), REDUCED["phase_convert"]
    spec = json.dumps(byte_level_tokenizer_json())
    prep = TorchPreprocessor()
    page = repo / ".contract_pages" / "page0.png"
    images = [prep.apply(str(page), s) for s in PREPROCESSING_STRATEGIES[:2]]
    turns = editor_turns(8)
    with_hf = importlib.util.find_spec("transformers") is not None
    families = {
        "vl": (cfgs["vl"], init_vl, TorchOCRBackend, [], {},
               lambda e: e.read_batch(images, OCR_PROMPT,
                                      reduced["read_tokens"][0])),
        "qwen3": (cfgs["qwen3"], init_qwen3, TorchReasoningBackend,
                  ["--quantize", "int8"], {"quantize": "int8"},
                  lambda e: e.chat_batch(turns, temperature=0.1,
                                         max_tokens=reduced["chat_tokens"][0]))}
    record = dict(phase="convert", card=card, reduced=reduced)
    torch.cuda.synchronize()
    reset_launches()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        converters = {}
        try:
            for seed, (family, (cfg, init, _, flags, _, _)) in enumerate(
                    families.items(), start=SEED + 20):
                root = Path(work) / family
                snapshot = root / "snapshot"
                t0 = time.perf_counter()
                tree = init(cfg, dtype=torch.bfloat16, device="cuda", seed=seed)
                save_snapshot(snapshot, tree, cfg, shards=4)
                (snapshot / "tokenizer.json").write_text(spec, encoding="utf-8")
                del tree
                write_s = time.perf_counter() - t0
                c = converters[family] = dict(write_s=write_s, logs=[])
                c["logs"] = [open(root / name, "w") for name in ("out", "err")]
                c["t0"] = time.perf_counter()
                c["proc"] = subprocess.Popen(
                    [sys.executable, "-m",
                     "handwritten_ocr_tpu_torch.cli.convert", family,
                     str(snapshot), str(root / "ckpt"), *flags],
                    cwd=repo, stdout=c["logs"][0], stderr=c["logs"][1])
            deadline = time.perf_counter() + 600
            while any("convert_s" not in c for c in converters.values()):
                if time.perf_counter() > deadline:
                    raise AssertionError("cli.convert gave no exit in 600 s")
                for c in converters.values():
                    if "convert_s" not in c and c["proc"].poll() is not None:
                        c["convert_s"] = time.perf_counter() - c["t0"]
                time.sleep(0.05)
        finally:
            for c in converters.values():
                if "proc" in c and c["proc"].poll() is None:
                    c["proc"].kill()
                    c["proc"].wait(timeout=60)
                for log in c["logs"]:
                    log.close()
        for family, (cfg, init, engine_cls, flags, at_load, run) in \
                families.items():
            root, c = Path(work) / family, converters[family]
            snapshot, checkpoint = root / "snapshot", root / "ckpt"
            if c["proc"].returncode != 0:
                raise AssertionError(f"convert {family} failed:\n"
                                     f"{(root / 'err').read_text()[-4000:]}")
            meta = json.loads((checkpoint / "meta.json").read_text())
            if meta["family"] != family or \
                    meta["quantize"] != (flags[1] if flags else None) or \
                    not (checkpoint / "tokenizer.json").exists():
                raise AssertionError(f"{family} checkpoint: {meta}")
            engines, load_s = {}, {}
            for way, path, kwargs in (("snapshot", snapshot, at_load),
                                      ("checkpoint", checkpoint, {})):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engines[way] = engine_cls.from_pretrained(
                    path, pool_bytes=2 ** 30, **kwargs)
                torch.cuda.synchronize()
                load_s[way] = time.perf_counter() - t0
                engines[way].tokenizer = SpelledTokens(engines[way].tokenizer)
            if not _trees_equal(engines["snapshot"].model.params,
                                engines["checkpoint"].model.params):
                raise AssertionError(f"{family}: the checkpoint's tree "
                                     "differs from the snapshot's")
            streams = {way: run(engine) for way, engine in engines.items()}
            torch.cuda.synchronize()
            if streams["snapshot"] != streams["checkpoint"]:
                raise AssertionError(f"{family}: snapshot and checkpoint "
                                     f"engines differ: {streams}")
            record[family] = dict(
                write_s=c["write_s"], convert_s=c["convert_s"],
                converter_said=(root / "out").read_text().strip()
                .splitlines()[-1],
                snapshot_bytes=_dir_bytes(snapshot),
                checkpoint_bytes=_dir_bytes(checkpoint), load_s=load_s,
                calls=len(streams["snapshot"]), tokens_equal=True,
                tokens=sum(len(t.split()) for t in streams["snapshot"]))
            del engines, streams
            gc.collect()
            torch.cuda.empty_cache()
            if family == "vl":
                record["hf_read"] = (_hf_read(snapshot, page, 32) if with_hf
                                     else None)
                gc.collect()
                torch.cuda.empty_cache()
    launches = read_launches()
    record.update(seconds=time.perf_counter() - t_phase, launches=launches,
                  fp32_launches=(record["hf_read"] or {}).get(
                      "port_launches", {name: 0 for name in launches}))
    require_launches("convert", launches, (
        "flash_attention", "window_attention", "paged_append_attention_int8",
        "int8_matmul") + (("paged_append_attention_fp32",) if with_hf else ()))
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
                     ("paged_append_attention", "paged_append_attention_fp32"))
    require_launches("int8 Qwen3 reference", launches["qwen3_int8_kv"],
                     ("paged_append_attention_int8", "int8_matmul"))
    guided = _reference_guided()
    for name, counts in guided["launches"].items():
        require_launches(f"guided {name} reference", counts,
                         ("paged_append_attention_int8", "int8_matmul"))
    record["guided"] = guided["record"]
    launches["guided"] = guided["launches"]
    runs = [c for key, c in launches.items() if key != "guided"] + list(
        guided["launches"].values())
    # every card run here is fp32: an int8_matmul launch is the fp32-x body
    record["launches_all"] = {name: sum(c[name] for c in runs)
                              for name in runs[0]}
    record["transforms"] = _reference_transforms()
    record["launches"] = launches
    emit(**record)
    return record

# The verify forward's products (408 rows: each int8 weight widened to
# bf16, the product rounded to bf16, then times the bf16 scale) and the
# decode step's (24 rows: the int8 kernel, fp32 sum times the fp32 scale,
# one rounding) round differently, and 64 layers carry the difference to
# the logits: on the same inputs the two paths' logits at the plain
# step's top-2 ids differed by at most 0.29 on an H100 (136 compared, median top-1
# logit 6.3, random weights). Each verify forward must stay within
# TIE_GAP of the plain step there, and a speculative stream may leave the
# plain one only where the plain step's top-2 gap is below it.
TIE_GAP = 0.5


@contextlib.contextmanager
def _env(name: str, value: str | None):
    """Environment variable ``name`` set to ``value`` (None: unset) for
    the block."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(original)`` for the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _first_difference(a: list[int], b: list[int]) -> int | None:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _check_stream(name: str, plain: list[list[int]], got: list[list[int]],
                  gaps: list) -> list[dict]:
    """Each row of ``got`` equals the plain greedy row up to its first
    difference, which must sit where the plain decode step's top-2 gap
    (``gaps[row][position - 1]``) was below TIE_GAP. Returns the
    differences (row, position, plain gap)."""
    found = []
    for row, (want, have) in enumerate(zip(plain, got)):
        pos = _first_difference(want, have)
        if pos is None:
            continue
        if pos == 0 or pos > len(gaps[row]):
            raise AssertionError(f"{name}: row {row} leaves the plain stream "
                                 f"at {pos}, outside the decode steps")
        gap = float(gaps[row][pos - 1])
        if not gap < TIE_GAP:
            raise AssertionError(f"{name}: row {row} leaves the plain stream "
                                 f"at {pos}, where the plain top-2 gap is "
                                 f"{gap} (tolerance {TIE_GAP})")
        found.append(dict(row=row, position=pos, plain_gap=gap))
    return found


def _verify_vs_step(batcher, encoded: list[list[int]], repeats: int = 3):
    """A verify round (16 random drafts for every live slot) against a
    plain decode step (through the batcher's step graphs, so replayed
    after the warm-up), on the batcher's pools with the turns prefilled:
    wall ms of each (host clock to the tokens on the host, the median of
    ``repeats`` alternating calls) and device ms (the kernels' sum under
    the profiler, one call each). Each call appends its rows as a real
    round does; the slots are retired afterwards."""
    from handwritten_ocr_tpu_torch.engine.serving import GenRequest
    admitted = batcher._try_admit(deque(
        GenRequest(np.asarray(ids, np.int32), 128) for ids in encoded))
    batcher._prefill_admitted(admitted)
    n, k = batcher.n_slots, batcher.draft_k
    live = sorted(batcher._slot_req)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    drafts = torch.randint(0, batcher.program.cfg.vocab_size, (n, k),
                           generator=gen, device="cuda", dtype=torch.int32)
    active = torch.zeros(n, dtype=torch.bool, device="cuda")
    active[live] = True
    draft_len = torch.where(active, k, 0).to(torch.int32)
    rope = batcher._tensor(batcher._rope_delta)
    pages = batcher._table_pages(live, k + 2)
    program, cache = batcher.program, batcher.cache

    def verify(_=None):
        tokens, accepted = program.verify_step(
            cache, cache.lengths.new_tensor(batcher._last), drafts,
            draft_len, active, rope, table_pages=pages)
        return tokens.cpu(), accepted.cpu()

    def step(_=None):
        tokens, _, _ = program.decode_chunk(
            cache, cache.lengths.new_tensor(batcher._last), ~active,
            torch.full((n,), 2, dtype=torch.int32, device="cuda"), rope, 1,
            table_pages=pages, graphs=batcher._graphs)
        return tokens.cpu()

    walls = {"verify": [], "step": []}
    verify(), step()                      # warm-up
    for name in ("step", "verify", "verify", "step") * repeats:
        t0 = time.perf_counter()
        {"verify": verify, "step": step}[name]()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    device = {name: _profiled(fn, 0)[1] * 1e3
              for name, fn in (("verify", verify), ("step", step))}
    if int(cache.lengths.max()) >= (pages or batcher.max_blocks) * batcher.block_size:
        raise AssertionError("the measured rounds outgrew their table")
    for slot in list(batcher._slot_req):
        batcher._retire(slot)
    return {name: dict(wall_ms=float(np.median(w)), wall_ms_all=w,
                       device_ms=device[name] if device[name] else None)
            for name, w in walls.items()} | {"rows_per_verify": n * (k + 1)}


def phase_speculative(reasoner, turns: list[Turn], card: str, guided: dict,
                      max_new_tokens: int = 128) -> dict:
    """Prompt-lookup speculative decoding on the guided phase's qwen3:32b
    (its depth-cut engine over the resident weights, ``REDUCED``; int8
    weights and KV, 24 slots, draft_k 16), through a
    second backend on the same weights with ``eos_token_id=-1`` (random
    weights then decode to the budget) and a tokenizer that spells every
    id: 8 editor turns of ~1.2k tokens, 128 new tokens.

    1. plain greedy (``HOCR_SPEC`` unset), with each decode step's top-2
       logit gap per slot observed;
    2. speculative with drafts read from the plain streams
       (``GenRequest.draft_oracle``): rounds, drafted, accepted, tokens
       committed per round; launch counts set to 0 before this run and
       read after it (the int8 paged kernel must launch, and at 17 query
       tokens);
    3. ``chat_batch`` with ``HOCR_SPEC=1`` (prompt-lookup drafts; the
       editor turns repeat their words);
    4. a verify round against a decode step, wall and device ms;
    5. one guided editor round (``chat_batch(json_schema=...)``, 256
       tokens) with ``HOCR_SPEC=1`` on the resident reasoner, beside the
       guided phase's editor round on the same turns without it.
    Streams 2 and 3 must equal the plain one up to a near-tie
    (``_check_stream``)."""
    from handwritten_ocr_tpu_torch.agents.schemas import EditorResult
    from handwritten_ocr_tpu_torch.engine import serving
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models import paged
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.utils.jsonio import extract_json

    reasoner._batcher = None               # its pools go before this phase's
    gc.collect()
    torch.cuda.empty_cache()
    backend = TorchReasoningBackend(
        Qwen3Model(reasoner.model.params,
                   dataclasses.replace(reasoner.model.config, eos_token_id=-1)),
        spelling_tokenizer(), kv_quant=True)
    with _env("HOCR_SPEC", None):
        backend.chat_batch(turns, temperature=0.1, max_tokens=8)  # pools
    batcher = backend._batcher
    encoded = [backend._encode(t.system, t.user) for t in turns]
    slots = batcher._free_slots[::-1][:len(turns)]   # _try_admit's order
    n = batcher.n_slots

    row_of: dict = {}              # id(request) -> its turn, for the run

    def run(speculate: bool, oracle=None):
        requests = [serving.GenRequest(
            np.asarray(ids, np.int32), max_new_tokens, speculate=speculate,
            draft_oracle=None if oracle is None else np.asarray(o, np.int32))
            for ids, o in zip(encoded, oracle or encoded)]
        row_of.clear()
        row_of.update((id(q), r) for r, q in enumerate(requests))
        _reset_stats(batcher)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = batcher.run(requests)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def summary(call_s: float, tokens: list[list[int]]) -> dict:
        st, spec = batcher.stats, batcher.spec_stats
        committed = st["decode_tokens"] + st["verify_tokens"]
        return dict(call_s=call_s, **spec, **{k: st[k] for k in (
            "prefill_s", "decode_s", "decode_tokens", "verify_s",
            "verify_tokens")},
            tokens_per_round=(st["verify_tokens"] / spec["rounds"]
                              if spec["rounds"] else None),
            verify_round_wall_ms=(st["verify_s"] / spec["rounds"] * 1e3
                                  if spec["rounds"] else None),
            tokens_per_s=committed / (st["decode_s"] + st["verify_s"]),
            generated=[len(t) for t in tokens])

    steps: list = []

    def observe_plain(lm_logits):
        def observed(params, cfg, hidden, **kwargs):
            logits = lm_logits(params, cfg, hidden, **kwargs)
            if tuple(hidden.shape[:2]) == (n, 1):        # a decode step
                steps.append(torch.topk(logits[:, -1], 2))
            return logits
        return observed

    with _env("HOCR_SPEC", None), _patched(serving, "lm_logits", observe_plain):
        plain, plain_s = run(False)
    # The plain decode step's top-2 logits and ids of token j of turn r
    # (j >= 1; token 0 comes from the prefill): [r][j - 1, 2].
    top_vals = torch.stack([t.values for t in steps]).cpu()
    top_ids = torch.stack([t.indices for t in steps])
    top_vals = [top_vals[:, slot] for slot in slots]
    top_ids = [top_ids[:, slot] for slot in slots]
    gaps = [v[:, 0] - v[:, 1] for v in top_vals]
    del steps
    records = {"plain": summary(plain_s, plain)}
    records["plain"]["decode_step_wall_ms"] = (
        batcher.stats["decode_s"] / (batcher.stats["decode_tokens"]
                                     / len(turns)) * 1e3)

    t_counts: Counter = Counter()

    def count_t(paged_append_attention):
        def counted(q, *args, **kwargs):
            t_counts[int(q.shape[1])] += 1
            return paged_append_attention(q, *args, **kwargs)
        return counted

    # Each verify forward of the oracle run, at the rows whose inputs are
    # the plain stream's: its logits at the plain step's top-2 ids minus
    # the plain step's (the two paths' disagreement on the same inputs).
    k = batcher.draft_k
    deltas, delta_at = [], []

    def observe_verify(lm_logits):
        def observed(params, cfg, hidden, **kwargs):
            logits = lm_logits(params, cfg, hidden, **kwargs)
            if tuple(hidden.shape[:2]) != (n, k + 1):
                return logits
            picks = []
            for slot, request in batcher._slot_req.items():
                r = row_of[id(request)]
                done = len(request.tokens)
                if request.tokens != plain[r][:done]:
                    continue                     # it left the plain stream
                picks += [(slot, i, r, done + i) for i in range(k + 1)
                          if 1 <= done + i < len(plain[r])]
            if picks:
                slot_i = [p[0] for p in picks]
                row_i = [p[1] for p in picks]
                ids = torch.stack([top_ids[r][j - 1] for _, _, r, j in picks])
                got = logits[slot_i, row_i].gather(1, ids).cpu()
                deltas.append(got - torch.stack([top_vals[r][j - 1]
                                                 for _, _, r, j in picks]))
                delta_at.extend((r, j) for _, _, r, j in picks)
            return logits
        return observed

    reset_launches()
    with _patched(paged, "paged_append_attention", count_t), \
            _patched(serving, "lm_logits", observe_verify):
        oracle, oracle_s = run(True, oracle=plain)
    launches = read_launches()
    records["oracle"] = summary(oracle_s, oracle)
    records["oracle"]["paged_calls_by_query_tokens"] = dict(t_counts)
    agree = torch.cat(deltas) if deltas else torch.zeros(0, 2)
    # how far the verify forward moved plain's second token above its first
    flip = agree[:, 1] - agree[:, 0]
    records["oracle"]["logit_disagreement"] = dict(
        compared=len(agree),
        max_abs=float(agree.abs().max()) if len(agree) else None,
        p99_abs=float(agree.abs().quantile(0.99)) if len(agree) else None,
        max_flip_margin=float(flip.max()) if len(agree) else None,
        p99_flip_margin=float(flip.quantile(0.99)) if len(agree) else None)
    if not (len(agree) and records["oracle"]["logit_disagreement"]["max_abs"]
            < TIE_GAP):
        raise AssertionError(f"the verify forward's logits are not within "
                             f"{TIE_GAP} of the plain step's: "
                             f"{records['oracle']['logit_disagreement']}")
    records["oracle"]["left_plain"] = _check_stream("oracle", plain, oracle,
                                                    gaps)
    if not (records["oracle"]["rounds"] > 0
            and records["oracle"]["accepted"] > 0):
        raise AssertionError(f"oracle drafts were not accepted: "
                             f"{records['oracle']}")
    require_launches("speculative", launches, (
        "paged_append_attention_int8", "int8_matmul"))
    if t_counts[batcher.draft_k + 1] == 0:
        raise AssertionError(f"no paged launch at {batcher.draft_k + 1} "
                             f"query tokens: {dict(t_counts)}")

    _reset_stats(batcher)
    with _env("HOCR_SPEC", "1"):
        t0 = time.perf_counter()
        texts = backend.chat_batch(turns, temperature=0.1,
                                   max_tokens=max_new_tokens)
        torch.cuda.synchronize()
        lookup_s = time.perf_counter() - t0
    if backend._batcher is not batcher:
        raise AssertionError("the prompt-lookup call rebuilt the batcher")
    lookup = [[int(x) for x in text.split()] for text in texts]
    records["prompt_lookup"] = summary(lookup_s, lookup)
    records["prompt_lookup"]["left_plain"] = _check_stream(
        "prompt lookup", plain, lookup, gaps)
    round_vs_step = _verify_vs_step(batcher, encoded)
    del backend, batcher
    gc.collect()
    torch.cuda.empty_cache()

    editor = guided_requests(turns)["editor"]
    schema = editor[0].schema
    with _env("HOCR_SPEC", "1"):
        reasoner.chat_batch(editor[:1], temperature=0.1, max_tokens=8,
                            json_schema=schema)                  # pools
        gbatcher = reasoner._batcher
        _reset_stats(gbatcher)
        t0 = time.perf_counter()
        gtexts = reasoner.chat_batch(editor, temperature=0.1,
                                     max_tokens=guided["max_new_tokens"],
                                     json_schema=schema)
        torch.cuda.synchronize()
        guided_s = time.perf_counter() - t0
    stats = _guided_stats(gbatcher)
    valid = 0
    for text in gtexts:
        parsed = extract_json(text)
        if parsed is not None:
            EditorResult.validate(parsed)
            valid += 1
    fallbacks = stats["sessions"] - stats["sessions_complete"]
    if valid + fallbacks < len(gtexts):
        raise AssertionError(f"guided editor with HOCR_SPEC=1: {valid} valid "
                             f"texts and {fallbacks} fallbacks of "
                             f"{len(gtexts)}")
    records["guided_editor"] = dict(
        call_s=guided_s, **stats, **gbatcher.spec_stats,
        verify_s=gbatcher.stats["verify_s"],
        verify_tokens=gbatcher.stats["verify_tokens"], validated=valid,
        fallbacks=fallbacks,
        same_texts_as_plain=sum(a == b for a, b in zip(gtexts,
                                                       guided["texts"])),
        plain=guided["stats"])
    _require_depth("phase_speculative", reasoner.model)
    record = dict(phase="speculative", card=card,
                  model="qwen3:32b (Qwen3Config(eos_token_id=-1) widths)",
                  reduced=REDUCED["phase_speculative"], weights="int8",
                  kv_cache="int8", turns=len(turns),
                  prompt_tokens=[len(ids) for ids in encoded],
                  max_new_tokens=max_new_tokens, draft_k=16, tie_gap=TIE_GAP,
                  plain_top2_gap_median=float(torch.cat(gaps).median()),
                  plain_top2_gap_min=float(torch.cat(gaps).min()),
                  plain_top1_logit_median=float(torch.cat(
                      [v[:, 0] for v in top_vals]).median()),
                  round_vs_step=round_vs_step, **records,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                  launches=launches)
    emit(**record)
    return record


def phase_dense(ocr, reasoner, turns: list[Turn], card: str, int8: dict,
                max_new_tokens: int = 128, json_tokens: int = 256) -> dict:
    """The dense (contiguous-cache) path of both engines at full width, on
    depth-cut models over the resident weights (``REDUCED``) once the KV
    pools are dropped:
    ``TorchOCRBackend(serving="dense").read_batch`` on the read phase's 4
    pages x 2 strategies (128 tokens), ``TorchReasoningBackend(serving=
    "dense")``: ``chat_batch`` on the 8 left-padded editor turns (128
    tokens, ``eos_token_id=-1``) and one ``chat(json_schema=critic)``
    through ``generate_json`` (256 tokens, the published EOS). Per call:
    wall s, peak memory and launches; flash, window and the int8 matmul
    must launch. Both models' ``forward_logits`` must be finite. Then the
    same reads and turns through the paged engines over fp KV
    (``phase_fp_kv``; the closer yardstick: dense KV is bf16): the first
    differing token per row is reported, not required to be absent.
    ``int8``: the read and reasoning phases' records, for phase_fp_kv."""
    from handwritten_ocr_tpu_torch.config import (OCR_PROMPT,
                                                  PREPROCESSING_STRATEGIES)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model

    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel

    ocr._batcher = reasoner._batcher = None     # the pools go first
    gc.collect()
    torch.cuda.empty_cache()
    tokenizer = spelling_tokenizer()
    prep = TorchPreprocessor()
    images = [prep.apply(page, s) for page in synthetic_pages(4)
              for s in PREPROCESSING_STRATEGIES[:2]]
    cfgs = reduced_configs("phase_dense")
    vl_model = VLModel(depth_cut(ocr.model.params, cfgs["vl"]), cfgs["vl"])
    q_params = depth_cut(reasoner.model.params, cfgs["qwen3"])
    free = Qwen3Model(q_params,
                      dataclasses.replace(cfgs["qwen3"], eos_token_id=-1))
    critic = guided_requests(turns[:1])["critic"][0]
    engines = {
        "read_batch": (TorchOCRBackend(vl_model, tokenizer, serving="dense"),
                       lambda e: e.read_batch(images, OCR_PROMPT,
                                              max_new_tokens)),
        "chat_batch": (TorchReasoningBackend(free, tokenizer, serving="dense"),
                       lambda e: e.chat_batch(turns, temperature=0.1,
                                              max_tokens=max_new_tokens)),
        "chat_json": (TorchReasoningBackend(Qwen3Model(q_params, cfgs["qwen3"]),
                                            dense_tokenizer(),
                                            serving="dense"),
                      lambda e: [e.chat(critic.system, critic.user,
                                        temperature=0.1, max_tokens=json_tokens,
                                        json_schema=critic.schema)])}
    calls, outputs = {}, {}
    reset_launches()
    for name, (engine, call) in engines.items():
        before = read_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outputs[name] = call(engine)
        torch.cuda.synchronize()
        calls[name] = dict(
            call_s=time.perf_counter() - t0,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={k: v - before[k] for k, v in read_launches().items()},
            batcher=engine._batcher is not None)
    launches = read_launches()
    require_launches("dense", launches, ("flash_attention", "window_attention",
                                         "int8_matmul"))
    if any(c["batcher"] for c in calls.values()):
        raise AssertionError(f"a dense engine built a batcher: {calls}")
    if len(outputs["read_batch"]) != len(images) or \
            len(outputs["chat_batch"]) != len(turns):
        raise AssertionError("dense calls returned the wrong number of texts")
    ids = [engines["chat_batch"][0]._encode(t.system, t.user) for t in turns]
    logits = free.forward_logits([ids[0][:512]])
    vl_ids = engines["read_batch"][0]._prompt_ids(OCR_PROMPT, 0)
    vl_logits = vl_model.forward_logits([vl_ids])
    for name, out in (("qwen3", logits), ("vl", vl_logits)):
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite {name} forward_logits")
    del logits, vl_logits
    fp_kv = phase_fp_kv(vl_model, free, tokenizer, images, turns, outputs,
                        int8, card, max_new_tokens)
    record = dict(phase="dense", card=card, reduced=REDUCED["phase_dense"],
                  models=["olmOCR-2-7B (VLConfig() widths), bf16",
                          "qwen3:32b (Qwen3Config() widths), int8 weights"],
                  kv_cache="bf16, contiguous, per call", reads=len(images),
                  turns=len(turns), prompt_tokens=[len(i) for i in ids],
                  json_prompt_tokens=len(engines["chat_json"][0]._encode(
                      critic.system, critic.user)),
                  max_new_tokens=max_new_tokens, json_tokens=json_tokens,
                  calls=calls, json_text=outputs["chat_json"][0][:160],
                  agreement_with_paged_fp_kv=fp_kv["agreement_with_dense"],
                  launches=launches)
    emit(**record)
    return record | {"fp_kv": fp_kv}


def phase_fp_kv(vl_model, llm_model, tokenizer, images, turns: list[Turn],
                dense_out: dict, int8: dict, card: str,
                max_new_tokens: int = 128) -> dict:
    """The fp-KV paged path at full width on the dense phase's depth-cut
    models (``REDUCED``): ``TorchOCRBackend`` and
    ``TorchReasoningBackend`` built with
    ``HOCR_KV_INT8=0`` and no ``kv_quant`` (bf16 pools, the paged kernel's
    tensor-core fp-KV body), over the read phase's 8 reads (``VLConfig()``
    bf16) and the 8 editor turns (qwen3:32b int8 weights), 128 tokens.
    Per engine: a first call, whose tokens are held against the dense
    path's (the first differing token per row); the timed call, with every
    launch count set to 0 before it and read after it (the bf16 body must
    launch, the fp32 body and the int8 branch must not); wall, prefill and
    decode s and ms per decode step; then two traced calls
    (``phase_trace``). Beside each, the int8 path's figures from this
    run's read and reasoning phases (``int8``: full depth)."""
    from handwritten_ocr_tpu_torch.config import OCR_PROMPT
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchReasoningBackend)
    _require_depth("phase_fp_kv", vl_model, llm_model)
    with _env("HOCR_KV_INT8", "0"):
        engines = {"read_batch": TorchOCRBackend(vl_model, tokenizer),
                   "chat_batch": TorchReasoningBackend(llm_model, tokenizer)}
    run = {"read_batch": lambda e, n: e.read_batch(images, OCR_PROMPT, n),
           "chat_batch": lambda e, n: e.chat_batch(turns, temperature=0.1,
                                                   max_tokens=n)}
    rows = {"read_batch": len(images), "chat_batch": len(turns)}
    calls, agreement = {}, {}
    for name, engine in engines.items():
        if engine.kv_quant:
            raise AssertionError(f"{name}: HOCR_KV_INT8=0 left the KV int8")
        first = run[name](engine, max_new_tokens)
        want = [[int(x) for x in t.split()] for t in first]
        got = [[int(x) for x in t.split()] for t in dense_out[name]]
        agreement[name] = dict(
            first_difference=[_first_difference(a, b)
                              for a, b in zip(want, got)],
            tokens=[len(t) for t in got])
        batcher = engine._batcher
        batcher.stats.update(prefill_s=0.0, decode_s=0.0, decode_tokens=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        texts = run[name](engine, max_new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        require_launches(f"fp-KV {name}", launches, ("paged_append_attention",))
        if launches["paged_append_attention_fp32"] or \
                launches["paged_append_attention_int8"]:
            raise AssertionError(f"fp-KV {name}: a body other than the bf16 "
                                 f"one launched: {launches}")
        if len(texts) != rows[name] or engine._batcher is not batcher:
            raise AssertionError(f"fp-KV {name}: {len(texts)} texts, or the "
                                 "timed call rebuilt the batcher")
        cache = batcher.cache
        if cache.quantized or cache.k.dtype != torch.bfloat16:
            raise AssertionError(f"fp-KV {name} decoded over {cache.k.dtype}")
        check_pools(cache, f"fp-KV {name}")
        stats = dict(batcher.stats)
        trace = phase_trace(f"fp_kv_{name}",
                            lambda budget: run[name](engine, budget))
        calls[name] = dict(
            wall_s=wall, prefill_s=stats["prefill_s"],
            decode_s=stats["decode_s"], decode_tokens=stats["decode_tokens"],
            decode_step_ms=stats["decode_s"]
            / (stats["decode_tokens"] / rows[name]) * 1e3,
            traced_step_device_ms=trace["decode_step_device_ms"],
            traced_step_wall_ms=trace["decode_step_wall_ms"],
            pool_blocks=batcher.n_blocks,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=launches)
        engine._batcher = None
        del batcher, cache
        gc.collect()
        torch.cuda.empty_cache()
    read, chat = int8["read"], int8["chat"]
    same_run_int8 = {
        "read_batch": dict(
            wall_s=read["read_s"] - read["preprocess_s"],
            prefill_s=read["prefill_s"], decode_s=read["decode_s"],
            decode_step_ms=read["decode_s"]
            / (read["decode_tokens"] / read["reads"]) * 1e3,
            traced_step_device_ms=read["trace"]["decode_step_device_ms"],
            traced_step_wall_ms=read["trace"]["decode_step_wall_ms"],
            launches=read["launches"]),
        "chat_batch": dict(
            wall_s=chat["call_s"], prefill_s=chat["prefill_s"],
            decode_s=chat["decode_s"], decode_step_ms=chat["decode_step_ms"],
            traced_step_device_ms=chat["trace"]["decode_step_device_ms"],
            traced_step_wall_ms=chat["trace"]["decode_step_wall_ms"],
            launches=chat["launches"])}
    record = dict(phase="fp_kv", card=card, env="HOCR_KV_INT8=0",
                  reduced=REDUCED["phase_fp_kv"],
                  kv_cache="bf16, paged", max_new_tokens=max_new_tokens,
                  models=["olmOCR-2-7B (VLConfig() widths), bf16",
                          "qwen3:32b (Qwen3Config() widths), int8 weights"],
                  calls=calls, int8_same_run_at="full depth",
                  int8_same_run=same_run_int8,
                  agreement_with_dense=agreement)
    emit(**record)
    return record


def phase_kernels_decode_modes(cfg, qcfg, prompt_len: int, q_prompt_len: int,
                         json_prompt_len: int) -> list[dict]:
    """The kernels at the speculative and dense paths' shapes: paged
    attention over int8 and over bf16 pools at 17 query tokens (a verify
    round, draft_k 16) with 8 of 24 slots live and every append crossing a
    page boundary, at 64:8 and 28:4 heads; flash at the dense VL prefill (unpadded prompt, causal)
    and at ``generate_json``'s one-row Qwen3 prefill; the int8 matmul at
    one row (``generate_json``'s steps). Runs when no model is
    resident."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    txt, slots = cfg.text, cfg_mod.SERVE_SLOTS
    rows = [
        _paged_case("paged_append_attention", "qwen3_verify_int8_t17", slots,
                    8, q_prompt_len + 64, qcfg.num_hidden_layers,
                    qcfg.num_attention_heads, qcfg.num_key_value_heads,
                    qcfg.head_dim, True, gen, "speculative", t=17),
        _paged_case("paged_append_attention", "vl_verify_int8_t17", slots, 8,
                    prompt_len + 64, txt.num_hidden_layers,
                    txt.num_attention_heads, txt.num_key_value_heads,
                    txt.head_dim, True, gen, "speculative", t=17),
        _paged_case("paged_append_attention", "qwen3_verify_t17", slots, 8,
                    q_prompt_len + 64, qcfg.num_hidden_layers,
                    qcfg.num_attention_heads, qcfg.num_key_value_heads,
                    qcfg.head_dim, False, gen, "fp_kv_chat", t=17),
        _paged_case("paged_append_attention", "vl_verify_t17", slots, 8,
                    prompt_len + 64, txt.num_hidden_layers,
                    txt.num_attention_heads, txt.num_key_value_heads,
                    txt.head_dim, False, gen, "fp_kv_read", t=17),
        _flash_case("dense_vl_prefill_causal", "dense", 8, prompt_len,
                    txt.num_attention_heads, txt.num_key_value_heads,
                    txt.head_dim, gen, causal=True),
        _flash_case("dense_qwen3_json_prefill_causal", "dense", 1,
                    json_prompt_len, qcfg.num_attention_heads,
                    qcfg.num_key_value_heads, qcfg.head_dim, gen,
                    causal=True)]
    d, ffn, vocab = qcfg.hidden_size, qcfg.intermediate_size, qcfg.vocab_size
    for case, d_in, d_out, out_dtype in (
            ("gate_m1", d, ffn, torch.bfloat16),
            ("lm_head_m1", d, vocab, torch.float32)):
        rows.append(_int8_matmul_case(case, 1, d_in, d_out, out_dtype, gen,
                                      "dense"))
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


# The paged kernel's qwen3:32b decode rows of PERF.md section 6 whose
# shapes the runs above do not fix (the pipeline's walk at its cut depth,
# the guided path's fp-KV twin): (case, live slots of 24, cached context).
PAGED_TABLE_ROWS = (("pipeline_critic", 3, 2609),
                    ("pipeline_editor", 3, 1590),
                    ("pipeline_arbitrator", 1, 1755),
                    ("guided_critic", 8, 3080),
                    ("guided_editor", 8, 2415))


def phase_kernels_paged_table(qcfg) -> list[dict]:
    """The paged kernel at the decode shapes of PERF.md section 6 that no
    run above fixes, both tensor-core bodies (int8 pools: the path each
    row is named after; bf16 pools: the fp-KV chat path that runs that
    body), each held to its plain version and timed beside SDPA. Runs
    when no model is resident."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    rows = []
    for case, live, context in PAGED_TABLE_ROWS:
        for kv_quant in (True, False):
            rows.append(_paged_case(
                "paged_append_attention",
                f"table_{case}_decode{'_int8' if kv_quant else ''}",
                cfg_mod.SERVE_SLOTS, live, context, qcfg.num_hidden_layers,
                qcfg.num_attention_heads, qcfg.num_key_value_heads,
                qcfg.head_dim, kv_quant, gen,
                case.split("_")[0] if kv_quant else "fp_kv_chat"))
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


def phase_kernels_fp32(cfg, qcfg, prompt_len: int) -> list[dict]:
    """The kernels' fp32 bodies at full width, each held at the fp32
    tolerance and shown to refuse a TF32 stand-in (``_refuses_tf32``):
    flash (the vision global layer and the causal prefill), window and
    paged attention at the shapes the convert phase's fp32 read gives
    them (``TorchOCRBackend`` on the VL snapshot in fp32, fp32 pools: one
    924x672 page, 1 of 24 slots live, 32 new tokens; path convert_fp32),
    and the int8 matmul's fp32-x body at a qwen3:32b gate projection of
    24 rows (path reference: the reference phase's fp32 Qwen3, whose
    every int8 launch takes this body, at narrow width). Runs when no
    model is resident."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    vis, txt, f32 = cfg.vision, cfg.text, torch.float32
    plan = plan_grid(vis, (1, 924 // 14, 672 // 14))
    valid = torch.as_tensor(plan.valid, device="cuda")
    rows = [
        _flash_case("vision_global_fp32", "convert_fp32", 1, len(plan.valid),
                    vis.num_heads, vis.num_heads, vis.head_dim, gen,
                    valid=valid, dtype=f32),
        _flash_case("prefill_causal_fp32", "convert_fp32", 1, prompt_len,
                    txt.num_attention_heads, txt.num_key_value_heads,
                    txt.head_dim, gen, causal=True, dtype=f32),
        _window_case("vision_window_fp32", "convert_fp32", 1, plan,
                     vis.num_heads, vis.head_dim, gen, dtype=f32),
        _paged_case("paged_append_attention", "decode_step_fp32",
                    cfg_mod.SERVE_SLOTS, 1, prompt_len + 16,
                    txt.num_hidden_layers, txt.num_attention_heads,
                    txt.num_key_value_heads, txt.head_dim, False, gen,
                    "convert_fp32", dtype=f32),
        _int8_matmul_case("gate_m24_fp32", cfg_mod.SERVE_SLOTS,
                          qcfg.hidden_size, qcfg.intermediate_size, f32, gen,
                          "reference", x_dtype=f32)]
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


# ── tp: both engines over two ranks (tensor parallelism) ────────────

TP_WORLD = 2
TP_NEW_TOKENS = REDUCED["phase_tp"]["new_tokens"][0]
TP_CONTEXT = 2048          # the tp pools' token bound
TP_TIMEOUT_S = 900
ONE_CARD_RING = ("one card; NCCL needs a card per rank and gloo sends no "
                 "CUDA tensors")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(world: int, target, timeout: float, *args) -> list:
    """``target(rank, world, port, *args)`` in ``world`` spawned
    processes that join one group on a free localhost port; returns each
    rank's result in rank order. A rank's exception, a non-zero exit or
    no answer within ``timeout`` seconds raises; every process is
    stopped either way."""
    import queue
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, port, results, args))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.perf_counter() + timeout
    out: dict = {}
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                raise AssertionError(
                    f"ranks {sorted(set(range(world)) - set(out))} gave no "
                    f"result within {timeout} s") from None
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for proc in procs:
            proc.join(timeout=120)
            if proc.exitcode != 0:
                raise AssertionError(f"a rank exited with {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
    return [out[r] for r in range(world)]


def _rank_main(target, rank: int, world: int, port: int, results,
               args) -> None:
    """One rank: joins the group through the port's
    ``initialize_from_env`` (HOCR_DIST_*, which binds its card), runs
    ``target`` and sends its result (or traceback) to the parent."""
    import traceback

    import torch.distributed as dist
    try:
        os.environ.update(HOCR_DIST_COORD=f"localhost:{port}",
                          HOCR_DIST_NPROCS=str(world),
                          HOCR_DIST_PROC_ID=str(rank))
        for name in ("HOCR_SPEC", "HOCR_VL_SERVING", "HOCR_LLM_SERVING",
                     "HOCR_KV_INT8"):
            os.environ.pop(name, None)
        from handwritten_ocr_tpu_torch.parallel.distributed import (
            initialize_from_env)
        if not initialize_from_env():
            raise AssertionError("the rank joined no process group")
        result = target(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, result))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _tp_pool_bytes(text_cfg, tp: int) -> int:
    """The rank's int8 KV pool for SERVE_SLOTS sequences of TP_CONTEXT
    tokens (its kv heads) and the trash block."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.models.paged import PagedKVCache
    block = cfg_mod.SERVE_BLOCK_SIZE
    blocks = 1 + cfg_mod.SERVE_SLOTS * -(-TP_CONTEXT // block)
    return blocks * PagedKVCache.block_bytes(
        text_cfg.num_hidden_layers, block, text_cfg.num_key_value_heads // tp,
        text_cfg.head_dim, kv_quant=True)


def _tp_timed(backend, warm, call, counts: dict, what: str,
              required) -> dict:
    """A short warm-up call, then ``call`` with every launch and
    collective count set to 0 before it and read after it: wall s, the
    batcher's prefill and decode s, decode steps and ms a step, the
    all-reduces of the call and of a decode step, peak memory, and each
    row's greedy ids (the spelling tokenizer's texts)."""
    warm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in counts:
        counts[key] = 0
    reset_launches()
    t0 = time.perf_counter()
    texts = call()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_launches()
    require_launches(f"tp {what}", launches, required)
    check_pools(backend._batcher.cache, f"tp {what}")
    stats = backend._batcher.stats
    steps = counts["steps"]
    return dict(
        call_s=call_s, prefill_s=stats["prefill_s"],
        decode_s=stats["decode_s"], decode_tokens=stats["decode_tokens"],
        decode_steps=steps, decode_step_ms=stats["decode_s"] / steps * 1e3,
        allreduces=counts["all"], allreduces_per_step=counts["decode"] / steps,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        pool_blocks=backend._batcher.n_blocks, launches=launches,
        streams=[[int(t) for t in text.split()] for text in texts])


def _tp_qwen3(mesh, counts: dict) -> dict:
    """qwen3:32b at int8, full width at the depth ``REDUCED`` names, drawn
    whole one matrix at a time from the reasoning phase's seed, the rank
    keeping its slices: the reasoning cell's 8 editor turns,
    TP_NEW_TOKENS tokens."""
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.quant import quantized_bytes
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model

    qcfg = dataclasses.replace(reduced_configs("phase_tp")["qwen3"],
                               eos_token_id=-1)
    tp = mesh.size(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_qwen3(qcfg, dtype=torch.bfloat16, device="cuda", seed=SEED,
                        quantize="int8", mesh=mesh)
    torch.cuda.synchronize()
    record = dict(model="qwen3:32b (Qwen3Config() widths)", weights="int8",
                  init_s=time.perf_counter() - t0,
                  init_peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                  weight_bytes=quantized_bytes(params))
    backend = TorchReasoningBackend(
        Qwen3Model(params, qcfg, mesh), spelling_tokenizer(), kv_quant=True,
        pool_bytes=_tp_pool_bytes(qcfg, tp)).shard(mesh)
    turns = editor_turns(8)
    record |= _tp_timed(
        backend,
        lambda: backend.chat_batch([Turn("sys", "hello")], temperature=0.1,
                                   max_tokens=2),
        lambda: backend.chat_batch(turns, temperature=0.1,
                                   max_tokens=TP_NEW_TOKENS),
        counts, "qwen3 chat",
        ("flash_attention", "paged_append_attention_int8", "int8_matmul"))
    del backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _tp_vl(mesh, counts: dict) -> dict:
    """olmOCR-2-7B (``VLConfig()`` widths at the depth ``REDUCED`` names)
    in bf16, drawn from the read phase's seed, the rank keeping its
    slices: the read cell's 8 reads (4 pages x 2 strategies),
    TP_NEW_TOKENS tokens."""
    from handwritten_ocr_tpu_torch.config import (OCR_PROMPT,
                                                  PREPROCESSING_STRATEGIES)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.parallel.budget import tree_bytes

    cfg = reduced_configs("phase_tp")["vl"]
    tp = mesh.size(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED,
                     mesh=mesh)
    torch.cuda.synchronize()
    record = dict(model="olmOCR-2-7B (VLConfig() widths)", weights="bf16",
                  init_s=time.perf_counter() - t0,
                  weight_bytes=tree_bytes(params))
    backend = TorchOCRBackend(VLModel(params, cfg, mesh), spelling_tokenizer(),
                              kv_quant=True,
                              pool_bytes=_tp_pool_bytes(cfg.text, tp)
                              ).shard(mesh)
    prep = TorchPreprocessor()
    images = [prep.apply(page, s) for page in synthetic_pages(4)
              for s in PREPROCESSING_STRATEGIES[:2]]
    record |= _tp_timed(
        backend, lambda: backend.read_batch(images[:1], OCR_PROMPT, 2),
        lambda: backend.read_batch(images, OCR_PROMPT, TP_NEW_TOKENS),
        counts, "VL read",
        ("flash_attention", "window_attention", "paged_append_attention_int8"))
    del backend, params
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _allreduce_ms(mesh) -> dict:
    """Time of one all-reduce over the model group at the shapes a step
    gives it (CUDA events can not see the host copies of gloo, so host
    clock around synchronised loops): a decode step's [24, 1, D] bf16
    rows at both models' widths, the top-k merge's [2, 24, 1] int64, and
    a VL prefill group's [8, 1024, 3584] bf16 rows."""
    import torch.distributed as dist
    from handwritten_ocr_tpu_torch.parallel.mesh import model_group
    group = model_group(mesh)

    def ms(tensor, iters):
        dist.all_reduce(tensor, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(tensor, group=group)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    bf16 = dict(dtype=torch.bfloat16, device="cuda")
    return {"rows_24x5120_bf16": ms(torch.zeros((24, 1, 5120), **bf16), 50),
            "rows_24x3584_bf16": ms(torch.zeros((24, 1, 3584), **bf16), 50),
            "topk_keys_2x24x1_int64": ms(torch.zeros(
                (2, 24, 1), dtype=torch.int64, device="cuda"), 50),
            "prefill_8x1024x3584_bf16": ms(torch.zeros((8, 1024, 3584),
                                                       **bf16), 5)}


def _narrow_tp_configs():
    """The reference phase's narrow models with their head counts doubled
    (vision 4 x 80, text 4:2 x 128), so that two ranks each run the
    reference phase's head shapes (2 x 80; 2:1 x 128)."""
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    vl = VLConfig(
        vision=VisionConfig(depth=4, hidden_size=320, intermediate_size=640,
                            num_heads=4, fullatt_block_indexes=(1, 3),
                            out_hidden_size=512),
        text=TextConfig(hidden_size=512, intermediate_size=1024,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2))
    qwen3 = Qwen3Config(vocab_size=152000, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        head_dim=128, eos_token_id=-1)
    return vl, qwen3


def _tp_reference(mesh) -> dict:
    """The narrow fp32 models on the card, whole (one rank alone) and
    sliced over the mesh, with the int8 and the fp KV cache: the greedy
    ids of both (the parent holds them equal)."""
    from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model

    vl_cfg, q_cfg = _narrow_tp_configs()
    prep = TorchPreprocessor(min_pixels=28 * 28)
    images = [prep.apply(np.ascontiguousarray(p[:168, :224]), s)
              for p in synthetic_pages(2)
              for s in PREPROCESSING_STRATEGIES[:2]]
    turns = [Turn("sys", "Correct: teh cat sat"), Turn(
        EDITOR_SYSTEM, "Correct this transcription:\nwe had rain for days")]
    out = {}
    for kv_quant in (True, False):
        kv = "int8_kv" if kv_quant else "fp_kv"
        for name in ("vl", "qwen3"):
            texts = []
            for sliced in (None, mesh):
                if name == "vl":
                    params = init_vl(vl_cfg, dtype=torch.float32,
                                     device="cuda", seed=SEED + 1,
                                     mesh=sliced)
                    texts.append(TorchOCRBackend(
                        VLModel(params, vl_cfg, sliced), spelling_tokenizer(),
                        kv_quant=kv_quant).read_batch(images,
                                                      "Read the page.", 16))
                else:
                    params = init_qwen3(q_cfg, dtype=torch.float32,
                                        device="cuda", seed=SEED + 4,
                                        quantize="int8", mesh=sliced)
                    texts.append(TorchReasoningBackend(
                        Qwen3Model(params, q_cfg, sliced),
                        spelling_tokenizer(), kv_quant=kv_quant
                    ).chat_batch(turns, temperature=0.1, max_tokens=16))
            out[f"{name}_{kv}"] = texts
    return out


def _tp_rank(rank: int, world: int) -> dict:
    """One rank of the tp phase: its card and backend, then qwen3:32b,
    olmOCR-2-7B, the collectives' times and the narrow references, with
    the all-reduces it issues counted (all, and inside decode steps)."""
    import torch.distributed as dist
    from handwritten_ocr_tpu_torch.engine.serving import PagedProgram
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model_parallel=world)
    counts = {"all": 0, "decode": 0, "steps": 0}
    inside = [False]
    all_reduce = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        counts["all"] += 1
        counts["decode"] += inside[0]
        return all_reduce(tensor, *args, **kwargs)

    def in_decode(original):
        def run(self, *args, **kwargs):
            inside[0] = True
            try:
                return original(self, *args, **kwargs)
            finally:
                inside[0] = False
        return run

    def stepping(original):
        def run(self, *args, **kwargs):
            counts["steps"] += 1
            return original(self, *args, **kwargs)
        return run

    record = dict(rank=rank, backend=dist.get_backend(),
                  card=torch.cuda.current_device(),
                  card_name=torch.cuda.get_device_name())
    with _patched(dist, "all_reduce", lambda _: counting), \
            _patched(PagedProgram, "decode_chunk", in_decode), \
            _patched(PagedProgram, "_step", stepping):
        record["qwen3"] = _tp_qwen3(mesh, counts)
        record["vl"] = _tp_vl(mesh, counts)
    record["allreduce_ms"] = _allreduce_ms(mesh)
    record["reference"] = _tp_reference(mesh)
    return record


def _tp_single() -> dict:
    """The tp phase's two models whole on this card, drawn from the same
    seeds at the same depths, through the same calls: the single-card
    streams a TP rank's are held against."""
    from handwritten_ocr_tpu_torch.config import (OCR_PROMPT,
                                                  PREPROCESSING_STRATEGIES)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model

    cfgs = reduced_configs("phase_tp")
    qcfg = dataclasses.replace(cfgs["qwen3"], eos_token_id=-1)
    chat = TorchReasoningBackend(
        Qwen3Model(init_qwen3(qcfg, dtype=torch.bfloat16, device="cuda",
                              seed=SEED, quantize="int8"), qcfg),
        spelling_tokenizer(), kv_quant=True,
        pool_bytes=_tp_pool_bytes(qcfg, 1)).chat_batch(
        editor_turns(8), temperature=0.1, max_tokens=TP_NEW_TOKENS)
    gc.collect()
    torch.cuda.empty_cache()
    prep = TorchPreprocessor()
    images = [prep.apply(page, s) for page in synthetic_pages(4)
              for s in PREPROCESSING_STRATEGIES[:2]]
    read = TorchOCRBackend(
        VLModel(init_vl(cfgs["vl"], dtype=torch.bfloat16, device="cuda",
                        seed=SEED), cfgs["vl"]),
        spelling_tokenizer(), kv_quant=True,
        pool_bytes=_tp_pool_bytes(cfgs["vl"].text, 1)).read_batch(
        images, OCR_PROMPT, TP_NEW_TOKENS)
    gc.collect()
    torch.cuda.empty_cache()
    return {path: [[int(t) for t in text.split()] for text in texts]
            for path, texts in (("chat", chat), ("read", read))}


def phase_tp(card: str) -> dict:
    """Both engines over TP_WORLD ranks (``shard(mesh)``, TP over
    "model"), at the depths ``REDUCED`` names: a card per rank over NCCL
    where there are enough cards, else every rank on cuda:0 over gloo.
    Prints each rank's line, then the phase's: the backend, the ranks per
    card, each model's call_s, decode ms a step and all-reduces a step
    with their ms, and each row's first token that differs from the
    single-card stream of the same seed and depth (``_tp_single``, run
    first; bf16 and int8 products round otherwise in a rank's partial
    sums, so rows may leave at near-ties). The ranks' ids must be equal,
    and the narrow fp32 models' tokens equal to their single-card
    tokens."""
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    single = _tp_single()
    single_s = time.perf_counter() - t0
    ranks = _spawn_ranks(TP_WORLD, _tp_rank, TP_TIMEOUT_S)
    phase_s = time.perf_counter() - t0
    for r in ranks:
        emit(phase="tp_rank", **{k: v for k, v in r.items() if k != "reference"}
             | {m: {k: v for k, v in r[m].items() if k != "streams"}
                for m in ("qwen3", "vl")})
    record = dict(phase="tp", card=card, reduced=REDUCED["phase_tp"],
                  world=TP_WORLD, backend=ranks[0]["backend"],
                  ranks_per_card=-(-TP_WORLD // torch.cuda.device_count()),
                  phase_s=phase_s, single_card_s=single_s,
                  parent_resident_gb=resident,
                  new_tokens=TP_NEW_TOKENS, pool_context=TP_CONTEXT,
                  peak_memory_gb=[{m: r[m]["peak_memory_gb"]
                                   for m in ("qwen3", "vl")} for r in ranks],
                  allreduce_ms=ranks[0]["allreduce_ms"])
    for model, path in (("qwen3", "chat"), ("vl", "read")):
        streams = [r[model]["streams"] for r in ranks]
        if any(s != streams[0] for s in streams):
            raise AssertionError(f"tp {model}: the ranks' ids differ")
        want = [row[:TP_NEW_TOKENS] for row in single[path]]
        got = streams[0]
        if len(got) != len(want):
            raise AssertionError(f"tp {model}: {len(got)} rows, want "
                                 f"{len(want)}")
        info = {k: ranks[0][model][k] for k in (
            "call_s", "prefill_s", "decode_s", "decode_steps",
            "decode_step_ms", "allreduces", "allreduces_per_step",
            "init_s", "weight_bytes", "pool_blocks")}
        info["first_difference"] = [_first_difference(g, w)
                                    for g, w in zip(got, want)]
        record[model] = info
    equal = {}
    for key, (whole, sliced) in ranks[0]["reference"].items():
        for r in ranks[1:]:
            if r["reference"][key] != [whole, sliced]:
                raise AssertionError(f"tp reference {key}: ranks differ")
        if whole != sliced:
            raise AssertionError(f"tp reference {key}: TP tokens differ from "
                                 f"the single-card tokens: {whole} {sliced}")
        equal[key] = sum(len(t.split()) for t in whole)
    record["reference_tokens_equal"] = equal
    record["launches"] = {name: ranks[0]["qwen3"]["launches"][name]
                          + ranks[0]["vl"]["launches"][name]
                          for name in ranks[0]["vl"]["launches"]}
    emit(**record)
    return record


def _ring_rank(rank: int, world: int) -> dict:
    """``ring_attention`` over the data axis of a (world, 1) mesh at
    [1, 8192, 64/8, 128] bf16, causal, against plain attention of the
    rank's rows (fp32 scores, a few heads at a time)."""
    from handwritten_ocr_tpu_torch.parallel.context_parallel import (
        ring_attention)
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(model_parallel=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    b, s, hq, hkv, d = 1, 8192, 64, 8, 128
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").bfloat16()
    got = ring_attention(q, k, v, mesh=mesh, causal=True)
    chunk = s // world
    rows = slice(rank * chunk, (rank + 1) * chunk)
    want = []
    for h in range(0, hq, 8):
        qh = q[:, rows, h:h + 8].float()
        kh = k[:, :, h // 8:h // 8 + 1].float()
        vh = v[:, :, h // 8:h // 8 + 1].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh.expand(-1, -1, 8, -1))
        mask = (torch.arange(s, device="cuda")[None, :]
                <= torch.arange(rank * chunk, (rank + 1) * chunk,
                                device="cuda")[:, None])
        scores = (scores * d ** -0.5).masked_fill(~mask, float("-inf"))
        want.append(torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1),
                                 vh.expand(-1, -1, 8, -1)))
    cmp = _compare(f"ring_attention rank {rank}", got,
                   torch.cat(want, dim=2).to(torch.bfloat16))
    ms = time_ms(lambda: ring_attention(q, k, v, mesh=mesh, causal=True),
                 iters=3, warmup=1)
    return dict(rank=rank, ms=ms, **cmp)


def phase_ring(card: str) -> dict:
    """Ring attention over two cards (NCCL), or the line that says why
    it did not run on one card."""
    if torch.cuda.device_count() < 2:
        record = dict(phase="ring", ran=False, why=ONE_CARD_RING)
        emit(**record)
        return record
    ranks = _spawn_ranks(2, _ring_rank, 600)
    record = dict(phase="ring", ran=True, card=card, world=2,
                  shape=[1, 8192, 64, 8, 128], causal=True, ranks=ranks)
    emit(**record)
    return record


def phase_kernels_tp(cfg, qcfg, prompt_len: int, q_prompt_len: int) -> list[dict]:
    """Each kernel at the shapes one rank of TP = 2 and of TP = 4 gives
    it: flash at the vision global layers, the VL prefill and the Qwen3
    prefill, window at the rank's packed qkv, int8 paged attention at
    both models' decode steps, and the int8 matmul at the rank's
    qwen3:32b projections and lm_head (151936 / tp channels: 75968, an
    odd count of 64-channel blocks, and 37984, not a multiple of 64).
    Runs in the parent, with no group and no model resident."""
    from handwritten_ocr_tpu_torch import config as cfg_mod
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    vis, txt = cfg.vision, cfg.text
    plan = plan_grid(vis, (1, 924 // 14, 672 // 14))
    valid = torch.as_tensor(plan.valid, device="cuda")
    unit, slots = cfg_mod.SERVE_PREFILL_BUCKET, cfg_mod.SERVE_SLOTS
    vl_bucket = -(-prompt_len // unit) * unit
    q_bucket = -(-q_prompt_len // unit) * unit
    d, ffn, vocab = qcfg.hidden_size, qcfg.intermediate_size, qcfg.vocab_size
    q_width = qcfg.num_attention_heads * qcfg.head_dim
    kv_width = qcfg.num_key_value_heads * qcfg.head_dim
    rows = []
    for tp in (2, 4):
        heads = vis.num_heads // tp
        rows += [
            _flash_case(f"vision_global_tp{tp}", "tp", 8, len(plan.valid),
                        heads, heads, vis.head_dim, gen, valid=valid),
            _window_case(f"vision_window_tp{tp}", "tp", 8, plan, heads,
                         vis.head_dim, gen),
            _flash_case(f"prefill_causal_tp{tp}", "tp", 8, vl_bucket,
                        txt.num_attention_heads // tp,
                        txt.num_key_value_heads // tp, txt.head_dim, gen,
                        causal=True),
            _flash_case(f"qwen3_prefill_causal_tp{tp}", "tp", 8, q_bucket,
                        qcfg.num_attention_heads // tp,
                        qcfg.num_key_value_heads // tp, qcfg.head_dim, gen,
                        causal=True),
            _paged_case("paged_append_attention", f"decode_step_int8_tp{tp}",
                        slots, 8, prompt_len + 64, txt.num_hidden_layers,
                        txt.num_attention_heads // tp,
                        txt.num_key_value_heads // tp, txt.head_dim, True,
                        gen, "tp"),
            _paged_case("paged_append_attention",
                        f"qwen3_decode_int8_tp{tp}", slots, 8,
                        q_prompt_len + 64, qcfg.num_hidden_layers,
                        qcfg.num_attention_heads // tp,
                        qcfg.num_key_value_heads // tp, qcfg.head_dim, True,
                        gen, "tp")]
        for case, d_in, d_out, out_dtype in (
                ("q", d, q_width // tp, torch.bfloat16),
                ("k", d, kv_width // tp, torch.bfloat16),
                ("gate", d, ffn // tp, torch.bfloat16),
                ("o", q_width // tp, d, torch.bfloat16),
                ("down", ffn // tp, d, torch.bfloat16),
                ("lm_head", d, vocab // tp, torch.float32)):
            rows.append(_int8_matmul_case(f"{case}_m24_tp{tp}", slots, d_in,
                                          d_out, out_dtype, gen, "tp"))
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


# ── training (the fine-tuning step) ───────────────────────────────────

TRAIN_STEPS = 3
TRAIN_PAGE = 448          # pixels a side: 1024 patches, 256 image tokens
TRAIN_TARGET_CHARS = 200
# Gradient check, kernels against plain versions, per leaf: fp32 largest
# error within TRAIN_FP32_GRAD_TOL of the leaf's max|grad| (fp32 sums in
# another order through four layers); bf16 RMS error within
# TRAIN_BF16_RMS_TOL of the leaf's RMS (the two forwards round to bf16 at
# other points, and the plain backward rounds dP to bf16 where the
# reference keeps fp32); the losses within TRAIN_LOSS_RTOL.
TRAIN_FP32_GRAD_TOL = 1e-3
TRAIN_BF16_RMS_TOL = 5e-2
TRAIN_LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """Names of a tree's leaves in ``train.optim.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree)
                for n in _leaf_names(tree[key], f"{prefix}/{key}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def train_pages(root) -> None:
    """One TRAIN_PAGE-square synthetic page, written as PNG by the port's
    writer, and its ground truth: TRAIN_TARGET_CHARS characters of
    lower-case words from a seeded generator."""
    from handwritten_ocr_tpu_torch.models.png import write_png
    rng = np.random.default_rng(SEED + 8)
    write_png(root / "page.png", synthetic_pages(1, TRAIN_PAGE, TRAIN_PAGE)[0])
    words = []
    while len(" ".join(words)) < TRAIN_TARGET_CHARS:
        words.append("".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                        rng.integers(2, 9))))
    text = " ".join(words)[:TRAIN_TARGET_CHARS].rstrip()
    text += "x" * (TRAIN_TARGET_CHARS - len(text))
    (root / "page.md").write_text(f"## Ground Truth\n{text}\n",
                                  encoding="utf-8")


def _train_batch(cfg, root):
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    from handwritten_ocr_tpu_torch.train.data import (batches_by_grid,
                                                      discover_examples)
    examples = discover_examples(root)
    batches = list(batches_by_grid(examples, ByteTokenizer(), cfg,
                                   batch_size=1))
    if len(examples) != 1 or len(batches) != 1:
        raise AssertionError(f"{len(examples)} examples, {len(batches)} "
                             "batches from one page")
    batch, grid = batches[0]
    side = TRAIN_PAGE // 14
    if tuple(grid) != (1, side, side) or not batch.input_ids.is_cuda:
        raise AssertionError(f"grid {grid}, batch on "
                             f"{batch.input_ids.device}")
    return batch, tuple(grid)


class _StepClock:
    """CUDA events at a train step's phases, through ``next_token_loss``
    and the default optimizer's ``update`` wrapped in place (the step
    calls both through its module's names): forward = the loss call;
    backward = from its end to the update's entry; the update runs after
    a check that every gradient is finite and not all zero. Each phase
    also opens a ``record_function`` range for the profiler."""

    def __init__(self, leaf_names: list[str]):
        self.names = leaf_names
        self.events = {}
        self.grad_report = None

    def _event(self, name: str):
        self.events[name] = torch.cuda.Event(enable_timing=True)
        self.events[name].record()

    def loss(self, fn):
        def timed(*args, **kwargs):
            self._event("forward_start")
            with torch.profiler.record_function("train_forward"):
                loss = fn(*args, **kwargs)
            self._event("forward_end")
            return loss
        return timed

    def optimizer(self, make):
        def wrapped(*args, **kwargs):
            init, update = make(*args, **kwargs)

            def timed(grads, state, params):
                self._event("check_start")
                with torch.profiler.record_function("train_grad_check"):
                    self.grad_report = self.check(grads)
                self._event("update_start")
                with torch.profiler.record_function("train_optimizer"):
                    state = update(grads, state, params)
                self._event("update_end")
                return state
            return init, timed
        return wrapped

    def check(self, grads) -> dict:
        ok = torch.stack([torch.isfinite(g).all() & (g != 0).any()
                          for g in grads])
        bad = [self.names[i] for i in torch.nonzero(~ok).flatten().tolist()]
        if bad:
            raise AssertionError(f"{len(bad)} gradient leaves are not finite "
                                 f"or all zero: {bad[:8]}")
        qkv = [i for i, n in enumerate(self.names)
               if n.endswith(("/qkv/w", "/q/w", "/k/w", "/v/w"))]
        peaks = torch.stack([grads[i].abs().max() for i in qkv]).float()
        return dict(leaves=len(grads), qkv_leaves=len(qkv),
                    qkv_min_max_abs=float(peaks.min()))

    def ms(self) -> dict:
        e = self.events
        return dict(
            forward_ms=e["forward_start"].elapsed_time(e["forward_end"]),
            backward_ms=e["forward_end"].elapsed_time(e["check_start"]),
            grad_check_ms=e["check_start"].elapsed_time(e["update_start"]),
            optimizer_ms=e["update_start"].elapsed_time(e["update_end"]))


def _changed_share(params, before) -> float:
    """Share of parameter elements that differ from ``before`` (host
    copies), one tensor at a time on the card."""
    changed = total = 0
    for p, old in zip(params, before):
        changed += int((p != old.to(p.device, non_blocking=False)).sum())
        total += p.numel()
    return changed / total


TRAIN_RANGES = ("train_forward", "train_grad_check", "train_optimizer",
                "flash_attention_backward", "window_attention_backward")


def _profile_train_step(run) -> dict:
    """One train step under ``torch.profiler``, read from its raw events:
    the device time of every kernel, memcpy and memset (the ranges' own
    device-side annotation spans left out), and of the kernels launched
    inside each ``record_function`` range (its host-side event's
    ``device_time_total``: the forward, the grad check, the update and the
    two kernels' backward ranges, autograd through the reference forms).
    The backward is the step less the forward, the grad check and the
    update; ``reference_backward_share`` is the two backward ranges' share
    of it."""
    from torch.profiler import ProfilerActivity, profile
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = sum(e.device_time_total for e in events
                 if e.device_type == cuda and e.name not in TRAIN_RANGES) / 1e3
    ranges = {name: 0.0 for name in TRAIN_RANGES}
    counts = Counter()
    for e in events:
        if e.device_type == cpu and e.name in ranges:
            ranges[e.name] += e.device_time_total / 1e3
            counts[e.name] += 1
    if not device:
        return dict(traced=False, wall_ms=wall)
    backward = device - sum(ranges[k] for k in (
        "train_forward", "train_grad_check", "train_optimizer"))
    reference = (ranges["flash_attention_backward"]
                 + ranges["window_attention_backward"])
    return dict(traced=True, wall_ms=wall, step_device_ms=device,
                busy_share=device / wall,
                range_device_ms=ranges, range_calls=dict(counts),
                backward_device_ms=backward,
                reference_backward_share=reference / backward)


def phase_train(cfg, card: str) -> dict:
    """Fine-tuning: olmOCR-2-7B (``VLConfig()``, published widths, full
    depth) in bf16 on the card, one 448x448 page with a 200-character
    ground truth through ``discover_examples`` / ``batches_by_grid``
    (byte tokenizer, B = 1), then TRAIN_STEPS calls of the
    ``make_train_step(cfg, grid)`` step (default ``adamw(1e-5)``) and one
    more under the profiler. Before: the plan (params, grads, mu, nu
    bytes) against the card. Per step, counts set to 0 before and read
    after: flash 32 and window 28 launches (4 vision global + 28 text
    causal layers; 28 window layers; the backward launches none), every
    gradient finite and not all zero, peak memory below the card. Also
    the share of parameter elements the first step changed."""
    import tempfile
    from pathlib import Path

    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.parallel.budget import tree_bytes
    from handwritten_ocr_tpu_torch.train import step as train_step_mod
    from handwritten_ocr_tpu_torch.train.optim import tree_leaves

    resident = torch.cuda.memory_allocated()
    if resident >= 2 ** 30:
        raise AssertionError(f"{resident / 2 ** 30:.2f} GiB resident before "
                             "the train phase")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    params = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    names = _leaf_names(params)
    n_params = _count_params(params)
    n_bytes = tree_bytes(params)
    plan = dict(params=n_bytes, grads=n_bytes, mu=n_bytes, nu=n_bytes)
    planned = sum(plan.values())
    emit(phase="train_plan", n_params=n_params, bytes=plan,
         planned_bytes=planned, card_bytes=card_bytes,
         fits=planned <= card_bytes, init_s=init_s, card=card)
    if planned > card_bytes:
        raise AssertionError(f"training state {planned} B > card "
                             f"{card_bytes} B")

    with tempfile.TemporaryDirectory() as work:
        root = Path(work)
        train_pages(root)
        batch, grid = _train_batch(cfg, root)
    tokens = batch.input_ids.numel()
    target = int(batch.loss_mask.sum())
    clock = _StepClock(names)
    with _patched(train_step_mod, "next_token_loss", clock.loss), \
            _patched(train_step_mod, "adamw", clock.optimizer):
        init, train_step = train_step_mod.make_train_step(cfg, grid)
        opt_state = init(params)
        torch.cuda.synchronize()
        steps, losses = [], []
        before = None
        for i in range(TRAIN_STEPS):
            if i == 0:
                before = [x.detach().to("cpu", copy=True) for x in leaves]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            params, opt_state, loss = train_step(params, opt_state, batch)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            loss = float(loss)
            peak = torch.cuda.max_memory_allocated()
            if not math.isfinite(loss):
                raise AssertionError(f"train step {i + 1}: loss {loss}")
            if (launches["flash_attention"], launches["window_attention"]) \
                    != (32, 28):
                raise AssertionError(f"train step {i + 1}: launches {launches}")
            require_launches("train", launches, ("flash_attention",
                                                 "window_attention"))
            if peak >= card_bytes:
                raise AssertionError(f"train step {i + 1}: peak {peak} B")
            wall_ms = start.elapsed_time(end)
            record = dict(phase="train_step", step=i + 1, loss=loss,
                          wall_ms=wall_ms, host_ms=host_ms, **clock.ms(),
                          peak_gib=peak / 2 ** 30,
                          target_tokens_per_s=target / wall_ms * 1e3,
                          tokens_per_s=tokens / wall_ms * 1e3,
                          grads=clock.grad_report, launches=launches)
            if i == 0:
                record["changed_share"] = _changed_share(leaves, before)
                del before
            emit(**record)
            steps.append(record)
            losses.append(loss)
        traced_run = {}

        def traced_step():
            traced_run["out"] = train_step(params, opt_state, batch)

        traced = _profile_train_step(traced_step)
        params, opt_state, _ = traced_run.pop("out")
    if opt_state.count != TRAIN_STEPS + 1:
        raise AssertionError(f"optimizer count {opt_state.count}")
    record = dict(phase="train", card=card, config="VLConfig() bf16",
                  grid=list(grid), tokens=tokens, target_tokens=target,
                  params=n_params, losses=losses, steps=TRAIN_STEPS,
                  changed_share=steps[0]["changed_share"],
                  peak_gib=max(r["peak_gib"] for r in steps),
                  launches=steps[-1]["launches"], traced_step=traced)
    emit(**record)
    del params, opt_state, leaves, batch, init, train_step
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _grads(params, cfg, batch, grid):
    from handwritten_ocr_tpu_torch.train.optim import tree_leaves
    from handwritten_ocr_tpu_torch.train.step import next_token_loss
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = next_token_loss(params, cfg, batch, grid)
    grads = torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return float(loss), grads


def phase_train_grad_check(card: str) -> dict:
    """Gradients through the kernels against gradients through their plain
    versions, at full width and reduced depth (vision 2 blocks: one
    window, one global; text 2 layers), on the train phase's page: once
    in fp32 (the kernels' fp32 bodies; fp32 matmuls in full fp32) and
    once in bf16. ``flash_attention`` / ``window_attention`` are swapped
    for their plain versions in the model modules for the second pass,
    so its backward is autograd through the plain versions."""
    import tempfile
    from pathlib import Path

    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl import language, vision
    from handwritten_ocr_tpu_torch.ops.flash_attention import (
        flash_attention_plain)
    from handwritten_ocr_tpu_torch.ops.window_attention import (
        window_attention_plain)

    small = reduced_configs("phase_train_grad_check")["vl"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        root = Path(work)
        train_pages(root)
        batch, grid = _train_batch(small, root)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = init_vl(small, dtype=dtype, device="cuda", seed=SEED)
        names = _leaf_names(params)
        reset_launches()
        loss_k, grads_k = _grads(params, small, batch, grid)
        launches = read_launches()
        if (launches["flash_attention"], launches["window_attention"]) != (3, 1):
            raise AssertionError(f"grad check launches {launches}")
        with _patched(vision, "flash_attention",
                      lambda _: flash_attention_plain), \
                _patched(vision, "window_attention",
                         lambda _: window_attention_plain), \
                _patched(language, "flash_attention",
                         lambda _: flash_attention_plain):
            reset_launches()
            loss_p, grads_p = _grads(params, small, batch, grid)
            if any(read_launches().values()):
                raise AssertionError("the plain pass launched a kernel")
        worst = (None, -1.0)
        for name, a, b in zip(names, grads_k, grads_p):
            a, b = a.float(), b.float()
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: non-finite kernel gradient")
            peak = float(b.abs().max())
            if dtype == torch.float32:
                ratio = float((a - b).abs().max()) / peak
                bound = TRAIN_FP32_GRAD_TOL
            else:
                ratio = float((a - b).pow(2).mean().sqrt()
                              / b.pow(2).mean().sqrt())
                bound = TRAIN_BF16_RMS_TOL
            if not ratio <= bound:                  # also catches NaN
                raise AssertionError(f"{name} ({dtype}): kernel vs plain "
                                     f"gradient {ratio} > {bound}")
            if ratio > worst[1]:
                worst = (name, ratio)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        if not loss_rel <= TRAIN_LOSS_RTOL[dtype]:
            raise AssertionError(f"{dtype} loss {loss_k} vs {loss_p}")
        key = "fp32" if dtype == torch.float32 else "bf16"
        out[key] = dict(loss_kernels=loss_k, loss_plain=loss_p,
                        loss_rel_err=loss_rel, leaves=len(names),
                        worst_leaf=worst[0], worst=worst[1],
                        bound=(TRAIN_FP32_GRAD_TOL if key == "fp32"
                               else TRAIN_BF16_RMS_TOL),
                        measure=("max|err| / max|plain|" if key == "fp32"
                                 else "RMS(err) / RMS(plain)"),
                        launches=launches)
        del params, grads_k, grads_p
        torch.cuda.empty_cache()
    record = dict(phase="train_grad_check", card=card,
                  reduced=REDUCED["phase_train_grad_check"],
                  config="VLConfig() widths, vision 2 blocks, text 2 layers",
                  tokens=batch.input_ids.numel(), **out)
    emit(**record)
    return record


def phase_kernels_train(cfg, tokens: int) -> list[dict]:
    """Flash and window at the train step's shapes (one 448x448 page:
    1024 vision slots, all live; ``tokens`` text tokens), with the
    backward's time (autograd through the reference forms) beside SDPA's
    backward."""
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid
    side = TRAIN_PAGE // 14
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    vis, txt = cfg.vision, cfg.text
    plan = plan_grid(vis, (1, side, side))
    valid = torch.as_tensor(plan.valid, device="cuda")
    rows = [
        _flash_case("train_vision_global", "train", 1, len(plan.valid),
                    vis.num_heads, vis.num_heads, vis.head_dim, gen,
                    valid=valid, backward=True),
        _window_case("train_vision_window", "train", 1, plan, vis.num_heads,
                     vis.head_dim, gen, backward=True),
        _flash_case("train_text_causal", "train", 1, tokens,
                    txt.num_attention_heads, txt.num_key_value_heads,
                    txt.head_dim, gen, causal=True, backward=True)]
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


SHARDED_WORLD = 2
SHARDED_TIMEOUT_S = 900
SHARDED_LR = 3e-3         # the fp32 check: AdamW moves every leaf visibly,
SHARDED_EPS = 1e-3        # and its eps keeps the update a smooth function
# of the gradient: a gradient of rounding noise (the k biases', zero in
# exact arithmetic) would otherwise become a whole step of either sign
SHARDED_FP32_TOL = 2e-4   # abs and rel, tests/test_torch_train_sharded.py's
# bf16 at full width: a TP rank rounds its partial products to bf16 before
# the all-reduce sums them, where one card rounds each product once; over
# 60 layers the loss may move by this share of itself (FSDP gathers the
# weights exactly and computes each row as one card does)
SHARDED_BF16_LOSS_RTOL = 1e-2
FSDP_NEW_TOKENS = REDUCED["phase_fsdp_serving"]["new_tokens"][0]


def _meta_vl(cfg) -> dict:
    """The VL tree's shapes (tensors on the meta device, bf16), for the
    plan a rank prints before it allocates."""
    from handwritten_ocr_tpu_torch.models import init as init_mod

    class Shapes(init_mod._Init):
        def __init__(self):
            self.dtype, self.device = torch.bfloat16, torch.device("meta")
            self.quantize, self.mesh = False, None

        def normal(self, *shape, dtype=None):
            return torch.empty(shape, dtype=dtype or self.dtype,
                               device="meta")

    init = Shapes()
    return {"vision": init_mod._init_vision(init, cfg.vision),
            "text": init_mod._init_text(init, cfg.text)}


class _Collectives:
    """Counts the rank's ``all_reduce`` calls, their bytes and their host
    time (gloo copies a CUDA tensor through host memory, so the call
    returns when the sum is on the card)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls, self.bytes, self.ms = 0, 0, 0.0

    def wrap(self, all_reduce):
        def counted(tensor, *args, **kwargs):
            t0 = time.perf_counter()
            out = all_reduce(tensor, *args, **kwargs)
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            return out
        return counted

    def read(self) -> dict:
        return dict(calls=self.calls, bytes=self.bytes, ms=self.ms)


def _sharded_batch(cfg, rows: int):
    """The train phase's page batch, its one row repeated ``rows`` times
    (every data rank's row is then the single-card batch)."""
    import tempfile
    from pathlib import Path

    from handwritten_ocr_tpu_torch.train.step import TrainBatch
    with tempfile.TemporaryDirectory() as work:
        root = Path(work)
        train_pages(root)
        batch, grid = _train_batch(cfg, root)
    return TrainBatch(*(t.repeat_interleave(rows, dim=1 if i == 2 else 0)
                        for i, t in enumerate(batch))), grid


def _sharded_fp32_check(mesh, fsdp: bool) -> dict:
    """The narrow fp32 VL (``_narrow_tp_configs``) one step on this card
    whole and one step sharded over ``mesh`` (FSDP when ``fsdp``), both
    at SHARDED_LR and SHARDED_EPS from the same weights and global batch:
    the loss, every
    gradient the update gets and every updated leaf (the rank's slices of
    the single-card results) within SHARDED_FP32_TOL."""
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.parallel.sharding import (param_shardings,
                                                             shard_params)
    from handwritten_ocr_tpu_torch.train.data import shard_batch
    from handwritten_ocr_tpu_torch.train.optim import adamw, tree_leaves
    from handwritten_ocr_tpu_torch.train.step import make_train_step

    cfg, _ = _narrow_tp_configs()
    data = mesh.size(0)
    batch, grid = _sharded_batch(cfg, data)

    def run(params, step_mesh, specs, step_batch):
        init, update = adamw(SHARDED_LR, eps=SHARDED_EPS)
        seen = []

        def keeping(grads, state, leaves):
            seen.extend(g.clone() for g in grads)
            return update(grads, state, leaves)

        _, step = make_train_step(cfg, grid, (init, keeping), step_mesh,
                                  specs)
        params, _, loss = step(params, init(params), step_batch)
        return params, seen, float(loss)

    whole = init_vl(cfg, dtype=torch.float32, device="cuda", seed=SEED + 1)
    specs = param_shardings(mesh, whole, fsdp=True) if fsdp else None
    sliced = shard_params(mesh, whole, fsdp=fsdp)
    if sliced is whole:
        raise AssertionError("the mesh sliced nothing")
    got, got_grads, loss = run(sliced, mesh, specs, shard_batch(mesh, batch))
    whole = init_vl(cfg, dtype=torch.float32, device="cuda", seed=SEED + 1)
    want, want_grads, want_loss = run(whole, None, None, batch)
    want_grads = tree_leaves(shard_params(mesh, _tree_like(whole, want_grads),
                                          fsdp=fsdp))
    want = tree_leaves(shard_params(mesh, want, fsdp=fsdp))
    worst = {}
    for name, a, b in (("grads", got_grads, want_grads),
                       ("params", tree_leaves(got), want)):
        if len(a) != len(b):
            raise AssertionError(f"{len(a)} {name} leaves, want {len(b)}")
        excess = max(float(((x - y).abs() - SHARDED_FP32_TOL * y.abs())
                           .max()) for x, y in zip(a, b))
        worst[name] = excess
        if not excess <= SHARDED_FP32_TOL:
            raise AssertionError(f"sharded fp32 {name}: |err| - rtol*|want| "
                                 f"reaches {excess}")
    if not abs(loss - want_loss) <= SHARDED_FP32_TOL * (1 + abs(want_loss)):
        raise AssertionError(f"sharded fp32 loss {loss} vs {want_loss}")
    return dict(loss=loss, single_card_loss=want_loss,
                grads_excess=worst["grads"], params_excess=worst["params"],
                leaves=len(want), tol=SHARDED_FP32_TOL)


def _tree_like(tree, leaves: list):
    """``leaves`` (``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def _sharded_full_width(mesh, fsdp: bool, counter: _Collectives,
                        steps: int) -> dict:
    """olmOCR-2-7B (``VLConfig()`` widths at the depth ``REDUCED`` names)
    in bf16 over ``mesh``: TP slices drawn from the train phase's seed one
    layer at a time, or (FSDP) the whole tree drawn and this rank's "data"
    blocks kept. The plan printed before the state is allocated; ``steps``
    steps of the train phase's page (one row per data rank), each
    counted from 0: flash / window launches (a launch per global block
    and text layer / per windowed block), all-reduces with bytes and
    ms, wall ms, peak memory; the first step's loss."""
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.parallel.budget import tree_bytes
    from handwritten_ocr_tpu_torch.parallel.sharding import (param_shardings,
                                                             shard_params)
    from handwritten_ocr_tpu_torch.train.data import shard_batch
    from handwritten_ocr_tpu_torch.train.step import make_train_step

    cfg = reduced_configs("phase_train_sharded")["vl"]
    n_global = len(cfg.vision.fullatt_block_indexes)
    want_launches = (n_global + cfg.text.num_hidden_layers,
                     cfg.vision.depth - n_global)
    data = mesh.size(0)
    mine = tree_bytes(shard_params(mesh, _meta_vl(cfg), fsdp=fsdp))
    plan = dict(params=mine, grads=mine, mu=mine, nu=mine,
                total=4 * mine, card_bytes=torch.cuda.get_device_properties(
                    0).total_memory)
    emit(phase="train_sharded_plan", rank=torch.distributed.get_rank(),
         mesh=list(mesh.shape), fsdp=fsdp, bytes=plan)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    specs = None
    if fsdp:
        whole = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED)
        specs = param_shardings(mesh, whole, fsdp=True)
        params = shard_params(mesh, whole, fsdp=True)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    else:
        params = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED,
                         mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if tree_bytes(params) != mine:
        raise AssertionError(f"{tree_bytes(params)} B of slices, planned "
                             f"{mine}")
    batch, grid = _sharded_batch(cfg, data)
    batch = shard_batch(mesh, batch)
    init, step = make_train_step(cfg, grid, mesh=mesh, shardings=specs)
    state = init(params)
    records = []
    for i in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        counter.reset()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        loss = float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        if not math.isfinite(loss):
            raise AssertionError(f"sharded step {i + 1}: loss {loss}")
        if (launches["flash_attention"], launches["window_attention"]) \
                != want_launches:
            raise AssertionError(f"sharded step {i + 1}: launches {launches}")
        records.append(dict(step=i + 1, loss=loss, wall_ms=wall_ms,
                            collectives=counter.read(),
                            peak_gib=torch.cuda.max_memory_allocated()
                            / 2 ** 30, launches=launches))
    del params, state, batch, init, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(mesh=list(mesh.shape), fsdp=fsdp, init_s=init_s,
                plan=plan, steps=records)


def _train_sharded_rank(rank: int, world: int) -> dict:
    """One rank of train_sharded: the fp32 checks at (1, 2) TP and (2, 1)
    FSDP, then full width at (1, 2) TP (two steps: the first pays the
    first calls) and at (2, 1) FSDP (one step: its ~47 s are gloo's
    gathers, the same every step), with its all-reduces counted."""
    import torch.distributed as dist
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh

    tp, dp = make_mesh(model_parallel=world), make_mesh(model_parallel=1)
    record = dict(rank=rank, backend=dist.get_backend(),
                  card=torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    record["fp32_tp"] = _sharded_fp32_check(tp, fsdp=False)
    record["fp32_fsdp"] = _sharded_fp32_check(dp, fsdp=True)
    gc.collect()
    torch.cuda.empty_cache()
    counter = _Collectives()
    with _patched(dist, "all_reduce", counter.wrap):
        record["tp"] = _sharded_full_width(tp, False, counter, steps=2)
        record["fsdp"] = _sharded_full_width(dp, True, counter, steps=1)
    return record


def _single_card_loss(cfg) -> float:
    """The first train step's loss of ``cfg`` on one card: the train
    phase's loss (``next_token_loss``) on its page, over the weights the
    train phase draws (its seed) at ``cfg``'s depth, before any update."""
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.train.step import next_token_loss
    params = init_vl(cfg, dtype=torch.bfloat16, device="cuda", seed=SEED)
    batch, grid = _sharded_batch(cfg, 1)
    with torch.no_grad():
        loss = float(next_token_loss(params, cfg, batch, grid))
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def phase_train_sharded(card: str) -> dict:
    """Sharded fine-tuning over SHARDED_WORLD ranks (NCCL with a card
    each where there are enough cards, else both on cuda:0 over gloo):
    the narrow fp32 model's step sharded equal to its single-card step
    (loss, gradients, updated leaves within SHARDED_FP32_TOL), then
    olmOCR-2-7B at full width in bf16 at the depth ``REDUCED`` names,
    TP = 2 and FSDP over 2 data ranks, with each rank's plan, peak, step
    ms, all-reduces and launches, and the first step's loss within
    SHARDED_BF16_LOSS_RTOL of the single-card loss at the same depth
    (``_single_card_loss``, run first)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = _single_card_loss(reduced_configs("phase_train_sharded")["vl"])
    ranks = _spawn_ranks(SHARDED_WORLD, _train_sharded_rank,
                         SHARDED_TIMEOUT_S)
    phase_s = time.perf_counter() - t0
    for r in ranks:
        emit(phase="train_sharded_rank", **r)
    record = dict(phase="train_sharded", card=card,
                  reduced=REDUCED["phase_train_sharded"], world=SHARDED_WORLD,
                  backend=ranks[0]["backend"],
                  ranks_per_card=-(-SHARDED_WORLD
                                   // torch.cuda.device_count()),
                  phase_s=phase_s, single_card_loss=want,
                  loss_rtol=SHARDED_BF16_LOSS_RTOL)
    for key in ("tp", "fsdp"):
        losses = {r[key]["steps"][0]["loss"] for r in ranks}
        if len(losses) != 1:
            raise AssertionError(f"train_sharded {key}: ranks' losses "
                                 f"{losses}")
        loss = losses.pop()
        if not abs(loss - want) <= SHARDED_BF16_LOSS_RTOL * abs(want):
            raise AssertionError(f"train_sharded {key}: loss {loss} vs the "
                                 f"single card's {want}")
        record[key] = dict(
            mesh=ranks[0][key]["mesh"], loss=loss,
            loss_rel_diff=abs(loss - want) / abs(want),
            step_ms=[[s["wall_ms"] for s in r[key]["steps"]] for r in ranks],
            collectives=[r[key]["steps"][-1]["collectives"] for r in ranks],
            peak_gib=[max(s["peak_gib"] for s in r[key]["steps"])
                      for r in ranks],
            planned_bytes=[r[key]["plan"]["total"] for r in ranks])
    record["fp32"] = {key: ranks[0][key] for key in ("fp32_tp", "fp32_fsdp")}
    record["launches"] = ranks[0]["tp"]["steps"][-1]["launches"]
    record["launches_fsdp"] = ranks[0]["fsdp"]["steps"][-1]["launches"]
    emit(**record)
    return record


def _fsdp_serving_rank(rank: int, world: int) -> dict:
    """One rank of fsdp_serving: the read cell's 8 reads (olmOCR-2-7B
    widths, bf16) and the reasoning cell's 8 turns (qwen3:32b widths,
    int8), at the depths ``REDUCED`` names, FSDP_NEW_TOKENS tokens,
    first through the whole model on this card, then through engines
    built with ``shard(mesh, fsdp=True)`` over a (world, 1) mesh, counted
    from 0 (flash, window, the int8 paged kernel and the int8 matmul
    must launch); the greedy ids of both."""
    import torch.distributed as dist
    from handwritten_ocr_tpu_torch.config import (OCR_PROMPT,
                                                  PREPROCESSING_STRATEGIES)
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model_parallel=1)
    cfgs = reduced_configs("phase_fsdp_serving")
    vl_cfg = cfgs["vl"]
    q_cfg = dataclasses.replace(cfgs["qwen3"], eos_token_id=-1)
    prep = TorchPreprocessor()
    images = [prep.apply(page, s) for page in synthetic_pages(4)
              for s in PREPROCESSING_STRATEGIES[:2]]
    turns = editor_turns(8)
    counter = _Collectives()
    out = dict(rank=rank, backend=dist.get_backend())
    for name in ("vl", "qwen3"):
        streams = []
        for fsdp in (False, True):
            if name == "vl":
                engine = TorchOCRBackend(VLModel(init_vl(
                    vl_cfg, dtype=torch.bfloat16, device="cuda", seed=SEED),
                    vl_cfg), spelling_tokenizer(), kv_quant=True,
                    pool_bytes=_tp_pool_bytes(vl_cfg.text, 1))
                run = functools.partial(engine.read_batch, images,
                                        OCR_PROMPT, FSDP_NEW_TOKENS)
                needed = ("flash_attention", "window_attention",
                          "paged_append_attention_int8")
            else:
                engine = TorchReasoningBackend(Qwen3Model(init_qwen3(
                    q_cfg, dtype=torch.bfloat16, device="cuda", seed=SEED,
                    quantize="int8"), q_cfg), spelling_tokenizer(),
                    kv_quant=True, pool_bytes=_tp_pool_bytes(q_cfg, 1))
                run = functools.partial(engine.chat_batch, turns,
                                        temperature=0.1,
                                        max_tokens=FSDP_NEW_TOKENS)
                needed = ("flash_attention", "paged_append_attention_int8",
                          "int8_matmul")
            if fsdp:
                engine.shard(mesh, fsdp=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            counter.reset()
            t0 = time.perf_counter()
            with _patched(dist, "all_reduce", counter.wrap):
                texts = run()
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
            streams.append([[int(t) for t in text.split()] for text in texts])
            if fsdp:
                launches = read_launches()
                require_launches(f"fsdp_serving {name}", launches, needed)
                out[name] = dict(call_s=call_s, collectives=counter.read(),
                                 peak_gib=torch.cuda.max_memory_allocated()
                                 / 2 ** 30, launches=launches)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        out[name]["streams"] = streams
    return out


def phase_fsdp_serving(card: str) -> dict:
    """Both engines built with ``shard(mesh, fsdp=True)`` over
    SHARDED_WORLD data ranks (each layer gathered over "data" just before
    it runs; every rank serves every request), at full width and the
    depths ``REDUCED`` names (every decode step gathers the whole model
    through gloo's host copies on one card): each row's first token that leaves
    the same model's single-card stream (FSDP gathers the weights
    exactly, so none should), call_s, all-reduces, peak, launches."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(SHARDED_WORLD, _fsdp_serving_rank,
                         SHARDED_TIMEOUT_S)
    record = dict(phase="fsdp_serving", card=card, world=SHARDED_WORLD,
                  backend=ranks[0]["backend"],
                  reduced=REDUCED["phase_fsdp_serving"],
                  new_tokens=FSDP_NEW_TOKENS,
                  phase_s=time.perf_counter() - t0)
    for model in ("vl", "qwen3"):
        single, sharded = ranks[0][model]["streams"]
        if any(r[model]["streams"][1] != sharded for r in ranks):
            raise AssertionError(f"fsdp_serving {model}: the ranks' ids differ")
        if len(sharded) != 8:
            raise AssertionError(f"fsdp_serving {model}: {len(sharded)} rows")
        record[model] = {k: ranks[0][model][k] for k in (
            "call_s", "collectives", "launches")} | dict(
            peak_gib=[r[model]["peak_gib"] for r in ranks],
            first_difference=[_first_difference(g, w)
                              for g, w in zip(sharded, single)])
    record["launches"] = {name: record["vl"]["launches"][name]
                          + record["qwen3"]["launches"][name]
                          for name in record["vl"]["launches"]}
    emit(**record)
    return record


def phase_kernels_train_tp(cfg, tokens: int) -> list[dict]:
    """Flash and window at the shapes one TP = 2 rank's train step gives
    them (the train page: 1024 vision slots; ``tokens`` text tokens; half
    the heads), with the backward's time beside SDPA's; path
    train_sharded."""
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid
    side = TRAIN_PAGE // 14
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    vis, txt = cfg.vision, cfg.text
    plan = plan_grid(vis, (1, side, side))
    valid = torch.as_tensor(plan.valid, device="cuda")
    rows = [
        _flash_case("train_tp2_vision_global", "train_sharded", 1,
                    len(plan.valid), vis.num_heads // 2, vis.num_heads // 2,
                    vis.head_dim, gen, valid=valid, backward=True),
        _window_case("train_tp2_vision_window", "train_sharded", 1, plan,
                     vis.num_heads // 2, vis.head_dim, gen, backward=True),
        _flash_case("train_tp2_text_causal", "train_sharded", 1, tokens,
                    txt.num_attention_heads // 2,
                    txt.num_key_value_heads // 2, txt.head_dim, gen,
                    causal=True, backward=True)]
    rows = [with_ratio(r) for r in rows]
    for r in rows:
        emit(phase="kernel", **r)
    return rows


def read_prompt_len() -> int:
    """Tokens of the read's prompt: the OCR prompt and one 924x672 page's
    image tokens (merged 2x2 from 14-pixel patches)."""
    from handwritten_ocr_tpu_torch.config import OCR_PROMPT
    from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                            vlm_chat_prompt)
    n_image = (924 // 14) * (672 // 14) // 4
    return (len(ByteTokenizer().encode(vlm_chat_prompt(OCR_PROMPT, 1)))
            - 1 + n_image)


def main() -> int:
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                            llm_chat_prompt)
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model

    info = phase_device()
    for name in ("HOCR_SPEC", "HOCR_VL_SERVING", "HOCR_LLM_SERVING",
                 "HOCR_KV_INT8"):
        os.environ.pop(name, None)        # every engine's defaults
    t_start = time.perf_counter()
    phase_build()
    cfg = VLConfig()                        # olmOCR-2-7B / Qwen2.5-VL-7B widths
    prompt_len = read_prompt_len()
    # qwen3:32b at its published widths and depth; no EOS id, so random
    # weights decode to the budget (as bench.py does)
    qcfg = Qwen3Config(eos_token_id=-1)
    turns = editor_turns(8)
    q_prompt_len = max(len(ByteTokenizer().encode(llm_chat_prompt(
        t.system, t.user))) for t in turns)
    rows = phase_kernels(cfg, prompt_len)
    rows += phase_kernels_reasoning(qcfg, q_prompt_len)
    int8 = {"read": phase_main_path(cfg, prompt_len),
            "chat": phase_reasoning(qcfg, turns)}
    paths = {"ocr_read": int8["read"]["launches"],
             "reasoning": int8["chat"]["launches"]}
    # qwen3:32b with the published EOS id stays resident from here to the
    # dense phase; the guided, speculative, cli and pipeline phases run
    # depth-cut engines over it (REDUCED), pool_plan the whole model.
    qparams = init_qwen3(Qwen3Config(), dtype=torch.bfloat16, device="cuda",
                         seed=SEED, quantize="int8")
    reasoner, paths["guided"], guided_seen = phase_guided(
        qparams, turns, info["smi"])
    paths["speculative"] = phase_speculative(
        reasoner, turns, info["smi"], guided_seen["agents"]["editor"])["launches"]
    reasoner._batcher = None
    reasoner = TorchReasoningBackend(Qwen3Model(qparams, Qwen3Config()),
                                     dense_tokenizer(), kv_quant=True)
    ocr, _ = phase_pool_plan(cfg, reasoner, prompt_len, info["smi"])
    ocr_cut, reasoner_cut = cut_engines(ocr, reasoner, "phase_cli")
    cli = phase_cli(ocr_cut, reasoner_cut, info["smi"])
    paths["cli"] = cli["cli"]["launches"]
    run = phase_pipeline(ocr_cut, reasoner_cut, info["smi"], cli["seen"])
    del ocr_cut, reasoner_cut       # their pools go before parity's
    gc.collect()
    torch.cuda.empty_cache()
    # the pipeline path: the CLI's lockstep run and the resumed run, each
    # counted from 0
    paths["pipeline"] = {name: cli["run_many"]["launches"][name]
                         + run["launches"][name] for name in run["launches"]}
    paths["parity"] = phase_parity(ocr, info["smi"])["launches"]
    dense = phase_dense(ocr, reasoner, turns, info["smi"], int8)
    paths["dense"] = dense["launches"]
    paths["fp_kv_read"] = dense["fp_kv"]["calls"]["read_batch"]["launches"]
    paths["fp_kv_chat"] = dense["fp_kv"]["calls"]["chat_batch"]["launches"]
    del reasoner, ocr, qparams
    gc.collect()                # both models go before the last phases
    torch.cuda.empty_cache()
    convert = phase_convert(info["smi"])
    paths["convert"] = convert["launches"]
    paths["convert_fp32"] = convert["fp32_launches"]
    paths["tp"] = phase_tp(info["smi"])["launches"]
    phase_ring(info["smi"])
    train = phase_train(cfg, info["smi"])
    paths["train"] = train["launches"]
    paths["train_sharded"] = phase_train_sharded(info["smi"])["launches"]
    paths["fsdp_serving"] = phase_fsdp_serving(info["smi"])["launches"]
    phase_train_grad_check(info["smi"])
    phase_loaders(info["smi"])
    paths["reference"] = phase_reference(info["smi"])["launches_all"]
    rows += phase_kernels_paths(cfg, Qwen3Config(), prompt_len, {
        "guided": guided_seen, "pipeline": cli["seen"]})
    rows += phase_kernels_decode_modes(cfg, Qwen3Config(), prompt_len, q_prompt_len,
                                 dense["json_prompt_tokens"])
    rows += phase_kernels_paged_table(Qwen3Config())
    rows += phase_kernels_train(cfg, train["tokens"])
    rows += phase_kernels_train_tp(cfg, train["tokens"])
    rows += phase_kernels_tp(cfg, Qwen3Config(), prompt_len, q_prompt_len)
    rows += phase_kernels_fp32(cfg, Qwen3Config(), prompt_len)
    kernels = []
    for r in rows:
        kernels.append({key: r[key] for key in (
            "name", "case", "route", "source", "replaces", "path")}
            | {"body": r.get("body")}
            | {"launches": paths[r["path"]][r["counter"]]}
            | {key: r[key] for key in ("max_abs_err", "tolerance",
                                       "rel_rms_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_ratio")}
            | {key: r.get(key) for key in ("rel_rms_tolerance",
                                           "tf32_max_abs_err",
                                           "tf32_rel_rms_err",
                                           "graph_ms", "library_graph_ms",
                                           "backward_ms",
                                           "library_backward_ms",
                                           "backward_bound_ms")}
            | {f"{path}_launches": paths[path][r["counter"]]
               for path in ("guided", "pipeline", "cli", "parity",
                            "speculative", "dense", "fp_kv_read",
                            "fp_kv_chat", "convert", "convert_fp32", "train",
                            "tp", "train_sharded", "fsdp_serving",
                            "reference")})
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": info["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
