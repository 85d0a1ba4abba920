"""The paged decode attention of one checkout of the port at the T = 1 and
T = 17 rows of PERF.md section 6, the fp32 bodies of flash and paged
attention at the fp32 read's and the reference runs' shapes, and window
attention at the fp32 read's qkv ``[1, 3456, 3840]`` (fp32 body) and the
read's ``[8, 3456, 3840]`` (bf16 body), for a side-by-side of two
checkouts on one CUDA card.

    python3 kernel_ab.py ROOT LABEL [paged] [flash] [window]

Imports ``handwritten_ocr_tpu_torch`` from checkout ROOT (its kernels are
built there at first use) and the case functions of the ``chip_smoke.py``
beside this script, and prints one JSON line per row of the kinds named
(all by default), tagged LABEL: the kernel's ms (paged, window: also
graph ms), its error against the plain version (paged: pools and two
calls bit-equal, or it raises; fp32 rows: held at the fp32 tolerance),
SDPA's ms (paged: graph ms; window: SDPA per window over q/k that are
not roped) at the same shape, the bound and the card's name and power
limit. Two packages of one name cannot share a process, so each checkout
runs in its own; run them in the order A, B, B, A in one session of one
card and compare within it:

    for r in old . . old; do python3 kernel_ab.py $r $r; done
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

# bf16 q, over int8 and over bf16 pools: (case, slots, live, context,
# layers, hq, hkv, new tokens): the read and Qwen3 decode steps, the
# pipeline's arbitrator and 1-live read, and the verify rounds at 64:8 and
# 28:4.
ROWS = (("read_decode", 24, 8, 978, 28, 28, 4, 1),
        ("qwen3_decode", 24, 8, 1232, 64, 64, 8, 1),
        ("pipeline_arbitrator", 24, 1, 1755, 64, 64, 8, 1),
        ("pipeline_read_1_live", 24, 1, 1042, 28, 28, 4, 1),
        ("qwen3_verify_t17", 24, 8, 1232, 64, 64, 8, 17),
        ("vl_verify_t17", 24, 8, 978, 28, 28, 4, 17))
# fp32 q: the same fields and the pools' kind: the fp32 read's decode step
# (1 of 24 slots live at its prompt + 16 tokens), a verify round at 28:4,
# and the reference phase's narrow VL (2:1 heads, 2 layers, 4 pages live)
# over int8 pools.
FP32_ROWS = (("convert_decode_fp32", 24, 1, 930, 28, 28, 4, 1, False),
             ("vl_verify_t17_fp32", 24, 8, 978, 28, 28, 4, 17, False),
             ("reference_int8_fp32", 24, 4, 160, 2, 2, 1, 1, True))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    kinds = set(sys.argv[3:]) or {"paged", "flash", "window"}
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    import handwritten_ocr_tpu_torch
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tag = dict(label=label, package=handwritten_ocr_tpu_torch.__file__,
               card=_card())

    def paged(i, case, slots, live, context, layers, hq, hkv, t, kv_quant,
              dtype):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        row = smoke._paged_case(
            "paged_append_attention", case, slots, live, context, layers,
            hq, hkv, 128, kv_quant, gen, "ab", t=t, dtype=dtype)
        print(json.dumps(tag | dict(
            case=case, body=row["body"], shape=row["shape"], live=live,
            starts=row["starts"], ms=row["ms"], graph_ms=row["graph_ms"],
            max_abs_err=row["max_abs_err"], tolerance=row["tolerance"],
            rel_rms_err=row["rel_rms_err"],
            sdpa_graph_ms=row["library_graph_ms"],
            bound_ms=row["bound_ms"])), flush=True)

    if "paged" in kinds:
        for i, (case, *shape) in enumerate(ROWS):
            for kv_quant in (True, False):
                paged(i, case, *shape, kv_quant, torch.bfloat16)
        for i, (case, *shape) in enumerate(FP32_ROWS):
            paged(len(ROWS) + i, case, *shape, torch.float32)

    cfg = VLConfig()
    vis, txt = cfg.vision, cfg.text
    plan = plan_grid(vis, (1, 924 // 14, 672 // 14))
    valid = torch.as_tensor(plan.valid, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(200)
    flash = () if "flash" not in kinds else (
        smoke._flash_case("vision_global_fp32", "ab", 1, len(plan.valid),
                          vis.num_heads, vis.num_heads, vis.head_dim,
                          gen, valid=valid, dtype=torch.float32),
        smoke._flash_case("prefill_causal_fp32", "ab", 1,
                          smoke.read_prompt_len(),
                          txt.num_attention_heads,
                          txt.num_key_value_heads, txt.head_dim, gen,
                          causal=True, dtype=torch.float32))
    for row in flash:
        print(json.dumps(tag | {key: row[key] for key in (
            "case", "body", "shape", "kv_heads", "ms", "max_abs_err",
            "tolerance", "rel_rms_err", "library_ms", "bound_ms")}),
            flush=True)
    window = ((1, torch.float32), (8, torch.bfloat16))
    for batch, dtype in window if "window" in kinds else ():
        row = smoke._window_case(f"vision_window_b{batch}", "ab", batch,
                                 plan, vis.num_heads, vis.head_dim, gen,
                                 dtype=dtype)
        print(json.dumps(tag | {key: row[key] for key in (
            "case", "shape", "ms", "graph_ms", "max_abs_err", "tolerance",
            "rel_rms_err", "library_ms", "bound_ms")}
            | dict(body=row.get("body", "bf16"))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
