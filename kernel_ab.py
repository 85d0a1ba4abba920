"""The paged decode attention of one checkout of the port at the T = 1 and
T = 17 rows of PERF.md section 6, for a side-by-side of two checkouts on
one CUDA card.

    python3 kernel_ab.py ROOT LABEL

Imports ``handwritten_ocr_tpu_torch`` from checkout ROOT (its kernels are
built there at first use) and ``_paged_case`` from the ``chip_smoke.py``
beside this script, and prints one JSON line per row, tagged LABEL: the
kernel's ms and graph ms, its error against the plain version (pools and
two calls bit-equal, or it raises), SDPA's graph ms at the same shape and
the card's name and power limit. Two packages of one name cannot share a
process, so each checkout runs in its own; run them in the order A, B, B,
A in one session of one card and compare within it:

    for r in old . . old; do python3 kernel_ab.py $r $r; done
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

# (case, slots, live, context, layers, hq, hkv, new tokens): the read and
# Qwen3 decode steps, the pipeline's arbitrator and 1-live read, and the
# verify rounds at 64:8 and 28:4.
ROWS = (("read_decode", 24, 8, 978, 28, 28, 4, 1),
        ("qwen3_decode", 24, 8, 1232, 64, 64, 8, 1),
        ("pipeline_arbitrator", 24, 1, 1755, 64, 64, 8, 1),
        ("pipeline_read_1_live", 24, 1, 1042, 28, 28, 4, 1),
        ("qwen3_verify_t17", 24, 8, 1232, 64, 64, 8, 17),
        ("vl_verify_t17", 24, 8, 978, 28, 28, 4, 17))


def main() -> int:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    import handwritten_ocr_tpu_torch
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for i, (case, slots, live, context, layers, hq, hkv, t) in enumerate(ROWS):
        for kv_quant in (True, False):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            row = smoke._paged_case(
                "paged_append_attention", case, slots, live, context, layers,
                hq, hkv, 128, kv_quant, gen, "ab", t=t)
            print(json.dumps(dict(
                label=label, package=handwritten_ocr_tpu_torch.__file__,
                card=card, case=case, body=row["body"], shape=row["shape"],
                live=live, starts=row["starts"], ms=row["ms"],
                graph_ms=row["graph_ms"], max_abs_err=row["max_abs_err"],
                sdpa_graph_ms=row["library_graph_ms"],
                bound_ms=row["bound_ms"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
