"""Constants of the OCR read path (copied from ``handwritten_ocr_tpu/config.py``).

Only the names the read path uses live here; the orchestrator's knobs come
with the pipeline in a later slice.
"""

from __future__ import annotations

# ── OCR model configuration ─────────────────────────────────────────
OCR_MAX_PIXELS = 1024 * 1024
OCR_MIN_PIXELS = 256 * 256
OCR_MAX_NEW_TOKENS = 2048
OCR_PROMPT = "Extract and return all the text from this handwritten document."

# Ordered strategy bank. Each entry is a transform chain applied left to
# right. The first two entries are the initial reads; the rest are tried
# on re-OCR.
PREPROCESSING_STRATEGIES: list[list[str]] = [
    ["deskew", "high_contrast", "binarize"],
    ["high_contrast", "binarize"],
    ["deskew", "high_contrast", "sharpen"],
    ["deskew", "denoise", "high_contrast"],
    ["deskew", "remove_lines", "high_contrast"],
    ["deskew", "high_contrast", "binarize"],
]

# ── Continuous-batching serving (engine/serving.py) ──────────────────
# Fixed decode-slot count (batch width of every decode step).
SERVE_SLOTS = 24
# KV block granularity in tokens; pool block 0 is the reserved trash sink.
SERVE_BLOCK_SIZE = 128
# Decode steps per dispatch: SERVE_CHUNK when a live request streams
# tokens, SERVE_THROUGHPUT_CHUNK otherwise. A chunk boundary is where the
# batcher retires finished requests and admits queued ones.
SERVE_CHUNK = 32
SERVE_THROUGHPUT_CHUNK = 128
# Prompt lengths pad up to a multiple of this.
SERVE_PREFILL_BUCKET = 128
# Pages per vision-tower call: wider batches encode in sequential chunks,
# which caps the tower's activation memory at one chunk.
SERVE_VISION_CHUNK = 8
