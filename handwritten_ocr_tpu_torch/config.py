"""Constants of the OCR read and reasoning paths (copied from
``handwritten_ocr_tpu/config.py``).

Only the names those paths use live here; the orchestrator's knobs come
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

# ── Reasoning-LLM configuration ─────────────────────────────────────
# Non-thinking mode: the chat template closes an empty <think> block.
LLM_ENABLE_THINKING = False

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
# int8 KV cache: per-token/per-head scales (amax/127 over head_dim),
# quantised on append and dequantised in score space inside the decode
# kernel. Halves pool memory and page-read bytes. The default of every
# engine on every device; a caller passes kv_quant=False for fp pools.
SERVE_KV_INT8 = True
# Pages per vision-tower call: wider batches encode in sequential chunks,
# which caps the tower's activation memory at one chunk.
SERVE_VISION_CHUNK = 8
