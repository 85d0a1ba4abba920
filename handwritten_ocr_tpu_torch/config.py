"""Configuration of the OCR read, the reasoning engine and the pipeline
(copied from ``handwritten_ocr_tpu/config.py``).

The tunable names, defaults and semantics are the JAX package's; the
TPU-only knobs (mesh axes, decode block) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

# ── Reasoning-LLM configuration ─────────────────────────────────────
# The Ollama model the HTTP parity client asks for (engine/ollama_client.py).
OLLAMA_MODEL = "qwen3:32b"
LLM_TEMPERATURE = 0.1
LLM_MAX_TOKENS = 4096
LLM_TIMEOUT = 300  # seconds
LLM_STREAM = True
# Non-thinking mode: the chat template closes an empty <think> block.
LLM_ENABLE_THINKING = False

# ── OCR model configuration ─────────────────────────────────────────
OLMOCR_MODEL = "allenai/olmOCR-2-7B-1025"
OCR_MAX_PIXELS = 1024 * 1024
OCR_MIN_PIXELS = 256 * 256
OCR_MAX_NEW_TOKENS = 2048
OCR_PROMPT = "Extract and return all the text from this handwritten document."

# ── Orchestrator configuration ──────────────────────────────────────
MAX_ITERATIONS = 10
ACCEPT_THRESHOLD = 85  # critic confidence to auto-accept
PLATEAU_PATIENCE = 2  # stop if no improvement for N iterations
AGREEMENT_THRESHOLD = 80  # % agreement below which a tiebreaker OCR pass runs

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
# int8 KV cache: per-token/per-head scales (amax/127 over head_dim),
# quantised on append and dequantised in score space inside the decode
# kernel. Halves pool memory and page-read bytes. The default of every
# engine on every device; a caller passes kv_quant=False for fp pools.
SERVE_KV_INT8 = True
# Pages per vision-tower call: wider batches encode in sequential chunks,
# which caps the tower's activation memory at one chunk. Read once, at
# import, from ``HOCR_VISION_CHUNK`` (as the JAX package does).
SERVE_VISION_CHUNK = int(os.environ.get("HOCR_VISION_CHUNK", "8"))
# Device memory the KV pool plan keeps back for everything but weights and
# pools: vision-tower chunks, prefill groups (PREFILL_GROUP_TOKENS rows of
# the 32B model's MLP), logits and kernel workspaces (parallel/budget.py;
# engine/torch_engines.py:plan_pools).
ACTIVATION_RESERVE_BYTES = 8 * 2**30


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Immutable per-run snapshot of the orchestrator configuration: the
    page's iteration cap and the pipeline's ``state["config"]``, which
    holds every knob the drivers read (routing thresholds, strategy bank,
    the OCR prompt and both token budgets)."""

    accept_threshold: int = ACCEPT_THRESHOLD
    plateau_patience: int = PLATEAU_PATIENCE
    agreement_threshold: int = AGREEMENT_THRESHOLD
    max_iterations: int = MAX_ITERATIONS
    strategies: Sequence[Sequence[str] | str] = dataclasses.field(
        default_factory=lambda: [list(s) for s in PREPROCESSING_STRATEGIES]
    )
    ocr_prompt: str = OCR_PROMPT
    ocr_max_new_tokens: int = OCR_MAX_NEW_TOKENS
    llm_max_tokens: int = LLM_MAX_TOKENS

    def as_state_dict(self) -> dict:
        """``state['config']``: every field but ``max_iterations``, which
        ``initial_state`` takes on its own."""
        return {
            "accept_threshold": self.accept_threshold,
            "plateau_patience": self.plateau_patience,
            "strategies": [list(s) if not isinstance(s, str) else s for s in self.strategies],
            "agreement_threshold": self.agreement_threshold,
            "ocr_prompt": self.ocr_prompt,
            "ocr_max_new_tokens": self.ocr_max_new_tokens,
            "llm_max_tokens": self.llm_max_tokens,
        }
