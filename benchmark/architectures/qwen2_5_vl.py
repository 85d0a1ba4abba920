"""Qwen2.5-VL (olmOCR-2-7B, the reader): the port's configuration from the
configuration file's ``hf`` keys. The OCR driver (``drivers/ocr.py``)
builds its own program, weights (``weights.py``) and reference
(``reference/models.py``)."""

from __future__ import annotations


def config(hf: dict):
    """(the port's ``VLConfig``, its decoder's configuration)."""
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    cfg = VLConfig.from_hf(hf)
    return cfg, cfg.text
