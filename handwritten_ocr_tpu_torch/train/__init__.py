"""Training: the fine-tuning step of the VLM (port of
``handwritten_ocr_tpu/train``).

A full training step on one card: vision encode + splice + decoder
forward, next-token cross-entropy on response tokens, gradients through
the flash and window kernels (``autograd.Function``s), and an in-place
AdamW update (``train/optim.py``, no optax).
"""

from handwritten_ocr_tpu_torch.train.step import (TrainBatch,
                                                  make_train_step, vl_forward)

__all__ = ["TrainBatch", "make_train_step", "vl_forward"]
