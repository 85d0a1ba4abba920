"""Qwen3 (qwen3:32b, the reasoner), served with int8 weights: what the
model-neutral agent driver (``drivers/agents.py``) takes from the
configuration's architecture.

- ``config(hf)``: the port's ``Qwen3Config``, as model and decoder;
- ``units(cfg)``: the seeded weight units in draw order
  (``qwen3_weights.py``);
- ``program(cfg, unit_list, cell, device, control, std)``: the port's
  ``TorchReasoningBackend`` over those weights, drawn in bf16 from the
  cell's ``weights_seed`` and quantised to int8 by the port's own
  ``quantize_tree``; the control (``control`` true) gets them rounded to
  int4 levels instead, the precision below the configuration's;
- ``reference_logits(cfg, unit_list, weights_seed, std, device, seqs)``:
  the plain float32 reference (``reference/qwen3.py``) over the same
  weights drawn again and widened, each sequence teacher-forced.
"""

from __future__ import annotations

from benchmark import qwen3_weights
from benchmark.reference import qwen3 as ref_qwen3
from benchmark.reference.chat import DenseTokenizer

CONTROL_LEVELS = 7          # the control's weights: int4 levels


def config(hf: dict):
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    cfg = Qwen3Config.from_hf(hf)
    return cfg, cfg


def units(cfg):
    return qwen3_weights.units(cfg)


def program(cfg, unit_list, cell: dict, device, control: bool, std: float):
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    params = qwen3_weights.program_params(
        unit_list, cell["weights_seed"], device,
        CONTROL_LEVELS if control else None, std)
    return TorchReasoningBackend(Qwen3Model(params, cfg), DenseTokenizer(),
                                 device=device, kv_quant=True)


def reference_logits(cfg, unit_list, weights_seed: int, std: float, device,
                     seqs: list[dict]):
    """float32 logits [len(want), V] of each of ``seqs`` (``ids``,
    ``want``; see ``reference/qwen3.py:logits``)."""
    return ref_qwen3.logits(
        lambda name: qwen3_weights.reference_unit(unit_list, name,
                                                  weights_seed, device, std),
        cfg, seqs, device)
