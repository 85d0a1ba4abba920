"""Fine-tuning step of the VLM on transcription targets (port of
``handwritten_ocr_tpu/train/step.py``).

One step: vision encode + splice + the causal decoder over the whole
sequence (flash attention, no cache), masked next-token cross-entropy on
the target tokens, gradients by autograd (the flash and window kernels
run forward; their backward is autograd through their reference forms,
as the JAX custom VJPs), and an AdamW update (``train/optim.py``).

Where JAX jits the step and donates params and optimizer state, the port
runs eagerly and updates both in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
from handwritten_ocr_tpu_torch.models.qwen25vl.language import (lm_logits,
                                                                text_forward)
from handwritten_ocr_tpu_torch.models.qwen25vl.vision import vision_encode
from handwritten_ocr_tpu_torch.train.optim import adamw, tree_leaves


class TrainBatch(NamedTuple):
    input_ids: torch.Tensor     # [B, T] int64 (prompt + target tokens)
    patches: torch.Tensor       # [B, S, patch_dim] fp32
    position_ids: torch.Tensor  # [3, B, T] M-RoPE positions
    loss_mask: torch.Tensor     # [B, T] fp32: 1 on target (response) tokens


def vl_forward(params: dict, cfg: VLConfig, input_ids: torch.Tensor,
               patches: torch.Tensor | None, grid, position_ids: torch.Tensor,
               ) -> torch.Tensor:
    """Full-sequence forward → fp32 vocabulary logits [B, T, V]."""
    embeds = params["text"]["embed"]["w"][input_ids]
    if patches is not None:
        image_embeds = vision_encode(params["vision"], cfg.vision, patches,
                                     grid).to(embeds.dtype)
        image_mask = input_ids == cfg.image_token_id
        slot = torch.clamp(torch.cumsum(image_mask.long(), dim=1) - 1, 0,
                           image_embeds.shape[1] - 1)
        gathered = torch.take_along_dim(image_embeds, slot[..., None], dim=1)
        embeds = torch.where(image_mask[..., None], gathered, embeds)
    hidden, _ = text_forward(params["text"], cfg.text, embeds, position_ids)
    return lm_logits(params["text"], cfg.text, hidden)


def next_token_loss(params: dict, cfg: VLConfig, batch: TrainBatch,
                    grid) -> torch.Tensor:
    """Masked next-token cross-entropy in fp32 (mean over target tokens,
    the denominator at least 1)."""
    logits = vl_forward(params, cfg, batch.input_ids, batch.patches, grid,
                        batch.position_ids)
    targets = batch.input_ids[:, 1:].long()
    mask = batch.loss_mask[:, 1:].float()
    log_probs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = torch.take_along_dim(log_probs, targets[..., None], dim=-1)[..., 0]
    return -(picked * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(cfg: VLConfig, grid: tuple[int, int, int],
                    optimizer=None):
    """Returns ``(init_opt_state, train_step)``; ``optimizer`` is an
    ``(init, update)`` pair (default ``adamw(1e-5)``, as JAX's default
    ``optax.adamw(1e-5)``).

    ``train_step(params, opt_state, batch)`` → ``(params, opt_state,
    loss)``: the parameters and the optimizer state are updated in place
    (JAX donates them) and returned. It marks every parameter as needing a
    gradient for the step, takes the gradients with
    ``torch.autograd.grad`` (nothing is left in ``.grad``), drops them
    after the update and gives each parameter back its own
    ``requires_grad``. The parameters must be floating point: int8
    weights are for serving.
    """
    init, update = optimizer if optimizer is not None else adamw(1e-5)

    def train_step(params, opt_state, batch: TrainBatch):
        leaves = tree_leaves(params)
        if not all(leaf.is_floating_point() for leaf in leaves):
            raise ValueError("train_step needs floating-point parameters "
                             "(int8 weights are for serving)")
        flags = [leaf.requires_grad for leaf in leaves]
        try:
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss = next_token_loss(params, cfg, batch, grid)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for leaf, flag in zip(leaves, flags):
                leaf.requires_grad_(flag)
        opt_state = update(list(grads), opt_state, leaves)
        del grads
        return params, opt_state, loss.detach()

    return init, train_step
