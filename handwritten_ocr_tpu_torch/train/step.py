"""Fine-tuning step of the VLM on transcription targets (port of
``handwritten_ocr_tpu/train/step.py``).

One step: vision encode + splice + the causal decoder over the whole
sequence (flash attention, no cache), masked next-token cross-entropy on
the target tokens, gradients by autograd (the flash and window kernels
run forward; their backward is autograd through their reference forms,
as the JAX custom VJPs), and an AdamW update (``train/optim.py``).

Where JAX jits the step and donates params and optimizer state, the port
runs eagerly and updates both in place.

Sharded (``mesh``, a ("data", "model") mesh of the process group): where
JAX reads the shardings from the arguments' placement and GSPMD inserts
the collectives, the port takes the mesh explicitly and calls them
itself. Over "model" the forward is the TP forward of ``models/`` (its
collectives differentiable, ``parallel/collectives.py``) and the
vocab-sharded logits are gathered before the loss. Over "data" each rank
holds its rows of the batch (``train/data.py:shard_batch``); its loss
divides its rows' sum by the whole batch's target count (one all-reduce
of the count), so the ranks' losses and gradients sum to JAX's. With
``shardings`` (FSDP specs, ``param_shardings(..., fsdp=True)``) the
parameters are split over "data" too: each layer is gathered just before
it runs, saved for the backward as the rank's block and gathered again
there (``parallel/collectives.py:regather_in_backward``), and the
gather's backward sums its gradient over "data" (a reduce-scatter); every
other gradient is summed over "data" by one
all-reduce a leaf. The default AdamW is elementwise, so each rank updates
its own slices with no collective.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from handwritten_ocr_tpu_torch.models.layers import embed
from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
from handwritten_ocr_tpu_torch.models.qwen25vl.language import (lm_logits,
                                                                text_forward)
from handwritten_ocr_tpu_torch.models.qwen25vl.vision import vision_encode
from handwritten_ocr_tpu_torch.parallel.collectives import (
    gather_from_group, regather_in_backward)
from handwritten_ocr_tpu_torch.parallel.mesh import data_group, model_group
from handwritten_ocr_tpu_torch.parallel.sharding import (gathered,
                                                         layer_gather, scoped,
                                                         split_over_data)
from handwritten_ocr_tpu_torch.train.optim import adamw, tree_leaves


class TrainBatch(NamedTuple):
    input_ids: torch.Tensor     # [B, T] int64 (prompt + target tokens)
    patches: torch.Tensor       # [B, S, patch_dim] fp32
    position_ids: torch.Tensor  # [3, B, T] M-RoPE positions
    loss_mask: torch.Tensor     # [B, T] fp32: 1 on target (response) tokens


def vl_forward(params: dict, cfg: VLConfig, input_ids: torch.Tensor,
               patches: torch.Tensor | None, grid, position_ids: torch.Tensor,
               group=None, gather=None) -> torch.Tensor:
    """Full-sequence forward → fp32 vocabulary logits [B, T, V] (under TP,
    ``group``, the rank's vocab shard [B, T, V/tp]). ``gather``: the
    tree's FSDP gather (``parallel/sharding.py:LayerGather``)."""
    text = scoped(gather, "text")
    embeds = embed(gathered(text, params["text"]["embed"], "embed"),
                   input_ids, group)
    if patches is not None:
        image_embeds = vision_encode(params["vision"], cfg.vision, patches,
                                     grid, group, scoped(gather, "vision")
                                     ).to(embeds.dtype)
        image_mask = input_ids == cfg.image_token_id
        slot = torch.clamp(torch.cumsum(image_mask.long(), dim=1) - 1, 0,
                           image_embeds.shape[1] - 1)
        gathered_rows = torch.take_along_dim(image_embeds, slot[..., None],
                                             dim=1)
        embeds = torch.where(image_mask[..., None], gathered_rows, embeds)
    hidden, _ = text_forward(params["text"], cfg.text, embeds, position_ids,
                             group=group, gather=text)
    return lm_logits(params["text"], cfg.text, hidden, group, text)


def next_token_loss(params: dict, cfg: VLConfig, batch: TrainBatch,
                    grid, mesh=None, gather=None) -> torch.Tensor:
    """Masked next-token cross-entropy in fp32 (mean over target tokens,
    the denominator at least 1). Over a ``mesh`` the batch is this rank's
    rows and the result its share: its rows' sum over the target count of
    the whole batch (summed over "data"), so the shares sum to the loss
    of the whole batch."""
    group = model_group(mesh)
    logits = gather_from_group(
        vl_forward(params, cfg, batch.input_ids, batch.patches, grid,
                   batch.position_ids, group, gather), group)
    targets = batch.input_ids[:, 1:].long()
    mask = batch.loss_mask[:, 1:].float()
    log_probs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = torch.take_along_dim(log_probs, targets[..., None], dim=-1)[..., 0]
    count = mask.sum()
    if data_group(mesh) is not None:
        dist.all_reduce(count, group=data_group(mesh))
    return -(picked * mask).sum() / torch.clamp(count, min=1.0)


def make_train_step(cfg: VLConfig, grid: tuple[int, int, int],
                    optimizer=None, mesh=None, shardings=None):
    """Returns ``(init_opt_state, train_step)``; ``optimizer`` is an
    ``(init, update)`` pair (default ``adamw(1e-5)``, as JAX's default
    ``optax.adamw(1e-5)``). ``mesh``: the ("data", "model") mesh the
    parameters are sliced for and the batch split over (None: one
    device); ``shardings``: the parameters' FSDP specs when they are
    split over "data" as well (``param_shardings(mesh, params,
    fsdp=True)`` of the tree before ``shard_params``).

    ``train_step(params, opt_state, batch)`` → ``(params, opt_state,
    loss)``: the parameters and the optimizer state are updated in place
    (JAX donates them) and returned. It marks every parameter as needing a
    gradient for the step, takes the gradients with
    ``torch.autograd.grad`` (nothing is left in ``.grad``), drops them
    after the update and gives each parameter back its own
    ``requires_grad``. The parameters must be floating point: int8
    weights are for serving. Over a mesh, ``batch`` is this rank's rows
    (``train/data.py:shard_batch``) and ``loss`` the whole batch's, on
    every rank.
    """
    init, update = optimizer if optimizer is not None else adamw(1e-5)
    gather = layer_gather(mesh, shardings)
    over_data = data_group(mesh)

    def train_step(params, opt_state, batch: TrainBatch):
        leaves = tree_leaves(params)
        if not all(leaf.is_floating_point() for leaf in leaves):
            raise ValueError("train_step needs floating-point parameters "
                             "(int8 weights are for serving)")
        flags = [leaf.requires_grad for leaf in leaves]
        try:
            for leaf in leaves:
                leaf.requires_grad_(True)
            with (regather_in_backward() if gather is not None
                  else contextlib.nullcontext()):
                loss = next_token_loss(params, cfg, batch, grid, mesh,
                                       gather)
            grads = list(torch.autograd.grad(loss, leaves))
        finally:
            for leaf, flag in zip(leaves, flags):
                leaf.requires_grad_(flag)
        loss = loss.detach()
        if over_data is not None:
            split = (tree_leaves(split_over_data(shardings))
                     if gather is not None else [False] * len(grads))
            for grad, summed in zip(grads, split, strict=True):
                if not summed:
                    dist.all_reduce(grad, group=over_data)
            dist.all_reduce(loss, group=over_data)
        opt_state = update(grads, opt_state, leaves)
        del grads
        return params, opt_state, loss

    return init, train_step
