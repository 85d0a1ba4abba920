"""AdamW on tensors, in place (the port's counterpart of ``optax.adamw``).

Same defaults and the same order of operations as optax 0.2.6
(``scale_by_adam`` → ``add_decayed_weights`` → ``scale_by_learning_rate``,
then ``apply_updates``): the moments are updated as ``(1 - b1)·g + b1·mu``
and ``(1 - b2)·g² + b2·nu``, the count goes up by one, each moment is
divided by its bias correction (computed in fp32, then cast to the
moment's dtype), the update is ``mu_hat / (sqrt(nu_hat + eps_root) + eps)
+ weight_decay·param``, times ``-learning_rate``, and the parameter becomes
``(param + update)`` in its own dtype. mu and nu are kept in the parameter
dtype (optax's ``mu_dtype=None``).

Where optax returns new trees, :func:`adamw`'s ``update`` writes the
parameters and the moments in place under ``torch.no_grad()``, one tensor
at a time: a fused pass over the whole tree would hold temporaries the
size of the parameters (16.6e9 B for the 7B model in bf16), which one
80 GB card does not have beside the parameters, gradients and moments.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the number of updates taken and the
    first and second moments, trees shaped like the parameters."""

    count: int
    mu: object
    nu: object


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in a fixed order: dict
    keys sorted (as JAX flattens a dict), lists in order. Two trees of one
    structure give their leaves in the same order whatever order their
    dicts were built in."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for value in tree for leaf in tree_leaves(value)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, value) for value in tree]
    return fn(tree)


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a weakly typed Python scalar is
    in JAX before it multiplies an array of that dtype."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _bias_correction(decay: float, count: int) -> torch.Tensor:
    """``1 - decay**count`` in fp32 (optax ``tree_bias_correction``)."""
    decay32 = torch.tensor(decay, dtype=torch.float32)
    return 1 - decay32 ** torch.tensor(count, dtype=torch.float32)


def adamw(learning_rate: float | Schedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4):
    """``(init, update)`` of AdamW with optax's defaults.

    ``init(params)`` → :class:`AdamWState` with zero moments in each
    parameter's dtype and device. ``update(grads, state, params)`` moves
    every parameter by one step in place and returns the new state (its
    moment tensors are the old ones, written in place). ``learning_rate``
    is a float or a callable of the number of updates already taken, as
    an optax schedule is called.
    """

    def _constants(dtype, device, count: int, lr: float) -> dict:
        """The step's scalars rounded to ``dtype``; the bias corrections
        as 0-d tensors on ``device`` (CUDA divides by a Python scalar as a
        product with its reciprocal)."""
        out = {name: _scalar(value, dtype) for name, value in (
            ("b1", b1), ("1-b1", 1 - b1), ("b2", b2), ("1-b2", 1 - b2),
            ("eps", eps), ("eps_root", eps_root),
            ("weight_decay", weight_decay), ("-lr", -lr))}
        for name, decay in (("correction1", b1), ("correction2", b2)):
            out[name] = _bias_correction(decay, count).to(dtype).to(device)
        return out

    def init(params) -> AdamWState:
        return AdamWState(count=0, mu=tree_map(torch.zeros_like, params),
                          nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params) -> AdamWState:
        lr = (learning_rate(state.count) if callable(learning_rate)
              else learning_rate)
        count = state.count + 1
        constants = {}        # (dtype, device) -> the step's scalars
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.mu), tree_leaves(state.nu),
                                strict=True):
            key = (p.dtype, p.device)
            if key not in constants:
                constants[key] = _constants(p.dtype, p.device, count, lr)
            c = constants[key]
            mu.mul_(c["b1"]).add_(g * c["1-b1"])
            g2 = g * g
            nu.mul_(c["b2"]).add_(g2.mul_(c["1-b2"]))
            del g2
            step = mu / c["correction1"]
            denom = nu / c["correction2"]
            denom.add_(c["eps_root"]).sqrt_().add_(c["eps"])
            step.div_(denom)
            del denom
            step.add_(p * c["weight_decay"])
            p.add_(step.mul_(c["-lr"]))
        return AdamWState(count=count, mu=state.mu, nu=state.nu)

    return init, update
