"""The port's training step against the JAX package's
(``handwritten_ocr_tpu/train/step.py``, ``optax.adamw``).

Tiny Qwen2.5-VL (``torch_port_tiny`` widths, the real vocabulary of
152064 ids, fp32); weights drawn with numpy in the JAX package's layout
and carried over with ``from_jax_params``; pages are PNG files written from seeded numpy
arrays. JAX runs its Pallas kernels in interpret mode
(``HOCR_TPU_FLASH`` / ``HOCR_TPU_WINATTN`` = ``interpret``), so its custom
VJPs (kernel forward, backward through the reference forms) are the
reference; the port's CPU tensors take the plain forward and the same
reference backward.

Tolerances, fp32 on both sides, the same algorithms summed in another
order:
- kernel Functions: outputs and gradients 2e-4 absolute and relative
  (the JAX suite's bound for its interpret kernels against the reference);
- whole model: logits 1e-4 relative / 1e-5 absolute, loss 1e-5 relative,
  every gradient leaf 2e-4 absolute and relative;
- AdamW: params, mu and nu 1e-6 relative (the same fp32 operations in
  the same order; only the scalars' rounding may differ by an ulp);
- train steps: losses and params 2e-4 (five steps of adamw at 3e-3).

The same Functions on the card: ``tests/test_torch_train_cuda.py``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from handwritten_ocr_tpu.models.processor import ByteTokenizer as JaxBytes
from handwritten_ocr_tpu.train import data as jax_data
from handwritten_ocr_tpu.train import step as jax_step
from handwritten_ocr_tpu_torch.models.init import init_vl
from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
from handwritten_ocr_tpu_torch.models.weights import (from_jax_opt_state,
                                                      from_jax_params)
from handwritten_ocr_tpu_torch.ops import flash_attention as flash_mod
from handwritten_ocr_tpu_torch.ops import window_attention as window_mod
from handwritten_ocr_tpu_torch.ops.flash_attention import flash_attention
from handwritten_ocr_tpu_torch.ops.window_attention import window_attention
from handwritten_ocr_tpu_torch.train import data, optim, step

from torch_port_tiny import configs, port_tree

KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
PIXELS = dict(min_pixels=28 * 28, max_pixels=56 * 56)
PROMPT = "Transcribe the page."
LR = 3e-3


def _numpy(tree):
    return jax.tree.map(np.array, tree)


def _jax_shapes(node, name=""):
    """The JAX package's layout of a port tree, as shapes: linear weights
    ``[in, out]`` (tables as they are), layer lists stacked to ``[L,
    ...]``."""
    if isinstance(node, list):
        inner = _jax_shapes(node[0], name)
        return jax.tree.map(lambda shape: (len(node), *shape), inner,
                            is_leaf=lambda x: isinstance(x, tuple))
    if isinstance(node, dict):
        out = {key: _jax_shapes(value, key) for key, value in node.items()}
        if "w" in out and name != "embed":
            out["w"] = out["w"][::-1]
        return out
    return tuple(node.shape)


def _params(cfg, seed=0):
    """fp32 parameters in the JAX package's layout, drawn with numpy:
    linear weights, tables and biases N(0, 0.02²), norm scales
    1 + N(0, 0.1²), so a transposed or dropped bias or scale shows. The
    shapes come from the port's ``init_vl`` on the CPU."""
    rng = np.random.default_rng(seed)

    def draw(node, name):
        if isinstance(node, dict):
            return {key: draw(node[key], key) for key in sorted(node)}
        if name == "scale":
            return (1 + rng.normal(0, 0.1, node)).astype(np.float32)
        return rng.normal(0, 0.02, node).astype(np.float32)

    return draw(_jax_shapes(init_vl(cfg, torch.float32, device="cpu")), "")


def _assert_trees_close(got, want, **tol):
    got, want = optim.tree_leaves(got), optim.tree_leaves(want)
    assert len(got) == len(want)
    for i, (ours, theirs) in enumerate(zip(got, want)):
        np.testing.assert_allclose(ours.detach().numpy(), theirs.numpy(),
                                   err_msg=f"leaf {i}", **tol)


# ── the kernels' autograd Functions ──────────────────────────────────

def _flash_inputs(d, case, seed):
    rng = np.random.default_rng(seed)
    b, t, hq, hkv = 2, 48, 4, 2
    q, g = (rng.standard_normal((b, t, hq, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
            for _ in range(2))
    mask = None
    if case == "shared_mask":
        mask = np.ones(t, bool)
        mask[[3, 20, 21, 47]] = False
    elif case == "row_mask":
        mask = np.ones((b, t), bool)
        mask[0, 30:] = False
        mask[1] = False                   # row 1: every key masked
    return (q, k, v), g, mask


@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("case", ["causal_gqa", "shared_mask", "row_mask"])
def test_flash_gradients_match_jax_custom_vjp(d, case):
    from handwritten_ocr_tpu.ops.flash_attention import (
        flash_attention as jax_flash)
    inputs, g, mask = _flash_inputs(d, case, seed=d)
    causal = case == "causal_gqa"
    jax_mask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, jax_mask, causal=causal, interpret=True),
        *(jnp.asarray(x) for x in inputs))
    want_grads = vjp(jnp.asarray(g))

    q, k, v = (torch.from_numpy(x).requires_grad_() for x in inputs)
    out = flash_attention(q, k, v, None if mask is None
                          else torch.from_numpy(mask), causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **KERNEL_TOL)
    for name, ours, theirs in zip("qkv", (q, k, v), want_grads):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs),
                                   err_msg=f"d{name}", **KERNEL_TOL)
    if case == "row_mask":
        assert bool((q.grad[1] == 0).all())


@pytest.mark.parametrize("window_len", [16, 64])
def test_window_gradients_match_jax_custom_vjp(window_len):
    from handwritten_ocr_tpu.ops.window_attention import (
        window_attention as jax_window)
    heads, hd, n_win = 2, 16, 3
    rng = np.random.default_rng(window_len)
    p = n_win * window_len
    qkv = rng.standard_normal((2, p, 3 * heads * hd)).astype(np.float32)
    g = rng.standard_normal((2, p, heads * hd)).astype(np.float32)
    cos = np.cos(rng.standard_normal((p, hd))).astype(np.float32)
    sin = np.sin(rng.standard_normal((p, hd))).astype(np.float32)
    valid = np.ones(p, bool)
    valid[window_len - 3:window_len] = False       # dead slots in a window
    valid[2 * window_len:] = False                 # a wholly dead window
    kw = dict(num_heads=heads, window_len=window_len, scale=hd ** -0.5)
    want, vjp = jax.vjp(lambda x: jax_window(
        x, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(valid),
        interpret=True, packed=True, **kw), jnp.asarray(qkv))
    (want_grad,) = vjp(jnp.asarray(g))

    x = torch.from_numpy(qkv).requires_grad_()
    out = window_attention(x, torch.from_numpy(cos), torch.from_numpy(sin),
                           torch.from_numpy(valid), **kw)
    assert type(out.grad_fn).__name__ == "_WindowAttentionBackward"
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **KERNEL_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               **KERNEL_TOL)


def test_lm_logits_gradients_match_jax():
    from handwritten_ocr_tpu.models.qwen25vl.language import (
        lm_logits as jax_lm_logits)
    from handwritten_ocr_tpu_torch.models.qwen25vl.language import lm_logits
    jax_cfg, cfg = configs()
    rng = np.random.default_rng(3)
    d, vocab = cfg.text.hidden_size, cfg.text.vocab_size
    w = rng.normal(0, 0.02, (d, vocab)).astype(np.float32)   # JAX [in, out]
    hidden = rng.standard_normal((2, 5, d)).astype(np.float32)
    g = rng.standard_normal((2, 5, vocab)).astype(np.float32)
    want, vjp = jax.vjp(lambda w_, h_: jax_lm_logits(
        {"lm_head": {"w": w_}}, jax_cfg.text, h_), jnp.asarray(w),
        jnp.asarray(hidden))
    want_dw, want_dh = vjp(jnp.asarray(g))

    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    th = torch.from_numpy(hidden).requires_grad_()
    out = lm_logits({"lm_head": {"w": tw}}, cfg.text, th)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **KERNEL_TOL)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(want_dw),
                               **GRAD_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh),
                               **GRAD_TOL)


# ── AdamW against optax.adamw ────────────────────────────────────────

def _opt_trees(seed):
    """A tree in the JAX package's layout (an embedding table, a stack of
    two layers, a norm scale) as numpy arrays drawn from a seed; the port
    takes it through ``from_jax_params``."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(0, 0.5, shape).astype(np.float32)

    return {"embed": {"w": arr(7, 4)},
            "layers": {"proj": {"w": arr(2, 4, 3), "b": arr(2, 3)}},
            "norm": {"scale": arr(4)}}


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_optax(schedule):
    if schedule:
        lr = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=6,
            end_value=1e-4)
        kw = dict(b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-10,
                  weight_decay=0.05)
        ours_lr = lambda count: float(lr(count))        # noqa: E731
    else:
        lr, kw, ours_lr = 1e-3, {}, 1e-3
    params = _opt_trees(0)
    init, update = optim.adamw(ours_lr, **kw)
    theirs = optax.adamw(lr, **kw)
    jax_params, jax_state = params, theirs.init(params)
    ours = from_jax_params(params)
    state = init(ours)
    for i in range(4):
        grads = _opt_trees(10 + i)
        updates, jax_state = theirs.update(grads, jax_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        state = update(from_jax_params(grads), state, ours)
        assert state.count == int(jax_state[0].count) == i + 1
        for got, want in ((ours, jax_params), (state.mu, jax_state[0].mu),
                          (state.nu, jax_state[0].nu)):
            _assert_trees_close(got, from_jax_params(_numpy(want)),
                                rtol=1e-6, atol=0)


# ── the whole model and the train step ───────────────────────────────

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's logits, loss and gradients of the tiny model on a two-page
    batch, and five steps of its ``make_train_step`` (adamw at LR), all
    through the Pallas kernels in interpret mode."""
    root = tmp_path_factory.mktemp("pages")
    rng = np.random.default_rng(0)
    for stem, text in (("a", "first page"), ("b", "second page words")):
        Image.fromarray(rng.integers(100, 256, (60, 80, 3),
                                     dtype=np.uint8)).save(root / f"{stem}.png")
        (root / f"{stem}.md").write_text(f"## Ground Truth\n{text}\n")
    jax_cfg, cfg = configs()
    jax_batch, grid = jax_data.build_batch(
        jax_data.discover_examples(root), JaxBytes(), jax_cfg, prompt=PROMPT,
        **PIXELS)
    params = _params(cfg)
    out = dict(root=root, cfg=cfg, grid=grid, params=params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOCR_TPU_FLASH", "interpret")
        mp.setenv("HOCR_TPU_WINATTN", "interpret")

        logits = jax.jit(jax_step.vl_forward, static_argnums=(1, 4))(
            params, jax_cfg, jax_batch.input_ids, jax_batch.patches, grid,
            jax_batch.position_ids)
        loss, grads = jax.jit(jax.value_and_grad(jax_step.next_token_loss),
                              static_argnums=(1, 3))(params, jax_cfg,
                                                     jax_batch, grid)
        out.update(loss=float(loss), logits=np.asarray(logits),
                   grads=_numpy(grads))
        init, train_step = jax_step.make_train_step(
            jax_cfg, grid, optimizer=optax.adamw(LR))
        p, state, losses = params, init(params), []
        for i in range(1, 6):
            p, state, loss = train_step(p, state, jax_batch)
            losses.append(float(loss))
            if i in (2, 3, 5):
                out[f"params{i}"] = _numpy(p)
            if i in (2, 3):
                out[f"state{i}"] = _numpy(state)
    out["losses"] = losses
    return out


def _port_batch(run):
    examples = data.discover_examples(run["root"])
    batch, grid = data.build_batch(examples, ByteTokenizer(), run["cfg"],
                                   prompt=PROMPT, device="cpu", **PIXELS)
    assert grid == tuple(run["grid"])
    return batch


def test_forward_loss_and_every_gradient_match_jax(run):
    cfg, grid = run["cfg"], run["grid"]
    batch = _port_batch(run)
    params = port_tree(run["params"])
    leaves = optim.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    logits = step.vl_forward(params, cfg, batch.input_ids, batch.patches,
                             grid, batch.position_ids)
    np.testing.assert_allclose(logits.detach().numpy(), run["logits"],
                               rtol=1e-4, atol=1e-5)
    loss = step.next_token_loss(params, cfg, batch, grid)
    np.testing.assert_allclose(loss.item(), run["loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = optim.tree_leaves(from_jax_params(run["grads"]))
    assert len(grads) == len(want) == len(leaves)
    for i, (ours, theirs) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(),
                                   err_msg=f"gradient leaf {i}", **GRAD_TOL)
    assert sum(bool(g.abs().max() > 0) for g in grads) == len(grads)


def test_five_train_steps_match_jax(run):
    cfg, grid = run["cfg"], run["grid"]
    batch = _port_batch(run)
    params = port_tree(run["params"])
    init, train_step = step.make_train_step(cfg, grid,
                                            optimizer=optim.adamw(LR))
    state, losses = init(params), []
    for _ in range(5):
        params, state, loss = train_step(params, state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, run["losses"], rtol=2e-4)
    assert losses[-1] < losses[0]                 # overfits the tiny batch
    assert state.count == 5
    _assert_trees_close(params, from_jax_params(run["params5"]), **GRAD_TOL)
    leaves = optim.tree_leaves(params)
    assert not any(leaf.requires_grad or leaf.grad is not None
                   for leaf in leaves)


def test_resume_from_jax_optimizer_state(run):
    """Params and optax state after JAX's step 2, carried over with
    ``from_jax_params`` / ``from_jax_opt_state``: the port's step 3 gives
    JAX's step 3."""
    cfg, grid = run["cfg"], run["grid"]
    params = from_jax_params(run["params2"])
    state = from_jax_opt_state(run["state2"])
    assert state.count == 2
    _, train_step = step.make_train_step(cfg, grid,
                                         optimizer=optim.adamw(LR))
    params, state, loss = train_step(params, state, _port_batch(run))
    np.testing.assert_allclose(float(loss), run["losses"][2], rtol=1e-5)
    want_state = from_jax_opt_state(run["state3"])
    assert state.count == want_state.count == 3
    _assert_trees_close(params, from_jax_params(run["params3"]), **GRAD_TOL)
    _assert_trees_close(state.mu, want_state.mu, **GRAD_TOL)
    _assert_trees_close(state.nu, want_state.nu, **GRAD_TOL)


def test_from_jax_opt_state_checks_the_schedule_count():
    params = _opt_trees(0)
    state = optax.adamw(optax.constant_schedule(1e-3)).init(params)
    ours = from_jax_opt_state(_numpy(state))
    assert ours.count == 0
    _assert_trees_close(ours.mu, from_jax_params(jax.tree.map(
        np.zeros_like, params)), rtol=0, atol=0)
    adam, decay, sched = state
    bad = (adam, decay, sched._replace(count=jnp.asarray(3)))
    with pytest.raises(ValueError, match="schedule count"):
        from_jax_opt_state(bad)


# ── serving is unchanged ─────────────────────────────────────────────

def test_serving_calls_the_kernels_without_autograd(run, monkeypatch):
    """Under ``torch.no_grad()``, or with inputs that need no gradient,
    neither wrapper goes through its ``autograd.Function``: a read of the
    tiny model runs with both Functions made to raise."""
    (q, k, v), _, _ = _flash_inputs(80, "causal_gqa", seed=1)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    assert flash_attention(q, k, v, causal=True).grad_fn is None
    with torch.no_grad():
        out = flash_attention(q.requires_grad_(), k, v, causal=True)
    assert out.grad_fn is None

    def refuse(*args):
        raise AssertionError("serving went through an autograd.Function")

    monkeypatch.setattr(flash_mod._FlashAttention, "apply", refuse)
    monkeypatch.setattr(window_mod._WindowAttention, "apply", refuse)
    batch = _port_batch(run)
    model = VLModel(port_tree(run["params"]), run["cfg"])
    logits = model.forward_logits(batch.input_ids[:1].numpy(),
                                  batch.patches[:1], run["grid"])
    np.testing.assert_allclose(logits.numpy(), run["logits"][:1],
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(AssertionError, match="autograd.Function"):
        flash_attention(q.requires_grad_(), k, v, causal=True)
