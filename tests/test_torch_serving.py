"""The port's continuous batcher against the JAX batcher.

More requests than slots, mixed prompt lengths and budgets, one request
whose budget ends inside a chunk: slot admission, block alloc and free,
retirement at chunk boundaries and prefill bucketing all run. On the same
fp32 weights the greedy token streams are equal. On a card, decode
through the paged kernel must give the CPU's tokens, and so must
speculative verify rounds and the dense path (JAX is imported inside the
JAX tests, so those cases also run where JAX is not installed).
"""

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.engine.serving import (ContinuousBatcher,
                                                      GenRequest, PagedProgram)

EOS = 7
BATCHER = dict(n_slots=2, block_size=8, max_context=96, chunk=5,
               prefill_bucket=16)


def requests(cls):
    rng = np.random.default_rng(3)
    out = []
    for n, budget in ((5, 12), (11, 7), (19, 12), (3, 9), (30, 4)):
        ids = rng.integers(10, 300, n).astype(np.int32)
        positions = np.broadcast_to(np.arange(n), (3, n)).astype(np.int64)
        out.append(cls(prompt_ids=ids, max_new=budget, positions=positions))
    return out


def test_batcher_matches_jax():
    import jax
    import jax.numpy as jnp
    from torch_port_tiny import configs, jax_tree, port_tree
    from handwritten_ocr_tpu.engine.serving import (
        ContinuousBatcher as JaxBatcher, GenRequest as JaxRequest,
        PagedProgram as JaxProgram)
    jax_cfg, port_cfg = configs(vocab_size=300, eos_token_id=EOS)
    tree = jax_tree(jax_cfg, seed=10)
    with jax.default_matmul_precision("highest"):
        jax_batcher = JaxBatcher(
            JaxProgram(tree["text"], jax_cfg.text, eos_token_id=EOS),
            dtype=jnp.float32, **BATCHER)
        want = jax_batcher.run(requests(JaxRequest))
    port = port_tree(jax.tree_util.tree_map(np.asarray, tree))
    batcher = ContinuousBatcher(
        PagedProgram(port["text"], port_cfg.text, eos_token_id=EOS),
        dtype=torch.float32, device="cpu", **BATCHER)
    got = batcher.run(requests(GenRequest))
    assert got == want
    assert all(len(t) <= b for t, b in zip(got, (12, 7, 12, 9, 4)))
    # every slot and block is back in the free lists
    assert len(batcher._free_slots) == 2
    assert len(batcher._free_blocks) == batcher.n_blocks - 1
    # a second run on the same batcher reuses the freed state
    assert batcher.run(requests(GenRequest)) == want


def test_streaming_callbacks_see_every_token():
    import jax
    from torch_port_tiny import configs, jax_tree, port_tree
    _, port_cfg = configs(vocab_size=300, eos_token_id=EOS)
    port = port_tree(jax.tree_util.tree_map(
        np.asarray, jax_tree(configs(vocab_size=300)[0], seed=11)))
    batcher = ContinuousBatcher(
        PagedProgram(port["text"], port_cfg.text, eos_token_id=EOS),
        dtype=torch.float32, device="cpu", **BATCHER)
    seen: list[int] = []
    flags: list[bool] = []
    reqs = requests(GenRequest)[:2]
    reqs[0].on_tokens = lambda toks, done: (seen.extend(toks),
                                            flags.append(done))
    got = batcher.run(reqs)
    assert seen == got[0] and flags[-1] is True


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_decode_matches_cpu_on_cuda():
    """The batcher on the card (paged kernel) emits the CPU's greedy tokens
    (plain versions) on the same fp32 weights, at head widths the kernels
    take (text 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = VLConfig(
        vision=VisionConfig(depth=1, hidden_size=160, num_heads=2,
                            out_hidden_size=256),
        text=TextConfig(vocab_size=1000, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=1),
        eos_token_id=EOS)
    text = init_vl(cfg, dtype=torch.float32, device="cpu", seed=1)["text"]
    kw = dict(BATCHER, block_size=128, max_context=512, dtype=torch.float32)
    want = ContinuousBatcher(PagedProgram(text, cfg.text, eos_token_id=EOS),
                             device="cpu", **kw).run(requests(GenRequest))
    before = paged_append_attention.launches
    batcher = ContinuousBatcher(
        PagedProgram(_to(text, "cuda"), cfg.text, eos_token_id=EOS),
        device="cuda", **kw)
    assert batcher.run(requests(GenRequest)) == want
    assert paged_append_attention.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [True, False])
def test_int8_qwen3_decode_matches_cpu_on_cuda(kv_quant):
    """A narrow Qwen3 with int8 weights (QK-norm) on the card (int8 matmul
    and paged kernels) emits the CPU's greedy tokens (plain versions) on
    the same fp32 activations, over int8 and over fp KV pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    from handwritten_ocr_tpu_torch.ops.int8_matmul import int8_matmul
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Qwen3Config(vocab_size=1000, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=128, eos_token_id=EOS)
    params = init_qwen3(cfg, dtype=torch.float32, device="cpu", seed=2,
                        quantize="int8")
    kw = dict(BATCHER, block_size=128, max_context=512, dtype=torch.float32,
              kv_quant=kv_quant)
    reqs = [GenRequest(prompt_ids=r.prompt_ids, max_new=r.max_new)
            for r in requests(GenRequest)]
    want = ContinuousBatcher(PagedProgram(params, cfg), device="cpu",
                             **kw).run(reqs)
    before = (int8_matmul.launches, paged_append_attention.int8_launches,
              paged_append_attention.launches)
    batcher = ContinuousBatcher(PagedProgram(_to(params, "cuda"), cfg),
                                device="cuda", **kw)
    assert batcher.run([GenRequest(prompt_ids=r.prompt_ids, max_new=r.max_new)
                        for r in reqs]) == want
    after = (int8_matmul.launches, paged_append_attention.int8_launches,
             paged_append_attention.launches)
    assert after[0] > before[0]
    assert (after[1] > before[1]) == kv_quant
    assert (after[2] > before[2]) == (not kv_quant)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [True, False])
def test_speculative_decode_matches_cpu_on_cuda(kv_quant):
    """Verify rounds on the card (the paged kernels at draft_k + 1 = 17
    query tokens, fp32 activations) with drafts read from the CPU's plain
    greedy streams: every draft is accepted and the tokens are the CPU's,
    over int8 and over fp KV pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Qwen3Config(vocab_size=1000, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=128, eos_token_id=EOS)
    params = init_qwen3(cfg, dtype=torch.float32, device="cpu", seed=3)
    kw = dict(BATCHER, block_size=128, max_context=512, dtype=torch.float32,
              kv_quant=kv_quant, draft_k=16)
    reqs = requests(GenRequest)
    want = ContinuousBatcher(PagedProgram(params, cfg), device="cpu",
                             **kw).run(reqs)
    before = (paged_append_attention.int8_launches
              + paged_append_attention.launches)
    batcher = ContinuousBatcher(PagedProgram(_to(params, "cuda"), cfg),
                                device="cuda", **kw)
    got = batcher.run([GenRequest(
        prompt_ids=r.prompt_ids, max_new=r.max_new, speculate=True,
        draft_oracle=np.asarray(w, np.int32)) for r, w in zip(reqs, want)])
    assert got == want
    assert batcher.spec_stats["rounds"] > 0
    assert batcher.spec_stats["accepted"] == batcher.spec_stats["drafted"]
    assert (paged_append_attention.int8_launches
            + paged_append_attention.launches) > before


@pytest.mark.cuda
@pytest.mark.parametrize("padded", [False, True], ids=["flash", "left_padded"])
def test_dense_generate_matches_cpu_on_cuda(padded):
    """The dense path on the card (flash prefill, or the masked plain
    prefill of left-padded rows; the int8 matmul in the decode steps)
    emits the CPU's greedy tokens on the same narrow int8 Qwen3 (fp32
    activations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.models.init import init_qwen3
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model
    from handwritten_ocr_tpu_torch.ops.int8_matmul import int8_matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Qwen3Config(vocab_size=1000, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=128, eos_token_id=EOS)
    params = init_qwen3(cfg, dtype=torch.float32, device="cpu", seed=4,
                        quantize="int8")
    rng = np.random.default_rng(4)
    ids = rng.integers(10, 1000, (3, 21)).astype(np.int32)
    mask = np.ones(ids.shape, bool)
    if padded:
        mask[0, :9] = mask[2, :4] = False
    pad_mask = mask if padded else None
    want = Qwen3Model(params, cfg).generate(ids, 12, pad_mask=pad_mask)
    before = int8_matmul.launches
    got = Qwen3Model(_to(params, "cuda"), cfg).generate(ids, 12,
                                                        pad_mask=pad_mask)
    assert got.tokens.tolist() == want.tokens.tolist()
    assert got.lengths.tolist() == want.lengths.tolist()
    assert int8_matmul.launches > before
