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


def test_the_cpu_batcher_steps_eagerly():
    """On the CPU no step graph is made: every step runs eagerly, none is
    counted as replayed or captured, and the tokens are the JAX
    batcher's."""
    import jax
    import jax.numpy as jnp
    from torch_port_tiny import configs, jax_tree, port_tree
    from handwritten_ocr_tpu.engine.serving import (
        ContinuousBatcher as JaxBatcher, GenRequest as JaxRequest,
        PagedProgram as JaxProgram)
    jax_cfg, port_cfg = configs(vocab_size=300, eos_token_id=EOS)
    tree = jax_tree(jax_cfg, seed=12)
    with jax.default_matmul_precision("highest"):
        want = JaxBatcher(JaxProgram(tree["text"], jax_cfg.text,
                                     eos_token_id=EOS),
                          dtype=jnp.float32, **BATCHER).run(
            requests(JaxRequest))
    port = port_tree(jax.tree_util.tree_map(np.asarray, tree))
    batcher = ContinuousBatcher(
        PagedProgram(port["text"], port_cfg.text, eos_token_id=EOS),
        dtype=torch.float32, device="cpu", **BATCHER)
    assert not batcher._graphs.captures
    assert batcher.run(requests(GenRequest)) == want
    assert batcher.stats["decode_steps"] > 0
    assert batcher.stats["decode_graph_steps"] == 0
    assert batcher.stats["decode_graph_captures"] == 0


@pytest.mark.parametrize("device, group, gather, graphed", [
    ("cuda", None, None, True), ("cpu", None, None, False),
    ("cuda", "group", None, False), ("cuda", None, "gather", False),
    ("cuda", "group", "gather", False)],
    ids=["card", "cpu", "tp", "fsdp", "tp_fsdp"])
def test_only_a_whole_program_on_a_card_is_graphed(device, group, gather,
                                                   graphed):
    """The rule reads what the program and the batcher's device are: a
    step is captured on a CUDA card, without a model group (TP) and
    without a gather (FSDP)."""
    from torch_port_tiny import configs
    from handwritten_ocr_tpu_torch.engine.step_graph import graphable
    from handwritten_ocr_tpu_torch.models.init import init_vl
    _, port_cfg = configs(vocab_size=300, eos_token_id=EOS)
    program = PagedProgram(init_vl(port_cfg, dtype=torch.float32,
                                   device="cpu", seed=1)["text"],
                           port_cfg.text, eos_token_id=EOS)
    program.group, program.gather = group, gather
    assert graphable(program, torch.device(device)) is graphed


def _graph_case(name):
    """(text params on the CPU, config, activation dtype, int8 KV) of the
    graphed-against-eager cases: the read's VL text stack in bf16 over
    int8 KV and in fp32 over fp32 KV, and Qwen3 with int8 weights in bf16
    over int8 KV; head width 128, as the kernels take."""
    from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    if name.startswith("vl"):
        cfg = VLConfig(
            vision=VisionConfig(depth=1, hidden_size=160, num_heads=2,
                                out_hidden_size=256),
            text=TextConfig(vocab_size=1000, hidden_size=256,
                            intermediate_size=512, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=1),
            eos_token_id=EOS)
        dtype = torch.bfloat16 if name == "vl_bf16" else torch.float32
        text = init_vl(cfg, dtype=dtype, device="cpu", seed=1)["text"]
        return text, cfg.text, dtype, dtype == torch.bfloat16
    cfg = Qwen3Config(vocab_size=1000, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, head_dim=128, eos_token_id=EOS)
    return (init_qwen3(cfg, dtype=torch.bfloat16, device="cpu", seed=2,
                       quantize="int8"), cfg, torch.bfloat16, True)


def _batcher_on_cuda(params, cfg, graphed: bool, **kw):
    """A batcher on the card whose ``StepGraphs`` captures its steps, or,
    for the eager side of a comparison, one that :func:`graphable` is
    made to refuse, so that every step runs eagerly through the same
    bodies and buffers."""
    from handwritten_ocr_tpu_torch.engine import step_graph
    with pytest.MonkeyPatch.context() as patch:
        if not graphed:
            patch.setattr(step_graph, "graphable",
                          lambda program, device: False)
        batcher = ContinuousBatcher(
            PagedProgram(params, cfg, eos_token_id=EOS), device="cuda", **kw)
    assert batcher._graphs.captures is graphed
    return batcher


def _long_requests(speculate: bool = False):
    """Prompts and budgets that walk the table-width ladder (8, 16 and all
    32 pages of 32 tokens) with two slots, and a last short read whose
    chunk ends early; with ``speculate``, drafts from a fixed stream
    (rejected, so verify rounds alternate with plain chunks)."""
    rng = np.random.default_rng(5)
    out = []
    for n, budget, delta in ((40, 61, 0), (200, 90, 3), (230, 47, 0),
                             (380, 150, 7), (12, 3, 1)):
        ids = rng.integers(10, 900, n).astype(np.int32)
        positions = np.broadcast_to(np.arange(n), (3, n)).astype(np.int64)
        out.append(GenRequest(
            prompt_ids=ids, max_new=budget, positions=positions,
            rope_delta=delta, speculate=speculate,
            draft_oracle=(rng.integers(10, 900, budget).astype(np.int32)
                          if speculate else None)))
    return out


def _serve_three_times(batcher):
    """Plain reads; the kernels' workspaces grown past what the graphs
    captured, with the freed sizes taken again at once (so that a graph
    that lost its buffer writes into them); speculative reads (T = 17
    verify rounds between replays); plain reads again. Returns (tokens of
    each run, the refilled buffers)."""
    from handwritten_ocr_tpu_torch.ops import int8_matmul as int8_mod
    from handwritten_ocr_tpu_torch.ops import paged_decode_attention as paged
    first = batcher.run(_long_requests())
    refilled = []
    for ws in (paged._WORKSPACE, int8_mod._WORKSPACE):
        for (device, dtype), buf in list(ws._buffers.items()):
            numel = buf.numel()
            del buf
            ws.take(device, dtype, numel + 1)
            refilled.append(torch.zeros(numel, dtype=dtype, device=device))
    second = batcher.run(_long_requests(speculate=True))
    return (first, second, batcher.run(_long_requests())), refilled


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vl_bf16", "vl_fp32", "qwen3_int8"])
def test_graphed_decode_equals_eager_on_cuda(case):
    """The batcher's graphed greedy step against the same batcher stepping
    eagerly on the card: the same tokens, cache lengths and KV pools bit
    for bit, the same launch counts, across table-width changes, early
    chunk ends and workspaces grown between replays; every step but one
    per capture is a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.ops import int8_matmul as int8_mod
    from handwritten_ocr_tpu_torch.ops import launch_counters
    from handwritten_ocr_tpu_torch.ops import paged_decode_attention as paged
    torch.backends.cuda.matmul.allow_tf32 = False
    params, cfg, dtype, kv_quant = _graph_case(case)
    params = _to(params, "cuda")
    kw = dict(n_slots=2, block_size=32, max_context=1024, chunk=8,
              prefill_bucket=16, dtype=dtype, kv_quant=kv_quant)
    runs = {}
    for graphed in (False, True):
        for ws in (paged._WORKSPACE, int8_mod._WORKSPACE):
            ws._buffers.clear()     # each run sizes its own, from nothing
        batcher = _batcher_on_cuda(params, cfg, graphed, **kw)
        before = [getattr(fn, attr) for _, fn, attr in launch_counters()]
        tokens, refilled = _serve_three_times(batcher)
        torch.cuda.synchronize()
        launches = [getattr(fn, attr) - b for (_, fn, attr), b
                    in zip(launch_counters(), before)]
        cache = batcher.cache
        pools = [getattr(cache, name).clone() for name in
                 ("k", "v", "k_scale", "v_scale")
                 if getattr(cache, name) is not None]
        runs[graphed] = (tokens, cache.lengths.clone(), pools, launches,
                         dict(batcher.stats), batcher.spec_stats)
        assert all(bool((buf == 0).all()) for buf in refilled)
        del batcher, cache
    eager, graphed = runs[False], runs[True]
    assert graphed[0] == eager[0]
    assert torch.equal(graphed[1], eager[1])
    assert all(torch.equal(g, e) for g, e in zip(graphed[2], eager[2]))
    assert graphed[3] == eager[3] and sum(eager[3]) > 0
    stats = graphed[4]
    assert eager[4]["decode_graph_steps"] == eager[4]["decode_graph_captures"] == 0
    assert stats["decode_steps"] == eager[4]["decode_steps"] > 0
    assert stats["decode_graph_captures"] >= 3       # widths 8, 16, 32
    assert stats["decode_graph_steps"] == (stats["decode_steps"]
                                           - stats["decode_graph_captures"])
    assert graphed[5]["rounds"] == eager[5]["rounds"] > 0


def _serve_guided_and_plain(batcher):
    """Guided decode (critic schema), plain reads, guided decode again, on
    one batcher: the guided steps' graphs are taken before any greedy
    graph and replayed after the greedy ones. Returns (the guided results
    and each request's tokens, the plain tokens, the stats after the first
    guided run)."""
    from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
    from torch_port_dist import SmallTokenizer
    schema, tokenizer = CriticResult.json_schema(), SmallTokenizer()

    def guided():
        requests = _long_requests()
        results = batcher.run_guided(requests, schema, tokenizer)
        return results, [r.tokens for r in requests]

    first = guided()
    after_guided = dict(batcher.stats)
    plain = batcher.run(_long_requests())
    return (first, guided()), plain, after_guided


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["qwen3_int8", "vl_bf16"])
def test_graphed_guided_decode_equals_eager_on_cuda(case):
    """Guided decode's string and top-k steps replayed from the batcher's
    graphs against the same batcher stepping eagerly on the card: the same
    results and committed tokens, cache lengths and KV pools bit for bit,
    the same launch counts, across table-width changes and with greedy
    graphs taken in between; every guided step but one per capture is a
    replay, counted apart from the greedy step's replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.ops import int8_matmul as int8_mod
    from handwritten_ocr_tpu_torch.ops import launch_counters
    from handwritten_ocr_tpu_torch.ops import paged_decode_attention as paged
    torch.backends.cuda.matmul.allow_tf32 = False
    params, cfg, dtype, kv_quant = _graph_case(case)
    params = _to(params, "cuda")
    kw = dict(n_slots=2, block_size=32, max_context=1024, chunk=8,
              prefill_bucket=16, dtype=dtype, kv_quant=kv_quant)
    runs = {}
    for graphed in (False, True):
        for ws in (paged._WORKSPACE, int8_mod._WORKSPACE):
            ws._buffers.clear()     # each run sizes its own, from nothing
        batcher = _batcher_on_cuda(params, cfg, graphed, **kw)
        before = [getattr(fn, attr) for _, fn, attr in launch_counters()]
        guided, plain, after_guided = _serve_guided_and_plain(batcher)
        torch.cuda.synchronize()
        launches = [getattr(fn, attr) - b for (_, fn, attr), b
                    in zip(launch_counters(), before)]
        cache = batcher.cache
        pools = [getattr(cache, name).clone() for name in
                 ("k", "v", "k_scale", "v_scale")
                 if getattr(cache, name) is not None]
        keys = list(batcher._graphs._graphs)
        runs[graphed] = (guided, plain, cache.lengths.clone(), pools,
                         launches, dict(batcher.stats), after_guided, keys)
        del batcher, cache
    eager, graphed = runs[False], runs[True]
    assert graphed[0] == eager[0] and graphed[1] == eager[1]
    assert torch.equal(graphed[2], eager[2])
    assert all(torch.equal(g, e) for g, e in zip(graphed[3], eager[3]))
    assert graphed[4] == eager[4] and sum(eager[4]) > 0
    stats, first = graphed[5], graphed[6]
    for name in ("topk_steps", "string_steps", "decode_steps"):
        assert stats[name] == eager[5][name] > 0
    assert eager[5]["guided_graph_steps"] == eager[5]["guided_graph_captures"] == 0
    steps = stats["topk_steps"] + stats["string_steps"]
    assert stats["guided_graph_steps"] == steps - stats["guided_graph_captures"]
    # the first guided run moved no greedy counter
    assert first["decode_graph_steps"] == first["decode_graph_captures"] == 0
    assert first["guided_graph_steps"] > 0
    assert stats["decode_graph_steps"] == (stats["decode_steps"]
                                           - stats["decode_graph_captures"])
    keys = graphed[7]
    for body in ("string", "topk"):
        widths = {key[1] for key in keys if key[0] == body}
        assert len(widths) >= 2, (body, keys)


@pytest.mark.cuda
def test_a_workspace_does_not_grow_inside_a_capture():
    """A call that needs a larger workspace than it holds cannot be
    captured: the buffer's allocation and zero fill would become nodes of
    the graph, so the capture raises instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from handwritten_ocr_tpu_torch.ops import build
    ws = build.Workspace()
    device = torch.device("cuda", torch.cuda.current_device())
    ws.take(device, torch.int32, 4)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(device)):
        graph.capture_begin()
        try:
            ws.take(device, torch.int32, 4).add_(0)             # no growth
            with pytest.raises(RuntimeError, match="cannot grow"):
                ws.take(device, torch.int32, 1 << 12)
        finally:
            graph.capture_end()
    assert ws.allocations == 1
