"""Fused append + paged attention of the PyTorch port against the JAX
Pallas kernel, fp KV and int8 KV.

The JAX kernel runs through the Pallas interpreter with exact fp32
matmuls; the port's CPU path is its plain version. Compared: the output of
every valid query row (2e-5, fp32 in another summation order) and the
whole pools after the append (bit-equal: fp appends copy values, int8
appends quantise with the same correctly rounded fp32 division and
round-half-even, so the int8 rows and the scale pools match bit for bit).
JAX is imported inside the parity tests, so the CUDA cases also run where
JAX is not installed.
"""

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
    paged_append_attention, paged_append_attention_plain)

L, N, BS, HKV, D, HQ, LAYER = 2, 16, 16, 2, 128, 6, 1


def make(t, start, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    s = len(start)
    arrays = dict(
        q=rng.standard_normal((s, t, HQ, D)).astype(np.float32),
        k_new=rng.standard_normal((s, t, HKV, D)).astype(np.float32),
        v_new=rng.standard_normal((s, t, HKV, D)).astype(np.float32),
        k_pool=rng.standard_normal((L, N, BS, HKV, D)).astype(np.float32),
        v_pool=rng.standard_normal((L, N, BS, HKV, D)).astype(np.float32),
        tables=rng.permutation(np.arange(1, N))[:s * 3].reshape(s, 3)
        .astype(np.int32),
        start=np.asarray(start, np.int32),
        n_valid=np.asarray(n_valid, np.int32))
    return arrays


def make_int8(t, start, n_valid, seed=11):
    """The inputs of the JAX package's ``test_quantized_kv``: int8 pools
    and fp32 scale pools [L, N, Hkv, BS]."""
    a = make(t, start, n_valid, seed=seed)
    rng = np.random.default_rng(seed + 1)
    a["k_pool"] = rng.integers(-127, 128, (L, N, BS, HKV, D)).astype(np.int8)
    a["v_pool"] = rng.integers(-127, 128, (L, N, BS, HKV, D)).astype(np.int8)
    a["k_scale"] = rng.uniform(0.001, 0.02, (L, N, HKV, BS)).astype(np.float32)
    a["v_scale"] = rng.uniform(0.001, 0.02, (L, N, HKV, BS)).astype(np.float32)
    return a


NAMES = ("q", "k_new", "v_new", "k_pool", "v_pool", "tables", "start",
         "n_valid")
POOLS = ("k_pool", "v_pool", "k_scale", "v_scale")


def run_port(a, fn=paged_append_attention):
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    scales = [t[k] for k in ("k_scale", "v_scale") if k in t]
    out = fn(*(t[k] for k in NAMES), *scales, layer=LAYER, scale=D ** -0.5)
    return (out.numpy(), *(t[k].numpy() for k in POOLS if k in t))


def run_jax(a):
    import jax
    import jax.numpy as jnp
    from handwritten_ocr_tpu.ops.paged_decode_attention import (
        paged_append_attention as jax_paged)
    with jax.default_matmul_precision("highest"):
        results = jax_paged(
            *(jnp.asarray(a[k]) for k in NAMES + POOLS[2:] if k in a),
            layer=LAYER, scale=D ** -0.5, interpret=True)
    return tuple(np.asarray(r) for r in results)


@pytest.mark.parametrize("t,start,n_valid", [
    (1, [5, 15, 0, 40], [1, 1, 1, 0]),     # decode: mid-page, boundary, dead
    (5, [15, 3, 30], [5, 3, 0]),           # 15+5 crosses a page boundary
])
def test_matches_jax_kernel(t, start, n_valid):
    a = make(t, start, n_valid, seed=t)
    out, k_pool, v_pool = run_port(a)
    want, want_k, want_v = run_jax(a)
    for s, nv in enumerate(n_valid):
        np.testing.assert_allclose(out[s, :nv], want[s, :nv],
                                   rtol=2e-5, atol=2e-5)
        assert np.all(out[s, nv:] == 0.0)
    np.testing.assert_array_equal(k_pool, want_k)
    np.testing.assert_array_equal(v_pool, want_v)


def test_dead_slots_leave_the_pool_untouched():
    a = make(1, [3, 9], [0, 0], seed=7)
    out, k_pool, v_pool = run_port(a)
    np.testing.assert_array_equal(k_pool, a["k_pool"])
    np.testing.assert_array_equal(v_pool, a["v_pool"])
    assert np.all(out == 0.0)


@pytest.mark.parametrize("t,start,n_valid", [
    (1, [5, 15, 0, 40], [1, 1, 1, 0]),     # decode: mid-page, boundary, dead
    (5, [15, 3, 30], [5, 3, 0]),           # 15+5 crosses a page boundary
])
def test_int8_kv_matches_jax_kernel(t, start, n_valid):
    a = make_int8(t, start, n_valid)
    out, *pools = run_port(a)
    want, *want_pools = run_jax(a)
    for s, nv in enumerate(n_valid):
        np.testing.assert_allclose(out[s, :nv], want[s, :nv],
                                   rtol=2e-5, atol=2e-5)
        assert np.all(out[s, nv:] == 0.0)
    for got, ref in zip(pools, want_pools):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(pools[0], a["k_pool"])   # the append happened


def test_int8_kv_refuses_appends_past_a_block():
    a = make_int8(BS + 1, [0], [BS + 1])
    a["tables"] = a["tables"][:1]
    with pytest.raises(ValueError, match="exceeds the block size"):
        run_port(a)
    a = make_int8(1, [3], [1])
    a["v_scale"] = a["v_scale"].astype(np.float64)
    with pytest.raises(ValueError, match="scale pools"):
        run_port(a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 5])
def test_kernel_matches_plain_on_cuda(dtype, t):
    """Kernel against its plain version on the card: outputs of valid rows
    within 1e-4 (fp32) or 2e-2 (bf16 output rounding), pools bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = make(t, [15, 3, 30, 0], [t, min(t, 3), 0, t], seed=11)
    dev = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    plain = {k: v.clone() for k, v in dev.items()}
    names = ("q", "k_new", "v_new", "k_pool", "v_pool", "tables", "start",
             "n_valid")
    got = paged_append_attention(*(dev[k] for k in names), layer=LAYER,
                                 scale=D ** -0.5).float()
    want = paged_append_attention_plain(*(plain[k] for k in names),
                                        layer=LAYER, scale=D ** -0.5).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.float32:
        live = [(s, i) for s, nv in enumerate(a["n_valid"]) for i in range(nv)]
        pick = tuple(torch.tensor(x) for x in zip(*live))
        assert_fp32_close(got[pick], want[pick])
    assert torch.equal(dev["k_pool"], plain["k_pool"])
    assert torch.equal(dev["v_pool"], plain["v_pool"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 5])
def test_int8_kernel_matches_plain_on_cuda(dtype, t):
    """The int8 branch against its plain version on the card: outputs of
    valid rows within 1e-4 (fp32) or 2e-2 (bf16 output rounding); the int8
    pools and the scale pools bit-equal after the append."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = make_int8(t, [15, 3, 30, 0], [t, min(t, 3), 0, t])
    dev = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    for k in ("q", "k_new", "v_new"):
        dev[k] = dev[k].to(dtype)
    plain = {k: v.clone() for k, v in dev.items()}
    before = paged_append_attention.int8_launches
    got = paged_append_attention(*(dev[k] for k in NAMES + POOLS[2:]),
                                 layer=LAYER, scale=D ** -0.5).float()
    torch.cuda.synchronize()
    assert paged_append_attention.int8_launches == before + 1
    want = paged_append_attention_plain(*(plain[k] for k in NAMES + POOLS[2:]),
                                        layer=LAYER, scale=D ** -0.5).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == torch.float32:
        live = [(s, i) for s, nv in enumerate(a["n_valid"]) for i in range(nv)]
        pick = tuple(torch.tensor(x) for x in zip(*live))
        assert_fp32_close(got[pick], want[pick])
    for k in POOLS:
        assert torch.equal(dev[k], plain[k]), k


def make_decode(seed, t, group, start, n_valid, hkv=2, bs=16, width=80,
                quant=True):
    """int8 pools (``quant``; else full-precision pools, made bf16 by the
    caller) of 2 layers and ``width`` pages of ``bs`` per slot (each slot
    its own shuffled blocks; block 0 unused), bf16 q and new rows: the
    shape of an engine's decode step over its KV cache."""
    rng = np.random.default_rng(seed)
    s = len(start)
    n_blocks = 1 + s * width
    shape = (2, n_blocks, bs, hkv, D)
    a = dict(
        q=rng.standard_normal((s, t, group * hkv, D)).astype(np.float32),
        k_new=rng.standard_normal((s, t, hkv, D)).astype(np.float32),
        v_new=rng.standard_normal((s, t, hkv, D)).astype(np.float32),
        tables=(1 + rng.permutation(s * width)).reshape(s, width)
        .astype(np.int32),
        start=np.asarray(start, np.int32),
        n_valid=np.asarray(n_valid, np.int32))
    if not quant:
        a["k_pool"] = rng.standard_normal(shape).astype(np.float32)
        a["v_pool"] = rng.standard_normal(shape).astype(np.float32)
        return a
    a.update(
        k_pool=rng.integers(-127, 128, shape).astype(np.int8),
        v_pool=rng.integers(-127, 128, shape).astype(np.int8),
        k_scale=rng.uniform(0.001, 0.02, (2, n_blocks, hkv, bs))
        .astype(np.float32),
        v_scale=rng.uniform(0.001, 0.02, (2, n_blocks, hkv, bs))
        .astype(np.float32))
    return a


def assert_fp32_close(got, want):
    """fp32 output against the plain version at ``chip_smoke.py``'s fp32
    bound: the largest error within 2^-14 of max|want|, the RMS error
    within 1e-5 of RMS(want) (two fp32 sums in another order; a TF32
    product, ~5e-4, fails it)."""
    diff = got - want
    assert float(diff.abs().max()) <= 2.0 ** -14 * float(want.abs().max())
    assert float(diff.pow(2).mean().sqrt()) <= 1e-5 * float(
        want.pow(2).mean().sqrt())


def assert_close_to_plain(got, want):
    """bf16 output against the plain version: the largest error within 2
    bf16 ulps of max|want|, the RMS error within 1% of RMS(want) (as
    ``chip_smoke.py`` holds the kernels)."""
    got, want = got.float(), want.float()
    peak = float(want.abs().max())
    diff = got - want
    assert float(diff.abs().max()) <= 2 * 2.0 ** (np.floor(np.log2(peak)) - 7)
    assert float(diff.pow(2).mean().sqrt()) <= 1e-2 * float(
        want.pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("group", [7, 8])
@pytest.mark.parametrize("t,start,n_valid,bs", [
    # inside a page; ending on a split boundary (128 cols); dead; many splits
    (1, [37, 255, 0, 1000, 127], [1, 1, 0, 1, 1], 16),
    (5, [37, 251, 0, 995, 128], [5, 5, 0, 5, 3], 16),
    # a speculative verify round (draft_k 16): 17 query tokens (an int8
    # append holds at most a block), appends that cross a page boundary,
    # two of them also a split boundary (128 and 1024 cols)
    (17, [20, 30, 0, 1020, 127], [17, 12, 0, 9, 17], 32),
])
def test_int8_tensor_core_body_on_cuda(group, t, start, n_valid, bs):
    """The int8-KV body with bf16 q at the engines' group sizes: valid rows
    within tolerance, dead slots zero, pools and scale pools bit-equal to
    the plain append, one launch per call, and two calls bit-equal (the
    split merge's fixed order and the counters' reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = make_decode(group + t, t, group, start, n_valid, bs=bs)
    dev = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    for k in ("q", "k_new", "v_new"):
        dev[k] = dev[k].bfloat16()
    plain = {k: v.clone() for k, v in dev.items()}
    names = NAMES + POOLS[2:]
    before = paged_append_attention.int8_launches
    got = paged_append_attention(*(dev[k] for k in names), layer=LAYER,
                                 scale=D ** -0.5)
    again = paged_append_attention(*(dev[k] for k in names), layer=LAYER,
                                   scale=D ** -0.5)
    torch.cuda.synchronize()
    assert paged_append_attention.int8_launches == before + 2
    assert torch.equal(got, again)
    want = paged_append_attention_plain(*(plain[k] for k in names),
                                        layer=LAYER, scale=D ** -0.5)
    live = [s for s, nv in enumerate(n_valid) if nv > 0]
    rows = [(s, i) for s in live for i in range(n_valid[s])]
    pick = (torch.tensor([r[0] for r in rows]), torch.tensor([r[1] for r in rows]))
    assert_close_to_plain(got[pick], want[pick])
    for s, nv in enumerate(n_valid):
        assert bool((got[s, nv:] == 0).all())
    for k in POOLS:
        assert torch.equal(dev[k], plain[k]), k


def launch_counts():
    f = paged_append_attention
    return f.launches, f.fp32_launches, f.int8_launches


@pytest.mark.cuda
@pytest.mark.parametrize("group", [7, 8])
@pytest.mark.parametrize("t,start,n_valid,bs,width", [
    # decode: inside a page, ending on a split boundary, dead, many
    # splits, and the last col of the table (start + 1 = W * BS)
    (1, [37, 255, 0, 1000, 1279], [1, 1, 0, 1, 1], 16, 80),
    # two tokens, the second of the last slot at the table's cap
    (2, [37, 251, 0, 995, 1278], [2, 2, 0, 1, 2], 16, 80),
    # a speculative verify round (draft_k 16): 17 query tokens, appends
    # across a page boundary (32 cols), one of them also across 1024
    (17, [20, 30, 0, 1020, 127], [17, 12, 0, 9, 17], 32, 80),
    # the engines' 128-col blocks: contexts that are not a multiple of 64,
    # a start at a page boundary, the last append ending at the cap
    (1, [100, 128, 0, 1400, 1535], [1, 1, 0, 1, 1], 128, 12),
    (17, [100, 128, 0, 1400, 1519], [17, 3, 0, 9, 17], 128, 12),
])
def test_bf16_tensor_core_body_on_cuda(group, t, start, n_valid, bs, width):
    """The fp-KV body with bf16 q over bf16 pools at the engines' group
    sizes: valid rows within tolerance, dead slots and rows zero, pools
    bit-equal to the plain append, one launch per call counted in
    ``launches`` alone, and two calls bit-equal (the split merge's fixed
    order and the counters' reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = make_decode(group * 100 + t, t, group, start, n_valid, bs=bs,
                    width=width, quant=False)
    dev = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].bfloat16()
    plain = {k: v.clone() for k, v in dev.items()}
    before = launch_counts()
    got = paged_append_attention(*(dev[k] for k in NAMES), layer=LAYER,
                                 scale=D ** -0.5)
    again = paged_append_attention(*(dev[k] for k in NAMES), layer=LAYER,
                                   scale=D ** -0.5)
    torch.cuda.synchronize()
    assert launch_counts() == (before[0] + 2, before[1], before[2])
    assert torch.equal(got, again)
    want = paged_append_attention_plain(*(plain[k] for k in NAMES),
                                        layer=LAYER, scale=D ** -0.5)
    live = [s for s, nv in enumerate(n_valid) if nv > 0]
    rows = [(s, i) for s in live for i in range(n_valid[s])]
    pick = (torch.tensor([r[0] for r in rows]), torch.tensor([r[1] for r in rows]))
    assert_close_to_plain(got[pick], want[pick])
    for s, nv in enumerate(n_valid):
        assert bool((got[s, nv:] == 0).all())
    assert torch.equal(dev["k_pool"], plain["k_pool"])
    assert torch.equal(dev["v_pool"], plain["v_pool"])


@pytest.mark.cuda
def test_each_body_moves_its_own_counter_on_cuda():
    """bf16 q over bf16 pools runs the tensor-core fp-KV body (``launches``
    alone); fp32 q over fp32 pools runs the fp32 body (``launches`` and
    ``fp32_launches``); neither moves ``int8_launches``, and bf16 q over
    int8 pools moves only that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = make_decode(3, 1, 7, [40, 0], [1, 1], quant=False)
    for dtype, want in ((torch.bfloat16, (1, 0, 0)),
                        (torch.float32, (1, 1, 0))):
        dev = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
        for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
            dev[k] = dev[k].to(dtype)
        before = launch_counts()
        paged_append_attention(*(dev[k] for k in NAMES), layer=LAYER,
                               scale=D ** -0.5)
        torch.cuda.synchronize()
        assert tuple(x - y for x, y in zip(launch_counts(), before)) == want
    q8 = make_decode(3, 1, 7, [40, 0], [1, 1])
    dev = {k: torch.from_numpy(v).cuda() for k, v in q8.items()}
    for k in ("q", "k_new", "v_new"):
        dev[k] = dev[k].bfloat16()
    before = launch_counts()
    paged_append_attention(*(dev[k] for k in NAMES + POOLS[2:]), layer=LAYER,
                           scale=D ** -0.5)
    torch.cuda.synchronize()
    assert tuple(x - y for x, y in zip(launch_counts(), before)) == (0, 0, 1)


def card_case(quant, hq, hkv, t, start, n_valid, *, slots=24, bs=128,
              width=32, seed=0, dtype=torch.bfloat16):
    """q and new rows in ``dtype`` (bf16: a tensor-core body; fp32: the
    fp32 body) over int8 (``quant``) or ``dtype`` pools of 2 layers, made
    on the card: each live slot its own ``width`` shuffled pages of ``bs``
    cols, dead slots' tables at block 0. Runs the kernel twice and the
    plain version once on copies; checks the valid rows within tolerance
    (fp32: ``assert_fp32_close``), dead slots and rows zero, the pools
    bit-equal to the plain append, one launch a call on the body's
    counters, and the two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    live = [s for s in range(slots) if n_valid[s] > 0]
    n_blocks = 1 + len(live) * width
    shape = (2, n_blocks, bs, hkv, D)
    tables = torch.zeros((slots, width), dtype=torch.int32, device="cuda")
    perm = 1 + torch.randperm(len(live) * width, generator=gen,
                              device="cuda").to(torch.int32)
    for i, s in enumerate(live):
        tables[s] = perm[i * width:(i + 1) * width]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    args = dict(q=randn(slots, t, hq, D), k_new=randn(slots, t, hkv, D),
                v_new=randn(slots, t, hkv, D), tables=tables,
                start=torch.tensor(start, dtype=torch.int32, device="cuda"),
                n_valid=torch.tensor(n_valid, dtype=torch.int32,
                                     device="cuda"))
    if quant:
        args.update(
            k_pool=torch.randint(-127, 128, shape, generator=gen,
                                 device="cuda", dtype=torch.int8),
            v_pool=torch.randint(-127, 128, shape, generator=gen,
                                 device="cuda", dtype=torch.int8),
            k_scale=torch.rand(shape[:2] + (hkv, bs), generator=gen,
                               device="cuda") * 0.02 + 0.001,
            v_scale=torch.rand(shape[:2] + (hkv, bs), generator=gen,
                               device="cuda") * 0.02 + 0.001)
    else:
        args.update(k_pool=randn(*shape), v_pool=randn(*shape))
    names = NAMES + (POOLS[2:] if quant else ())
    plain = {k: v.clone() for k, v in args.items()}
    before = launch_counts()
    got = paged_append_attention(*(args[k] for k in names), layer=LAYER,
                                 scale=D ** -0.5)
    again = paged_append_attention(*(args[k] for k in names), layer=LAYER,
                                   scale=D ** -0.5)
    torch.cuda.synchronize()
    moved = tuple(x - y for x, y in zip(launch_counts(), before))
    fp32 = 2 if dtype == torch.float32 else 0
    assert moved == ((0, fp32, 2) if quant else (2, fp32, 0))
    assert torch.equal(got, again)
    want = paged_append_attention_plain(*(plain[k] for k in names),
                                        layer=LAYER, scale=D ** -0.5)
    rows = [(s, i) for s in live for i in range(n_valid[s])]
    if rows:
        pick = (torch.tensor([r[0] for r in rows]),
                torch.tensor([r[1] for r in rows]))
        close = assert_fp32_close if fp32 else assert_close_to_plain
        close(got[pick].float(), want[pick].float())
    for s, nv in enumerate(n_valid):
        assert bool((got[s, nv:] == 0).all())
    for k in POOLS[:4 if quant else 2]:
        assert torch.equal(args[k], plain[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("hq,hkv", [(64, 8), (28, 4)])
@pytest.mark.parametrize("live", [1, 2, 3, 4])
def test_few_live_slots_at_long_contexts_on_cuda(quant, hq, hkv, live):
    """A decode step with 1-4 of 24 slots live at long contexts in
    4096-col tables (32 blocks of 128): the persistent grid's chunks of
    the live work, the last of them at the table's last col."""
    start = [4095 - 701 * i if i < live else 0 for i in range(24)]
    n_valid = [1 if i < live else 0 for i in range(24)]
    card_case(quant, hq, hkv, 1, start, n_valid, seed=live)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("hq,hkv", [(64, 8), (28, 4)])
def test_verify_round_over_128_col_blocks_on_cuda(quant, hq, hkv):
    """A verify round (T = 17) with 8 of 24 slots live over 128-col
    blocks: slot s starts 1 + s rows before a page boundary and appends 17
    - s rows across it, so all G*T rows of a kv-head share each K/V tile
    and the appends cross pages with their own counts."""
    start = [1279 - s if s < 8 else 0 for s in range(24)]
    n_valid = [17 - s if s < 8 else 0 for s in range(24)]
    card_case(quant, hq, hkv, 17, start, n_valid, width=16, seed=hq)


@pytest.mark.cuda
@pytest.mark.parametrize("quant,hq,hkv,cols", [
    (True, 28, 4, 8192),      # int8 at T = 1: 64 two-tile chunks uncapped
    (True, 14, 2, 16384),
    (True, 7, 1, 16384),
    (False, 14, 2, 16384),    # bf16: 128 uncapped
    (False, 28, 4, 16384),
])
def test_one_live_slot_over_long_tables_on_cuda(quant, hq, hkv, cols):
    """One live slot of 24 at the last col of a long table: the chunk rule
    alone would give its pairs more chunks than the merge's buffer holds;
    the capped chunks merge in shared memory within bounds."""
    start = [cols - 1] + [0] * 23
    n_valid = [1] + [0] * 23
    card_case(quant, hq, hkv, 1, start, n_valid, width=cols // 128,
              seed=cols + hkv)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("hq,hkv", [(64, 8), (28, 4)])
@pytest.mark.parametrize("t", [33, 64])
def test_row_tiles_past_one_pass_on_cuda(quant, hq, hkv, t):
    """More than 12 row tiles of G*T rows (T = 33: 15-17, T = 64: 28-32):
    12 warps with q in shared memory walk each chunk once per 12 row
    tiles; slot s appends t - s rows from 1 + s before a page boundary."""
    start = [1279 - s if s < 8 else 0 for s in range(24)]
    n_valid = [t - s if s < 8 else 0 for s in range(24)]
    card_case(quant, hq, hkv, t, start, n_valid, width=16, seed=t + hq)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
def test_more_than_128_slots_on_cuda(quant):
    """160 slots, four of them live at both ends of the slot range: the
    work list grows in shared memory with the slot count."""
    live = {0: 900, 77: 2047, 128: 63, 159: 1500}
    start = [live.get(s, 0) for s in range(160)]
    n_valid = [1 if s in live else 0 for s in range(160)]
    card_case(quant, 28, 4, 1, start, n_valid, slots=160, width=16, seed=160)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("hq,hkv", [(64, 8), (28, 4)])
@pytest.mark.parametrize("t", [1, 2, 5])
@pytest.mark.parametrize("live", [1, 8])
def test_fp32_body_on_cuda(quant, hq, hkv, t, live):
    """The fp32 body (fp32 q over int8 or fp32 pools): 1 or 8 of 24 slots
    live at contexts of 900-4000 cols in 4096-col tables, 1, 2 or 5 new
    tokens (one row tile of 8 rows, one of 16, several), one launch a
    call, two calls bit-equal, within the fp32 bound."""
    start = [4094 - t - 397 * i if i < live else 0 for i in range(24)]
    n_valid = [t if i < live else 0 for i in range(24)]
    card_case(quant, hq, hkv, t, start, n_valid, seed=t + live,
              dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("hq,hkv", [(64, 8), (28, 4)])
def test_fp32_verify_round_across_a_page_on_cuda(quant, hq, hkv):
    """T = 17 under fp32 q: slot s starts 1 + s rows before a page
    boundary and appends 17 - s rows across it; 119 or 136 query rows a
    kv-head, one pass of 8 row tiles or two."""
    start = [1279 - s if s < 8 else 0 for s in range(24)]
    n_valid = [17 - s if s < 8 else 0 for s in range(24)]
    card_case(quant, hq, hkv, 17, start, n_valid, width=16, seed=hq,
              dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("quant,hq,hkv,cols", [
    (True, 28, 4, 8192),
    (False, 28, 4, 8192),
    (True, 7, 1, 16384),      # 128 two-tile chunks uncapped, 111 fit
    (False, 14, 2, 16384),
])
def test_fp32_one_live_slot_over_long_tables_on_cuda(quant, hq, hkv, cols):
    """One live slot of 24 at the last col of a long table under fp32 q:
    the chunks capped by the fp32 body's merge buffer merge within it."""
    start = [cols - 1] + [0] * 23
    n_valid = [1] + [0] * 23
    card_case(quant, hq, hkv, 1, start, n_valid, width=cols // 128,
              seed=cols + hkv, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
def test_fp32_all_slots_dead_on_cuda(quant):
    """No live slot: the fp32 body's launch writes zeros everywhere and
    leaves the pools as they were."""
    card_case(quant, 28, 4, 1, [0] * 24, [0] * 24, width=4, seed=5,
              dtype=torch.float32)
