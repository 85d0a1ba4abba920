"""Ring (context-parallel) attention of the PyTorch port against the JAX
package's on its virtual CPU mesh and against plain attention.

Gloo groups of 2 and 4 processes (``tests/torch_port_dist.py``) run
``parallel.context_parallel.ring_attention`` over a ring of 2 (the data
axis of a (2, 1) mesh, and the model axis of a (2, 2) mesh) and of 4 (the
data axis of a (4, 1) mesh), causal and not, with and without GQA; each
rank's chunk must equal the matching rows of JAX's ``ring_attention`` and
of float64 plain attention to 1e-5 in fp32. A sequence that does not
split over the ring raises ``ValueError``.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from handwritten_ocr_tpu.parallel.context_parallel import (
    ring_attention as jax_ring_attention)
from torch_port_dist import Group, ring_cases

B, S, D = 2, 64, 32
HEADS = {"mha": (4, 4), "gqa": (8, 2)}
# world: {case name: (model axis, ring axis)}
RINGS = {2: {"ring2_data": (1, "data")},
         4: {"ring2_model": (2, "model"), "ring4_data": (1, "data")}}


def inputs(heads: str):
    hq, hkv = HEADS[heads]
    rng = np.random.default_rng(hq * 10 + hkv)
    return (rng.standard_normal((B, S, hq, D)).astype(np.float32),
            rng.standard_normal((B, S, hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, hkv, D)).astype(np.float32))


def plain(q, k, v, causal):
    hq, hkv = q.shape[2], k.shape[2]
    k = np.repeat(k, hq // hkv, axis=2).astype(np.float64)
    v = np.repeat(v, hq // hkv, axis=2).astype(np.float64)
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * D ** -0.5
    if causal:
        scores = np.where(np.tril(np.ones((S, S), bool))[None, None], scores,
                          -np.inf)
    scores -= scores.max(axis=-1, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _cases(world: int) -> dict:
    return {f"{ring}_{heads}_{'causal' if causal else 'full'}":
            (model, axis, causal, *inputs(heads))
            for ring, (model, axis) in RINGS[world].items()
            for heads in HEADS for causal in (False, True)}


@pytest.fixture(scope="module")
def rings():
    """{world: per-rank results}; both groups run at once."""
    groups = {world: Group(world, ring_cases, _cases(world))
              for world in RINGS}
    return {world: group.results(timeout=240)
            for world, group in groups.items()}


@functools.lru_cache(maxsize=None)
def _jax_ring(n: int, heads: str, causal: bool) -> np.ndarray:
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("data",))
    q, k, v = (jnp.asarray(x) for x in inputs(heads))
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_ring_attention(q, k, v, mesh=mesh,
                                             causal=causal))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("ring", ["ring2_data", "ring2_model", "ring4_data"])
def test_ring_matches_jax_ring_and_plain_attention(rings, ring, heads, causal):
    world = 2 if ring in RINGS[2] else 4
    n = int(ring[4])
    name = f"{ring}_{heads}_{'causal' if causal else 'full'}"
    want_jax = _jax_ring(n, heads, causal)
    want_plain = plain(*inputs(heads), causal)
    np.testing.assert_allclose(want_jax, want_plain, rtol=0, atol=1e-5)
    chunk = S // n
    seen = set()
    for result in rings[world]:
        index, got = result[name]
        seen.add(index)
        rows = slice(index * chunk, (index + 1) * chunk)
        assert got.shape == (B, chunk, HEADS[heads][0], D)
        np.testing.assert_allclose(got, want_jax[:, rows], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, want_plain[:, rows], rtol=0, atol=1e-5)
    assert seen == set(range(n))


@pytest.mark.parametrize("world", sorted(RINGS))
def test_rejects_indivisible_sequence(rings, world):
    for result in rings[world]:
        assert "not divisible" in result["indivisible"]
