"""Attention wider than 512 columns a head, the port (plain path on the CPU)
against the JAX package, which computes it: `attention_v3` on an untiled
graph (Pallas forward and B1/B2 in interpret mode) and the v2 contract on a
`with_tiling()` graph, forward and gradients, at 1 head.

On the card the attention kernels run such rows in column strips of <= 512
(tests/test_torch_cuda.py holds them to their plain versions); here the
plain versions run, so this pins the function the strips must compute.
Tolerances: output rtol 1e-4 / atol 1e-5 (tests/test_gat_fused.py:34),
gradients rtol 5e-4 / atol 1e-4 (:53-55): both packages round the same rows
at the same places and sum in f32, only the order differs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_graph as jax_build_graph
from plotpointe_tpu.ops.gat_fused import attention_v3 as jax_attention_v3
from plotpointe_tpu.ops.segment import segment_softmax_attention as jax_attention
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops.gat_fused import attention_v3
from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
N, E = 40, 200


@pytest.fixture(scope="module")
def graphs():
    """40 nodes, 200 edges, a hot destination (node 3) and isolated nodes
    (30..39), in both packages."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 30, E)
    dst = np.where(rng.random(E) < 0.3, 3, rng.integers(0, 30, E))
    return build_graph(src, dst, N), jax_build_graph(src, dst, N, pad_multiple=512)


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, 1, d)).astype(np.float32)
    a_s = (rng.normal(size=(1, d)) * 0.05).astype(np.float32)
    a_d = (rng.normal(size=(1, d)) * 0.05).astype(np.float32)
    ct = rng.normal(size=(N, 1, d)).astype(np.float32)
    return h, a_s, a_d, ct


def _jax_out_and_grads(fn, h, a_s, a_d, ct):
    args = tuple(map(jnp.asarray, (h, a_s, a_d)))
    grads = jax.grad(lambda *a: (fn(*a) * ct).sum(), argnums=(0, 1, 2))(*args)
    return np.asarray(fn(*args)), [np.asarray(x) for x in grads]


def _port_out_and_grads(fn, h, a_s, a_d, ct):
    x = [torch.from_numpy(a).requires_grad_() for a in (h, a_s, a_d)]
    out = fn(*x)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in x]


def _compare(got, want):
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **TOL)
    for name, a, b in zip(("dh", "da_src", "da_dst"), got[1], want[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
def test_v3_at_d1024_matches_jax(graphs, hs_dtype):
    g, jg = graphs
    jl = jg.with_layout(nb=64, eb=128).to_device()
    h, a_s, a_d, ct = _inputs(1024, seed=1)
    want = _jax_out_and_grads(lambda *a: jax_attention_v3(*a, jl, hs_dtype=getattr(jnp, hs_dtype)),
                              h, a_s, a_d, ct)
    got = _port_out_and_grads(lambda *a: attention_v3(*a, g, hs_dtype=getattr(torch, hs_dtype)),
                              h, a_s, a_d, ct)
    _compare(got, want)
    assert np.all(got[0][30:] == 0) and np.all(got[1][0][30:] == 0)


def test_dispatch_at_d544_matches_jax_dispatch(graphs):
    """The fault's smallest input: 1 head of 544 (a multiple of 32, not of
    128), through both dispatches (JAX pads to 640 lanes, the port to 544)."""
    g, jg = graphs
    jl = jg.with_layout(nb=64, eb=128).to_device()
    h, a_s, a_d, ct = _inputs(544, seed=2)
    want = _jax_out_and_grads(lambda *a: jax_attention(*a, jl, impl="pallas"), h, a_s, a_d, ct)
    got = _port_out_and_grads(lambda *a: segment_softmax_attention_kernel(*a, g), h, a_s, a_d, ct)
    _compare(got, want)


def test_v2_on_tiled_graph_at_d1024_matches_jax(graphs):
    g, jg = graphs
    jt = jg.with_tiling(nb=64, eb=128).to_device()
    h, a_s, a_d, ct = _inputs(1024, seed=3)
    want = _jax_out_and_grads(lambda *a: jax_attention(*a, jt, impl="pallas"), h, a_s, a_d, ct)
    got = _port_out_and_grads(
        lambda *a: segment_softmax_attention_kernel(*a, g.with_tiling(nb=64, eb=128)), h, a_s, a_d, ct)
    _compare(got, want)
