"""The port's attention backward (plain path on the CPU) against the JAX
package: gradients of `attention_v3` (Pallas B1/B2 in interpret mode, as
tests/test_gat_fused.py runs them), autograd of the golden, the transpose
CSR, and the gather fence.

Gradient tolerance rtol 5e-4 / atol 1e-4 (tests/test_gat_fused.py:53-55),
for f32 and bf16 rows alike: both packages round the same rows (and, in B2,
the same cotangent) to bf16 at the same places and sum in f32, so only the
summation order differs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_graph as jax_build_graph
from plotpointe_tpu.ops.gat_fused import _gather_fence, attention_v3 as jax_attention_v3
from plotpointe_tpu_torch import reference_active
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops.gat_fused import (
    attention_bwd_dst, attention_bwd_dst_plain, attention_bwd_plain, attention_bwd_src,
    attention_bwd_src_plain, attention_fwd_plain, attention_v3, gather_fence, gather_fence_plain,
    hash_mask, node_terms_plain, reference_versions)
from plotpointe_tpu_torch.ops.segment import segment_softmax_attention

GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
N, E = 200, 1500


@pytest.fixture(scope="module")
def graphs():
    """Skewed in-degrees (60% of edges into node 3) and isolated nodes
    (150..199 touch no edge), in both packages."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 150, E)
    dst = np.where(rng.random(E) < 0.6, 3, rng.integers(0, 150, E))
    jg = jax_build_graph(src, dst, N, pad_multiple=512).with_layout(nb=64, eb=128).to_device()
    return build_graph(src, dst, N), jg, (src, dst)


def _inputs(d, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, 1, d)).astype(np.float32)
    a_s = (rng.normal(size=(1, d)) * 0.3).astype(np.float32)
    a_d = (rng.normal(size=(1, d)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(N, 1, d)).astype(np.float32)
    return h, a_s, a_d, ct


def _jax_grads(h, a_s, a_d, ct, jg, **kw):
    """jax.grad of sum(attention_v3 * ct), D lane-padded to 128 as the JAX
    dispatch does."""
    d = h.shape[-1]
    pad = 128 - d

    def loss(h, a_s, a_d):
        out = jax_attention_v3(jnp.pad(h, ((0, 0), (0, 0), (0, pad))), jnp.pad(a_s, ((0, 0), (0, pad))),
                               jnp.pad(a_d, ((0, 0), (0, pad))), jg, **kw)[..., :d]
        return (out * ct).sum()

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d))]


def _port_grads(h, a_s, a_d, ct, g, **kw):
    th, ts, td = (torch.from_numpy(x).requires_grad_() for x in (h, a_s, a_d))
    (attention_v3(th, ts, td, g, **kw) * torch.from_numpy(ct)).sum().backward()
    return [t.grad.numpy() for t in (th, ts, td)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dropout", [0.0, 0.4])
@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
def test_attention_v3_grads_match_jax(graphs, d, dropout, hs_dtype):
    g, jg, _ = graphs
    h, a_s, a_d, ct = _inputs(d)
    key = jax.random.key(5)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    want = _jax_grads(h, a_s, a_d, ct, jg, dropout_rate=dropout, rng=key,
                      hs_dtype=getattr(jnp, hs_dtype))
    got = _port_grads(h, a_s, a_d, ct, g, dropout_rate=dropout, seed=seed,
                      hs_dtype=getattr(torch, hs_dtype))
    for name, a, b in zip(("dh", "da_src", "da_dst"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
    assert np.all(got[0][150:] == 0)  # isolated nodes get no gradient


@pytest.mark.parametrize("d", [32, 128])
def test_plain_backward_matches_autograd_of_golden(graphs, d):
    g, _, _ = graphs
    h, a_s, a_d, ct = _inputs(d, seed=2)
    th, ts, td = (torch.from_numpy(x).requires_grad_() for x in (h, a_s, a_d))
    (segment_softmax_attention(th, ts, td, g) * torch.from_numpy(ct)).sum().backward()
    want = [t.grad.numpy() for t in (th, ts, td)]

    h_, s_, d_ = map(torch.from_numpy, (h, a_s, a_d))
    out, den = attention_fwd_plain(h_, s_, d_, g, hs_dtype=torch.float32)
    got = attention_bwd_plain(h_, s_, d_, g, torch.from_numpy(ct), out, den, hs_dtype=torch.float32)
    for name, a, b in zip(("dh", "da_src", "da_dst"), got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **GRAD_TOL)
    via_op = _port_grads(h, a_s, a_d, ct, g, hs_dtype=torch.float32)
    for name, a, b in zip(("dh", "da_src", "da_dst"), via_op, got):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    with pytest.raises(RuntimeError), reference_versions():
        via_ref = _port_grads(h, a_s, a_d, ct, g, hs_dtype=torch.float32)
        raise RuntimeError
    assert not reference_active()  # the switch is scoped, even on an error
    for name, a, b in zip(("dh", "da_src", "da_dst"), via_ref, got):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrappers_on_cpu_are_their_plain_versions(graphs, hs_dtype):
    g, _, _ = graphs
    h, a_s, a_d, ct = (torch.from_numpy(x) for x in _inputs(64, seed=3))
    rows, gs, gd = node_terms_plain(h[:, 0], a_s, a_d, hs_dtype)
    mask = hash_mask(9, torch.arange(g.n_edges), 0.3)
    out, den = attention_fwd_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    args = (rows, gs, gd, ct[:, 0], out[:, 0], den, g, mask)
    for a, b in zip(attention_bwd_dst(*args), attention_bwd_dst_plain(*args)):
        assert torch.equal(a, b)
    de_sum, godot, _ = attention_bwd_dst(*args)
    assert torch.allclose(godot, (ct[:, 0] * out[:, 0]).sum(1))
    args2 = (rows, ct[:, 0].to(hs_dtype), a_s, gs, gd, den, godot, g, mask)
    assert torch.equal(attention_bwd_src(*args2), attention_bwd_src_plain(*args2))
    with pytest.raises(ValueError, match="gh must be"):
        attention_bwd_src(rows, ct[:, 0].double(), a_s, gs, gd, den, godot, g, mask)
    with pytest.raises(ValueError, match="multiple of 32"):
        attention_bwd_dst(rows[:, :48], gs, gd, ct[:, 0, :48], out[:, 0, :48], den, g, mask)


def test_transpose_csr_matches_jax_layout(graphs):
    g, jg, (src, dst) = graphs
    L = jg.layout
    t_src_key, t_other, t_pos = (np.asarray(x) for x in (L.t_dst, L.t_src, L.t_pos))
    keep = t_pos != jg.n_edges
    want = np.stack([t_src_key[keep], t_other[keep], t_pos[keep]], axis=1)

    t_ptr, t_dst, t_eid = (x.numpy().astype(np.int64) for x in (g.t_ptr, g.t_dst, g.t_eid))
    owner = np.repeat(np.arange(N), np.diff(t_ptr))
    got = np.stack([owner, t_dst, t_eid], axis=1)
    assert t_ptr[-1] == len(src) == g.n_edges
    # the same (source, destination, canonical id) triples, per source
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])
    # canonical ids point back at the (dst, src)-sorted edges
    np.testing.assert_array_equal(g.src.numpy()[t_eid], owner)
    np.testing.assert_array_equal(g.dst.numpy()[t_eid], t_dst)
    moved = g.to("cpu")
    assert torch.equal(moved.t_eid, g.t_eid) and torch.equal(moved.t_ptr, g.t_ptr)


@pytest.mark.parametrize("shape", [(8, 128), (40, 64), (300, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_fence_matches_jax(shape, dtype):
    x = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    want = np.asarray(_gather_fence(jnp.asarray(x).astype(getattr(jnp, dtype))))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = gather_fence(xt)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, gather_fence_plain(xt))
    with pytest.raises(ValueError):
        gather_fence(torch.zeros(0, 4))
