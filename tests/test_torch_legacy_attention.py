"""The port's legacy attention contracts on the CPU against the JAX package:
v1 (`_attention_v1`: kernel 13, and kernel 15 above one head) and v2
(`_attention_v2`: kernel 14), selected by a graph marked with
`with_tiling()`; the reduces against their Pallas kernels in interpret mode;
the golden's dropout mask; and a tiny tiled GAT model's forward.

Tolerances: forward rtol 1e-4 / atol 1e-5 (tests/test_gat_fused.py:34; v2
rounds the same f32 rows to bf16 on both sides, so only the summation order
differs); gradients rtol 5e-4 / atol 1e-4 (:53-55). Dropout: JAX draws its
Bernoulli keep over the padded edges; both packages get its first E rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_bipartite_graph as jax_bipartite
from plotpointe_tpu.graphs.csr import build_graph as jax_build_graph
from plotpointe_tpu.models.gat import GATModel as JaxGAT
from plotpointe_tpu.ops.gat_fused import _reduce_call
from plotpointe_tpu.ops.gat_kernel import _fused_segment_reduce
from plotpointe_tpu.ops.segment import segment_softmax_attention as jax_attention
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops import cuda_build
from plotpointe_tpu_torch.ops.gat_fused import segment_sum_rows, segment_sum_rows_plain
from plotpointe_tpu_torch.ops.gat_kernel import (
    attention_v1, attention_v2, fused_layer, fused_layer_plain, fused_segment_reduce,
    fused_segment_reduce_plain, legacy_mask, segment_softmax_attention_kernel)
from plotpointe_tpu_torch.ops.segment import bernoulli_mask, segment_softmax_attention
from plotpointe_tpu_torch.train.checkpoint import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
N, E = 200, 1500


@pytest.fixture(scope="module")
def graphs():
    """A hot destination (node 3 takes half the edges) and isolated nodes
    (150..199), in both packages; JAX's padded to 2,048 edges."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 150, E)
    dst = np.where(rng.random(E) < 0.5, 3, rng.integers(0, 150, E))
    jg = jax_build_graph(src, dst, N, pad_multiple=512)
    return build_graph(src, dst, N).with_tiling(nb=64, eb=128), jg


def test_with_tiling_marks_a_copy(graphs):
    g, _ = graphs
    assert g.tiling == (64, 128) and g.to("cpu").tiling == (64, 128)
    assert build_graph(np.array([0]), np.array([1]), 2).tiling is None
    with pytest.raises(ValueError, match="positive"):
        g.with_tiling(nb=0)


@pytest.mark.parametrize("width", [128, 256])
def test_fused_segment_reduce_matches_pallas(graphs, width):
    g, jg = graphs
    rng = np.random.default_rng(width)
    w = rng.random(E).astype(np.float32)
    hs = rng.normal(size=(E, width)).astype(np.float32)
    jt = jg.with_tiling(nb=64, eb=128).to_device()
    pad = jt.n_padded - E
    want = _fused_segment_reduce(
        jnp.asarray(np.pad(w, (0, pad))), jt.dst, jnp.asarray(np.pad(hs, ((0, pad), (0, 0)))),
        jt.chunk_base, 64, 128, int(jt.chunk_base.shape[0]), jt.c_max)
    got = fused_segment_reduce(torch.from_numpy(w), torch.from_numpy(hs), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:N], **TOL)
    assert torch.equal(got, fused_segment_reduce_plain(torch.from_numpy(w), torch.from_numpy(hs), g))
    assert np.all(got.numpy()[150:] == 0)


@pytest.mark.parametrize("width", [64, 128])
def test_segment_sum_rows_matches_pallas(graphs, width):
    g, jg = graphs
    x = np.random.default_rng(width + 1).normal(size=(E, width)).astype(np.float32)
    lay = jg.with_layout(nb=64, eb=128).layout
    x_al = np.concatenate([x, np.zeros((1, width), np.float32)])[lay.pos]  # pads read the zero row
    want = _reduce_call(jnp.asarray(x_al), jnp.asarray(lay.dst.reshape(-1, 128)),
                        jnp.asarray(lay.tile_of), jnp.asarray(lay.is_last), 64, 128, lay.n_tiles,
                        lay.n_chunks)
    got = segment_sum_rows(torch.from_numpy(x), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:N], **TOL)
    assert torch.equal(got, segment_sum_rows_plain(torch.from_numpy(x), g))


def _inputs(heads, d, seed=1):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, heads, d)).astype(np.float32)
    a_s = (rng.normal(size=(heads, d)) * 0.3).astype(np.float32)
    a_d = (rng.normal(size=(heads, d)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(N, heads, d)).astype(np.float32)
    return h, a_s, a_d, ct


def _out_and_grads_jax(fn, h, a_s, a_d, ct):
    args = tuple(map(jnp.asarray, (h, a_s, a_d)))
    grads = jax.grad(lambda *a: (fn(*a) * ct).sum(), argnums=(0, 1, 2))(*args)
    return np.asarray(fn(*args)), [np.asarray(x) for x in grads]


def _out_and_grads_port(fn, h, a_s, a_d, ct):
    x = [torch.from_numpy(a).requires_grad_() for a in (h, a_s, a_d)]
    out = fn(*x)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in x]


@pytest.mark.parametrize("heads,d,version", [(1, 128, 2), (1, 64, 1), (2, 64, 1)])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_legacy_contracts_match_jax(graphs, heads, d, version, dropout):
    """JAX `segment_softmax_attention(impl="pallas")` on a tiled graph (v2 at
    1 head of 128, v1 otherwise) against the port's contract with JAX's
    keep mask; the port's dispatch on the marked graph takes the same
    contract."""
    g, jg = graphs
    jt = jg.with_tiling(nb=64, eb=128).to_device()
    h, a_s, a_d, ct = _inputs(heads, d, seed=heads * d)
    key = jax.random.key(3) if dropout else None
    want = _out_and_grads_jax(lambda *a: jax_attention(*a, jt, dropout_rate=dropout, rng=key,
                                                       impl="pallas"), h, a_s, a_d, ct)
    mask = None
    if dropout:
        keep = np.asarray(jax.random.bernoulli(key, 1.0 - dropout, (jt.n_padded, heads)))[:E]
        mask = torch.from_numpy(np.where(keep, np.float32(1.0 / (1.0 - dropout)), 0.0)
                                .astype(np.float32))
    op = attention_v2 if version == 2 else attention_v1
    got = _out_and_grads_port(lambda *a: op(*a, g, mask), h, a_s, a_d, ct)
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **TOL)
    for name, a, b in zip(("dh", "da_src", "da_dst"), got[1], want[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
    if not dropout:
        via = segment_softmax_attention_kernel(*map(torch.from_numpy, (h, a_s, a_d)), g)
        assert torch.equal(via, torch.from_numpy(got[0]))


@pytest.mark.parametrize("heads,d", [(1, 128), (2, 64)])
def test_dispatch_draws_one_mask_for_forward_and_backward(graphs, heads, d):
    """With dropout on a tiled graph the dispatch draws `legacy_mask` from
    the seed once: its output and gradients are the golden's with that
    mask (v2's forward rounds rows to bf16: within 2e-2 of the f32 golden,
    the band of tests/test_gat_kernel.py's v2 tests)."""
    g, _ = graphs
    h, a_s, a_d, ct = _inputs(heads, d, seed=9)
    mask = legacy_mask(g, heads, 0.4, 1234, "cpu")
    assert mask.shape == (E, heads)
    assert set(np.unique(mask.numpy())) <= {0.0, np.float32(1 / 0.6)}
    assert torch.equal(mask, bernoulli_mask(E, heads, 0.4, torch.Generator().manual_seed(1234)))
    got = _out_and_grads_port(lambda *a: segment_softmax_attention_kernel(
        *a, g, dropout_rate=0.4, seed=1234), h, a_s, a_d, ct)
    want = _out_and_grads_port(lambda *a: segment_softmax_attention(*a, g, mask=mask), h, a_s, a_d, ct)
    np.testing.assert_allclose(got[0], want[0], **(TOL if d != 128 else dict(rtol=2e-2, atol=2e-2)))
    for a, b in zip(got[1], want[1]):  # the same function, summed in another order
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    per_head = legacy_mask(g, 2, 0.4, [5, 6], "cpu")
    assert torch.equal(per_head[:, 1:], legacy_mask(g, 1, 0.4, 6, "cpu"))
    with pytest.raises(ValueError, match="one per head"):
        legacy_mask(g, 3, 0.4, [5, 6], "cpu")


def test_kernel_wrappers_on_cpu_are_their_plain_versions(graphs):
    """On CPU tensors the wrappers run their plain versions and count no
    launch; v2 takes kernel 1's widths: any multiple of 32 (column strips
    above 512 on the card)."""
    g, _ = graphs
    h, a_s, a_d, _ = (torch.from_numpy(x) for x in _inputs(1, 128, seed=4))
    mask = bernoulli_mask(E, 1, 0.2, torch.Generator().manual_seed(0))[:, 0]
    before = {k: cuda_build.COUNTERS[k].count for k in cuda_build.SHARED}
    assert torch.equal(fused_layer(h, a_s, a_d, g, mask), fused_layer_plain(h, a_s, a_d, g, mask))
    assert {k: cuda_build.COUNTERS[k].count for k in cuda_build.SHARED} == before
    wide = torch.ones(N, 1, 640)
    assert torch.equal(attention_v2(wide, torch.zeros(1, 640), torch.zeros(1, 640), g),
                       fused_layer_plain(wide, torch.zeros(1, 640), torch.zeros(1, 640), g))
    with pytest.raises(ValueError, match="multiple of 32"):
        attention_v2(torch.zeros(N, 1, 48), torch.zeros(1, 48), torch.zeros(1, 48), g)
    with pytest.raises(ValueError, match="single-head"):
        attention_v2(torch.zeros(N, 2, 128), torch.zeros(2, 128), torch.zeros(2, 128), g)
    with pytest.raises(ValueError, match=r"\[1500, W\]"):
        fused_segment_reduce(torch.ones(E), torch.ones(E - 1, 32), g)


@pytest.mark.parametrize("heads", [1, 2])
def test_tiled_gat_forward_matches_jax(tiny_dataset, heads):
    """`GATModel.forward` on a tiled graph (hidden 32: v1) against JAX
    `GATModel.apply` with attn_impl="pallas" on a graph with tiling only."""
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.models.gat import GATModel

    s = build_splits(tiny_dataset, *build_node_maps(tiny_dataset))
    feats = np.random.default_rng(2).normal(size=(s.n_items, 24)).astype(np.float32)
    jm = JaxGAT(s.n_users, s.n_items, 24, hidden_dim=32, n_layers=2, heads=heads,
                attn_impl="pallas")
    params = jm.init(jax.random.key(heads))
    flat = {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    jg = jax_bipartite(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
    want = jm.apply(params, jnp.asarray(feats), jg.with_tiling().to_device())
    graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items,
                                  weight=s.train_w).with_tiling()
    model = GATModel.from_config(jm.config_dict())
    model.load_state_dict(params_from_jax(flat))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), graph)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
