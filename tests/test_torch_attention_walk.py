"""Kernels 1 (single-head forward), 8 (head-packed forward) and 3 (B2) in
the order of sums of their edge-balanced walk, on the CPU:
`attention_fwd_mh_pieces` (kernel 1 at one head, kernel 8 at more) and
`attention_bwd_src_pieces` sum each piece of `piece_plan` alone and a split
row's pieces in piece order, as `csrc/gat_fwd.cu` and
`csrc/gat_bwd_src.cu` do. A small cap (4, 8) on rows of 0 to 300 entries
splits many rows. Each order is held against the JAX package (Pallas in
interpret mode, as tests/test_torch_multihead.py and
tests/test_torch_attention_bwd.py run it) and against the plain versions.

Tolerances: forward rtol 1e-4 / atol 1e-5 (tests/test_gat_fused.py:34) and
the f32 gradient band rtol 5e-4 / atol 1e-4 (:53-55): the same rows and
rounding, the sums in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_graph as jax_build_graph
from plotpointe_tpu.ops.gat_fused import attention_v3 as jax_attention_v3
from plotpointe_tpu.ops.gat_fused import attention_v3_mh as jax_attention_v3_mh
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops.gat_fused import (
    attention_bwd_dst_plain, attention_bwd_src_pieces, attention_bwd_src_plain,
    attention_fwd_mh_pieces, attention_fwd_mh_plain, attention_fwd_plain, dropout_mask,
    dropout_mask_mh, node_terms_mh_plain)
from plotpointe_tpu_torch.ops.spmm_kernel import piece_plan

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
N, D = 400, 128
RATE = 0.1


@pytest.fixture(scope="module")
def graphs():
    """Node 0 takes 300 in-edges and node 1 150; node 5 sends 300 (a long
    row of the transpose CSR); nodes 2, 3 have no in-edge, 350..399 touch
    no edge; the rest have lognormal in-degrees up to 40."""
    rng = np.random.default_rng(0)
    deg = np.concatenate([[300, 150, 0, 0], np.minimum(rng.lognormal(1.2, 1.0, 346).astype(int), 40)])
    dst = np.repeat(np.arange(350), deg)
    src = rng.integers(0, 350, dst.shape[0])
    src[rng.choice(dst.shape[0], 300, replace=False)] = 5
    jg = jax_build_graph(src, dst, N, pad_multiple=512).with_layout(nb=64, eb=128).to_device()
    return build_graph(src, dst, N), jg


def test_the_graph_splits_rows_in_both_directions(graphs):
    g, _ = graphs
    for ptr in (g.row_ptr, g.t_ptr):
        assert int((ptr[1:] - ptr[:-1]).max()) >= 300
        assert piece_plan(ptr, 4).split_rows.numel() > 100


def _inputs(heads, seed=1, d=D):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, heads, d)).astype(np.float32)
    a_s = (rng.normal(size=(heads, d)) * 0.1).astype(np.float32)
    a_d = (rng.normal(size=(heads, d)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(N, heads, d)).astype(np.float32)
    return h, a_s, a_d, ct


def _seed(key):
    return int(jax.random.bits(key, (), jnp.uint32))


_jax_fwd = {}


def _jax_forward(jg, heads, hs_dtype, masked):
    """JAX's head-packed forward output, once per configuration."""
    k = (heads, hs_dtype, masked)
    if k not in _jax_fwd:
        h, a_s, a_d, _ = _inputs(heads)
        _jax_fwd[k] = np.asarray(jax_attention_v3_mh(
            jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d), jg, dropout_rate=RATE if masked else 0.0,
            rng=jax.random.key(5), hs_dtype=getattr(jnp, hs_dtype)))
    return _jax_fwd[k]


@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_mh_piece_order_matches_jax_and_plain(graphs, cap, heads, hs_dtype, masked):
    g, jg = graphs
    h, a_s, a_d = map(torch.from_numpy, _inputs(heads)[:3])
    mask = dropout_mask_mh(g, RATE, _seed(jax.random.key(5)), heads, "cpu") if masked else None
    dt = getattr(torch, hs_dtype)
    out, den = attention_fwd_mh_pieces(h, a_s, a_d, g, mask=mask, hs_dtype=dt, cap=cap)
    want_out, want_den = attention_fwd_mh_plain(h, a_s, a_d, g, mask=mask, hs_dtype=dt)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(den, want_den, **TOL)
    np.testing.assert_allclose(out.numpy(), _jax_forward(jg, heads, hs_dtype, masked), **TOL)
    assert torch.all(out[350:] == 0) and torch.all(den[2:4] == 0)


_jax_fwd1 = {}


def _jax_forward_1(jg, d, hs_dtype, masked):
    """JAX's single-head `attention_v3` output, once per configuration."""
    k = (d, hs_dtype, masked)
    if k not in _jax_fwd1:
        h, a_s, a_d, _ = _inputs(1, seed=3, d=d)
        _jax_fwd1[k] = np.asarray(jax_attention_v3(
            jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d), jg, dropout_rate=RATE if masked else 0.0,
            rng=jax.random.key(5), hs_dtype=getattr(jnp, hs_dtype)))
    return _jax_fwd1[k]


@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("d", [128, 96])
@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_single_head_piece_order_matches_jax_and_plain(graphs, cap, d, hs_dtype, masked):
    """Kernel 1 on the walk: the head-packed order at one head (h [N, 1, D],
    mask [1, E]) is JAX's `attention_v3` and the plain single-head forward,
    at D 128 and at D 96 (a row of 24 f32 or 12 bf16 chunks: a lane group
    of the next power of two with idle lanes on the card)."""
    g, jg = graphs
    h, a_s, a_d = map(torch.from_numpy, _inputs(1, seed=3, d=d)[:3])
    mask = dropout_mask(g, RATE, _seed(jax.random.key(5)), "cpu") if masked else None
    dt = getattr(torch, hs_dtype)
    out, den = attention_fwd_mh_pieces(h, a_s, a_d, g, mask=None if mask is None else mask[None],
                                       hs_dtype=dt, cap=cap)
    want_out, want_den = attention_fwd_plain(h, a_s, a_d, g, mask=mask, hs_dtype=dt)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(den[:, 0], want_den, **TOL)
    np.testing.assert_allclose(out.numpy(), _jax_forward_1(jg, d, hs_dtype, masked), **TOL)
    assert torch.all(out[350:] == 0) and torch.all(den[2:4] == 0)


_jax_dh = {}


def _jax_grad_h(jg, heads, hs_dtype):
    """d/dh of sum(attention * ct) in JAX with the 0.1 dropout mask: the
    single-head `attention_v3` (heads 1) or the head-packed op."""
    k = (heads, hs_dtype)
    if k not in _jax_dh:
        h, a_s, a_d, ct = _inputs(heads, seed=2)
        op = jax_attention_v3 if heads == 1 else jax_attention_v3_mh

        def loss(h):
            out = op(h, jnp.asarray(a_s), jnp.asarray(a_d), jg, dropout_rate=RATE,
                     rng=jax.random.key(5), hs_dtype=getattr(jnp, hs_dtype))
            return (out * ct).sum()

        _jax_dh[k] = np.asarray(jax.grad(loss)(jnp.asarray(h)))
    return _jax_dh[k]


@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_bwd_src_piece_order_matches_jax_and_plain(graphs, cap, hs_dtype, strided):
    """B2 in piece order, plus B1's de_sum * a_dst, is JAX's dh; B2 alone
    is the plain B2. Strided: the last head's rows of the [N, 2, D]
    tensors, read as row-strided views, as the 2-head backward passes them."""
    g, jg = graphs
    heads = 2 if strided else 1
    h, a_s, a_d, ct = map(torch.from_numpy, _inputs(heads, seed=2))
    dt = getattr(torch, hs_dtype)
    mask = dropout_mask_mh(g, RATE, _seed(jax.random.key(5)), max(heads, 2), "cpu")[:heads]
    rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, dt)
    out, den = attention_fwd_mh_plain(h, a_s, a_d, g, mask=mask, hs_dtype=dt)
    gh = ct.to(dt)
    want_dh = _jax_grad_h(jg, heads, hs_dtype)
    for k in range(heads):
        de_sum, godot, _ = attention_bwd_dst_plain(rows[:, k], gs[:, k], gd[:, k], ct[:, k], out[:, k],
                                                   den[:, k], g, mask[k])
        if strided:
            assert rows[:, k].stride(0) == heads * D and gh[:, k].stride(0) == heads * D
        args = (rows[:, k], gh[:, k], a_s[k:k + 1], gs[:, k], gd[:, k], den[:, k], godot, g, mask[k])
        got = attention_bwd_src_pieces(*args, cap=cap)
        torch.testing.assert_close(got, attention_bwd_src_plain(*args), **GRAD_TOL)
        dh = got + de_sum[:, None] * a_d[k]
        np.testing.assert_allclose(dh.numpy(), want_dh[:, k], **GRAD_TOL)
        assert torch.all(got[350:] == 0)
