"""Kernels 2 (B1) and 9 in the order of sums of their edge-balanced walk,
on the CPU: `attention_bwd_dst_pieces` sums de_sum over each piece of
`piece_plan(row_ptr, cap)` alone and a split row's pieces in piece order,
and d a_src over each unit's entries, a block's units and then the blocks,
as `csrc/gat_bwd_dst.cu` does. A small cap (4, 8) on rows of 0 to 300
entries splits many rows. The order is held against the JAX package's
gradients of `attention_v3` / `attention_v3_mh` (Pallas in interpret mode,
as tests/test_torch_attention_walk.py runs them) and against the plain
versions, at 1 and 2 heads, f32 and bf16 rows, with and without the
dropout mask, and at one head of D 544 (the kernel's column strips).

Tolerance: the f32 gradient band rtol 5e-4 / atol 1e-4
(tests/test_gat_fused.py:53-55): the same rows and rounding, the sums in
another order.
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
    attention_bwd_dst_mh_plain, attention_bwd_dst_pieces, attention_bwd_dst_plain, attention_bwd_src_plain,
    attention_fwd_mh_plain, dropout_mask_mh, node_terms_mh_plain)

GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
N = 400
RATE = 0.1


@pytest.fixture(scope="module")
def graphs():
    """Node 0 takes 300 in-edges and node 1 150; nodes 2, 3 have no
    in-edge, 350..399 touch no edge; the rest have lognormal in-degrees up
    to 40 (tests/test_torch_attention_walk.py's graph)."""
    rng = np.random.default_rng(0)
    deg = np.concatenate([[300, 150, 0, 0], np.minimum(rng.lognormal(1.2, 1.0, 346).astype(int), 40)])
    dst = np.repeat(np.arange(350), deg)
    src = rng.integers(0, 350, dst.shape[0])
    jg = jax_build_graph(src, dst, N, pad_multiple=512).with_layout(nb=64, eb=128).to_device()
    return build_graph(src, dst, N), jg


def _inputs(heads, d, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, heads, d)).astype(np.float32)
    a_s = (rng.normal(size=(heads, d)) * 0.1).astype(np.float32)
    a_d = (rng.normal(size=(heads, d)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(N, heads, d)).astype(np.float32)
    return h, a_s, a_d, ct


def _seed():
    return int(jax.random.bits(jax.random.key(5), (), jnp.uint32))


_jax_grads = {}


def _jax(jg, heads, d, hs_dtype, masked):
    """(dh, da_src, da_dst) of sum(attention * ct) in JAX, once per
    configuration: `attention_v3` at one head (D padded with zero columns
    to a multiple of 128, as the JAX dispatch pads lanes), the head-packed
    op at more."""
    key = (heads, d, hs_dtype, masked)
    if key not in _jax_grads:
        h, a_s, a_d, ct = _inputs(heads, d, seed=heads * d)
        pad = -d % 128 if heads == 1 else 0
        op = jax_attention_v3 if heads == 1 else jax_attention_v3_mh

        def loss(h, a_s, a_d):
            out = op(jnp.pad(h, ((0, 0), (0, 0), (0, pad))), jnp.pad(a_s, ((0, 0), (0, pad))),
                     jnp.pad(a_d, ((0, 0), (0, pad))), jg, dropout_rate=RATE if masked else 0.0,
                     rng=jax.random.key(5), hs_dtype=getattr(jnp, hs_dtype))[..., :d]
            return (out * ct).sum()

        _jax_grads[key] = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d))]
    return _jax_grads[key]


def _check(graphs, cap, heads, d, hs_dtype, masked):
    g, jg = graphs
    h, a_s, a_d, ct = map(torch.from_numpy, _inputs(heads, d, seed=heads * d))
    dt = getattr(torch, hs_dtype)
    mask = dropout_mask_mh(g, RATE, _seed(), max(heads, 2), "cpu")[:heads] if masked else None
    rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, dt)
    out, den = attention_fwd_mh_plain(h, a_s, a_d, g, mask=mask, hs_dtype=dt)
    args = (rows, gs, gd, ct, out, den, g, mask)
    de_sum, godot, da_src = attention_bwd_dst_pieces(*args, cap=cap)
    if heads == 1:
        want = attention_bwd_dst_plain(rows[:, 0], gs[:, 0], gd[:, 0], ct[:, 0], out[:, 0], den[:, 0], g,
                                       None if mask is None else mask[0])
        want = (want[0][:, None], want[1][:, None], want[2])
    else:
        want = attention_bwd_dst_mh_plain(*args)
    for name, a, b in zip(("de_sum", "godot", "da_src"), (de_sum, godot, da_src), want):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)
    # JAX: da_src directly; de_sum and godot through dh = B2 (plain, which
    # reads godot) plus de_sum * a_dst, node by node
    want_dh, want_da_src, _ = _jax(jg, heads, d, hs_dtype, masked)
    np.testing.assert_allclose(da_src.numpy(), want_da_src, err_msg="da_src", **GRAD_TOL)
    gh = ct.to(dt)
    for k in range(heads):
        dh = attention_bwd_src_plain(rows[:, k], gh[:, k], a_s[k:k + 1], gs[:, k], gd[:, k], den[:, k],
                                     godot[:, k], g, None if mask is None else mask[k])
        np.testing.assert_allclose((dh + de_sum[:, k:k + 1] * a_d[k]).numpy(), want_dh[:, k],
                                   err_msg=f"dh head {k}", **GRAD_TOL)
    assert torch.all(de_sum[350:] == 0) and torch.all(de_sum[2:4] == 0)


@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_dst_piece_order_matches_jax_and_plain(graphs, cap, heads, hs_dtype, masked):
    """Kernel 2 (one head) and 9 (two heads) at D 128."""
    _check(graphs, cap, heads, 128, hs_dtype, masked)


@pytest.mark.parametrize("cap", [4, 8])
def test_bwd_dst_piece_order_in_column_strips_matches_jax_and_plain(graphs, cap):
    """One head of D 544, which the kernel runs in strips of 512 and 32
    columns after `row_dots`: the order of each column's sum is the same,
    so the walk's function is the one above. bf16 rows with the mask, the
    training step's configuration."""
    _check(graphs, cap, 1, 544, "bfloat16", True)
