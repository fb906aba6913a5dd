"""Port attention (plain path on the CPU) against the JAX package: the XLA
golden `segment_softmax_attention` and the fused Pallas `attention_v3` (run
in interpret mode on the CPU, as tests/test_gat_fused.py does).

Tolerance rtol 1e-4 / atol 1e-5 throughout (tests/test_gat_fused.py:34),
also for bf16 source rows: both packages round the same rows to bf16 and
sum in f32, so only the summation order differs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plotpointe_tpu.graphs.csr import build_graph as jax_build_graph
from plotpointe_tpu.ops.gat_fused import _hash_mask, attention_v3
from plotpointe_tpu.ops.segment import segment_softmax_attention as jax_attention
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops.gat_fused import attention_fwd, hash_mask
from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel
from plotpointe_tpu_torch.ops.segment import segment_softmax_attention

TOL = dict(rtol=1e-4, atol=1e-5)


def _graphs(rng, kind, n=200, e=1500):
    src = rng.integers(0, n, e)
    if kind == "skewed":
        dst = np.where(rng.random(e) < 0.6, 3, rng.integers(0, n, e))
    elif kind == "isolated":
        src, dst = src % 150, rng.integers(0, 150, e)  # nodes 150.. have no edges
    else:
        dst = rng.integers(0, n, e)
    jg = jax_build_graph(src, dst, n, pad_multiple=512).with_layout(nb=64, eb=128).to_device()
    return build_graph(src, dst, n), jg


def _inputs(rng, n, d, heads=1):
    h = rng.normal(size=(n, heads, d)).astype(np.float32)
    a_s = rng.normal(size=(heads, d)).astype(np.float32) * 0.3
    a_d = rng.normal(size=(heads, d)).astype(np.float32) * 0.3
    return h, a_s, a_d


def _v3(h, a_s, a_d, jg, **kw):
    """attention_v3 on D lane-padded to 128, as the JAX dispatch does."""
    d = h.shape[-1]
    pad = 128 - d
    out = attention_v3(jnp.pad(jnp.asarray(h), ((0, 0), (0, 0), (0, pad))),
                       jnp.pad(jnp.asarray(a_s), ((0, 0), (0, pad))),
                       jnp.pad(jnp.asarray(a_d), ((0, 0), (0, pad))), jg, **kw)
    return np.asarray(out)[..., :d]


def _port(h, a_s, a_d, g, **kw):
    out, den = attention_fwd(torch.from_numpy(h), torch.from_numpy(a_s), torch.from_numpy(a_d), g, **kw)
    return out.numpy(), den.numpy()


@pytest.mark.parametrize("kind", ["random", "skewed", "isolated"])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_rows_match_xla_golden_and_v3(rng, kind, d):
    g, jg = _graphs(rng, kind)
    h, a_s, a_d = _inputs(rng, g.n_nodes, d)
    got, den = _port(h, a_s, a_d, g, hs_dtype=torch.float32)
    want = np.asarray(jax_attention(jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d), jg, impl="xla"))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _v3(h, a_s, a_d, jg, hs_dtype=jnp.float32), **TOL)
    # den is the per-destination sum of the (unmasked) numerators
    x = (h[:, 0] @ a_s[0])[g.src.numpy()] + (h[:, 0] @ a_d[0])[g.dst.numpy()]
    num = np.exp(np.clip(np.where(x > 0, x, 0.2 * x), -10, 10))
    np.testing.assert_allclose(den, np.bincount(g.dst.numpy(), num, g.n_nodes), **TOL)
    if kind == "isolated":
        assert np.all(got[150:] == 0) and np.all(den[150:] == 0)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_rows_match_v3_default(rng, d):
    g, jg = _graphs(rng, "skewed")
    h, a_s, a_d = _inputs(rng, g.n_nodes, d)
    got, _ = _port(h, a_s, a_d, g)  # bf16 rows by default, as attention_v3
    want = np.asarray(jax_attention(jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d), jg, impl="pallas"))
    np.testing.assert_allclose(got, want, **TOL)


def test_hash_mask_bit_exact():
    ids = np.concatenate([np.arange(5000), np.array([2**27 - 1, 2**27 + 5, 2**31 - 1])]).astype(np.int32)
    for seed in (0, 1, 12345, 2**31 + 7, 2**32 - 1):
        for rate in (0.1, 0.4, 0.5):
            want = np.asarray(_hash_mask(jnp.uint32(seed), jnp.asarray(ids), rate))
            got = hash_mask(seed, torch.from_numpy(ids), rate).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hs_dtype", ["float32", "bfloat16"])
def test_masked_forward_matches_v3_dropout(rng, hs_dtype):
    g, jg = _graphs(rng, "skewed")
    h, a_s, a_d = _inputs(rng, g.n_nodes, 128)
    key = jax.random.key(11)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    mask = hash_mask(seed, torch.arange(g.n_edges), 0.1)
    assert 0 < int((mask == 0).sum()) < g.n_edges
    got, _ = _port(h, a_s, a_d, g, mask=mask, hs_dtype=getattr(torch, hs_dtype))
    want = _v3(h, a_s, a_d, jg, dropout_rate=0.1, rng=key, hs_dtype=getattr(jnp, hs_dtype))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [1, 2])
def test_dispatch_and_golden_match_jax_xla(rng, heads):
    g, jg = _graphs(rng, "random")
    h, a_s, a_d = _inputs(rng, g.n_nodes, 64, heads)
    want = np.asarray(jax_attention(jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d), jg, impl="xla"))
    th, ts, td = map(torch.from_numpy, (h, a_s, a_d))
    np.testing.assert_allclose(segment_softmax_attention(th, ts, td, g).numpy(), want, **TOL)
    got = segment_softmax_attention_kernel(th, ts, td, g, hs_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_attention_fwd_rejects_bad_shapes(rng):
    g, _ = _graphs(rng, "random")
    h, a_s, a_d = _inputs(rng, g.n_nodes, 48)
    with pytest.raises(ValueError, match="multiple of 32"):
        _port(h, a_s, a_d, g)
    h, a_s, a_d = _inputs(rng, g.n_nodes, 64)
    with pytest.raises(ValueError, match="mask"):
        _port(h, a_s, a_d, g, mask=torch.ones(3))
