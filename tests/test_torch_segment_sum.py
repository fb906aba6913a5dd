"""`ops/segment.segment_sum` and `weighted_degree` against the JAX package's
on seeded numpy inputs, f32, rtol 1e-6 / atol 1e-6 (the same terms summed
in another order): unsorted and sorted ids, ids outside [0, n) (dropped by
both), empty segments, rows of width 1 and [E] vectors, and the edge
weights of a graph built by each package from the same edges. Then
`resolve_attn_impl` against the JAX package's on the CPU backend, its
answer on a CUDA device (shown without a card), and the row types
`ops/gat_kernel.resolve_hs_dtype` derives from it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotpointe_tpu.graphs.csr import build_graph as jax_graph
from plotpointe_tpu.ops.segment import resolve_attn_impl as jax_resolve_attn_impl
from plotpointe_tpu.ops.segment import segment_sum as jax_segment_sum
from plotpointe_tpu.ops.segment import weighted_degree as jax_weighted_degree
from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops import segment_sum
from plotpointe_tpu_torch.ops.gat_kernel import resolve_hs_dtype
from plotpointe_tpu_torch.ops.segment import resolve_attn_impl, weighted_degree

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(3000,), (3000, 1), (3000, 16)])
@pytest.mark.parametrize("ids", ["unsorted", "sorted", "out_of_range", "empty"])
def test_segment_sum_matches_jax(rng, shape, ids):
    """The JAX package's `segment_sum` asserts sorted ids; unsorted ones go
    through `jax.ops.segment_sum` without that promise."""
    n = 200
    data = rng.normal(size=shape).astype(np.float32)
    seg = rng.integers(0, n // 2, shape[0]) * 2  # odd segments stay empty
    if ids == "sorted":
        seg = np.sort(seg)
    elif ids == "out_of_range":
        seg = rng.integers(-5, n + 5, shape[0])
    elif ids == "empty":
        data, seg = data[:0], seg[:0]
    if ids == "sorted":
        want = np.asarray(jax_segment_sum(jnp.asarray(data), jnp.asarray(seg), n))
    else:
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg), num_segments=n))
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(seg), n)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_weighted_degree_matches_jax(rng):
    n, e = 500, 6000
    src, dst = rng.integers(0, n, e), np.where(rng.random(e) < 0.3, 11, rng.integers(0, n - 50, e))
    w = rng.random(e).astype(np.float32)
    g, jg = build_graph(src, dst, n, weight=w), jax_graph(src, dst, n, weight=w)
    vals = jnp.asarray(np.asarray(jg.weight))  # [E_pad]: the padding edges land in the sentinel node
    want = np.asarray(jax_weighted_degree(jg, vals))
    np.testing.assert_allclose(weighted_degree(g, g.weight).numpy(), want, **TOL)
    assert want.shape == (n,) and (want[n - 50:] == 0).all()


def test_segment_sum_gradient_is_a_gather(rng):
    data = torch.tensor(rng.normal(size=(400, 8)).astype(np.float32), requires_grad=True)
    seg = torch.from_numpy(rng.integers(-2, 60, 400))
    g = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    (segment_sum(data, seg, 50) * g).sum().backward()
    keep = (seg >= 0) & (seg < 50)
    want = torch.zeros_like(data)
    want[keep] = g[seg[keep]]
    torch.testing.assert_close(data.grad, want, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas", "interpret"])
def test_resolve_attn_impl_matches_jax_on_the_cpu(impl):
    """JAX's answer on its CPU backend; a value other than "auto" comes back
    unchanged in both packages, unknown ones included."""
    assert jax.default_backend() == "cpu"
    want = jax_resolve_attn_impl(impl)
    assert resolve_attn_impl(impl, "cpu") == resolve_attn_impl(impl, torch.device("cpu")) == want
    assert want == ("xla" if impl == "auto" else impl)


@pytest.mark.parametrize("device", [torch.device("cuda"), "cuda:0", None])
def test_resolve_attn_impl_takes_the_kernel_on_cuda(device):
    """A CUDA device (or none: the port's default device is the card) takes
    the kernel path for "auto"; no card is needed to resolve the name."""
    assert resolve_attn_impl("auto", device) == "pallas"
    assert resolve_attn_impl("xla", device) == "xla"
    assert resolve_attn_impl("pallas", device) == "pallas"


@pytest.mark.parametrize("impl,device,want", [
    ("pallas", "cpu", torch.bfloat16), ("pallas", "cuda", torch.bfloat16), ("auto", "cuda", torch.bfloat16),
    ("auto", "cpu", torch.float32), ("xla", "cpu", torch.float32), ("xla", "cuda", torch.float32)])
def test_resolve_hs_dtype_follows_resolve_attn_impl(impl, device, want):
    assert resolve_hs_dtype(impl, torch.device(device)) == want
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_hs_dtype("interpret", torch.device(device))
