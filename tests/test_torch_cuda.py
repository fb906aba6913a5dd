"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: attention rtol 1e-4 / atol 1e-5 (both sides round the same rows
and sum in f32; only the summation order differs); scores rtol 1e-5 /
atol 1e-4 (f32 dot products of width <= 256, summed in another order).
"""
import numpy as np
import pytest
import torch

from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops import cuda_build
from plotpointe_tpu_torch.ops.gat_fused import attention_fwd, attention_fwd_plain, hash_mask
from plotpointe_tpu_torch.ops.topk_kernel import (
    chunk_max, chunk_max_plain, n_chunks_of, rescore, rescore_plain, topk_mips, topk_mips_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(rng, n=300, e=3000):
    # a hot destination (node 3), isolated nodes (no edges touch 250..299)
    src = rng.integers(0, 250, e)
    dst = np.where(rng.random(e) < 0.4, 3, rng.integers(0, 250, e))
    return build_graph(src, dst, n)


@pytest.mark.parametrize("d", [32, 64, 128, 512])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_gat_fwd_kernel_matches_plain(cuda, d, hs_dtype, masked):
    rng = np.random.default_rng(d)
    g = _graph(rng).to(cuda)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, 1, d)).astype(np.float32), device=cuda)
    a_s = torch.as_tensor(rng.normal(size=(1, d)).astype(np.float32) * 0.2, device=cuda)
    a_d = torch.as_tensor(rng.normal(size=(1, d)).astype(np.float32) * 0.2, device=cuda)
    mask = hash_mask(1234, torch.arange(g.n_edges), 0.1).to(cuda) if masked else None
    before = cuda_build.COUNTERS["gat_fwd"].count
    out, den = attention_fwd(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["gat_fwd"].count == before + 1
    want_out, want_den = attention_fwd_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(den, want_den, rtol=1e-4, atol=1e-5)
    assert torch.all(out[250:] == 0)


def test_multihead_attention_on_cuda_raises(cuda):
    from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel

    g = _graph(np.random.default_rng(0)).to(cuda)
    h = torch.zeros((g.n_nodes, 2, 64), device=cuda)
    a = torch.zeros((2, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="later slice"):
        segment_softmax_attention_kernel(h, a, a, g)


def test_gat_fwd_rejects_unsupported_width(cuda):
    g = _graph(np.random.default_rng(0)).to(cuda)
    h = torch.zeros((g.n_nodes, 1, 48), device=cuda)
    a = torch.zeros((1, 48), device=cuda)
    with pytest.raises(ValueError):
        attention_fwd(h, a, a, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b,d", [(1037, 1, 32), (5000, 8, 128), (2000, 20, 64), (3000, 64, 128),
                                   (700, 100, 256)])
def test_topk_kernels_match_plain(cuda, dtype, n, b, d):
    rng = np.random.default_rng(n + b)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda).to(dtype)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=cuda).to(dtype)
    cm = chunk_max(x, q)
    torch.testing.assert_close(cm, chunk_max_plain(x, q), rtol=1e-5, atol=1e-4)
    cid = torch.as_tensor(rng.integers(0, n_chunks_of(n), size=(b, 11)).astype(np.int32), device=cuda)
    cid[:, 0] = n_chunks_of(n) - 1  # the tail chunk, partly past N
    sc = rescore(x, q, cid)
    torch.testing.assert_close(sc, rescore_plain(x, q, cid), rtol=1e-5, atol=1e-4)
    # the chunk max is exactly the max of that chunk's phase-2 scores
    full = rescore(x, q, torch.arange(n_chunks_of(n), device=cuda, dtype=torch.int32).repeat(b, 1))
    assert torch.equal(full.amax(dim=2), cm)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_topk_mips_on_card_matches_reference(cuda, mode):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(20_000, 64)).astype(np.float32), device=cuda)
    q = torch.as_tensor(rng.normal(size=(16, 64)).astype(np.float32), device=cuda)
    gi, gv = topk_mips(x, q, 20, mode=mode)
    wi, wv = topk_mips_ref(x, q, 20)
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-4)
    got = torch.gather(q @ x.T, 1, gi.long())
    torch.testing.assert_close(got, wv, rtol=1e-5, atol=1e-4)


def test_chunkmax_rejects_width_over_shared_memory(cuda):
    x = torch.zeros((256, 1024), device=cuda)  # a 64-query slab of 1024 f32 is 256 KB
    with pytest.raises(ValueError):
        chunk_max(x, torch.zeros((4, 1024), device=cuda))
    with pytest.raises(ValueError):  # bf16 rows are read 8 values at a time
        chunk_max(torch.zeros((256, 36), device=cuda).bfloat16(), torch.zeros((4, 36), device=cuda).bfloat16())
