"""The port's CUDA kernels against their plain PyTorch versions, on the card:
attention (kernels 1, 2, 3 and the head-packed 8, 9; rows wider than 512 in
column strips), the gather fence (16), top-K (4, 5), the CSR SpMM (7) and
its edge-balanced walk (rows above the piece cap, empty rows, both
directions, the pre-gathered modes of kernels 13 and 15), the kNN
candidates (10, 11), the read-stream probe (6), the smoke's affine pass
(12) and the host time of a launch, the legacy attention contracts (13, 14,
15), and same-seed trainer determinism.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: attention rtol 1e-4 / atol 1e-5 (both sides round the same rows
and sum in f32; only the summation order differs); attention gradients rtol
5e-4 / atol 1e-4 (tests/test_gat_fused.py:53-55: sums over every edge of a
row, with cancellation, in another order); SpMM rtol 1e-4 / atol 1e-5 (the
same rounded rows, f32 sums, another order); scores rtol 1e-5 / atol 1e-4 (f32
dot products of width <= 256, summed in another order); kNN candidate
scores rtol 1e-5 / atol 1e-5 (f32 dot products of unit rows, another order),
their columns equal wherever no tie within 1e-5 straddles a place (kernel 11:
recall >= 0.999 against its plain version; on rows along an arc, where the
survivor buffers overflow on every tile, its untied columns too); two
launches of a kNN kernel give the same bits.
"""
import contextlib

import numpy as np
import pytest
import torch

from plotpointe_tpu_torch.graphs.csr import build_graph
from plotpointe_tpu_torch.ops import cuda_build
from plotpointe_tpu_torch.ops.gat_fused import (
    attention_bwd_dst, attention_bwd_dst_plain, attention_bwd_src, attention_bwd_src_plain,
    attention_fwd, attention_fwd_plain, attention_v3, gather_fence, gather_fence_plain, hash_mask,
    node_terms_plain, reference_versions)
from plotpointe_tpu_torch.ops.segment import segment_softmax_attention
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


@pytest.mark.parametrize("d", [32, 64, 128, 512, 544, 1024])
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


GRAD_TOL = dict(rtol=5e-4, atol=1e-4)


def _attn_inputs(rng, g, d, cuda):
    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=cuda)
    return t(g.n_nodes, 1, d), t(1, d, scale=0.2), t(1, d, scale=0.2), t(g.n_nodes, d)


@pytest.mark.parametrize("d", [32, 64, 128, 512, 544, 1024])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_gat_bwd_kernels_match_plain(cuda, d, hs_dtype, masked):
    rng = np.random.default_rng(d + 1)
    g = _graph(rng).to(cuda)
    h, a_s, a_d, ct = _attn_inputs(rng, g, d, cuda)
    mask = hash_mask(99, torch.arange(g.n_edges), 0.3).to(cuda) if masked else None
    rows, gs, gd = node_terms_plain(h[:, 0], a_s, a_d, hs_dtype)
    out, den = attention_fwd_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    args = (rows, gs, gd, ct, out[:, 0], den, g, mask)
    before = {k: cuda_build.COUNTERS[k].count for k in ("gat_bwd_dst", "gat_bwd_src")}
    got = attention_bwd_dst(*args)
    for name, a, b in zip(("de_sum", "godot", "da_src"), got, attention_bwd_dst_plain(*args)):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)
    args2 = (rows, ct.to(hs_dtype), a_s, gs, gd, den, got[1], g, mask)
    dh = attention_bwd_src(*args2)
    torch.cuda.synchronize()
    torch.testing.assert_close(dh, attention_bwd_src_plain(*args2), **GRAD_TOL)
    assert torch.all(dh[250:] == 0) and torch.all(got[0][250:] == 0)
    assert {k: cuda_build.COUNTERS[k].count - before[k] for k in before} == \
        {"gat_bwd_dst": 1, "gat_bwd_src": 1}


@pytest.mark.parametrize("d", [64, 128, 1024])
def test_attention_v3_grads_match_golden_autograd(cuda, d):
    rng = np.random.default_rng(d)
    g = _graph(rng).to(cuda)
    h, a_s, a_d, ct = _attn_inputs(rng, g, d, cuda)
    got = [x.clone().requires_grad_() for x in (h, a_s, a_d)]
    (attention_v3(*got, g, hs_dtype=torch.float32)[:, 0] * ct).sum().backward()
    want = [x.clone().requires_grad_() for x in (h, a_s, a_d)]
    (segment_softmax_attention(*want, g)[:, 0] * ct).sum().backward()
    for name, a, b in zip(("dh", "da_src", "da_dst"), got, want):
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
def test_attention_v3_kernels_match_plain_with_dropout(cuda, hs_dtype):
    rng = np.random.default_rng(3)
    g = _graph(rng).to(cuda)
    h, a_s, a_d, ct = _attn_inputs(rng, g, 128, cuda)
    grads = []
    for plain in (False, True):
        x = [t.clone().requires_grad_() for t in (h, a_s, a_d)]
        with reference_versions() if plain else contextlib.nullcontext():
            (attention_v3(*x, g, dropout_rate=0.4, seed=2**31 + 5,
                          hs_dtype=hs_dtype)[:, 0] * ct).sum().backward()
        grads.append([t.grad for t in x])
    for name, a, b in zip(("dh", "da_src", "da_dst"), *grads):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("shape", [(8, 128), (300, 64), (1000, 256), (3, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_fence_kernel_matches_plain(cuda, shape, dtype):
    x = torch.as_tensor(np.random.default_rng(7).normal(size=shape).astype(np.float32),
                        device=cuda).to(dtype)
    before = cuda_build.COUNTERS["gather_fence"].count
    got = gather_fence(x)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["gather_fence"].count == before + 1
    torch.testing.assert_close(got, gather_fence_plain(x), rtol=1e-5, atol=1e-5)


def _tiny_dataset(seed=0, n_users=300, n_items=200, n=6000):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, n_users, n), "asin": rng.integers(0, n_items, n),
            "ts": rng.integers(0, 10**9, n), "rating": rng.integers(1, 6, n).astype(np.float64)}


def test_same_seed_fit_is_bit_identical_on_card(cuda):
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.train.trainer import Trainer

    inter = _tiny_dataset()
    s = build_splits(inter, *build_node_maps(inter))
    feats = np.random.default_rng(1).normal(size=(s.n_items, 48)).astype(np.float32)
    runs = []
    for _ in range(2):
        cfg = TrainConfig(epochs=3, samples_per_epoch=20_000, eval_neg_k=100, eval_chunk=128,
                          hidden_dim=64)
        model = GATModel(s.n_users, s.n_items, 48, hidden_dim=64, hs_dtype=torch.bfloat16)
        graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items, weight=s.train_w)
        cuda_build.reset_counters()
        res = Trainer(model, cfg, graph, s, item_feats=feats, device=cuda).fit()
        assert all(cuda_build.COUNTERS[k].count > 0 for k in ("gat_fwd", "gat_bwd_dst", "gat_bwd_src"))
        runs.append(([{k: v for k, v in h.items() if not k.endswith("time_s")} for h in res["history"]],
                     res["test"], {k: v.cpu() for k, v in model.state_dict().items()}))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    for k, v in runs[0][2].items():
        assert torch.equal(v, runs[1][2][k]), k
    assert all(np.isfinite(h["loss"]) for h in runs[0][0])


def test_multihead_attention_on_cuda_launches_kernels_8_and_9(cuda):
    from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel

    rng = np.random.default_rng(0)
    g = _graph(rng).to(cuda)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, 2, 48)).astype(np.float32), device=cuda)
    a = torch.as_tensor(rng.normal(size=(2, 48)).astype(np.float32) * 0.2, device=cuda)
    x = h.clone().requires_grad_()
    cuda_build.reset_counters()
    segment_softmax_attention_kernel(x, a, a, g, dropout_rate=0.1, seed=3).sum().backward()
    torch.cuda.synchronize()
    launched = {k: cuda_build.COUNTERS[k].count for k in ("gat_fwd_mh", "gat_bwd_dst_mh", "gat_bwd_src")}
    assert launched == {"gat_fwd_mh": 1, "gat_bwd_dst_mh": 1, "gat_bwd_src": 2}
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
def test_spmm_kernel_matches_plain_both_directions(cuda, d, rows_dtype):
    """LightGCN's operator: the symmetric normalized values, so each row is
    a weighted mean (hot node 3 sums 1,200 entries) and f32 sums in another
    order stay within the attention band."""
    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights
    from plotpointe_tpu_torch.ops.spmm_kernel import spmm_csr, spmm_csr_plain

    rng = np.random.default_rng(d + 7)
    g = _graph(rng).to(cuda)
    v = torch.as_tensor(symmetric_normalized_weights(g), device=cuda)
    x = torch.as_tensor(rng.normal(size=(g.n_nodes, d)).astype(np.float32), device=cuda)
    before = cuda_build.COUNTERS["spmm_csr"].count
    for ptr, idx, vals in ((g.row_ptr, g.src, v), (g.t_ptr, g.t_dst, v[g.t_eid.long()])):
        got = spmm_csr(x, vals, ptr, idx, rows_dtype)
        torch.testing.assert_close(got, spmm_csr_plain(x, vals, ptr, idx, rows_dtype), rtol=1e-4, atol=1e-5)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["spmm_csr"].count == before + 2
    assert torch.all(spmm_csr(x, v, g.row_ptr, g.src, rows_dtype)[250:] == 0)


def test_make_spmm_grads_match_golden_autograd(cuda):
    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights
    from plotpointe_tpu_torch.ops.segment import spmm as plain_spmm
    from plotpointe_tpu_torch.ops.spmm_kernel import make_spmm

    rng = np.random.default_rng(4)
    g = _graph(rng).to(cuda)
    vals = symmetric_normalized_weights(g)
    x = torch.as_tensor(rng.normal(size=(g.n_nodes, 64)).astype(np.float32), device=cuda)
    ct = torch.as_tensor(rng.normal(size=(g.n_nodes, 64)).astype(np.float32), device=cuda)
    got, want = x.clone().requires_grad_(), x.clone().requires_grad_()
    (make_spmm(g, vals, torch.float32)(got) * ct).sum().backward()
    (plain_spmm(g, torch.as_tensor(vals, device=cuda), want) * ct).sum().backward()
    torch.testing.assert_close(got.grad, want.grad, **GRAD_TOL)


@pytest.mark.parametrize("heads,d", [(2, 64), (2, 128), (4, 128), (2, 512)])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_multihead_kernels_match_plain(cuda, heads, d, hs_dtype, masked):
    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst_mh, attention_bwd_dst_mh_plain, attention_fwd_mh, attention_fwd_mh_plain,
        dropout_mask_mh, node_terms_mh_plain)

    rng = np.random.default_rng(heads * d)
    g = _graph(rng).to(cuda)

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=cuda)

    h, a_s, a_d, ct = t(g.n_nodes, heads, d), t(heads, d, scale=0.2), t(heads, d, scale=0.2), \
        t(g.n_nodes, heads, d)
    mask = dropout_mask_mh(g, 0.3, 77, heads, cuda) if masked else None
    before = {k: cuda_build.COUNTERS[k].count for k in ("gat_fwd_mh", "gat_bwd_dst_mh", "gat_bwd_src")}
    out, den = attention_fwd_mh(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    want_out, want_den = attention_fwd_mh_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(den, want_den, rtol=1e-4, atol=1e-5)
    rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, hs_dtype)
    args = (rows, gs, gd, ct, want_out, want_den, g, mask)
    got = attention_bwd_dst_mh(*args)
    for name, a, b in zip(("de_sum", "godot", "da_src"), got, attention_bwd_dst_mh_plain(*args)):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)
    # B2 on one head's rows of the [N, H, D] tensors, read with a row stride
    gh = ct.to(hs_dtype)
    k = heads - 1
    args2 = (rows[:, k], gh[:, k], a_s[k:k + 1], gs[:, k].contiguous(), gd[:, k].contiguous(),
             want_den[:, k].contiguous(), got[1][:, k].contiguous(), g, None if mask is None else mask[k])
    torch.testing.assert_close(attention_bwd_src(*args2), attention_bwd_src_plain(*args2), **GRAD_TOL)
    torch.cuda.synchronize()
    assert {k: cuda_build.COUNTERS[k].count - before[k] for k in before} == \
        {"gat_fwd_mh": 1, "gat_bwd_dst_mh": 1, "gat_bwd_src": 1}
    assert torch.all(out[250:] == 0)


@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
def test_attention_v3_mh_kernels_match_plain_with_dropout(cuda, hs_dtype):
    from plotpointe_tpu_torch.ops.gat_fused import attention_v3_mh

    rng = np.random.default_rng(5)
    g = _graph(rng).to(cuda)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, 2, 128)).astype(np.float32), device=cuda)
    a_s, a_d = (torch.as_tensor(rng.normal(size=(2, 128)).astype(np.float32) * 0.2, device=cuda)
                for _ in range(2))
    ct = torch.as_tensor(rng.normal(size=(g.n_nodes, 2, 128)).astype(np.float32), device=cuda)
    grads = []
    for plain in (False, True):
        x = [t.clone().requires_grad_() for t in (h, a_s, a_d)]
        with reference_versions() if plain else contextlib.nullcontext():
            (attention_v3_mh(*x, g, dropout_rate=0.3, seed=2**31 + 9, hs_dtype=hs_dtype)
             * ct).sum().backward()
        grads.append([t.grad for t in x])
    for name, a, b in zip(("dh", "da_src", "da_dst"), *grads):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)


def test_same_seed_lightgcn_fit_is_bit_identical_on_card(cuda):
    from plotpointe_tpu_torch.config import TrainConfig
    from plotpointe_tpu_torch.data.splits import build_node_maps, build_splits
    from plotpointe_tpu_torch.graphs.csr import build_bipartite_graph
    from plotpointe_tpu_torch.models.lightgcn import LightGCNModel
    from plotpointe_tpu_torch.train.trainer import Trainer

    inter = _tiny_dataset(seed=2, n=12_000)
    s = build_splits(inter, *build_node_maps(inter))
    runs = []
    for _ in range(2):
        cfg = TrainConfig(model_family="lightgcn", epochs=3, batch_size=1024, neg_per_pos=5,
                          eval_neg_k=100, eval_chunk=128)
        model = LightGCNModel(s.n_users, s.n_items, 64, 3, xs_dtype=torch.bfloat16)
        graph = build_bipartite_graph(s.train_u, s.train_i, s.n_users, s.n_items)
        cuda_build.reset_counters()
        res = Trainer(model, cfg, graph, s, device=cuda).fit()
        assert cuda_build.COUNTERS["spmm_csr"].count > 0
        runs.append(([{k: v for k, v in h.items() if not k.endswith("time_s")} for h in res["history"]],
                     res["test"], {k: v.cpu() for k, v in model.state_dict().items()}))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    for k, v in runs[0][2].items():
        assert torch.equal(v, runs[1][2][k]), k
    assert all(np.isfinite(h["loss"]) for h in runs[0][0])


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


def _knn_rows(cuda, n, d, seed):
    """Rows clustered around n // 30 centres (within-cluster cosine near
    0.7), 5% of them copies of others (exact ties) and one zero row."""
    from plotpointe_tpu_torch.graphs.knn import l2_normalize

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(max(1, n // 30), d))[rng.integers(0, max(1, n // 30), n)]
    x = (x + 0.65 * rng.normal(size=(n, d))).astype(np.float32)
    src, dst = rng.choice(n, size=(2, max(1, n // 20)), replace=False)
    x[dst] = x[src]
    x[n // 2] = 0.0
    return l2_normalize(torch.as_tensor(x, device=cuda))


def _untied_mismatches(got_i, want_i, want_s, r, tol=1e-5):
    """Candidate columns that differ where no tie within tol straddles the
    place (want lists one more candidate than got, to show the tie past the
    last place)."""
    gap = (want_s[:, :-1] - want_s[:, 1:]).abs() <= tol
    tied = gap.clone()
    tied[:, 1:] |= gap[:, :-1]
    return int(((got_i != want_i[:, :r]) & ~tied).sum())


@pytest.mark.parametrize("n,d", [(300, 64), (1037, 128), (777, 384), (130, 16)])
def test_knn_exact_kernel_matches_plain(cuda, n, d):
    from plotpointe_tpu_torch.ops.knn_kernel import knn_candidates, knn_candidates_plain

    xn = _knn_rows(cuda, n, d, n + d)
    for r in (28, 9, 128):
        before = cuda_build.COUNTERS["knn_topk"].count
        got_i, got_s = knn_candidates(xn, r)
        torch.cuda.synchronize()
        assert cuda_build.COUNTERS["knn_topk"].count == before + 1
        want_i, want_s = knn_candidates_plain(xn, r + 1)
        torch.testing.assert_close(got_s, want_s[:, :r], rtol=1e-5, atol=1e-5)
        assert _untied_mismatches(got_i, want_i, want_s, r) == 0
        assert not (got_i == torch.arange(n, device=cuda)[:, None]).any()
        assert ((got_i >= -1) & (got_i < n)).all()
        assert (got_s.diff(dim=1) <= 0).all()
        real = got_i >= 0
        assert (got_s[~real] == -1e30).all() and int(real.sum(1).min()) == min(r, n - 1)


@pytest.mark.parametrize("n,d", [(300, 64), (1037, 128), (777, 384), (130, 16)])
def test_knn_fast_kernel_matches_plain(cuda, n, d):
    from plotpointe_tpu_torch.ops.knn_kernel import knn_candidates_fast, knn_candidates_fast_plain

    xn = _knn_rows(cuda, n, d, n + d + 1)
    before = cuda_build.COUNTERS["knn_topk_fast"].count
    got_i, got_s = knn_candidates_fast(xn, 29)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["knn_topk_fast"].count == before + 1
    want_i, want_s = knn_candidates_fast_plain(xn, 29)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
    hits = sum(len(set(a) & set(b)) for a, b in zip(got_i.tolist(), want_i.tolist()))
    assert hits / want_i.numel() >= 0.999
    assert not (got_i == torch.arange(n, device=cuda)[:, None]).any()
    assert (got_s.diff(dim=1) <= 0).all()


def _arc_rows(cuda, n, d, seed):
    """Unit rows on half a great circle in the order of their angle (a random
    plane of R^d): for the last rows every column tile ranks above their
    whole list so far, so their survivor buffers overflow on every tile."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, 2)))
    theta = np.linspace(0.0, np.pi, n, endpoint=False)
    x = (np.stack([np.cos(theta), np.sin(theta)], 1) @ q.T).astype(np.float32)
    return torch.as_tensor(x, device=cuda)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("r", [28, 128])
def test_knn_kernels_match_plain_when_every_tile_overflows(cuda, mode, r):
    from plotpointe_tpu_torch.ops.knn_kernel import (
        knn_candidates, knn_candidates_fast, knn_candidates_fast_plain, knn_candidates_plain)

    kernel, plain = ((knn_candidates, knn_candidates_plain) if mode == "exact"
                     else (knn_candidates_fast, knn_candidates_fast_plain))
    n = 1037
    xn = _arc_rows(cuda, n, 64, 3)
    got_i, got_s = kernel(xn, r)
    want_i, want_s = plain(xn, r + 1)
    torch.testing.assert_close(got_s, want_s[:, :r], rtol=1e-5, atol=1e-5)
    assert _untied_mismatches(got_i, want_i, want_s, r) == 0
    if mode == "exact":  # the last row's list: its r nearest predecessors
        assert set(got_i[-1].tolist()) == set(range(n - 1 - r, n - 1))


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("rows", ["clusters", "arc"])
def test_knn_kernels_give_the_same_bits_twice(cuda, mode, rows):
    from plotpointe_tpu_torch.ops.knn_kernel import knn_candidates, knn_candidates_fast

    kernel = knn_candidates if mode == "exact" else knn_candidates_fast
    xn = _knn_rows(cuda, 1037, 128, 9) if rows == "clusters" else _arc_rows(cuda, 1037, 128, 9)
    for r in (29, 128):
        a_i, a_s = kernel(xn, r)
        b_i, b_s = kernel(xn, r)
        assert torch.equal(a_i, b_i)
        assert torch.equal(a_s.view(torch.int32), b_s.view(torch.int32))


def test_knn_fast_recall_against_exact(cuda):
    from plotpointe_tpu_torch.ops.knn_kernel import knn_topk

    xn = _knn_rows(cuda, 6000, 384, 11)
    ei, es = knn_topk(xn, 20)
    fi, fs = knn_topk(xn, 20, mode="fast")
    hits = sum(len(set(a) & set(b)) for a, b in zip(ei.tolist(), fi.tolist()))
    assert hits / ei.numel() >= 0.995
    exact = (xn[fi.long()] * xn[:, None, :]).sum(-1)
    torch.testing.assert_close(fs, exact, rtol=1e-5, atol=1e-5)


def test_cosine_knn_graph_on_card_matches_cpu(cuda, tmp_path):
    from plotpointe_tpu_torch.graphs.knn import cosine_knn_graph

    x = _knn_rows(cuda, 2000, 128, 5).cpu().numpy() * 3.0
    cuda_build.reset_counters()
    (gr, gc, gd), gstats = cosine_knn_graph(x, out_prefix=str(tmp_path), feature_name="fused",
                                            k=10, min_similarity=0.3)
    assert cuda_build.COUNTERS["knn_topk"].count == 1
    (cr, cc, cd), cstats = cosine_knn_graph(x, k=10, min_similarity=0.3, device="cpu")
    near = np.abs(cd - 0.3) <= 1e-5
    assert abs(len(gd) - len(cd)) <= int(near.sum())
    got = dict(zip(zip(gr.tolist(), gc.tolist()), gd.tolist()))
    want = dict(zip(zip(cr.tolist(), cc.tolist()), cd.tolist()))
    shared = got.keys() & want.keys()
    assert len(shared) >= 0.995 * len(want)  # the CPU's xla path breaks ties either way
    assert max(abs(got[e] - want[e]) for e in shared) <= 1e-5
    assert (tmp_path / "ii_edges_fused.npz").exists() and gstats.keys() == cstats.keys()


def test_knn_rejects_k_above_128_on_card(cuda):
    from plotpointe_tpu_torch.ops.knn_kernel import knn_topk

    with pytest.raises(ValueError):
        knn_topk(torch.zeros((300, 16), device=cuda), 129)


# -- the last five TPU kernels: 6, 12 (tooling), 13, 14, 15 (legacy attention) --


@pytest.mark.parametrize("m,d,bm", [(512, 256, 64), (4096, 4096, 512), (1024, 384, 8)])
def test_stream_probe_kernel_matches_plain(cuda, m, d, bm):
    from plotpointe_tpu_torch.utils.profiling import stream_probe, stream_probe_plain

    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32), device=cuda).to(torch.bfloat16)
    before = cuda_build.COUNTERS["stream_probe"].count
    got = stream_probe(x, bm=bm, c=0.25)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["stream_probe"].count == before + 1
    assert torch.equal(got, stream_probe_plain(x, bm, 0.25))  # max is exact


@pytest.mark.parametrize("shape", [(256, 128), (3, 5), (1, 1), (1000, 1001)])
def test_smoke_affine_kernel_matches_plain(cuda, shape):
    from plotpointe_tpu_torch.ops.elementwise import affine, affine_plain

    x = torch.as_tensor(np.random.default_rng(0).normal(size=shape).astype(np.float32) * 1e3,
                        device=cuda)
    before = cuda_build.COUNTERS["smoke_affine"].count
    got = affine(x)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["smoke_affine"].count == before + 1
    assert torch.equal(got, affine_plain(x))  # x * 2 is exact: one rounding on both sides


def test_run_smoke_on_card(cuda):
    from plotpointe_tpu_torch.tools.smoke_gpu import run_smoke

    report = run_smoke()
    assert report["ok"], report


@pytest.mark.parametrize("width", [32, 64, 128, 200, 512, 1100])
def test_legacy_reduces_match_plain(cuda, width):
    """Kernel 13 (weights) and 15 (unit weights) over pre-gathered rows, in
    column strips of <= 512 above 512, padded to a multiple of 32 below. The
    weights sum to 1 over each destination, as alpha does (node 3's 1,200
    rows of N(0, 1) summed with weights of order 1 would cancel below the
    band's atol)."""
    from plotpointe_tpu_torch.ops.gat_fused import segment_sum_rows, segment_sum_rows_plain
    from plotpointe_tpu_torch.ops.gat_kernel import fused_segment_reduce, fused_segment_reduce_plain

    rng = np.random.default_rng(width)
    g = _graph(rng).to(cuda)
    u = rng.random(g.n_edges)
    dst = g.dst.cpu().numpy()
    w = torch.as_tensor((u / np.bincount(dst, u)[dst]).astype(np.float32), device=cuda)
    hs = torch.as_tensor(rng.normal(size=(g.n_edges, width)).astype(np.float32), device=cuda)
    strips = -(-width // 512)
    before = {k: cuda_build.COUNTERS[k].count for k in ("fused_segment_reduce", "onehot_reduce", "spmm_csr")}
    scaled = hs * w[:, None]
    got13, got15 = fused_segment_reduce(w, hs, g), segment_sum_rows(scaled, g)
    torch.cuda.synchronize()
    after = {k: cuda_build.COUNTERS[k].count for k in before}
    assert after == {"fused_segment_reduce": before["fused_segment_reduce"] + strips,
                     "onehot_reduce": before["onehot_reduce"] + strips, "spmm_csr": before["spmm_csr"]}
    torch.testing.assert_close(got13, fused_segment_reduce_plain(w, hs, g), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got15, segment_sum_rows_plain(scaled, g), rtol=1e-4, atol=1e-5)
    assert torch.all(got13[250:] == 0) and torch.all(got15[250:] == 0)


@pytest.mark.parametrize("d", [128, 256, 512, 1024])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_layer_kernel_matches_plain(cuda, d, masked):
    from plotpointe_tpu_torch.ops.gat_kernel import fused_layer, fused_layer_plain, legacy_mask

    rng = np.random.default_rng(d)
    g = _graph(rng).to(cuda)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, 1, d)).astype(np.float32), device=cuda)
    a_s, a_d = (torch.as_tensor(rng.normal(size=(1, d)).astype(np.float32) * 0.2, device=cuda)
                for _ in range(2))
    mask = legacy_mask(g, 1, 0.3, 7, cuda)[:, 0].contiguous() if masked else None
    before = {k: cuda_build.COUNTERS[k].count for k in ("fused_layer", "gat_fwd")}
    got = fused_layer(h, a_s, a_d, g, mask)
    torch.cuda.synchronize()
    assert {k: cuda_build.COUNTERS[k].count for k in before} == {
        "fused_layer": before["fused_layer"] + 1, "gat_fwd": before["gat_fwd"]}
    torch.testing.assert_close(got, fused_layer_plain(h, a_s, a_d, g, mask), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("heads,d", [(1, 128), (1, 64), (2, 64)])
def test_legacy_dispatch_on_card_matches_reference_versions(cuda, heads, d):
    """v2 / v1 through the dispatch on a tiled graph with dropout: output
    and gradients with the kernels vs inside `reference_versions()`."""
    from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel

    rng = np.random.default_rng(heads * d)
    g = _graph(rng).with_tiling().to(cuda)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, heads, d)).astype(np.float32), device=cuda)
    a_s, a_d = (torch.as_tensor(rng.normal(size=(heads, d)).astype(np.float32) * 0.2, device=cuda)
                for _ in range(2))
    ct = torch.as_tensor(rng.normal(size=(g.n_nodes, heads, d)).astype(np.float32), device=cuda)
    name = "fused_layer" if d == 128 else ("fused_segment_reduce" if heads == 1 else "onehot_reduce")
    res = []
    for plain in (False, True):
        x = [t.clone().requires_grad_() for t in (h, a_s, a_d)]
        before = cuda_build.COUNTERS[name].count
        with reference_versions() if plain else contextlib.nullcontext():
            out = segment_softmax_attention_kernel(*x, g, dropout_rate=0.1, seed=11)
            (out * ct).sum().backward()
        torch.cuda.synchronize()
        assert cuda_build.COUNTERS[name].count == before + (0 if plain else 1)
        res.append((out.detach(), [t.grad for t in x]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-4, atol=1e-5)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_wide_multihead_runs_one_pass_per_head_on_card(cuda):
    """4 heads of D 512 (above the packed kernels' width): one `attention_v3`
    pass per head, kernel 1 launched 4 times and kernel 8 not at all."""
    from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel

    rng = np.random.default_rng(3)
    g = _graph(rng).to(cuda)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, 4, 512)).astype(np.float32), device=cuda)
    a_s, a_d = (torch.as_tensor(rng.normal(size=(4, 512)).astype(np.float32) * 0.05, device=cuda)
                for _ in range(2))
    before = {k: cuda_build.COUNTERS[k].count for k in ("gat_fwd", "gat_fwd_mh")}
    got = segment_softmax_attention_kernel(h, a_s, a_d, g, dropout_rate=0.2, seed=5)
    torch.cuda.synchronize()
    assert {k: cuda_build.COUNTERS[k].count - before[k] for k in before} == {"gat_fwd": 4, "gat_fwd_mh": 0}
    with reference_versions():
        want = segment_softmax_attention_kernel(h, a_s, a_d, g, dropout_rate=0.2, seed=5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# -- the edge-balanced row walk of csrc/spmm_csr.cu (kernels 7, 13, 15) --------


def _skewed_graph(rng, n=3000):
    """Node 0 takes 10,000 in-edges (above any piece cap) and node 9 sends
    3,000 (a hot row of the transpose CSR); nodes 1..6 touch no edge (a run
    of empty rows in both directions); node 8 has one in-edge; the rest
    have lognormal in-degrees."""
    deg = np.minimum(rng.lognormal(1.5, 1.3, n - 10).astype(int), 400)
    dst = np.concatenate([np.zeros(10_000, int), rng.integers(10, n, 3000), [8],
                          np.repeat(np.arange(10, n), deg)])
    src = np.concatenate([rng.integers(10, n, 10_000), np.full(3000, 9), [10],
                          rng.integers(10, n, deg.sum())])
    return build_graph(src, dst, n)


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256, 512])
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
def test_spmm_walk_on_rows_above_the_cap_matches_plain(cuda, d, rows_dtype):
    """Kernel 7 in both directions over rows of 10,000 and 3,000 entries,
    empty rows and a one-entry row: rtol 1e-4 / atol 1e-5 against the plain
    reduce, one count per call, the same bits on a second call. Each
    direction's values sum to 1 over each of its rows, so every row is a
    weighted mean of N(0, 1) rows: with unnormalized values the 3,000-entry
    row sums to ~10 with cancellation, where the plain version's own f32
    error (its atomics) passes the band's atol."""
    from plotpointe_tpu_torch.ops.spmm_kernel import spmm_csr, spmm_csr_plain

    rng = np.random.default_rng(d)
    g = _skewed_graph(rng).to(cuda)
    x = torch.as_tensor(rng.normal(size=(g.n_nodes, d)).astype(np.float32), device=cuda)

    def row_normalized(ptr):
        lens = (ptr[1:] - ptr[:-1]).cpu().numpy()
        u = rng.random(int(lens.sum()))
        row = np.repeat(np.arange(len(lens)), lens)
        return torch.as_tensor((u / np.bincount(row, u, len(lens))[row]).astype(np.float32), device=cuda)

    for ptr, idx in ((g.row_ptr, g.src), (g.t_ptr, g.t_dst)):
        vals = row_normalized(ptr)
        before = cuda_build.COUNTERS["spmm_csr"].count
        got = spmm_csr(x, vals, ptr, idx, rows_dtype)
        again = spmm_csr(x, vals, ptr, idx, rows_dtype)
        torch.cuda.synchronize()
        assert cuda_build.COUNTERS["spmm_csr"].count == before + 2
        torch.testing.assert_close(got, spmm_csr_plain(x, vals, ptr, idx, rows_dtype), rtol=1e-4, atol=1e-5)
        assert torch.equal(got, again)
        assert torch.all(got[1:7] == 0)


@pytest.mark.parametrize("width", [64, 256, 1100])
def test_spmm_pregathered_walk_on_rows_above_the_cap_matches_plain(cuda, width):
    """Kernels 13 (weights) and 15 (unit weights) over pre-gathered rows of
    the skewed graph: column strips of <= 512 read with the row stride of
    the padded array (1,100 -> 1,120: three strips), null values in kernel
    15; the same bits on a second call."""
    from plotpointe_tpu_torch.ops.gat_fused import segment_sum_rows, segment_sum_rows_plain
    from plotpointe_tpu_torch.ops.gat_kernel import fused_segment_reduce, fused_segment_reduce_plain

    rng = np.random.default_rng(width)
    g = _skewed_graph(rng).to(cuda)
    u = rng.random(g.n_edges)
    dst = g.dst.cpu().numpy()
    w = torch.as_tensor((u / np.bincount(dst, u)[dst]).astype(np.float32), device=cuda)
    hs = torch.as_tensor(rng.normal(size=(g.n_edges, width)).astype(np.float32), device=cuda)
    scaled = hs * w[:, None]
    got13, got15 = fused_segment_reduce(w, hs, g), segment_sum_rows(scaled, g)
    torch.testing.assert_close(got13, fused_segment_reduce_plain(w, hs, g), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got15, segment_sum_rows_plain(scaled, g), rtol=1e-4, atol=1e-5)
    assert torch.equal(got13, fused_segment_reduce(w, hs, g))
    assert torch.equal(got15, segment_sum_rows(scaled, g))
    assert torch.all(got13[1:7] == 0) and torch.all(got15[1:7] == 0)


def test_host_us_per_launch_is_finite(cuda):
    """chip_smoke.py's `host_us_per_launch` line, on the kernel 12 wrapper."""
    import importlib.util
    from pathlib import Path

    from plotpointe_tpu_torch.ops.elementwise import affine

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    x = torch.randn((256, 128), device=cuda)
    us = chip_smoke.host_us_per_launch(lambda: affine(x), calls=50, warmup=5)
    assert np.isfinite(us) and us > 0
