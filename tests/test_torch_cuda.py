"""The port's CUDA kernels against their plain PyTorch versions, on the card:
attention (kernels 1, 2, 3 and the head-packed 8, 9; rows wider than 512 in
column strips), the gather fence (16), top-K (4, 5 and the select kernel
between them, bit-equal to its plain version; `topk_mips` as four launches),
the CSR SpMM (7) and
its edge-balanced walk (rows above the piece cap, empty rows, both
directions, the pre-gathered modes of kernels 13 and 15), the kNN
candidates (10, 11), the read-stream probe (6), the smoke's affine pass
(12) and the host time of a launch, the legacy attention contracts (13, 14,
15), same-seed trainer determinism, and the edge-balanced walk of kernels
1, 8, 3, 2 and 9 (rows of 10,000 and 3,000 entries and a star's, rows
ending at a piece boundary, 1 to 8 heads, D 96 on idle tail lanes, strided
head rows, column strips in kernels 1, 3 and 2, equal bits on a second
call, misaligned rows raising); in plain PyTorch ops, the MiniLM and
CLIP towers (f32 with TF32 off, and bf16) and one fusion step's gradients
against the CPU; `ops.segment_sum`'s equal bits on a second call; and
sharded training (`-k sharded`): kernels 1, 2, 3, 8,
9 and 7 on shards' local graphs against their plain versions and their
owned rows against the unsharded output, and one spawned NCCL rank's fused
step against the unsharded model's autograd.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: attention rtol 1e-4 / atol 1e-5 (both sides round the same rows
and sum in f32; only the summation order differs); attention gradients rtol
5e-4 / atol 1e-4 (tests/test_gat_fused.py:53-55: sums over every edge of a
row, with cancellation, in another order), and for B1's d a_src, a sum over
every edge, that band plus a bound of f32 summation error against an f64
reference (`_hold_b1`); SpMM rtol 1e-4 / atol 1e-5 (the
same rounded rows, f32 sums, another order); scores rtol 1e-5 / atol 1e-4 (SCORE_TOL:
f32 dot products of width <= 1,024, summed in another order; the chunk max
on the tensor cores, 3xTF32 or bf16, against f32 FMAs), top-K indices equal
wherever no tie within twice that band straddles a place; kNN candidate
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
    CHUNK, NEG_INF, chunk_max, chunk_max_plain, n_chunks_of, rescore, rescore_plain, select_chunks,
    select_chunks_plain, select_items, select_items_plain, topk_mips, topk_mips_ref, untied)

pytestmark = pytest.mark.cuda
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)


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


def _b1_f64(rows, gs, gd, g, out, den, graph, mask):
    """B1's d a_src [H, D] in f64 from the same inputs (rows [N, H, D] at
    the row type, gs/gd/den [N, H], g/out [N, H, D], mask [H, E] or None)
    and sum_e |de_e * hs_s| [H, D]. The clamp's inside test is taken on the
    f32 logits, as both f32 versions take it; every other product and sum
    is f64."""
    src, dst = graph.src.long(), graph.dst.long()
    ref, mag = [], []
    for k in range(rows.shape[1]):
        x = gs[src, k] + gd[dst, k]
        lx = torch.where(x > 0, x, 0.2 * x)
        inside = ((lx > -10) & (lx < 10)).double()
        xd = x.double()
        lxd = torch.where(xd > 0, xd, 0.2 * xd)
        deriv = torch.exp(lxd.clamp(-10, 10)) * inside * torch.where(xd > 0, 1.0, 0.2)
        hs, gk = rows[:, k].double()[src], g[:, k].double()
        ghs = (gk[dst] * hs).sum(1)
        godot = (gk * out[:, k].double()).sum(1)
        m = 1.0 if mask is None else mask[k].double()
        term = (((m * ghs - godot[dst]) / (den[:, k].double()[dst] + 1e-9)) * deriv)[:, None] * hs
        ref.append(term.sum(0))
        mag.append(term.abs().sum(0))
    return torch.stack(ref), torch.stack(mag)


def _b1_sum_depth(graph):
    """The most f32 roundings a term of the kernel's d a_src passes: at most
    UNIT + CAP - 1 additions in its lane's run over its unit (a unit holds
    at most UNIT + CAP entries; each step one FMA), WALK_UNITS - 1 in its
    block's sum of the group rows and n_blocks - 1 in the wrapper's sum of
    the block rows. Recursive summation errs by at most that many times
    2**-24 * sum |term| (first order)."""
    from plotpointe_tpu_torch.ops.spmm_kernel import CAP, UNIT, WALK_UNITS, piece_plan

    n_units = piece_plan(graph.row_ptr.cpu()).n_units
    return UNIT + CAP + WALK_UNITS + -(-n_units // WALK_UNITS)


def _assert_da_src(got, ref, mag, depth, what):
    """|got - ref| <= GRAD_TOL + depth * 2**-24 * sum_e |de_e * hs_s|: d a_src
    sums every edge with cancellation, so the relative band alone is narrower
    than f32 summation error where a column's sum is near 0."""
    band = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * ref.abs() + depth * 2.0 ** -24 * mag
    err = (got.double() - ref).abs()
    assert bool((err <= band).all()), f"{what}: worst |err| - band {float((err - band).max())}"


def _hold_b1(got, want, args):
    """Kernel 2 or 9 (`got`) and its f32 plain version (`want`): de_sum and
    godot within GRAD_TOL of each other; d a_src of both against the f64
    reference, the kernel within its order's depth (`_b1_sum_depth`), the
    plain version within E (PyTorch's sum over the E rows, in an order
    unknown here: at most E - 1 additions, plus the product's rounding)."""
    graph = args[6]
    for name, a, b in zip(("de_sum", "godot"), got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL, msg=name)
    rows, gs, gd, g, out, den = args[:6]
    if rows.dim() == 2:  # one head: [N, D] rows, [N] tables, mask [E]
        rows, g, out = rows[:, None], g[:, None], out[:, None]
        gs, gd, den = gs[:, None], gd[:, None], den[:, None]
    mask = args[7] if args[7] is None or args[7].dim() == 2 else args[7][None]
    ref, mag = _b1_f64(rows, gs, gd, g, out, den, graph, mask)
    _assert_da_src(got[2], ref, mag, _b1_sum_depth(graph), "kernel d a_src")
    _assert_da_src(want[2], ref, mag, graph.n_edges, "plain d a_src")


@pytest.mark.parametrize("d", [32, 64, 128, 512, 544, 1024])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_gat_bwd_kernels_match_plain(cuda, d, hs_dtype, masked):
    """B1 and B2 on inputs that are the same on every run: the node terms
    and the forward's out and den come from the plain versions on the CPU
    (not from `index_add_`'s float atomics on the card). de_sum, godot and
    dh within GRAD_TOL of the plain versions; d a_src against f64
    (`_hold_b1`)."""
    rng = np.random.default_rng(d + 1)
    g = _graph(rng)
    h, a_s, a_d, ct = _attn_inputs(rng, g, d, "cpu")
    mask = hash_mask(99, torch.arange(g.n_edges), 0.3) if masked else None
    rows, gs, gd = node_terms_plain(h[:, 0], a_s, a_d, hs_dtype)
    out, den = attention_fwd_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    g, a_s, ct = g.to(cuda), a_s.to(cuda), ct.to(cuda)
    rows, gs, gd, out, den = (t.to(cuda) for t in (rows, gs, gd, out[:, 0], den))
    mask = None if mask is None else mask.to(cuda)
    args = (rows, gs, gd, ct, out, den, g, mask)
    before = {k: cuda_build.COUNTERS[k].count for k in ("gat_bwd_dst", "gat_bwd_src")}
    got = attention_bwd_dst(*args)
    _hold_b1(got, attention_bwd_dst_plain(*args), args)
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
    # kernel 9's inputs from the walk forward (the same bits on every run,
    # unlike the plain forward's float atomics on the card)
    rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, hs_dtype)
    args = (rows, gs, gd, ct, out, den, g, mask)
    got = attention_bwd_dst_mh(*args)
    _hold_b1(got, attention_bwd_dst_mh_plain(*args), args)
    # B2 on one head's rows of the [N, H, D] tensors, read with a row stride
    gh = ct.to(hs_dtype)
    k = heads - 1
    args2 = (rows[:, k], gh[:, k], a_s[k:k + 1], gs[:, k].contiguous(), gd[:, k].contiguous(),
             den[:, k].contiguous(), got[1][:, k].contiguous(), g, None if mask is None else mask[k])
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


# a tie within twice the score band may put either index at a place
TIE_BAND = {key: 2 * v for key, v in SCORE_TOL.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b,d", [(1037, 1, 32), (5000, 8, 128), (2000, 20, 64), (3000, 64, 128),
                                   (700, 100, 256), (4097, 65, 96), (300, 70, 1024)])
def test_topk_kernels_match_plain(cuda, dtype, n, b, d):
    """Both phases against their plain versions at B 1 to 100 (slabs of 8
    to 64 queries, 65 and 100 in two; D 1,024 in slabs of 16, the widest
    that fits), ragged N. The tensor-core chunk max is within SCORE_TOL of
    the max of its chunk's phase-2 scores (not bit-equal: 3xTF32 or bf16
    products against f32 FMAs), and `topk_mips` returns `topk_mips_ref`'s
    indices wherever no tie within the band straddles a place."""
    rng = np.random.default_rng(n + b)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda).to(dtype)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=cuda).to(dtype)
    cm = chunk_max(x, q)
    torch.testing.assert_close(cm, chunk_max_plain(x, q), **SCORE_TOL)
    cid = torch.as_tensor(rng.integers(0, n_chunks_of(n), size=(b, 11)).astype(np.int32), device=cuda)
    cid[:, 0] = n_chunks_of(n) - 1  # the tail chunk, partly past N
    sc = rescore(x, q, cid)
    torch.testing.assert_close(sc, rescore_plain(x, q, cid), **SCORE_TOL)
    assert torch.equal(sc, rescore(x, q, cid))  # the same bits on a second launch
    # the chunk max is within the score band of the max of that chunk's phase-2 scores
    full = rescore(x, q, torch.arange(n_chunks_of(n), device=cuda, dtype=torch.int32).repeat(b, 1))
    torch.testing.assert_close(full.amax(dim=2), cm, **SCORE_TOL)
    k = 20
    gi, gv = topk_mips(x, q, k)
    wi, wv = topk_mips_ref(x, q, k + 1)
    torch.testing.assert_close(gv, wv[:, :k], **SCORE_TOL)
    keep = untied(wv, **TIE_BAND)
    assert torch.equal(gi[keep], wi[:, :k][keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_chunkmax_on_tied_rows_gives_the_same_bits_twice(cuda, dtype, b):
    """A catalog of 20,000 rows, 2,000 of them copies of others (exact ties
    in every query's scores), ragged last chunk: the chunk max within
    SCORE_TOL of the plain one, equal bits on a second call, and the top-k
    scores of `topk_mips` those of `topk_mips_ref`, its indices too wherever
    untied."""
    rng = np.random.default_rng(b)
    x = rng.normal(size=(20_000, 128)).astype(np.float32)
    src, dst = rng.choice(20_000, size=(2, 2000), replace=False)
    x[dst] = x[src]
    x = torch.as_tensor(x, device=cuda).to(dtype)
    q = torch.as_tensor(rng.normal(size=(b, 128)).astype(np.float32), device=cuda).to(dtype)
    cm = chunk_max(x, q)
    torch.testing.assert_close(cm, chunk_max_plain(x, q), **SCORE_TOL)
    assert torch.equal(cm, chunk_max(x, q))
    gi, gv = topk_mips(x, q, 20)
    wi, wv = topk_mips_ref(x, q, 21)
    torch.testing.assert_close(gv, wv[:, :20], **SCORE_TOL)
    keep = untied(wv, **TIE_BAND)
    assert torch.equal(gi[keep], wi[:, :20][keep])


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


def _select_rows(rng, b, w, cuda):
    """Rows with exact ties (values on a grid of 1/4), NEG_INF runs (the
    rescore's fill past N) and a few values at the grid's top."""
    x = np.round(rng.normal(size=(b, w)) * 4) / 4
    x[rng.random((b, w)) < 0.2] = NEG_INF
    x[:, -37:] = NEG_INF
    return torch.as_tensor(x.astype(np.float32), device=cuda)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), f"{int((g != w).sum())} of {g.numel()} entries differ"


@pytest.mark.parametrize("b", [1, 8, 64, 100])
@pytest.mark.parametrize("w", [3893, 5120])
def test_select_kernel_is_bit_equal_to_plain(cuda, b, w):
    """Both modes of the select kernel against their plain versions at the
    served widths (the 498,196-row catalog's 3,893 chunk maxima; 40 chunks'
    scores): ids and values bit for bit, ties and NEG_INF among the rows,
    at r 1, the served r, and r = W; the final mode with the tail chunk."""
    rng = np.random.default_rng(b * 7 + w)
    x = _select_rows(rng, b, w, cuda)
    n = (w - 2) * CHUNK - 50  # the last chunk is w - 3: the clamp binds on the last positions
    for r in (1, 40, w):
        _assert_same([select_chunks(x, r, n)], [select_chunks_plain(x.cpu(), r, n).to(cuda)])
    if w % CHUNK == 0:
        cid = torch.as_tensor(np.sort(rng.choice(3893, size=(b, w // CHUNK)), axis=1).astype(np.int32),
                              device=cuda)
        cid[:, -1] = 3892  # the tail chunk
        for k in (1, 32, 2048, 2049, w):
            _assert_same(select_items(x, cid, k), [t.to(cuda) for t in select_items_plain(x.cpu(), cid.cpu(), k)])


@pytest.mark.parametrize("w,r", [(300_032, 2000), (300_032, 20_000), (8192, 8192)])
def test_select_kernel_on_long_rows(cuda, w, r):
    """The per-request path's long rows (B 1: a large k over its chunks'
    scores), read from global memory on each pass; above 2,048 survivors
    the final selection sorts through its scratch buffer."""
    rng = np.random.default_rng(w + r)
    x = _select_rows(rng, 1, w, cuda)
    _assert_same([select_chunks(x, r, 10**9)], [select_chunks_plain(x.cpu(), r, 10**9).to(cuda)])
    cid = torch.arange(w // CHUNK, device=cuda, dtype=torch.int32)[None] * 3
    _assert_same(select_items(x, cid, r), [t.to(cuda) for t in select_items_plain(x.cpu(), cid.cpu(), r)])
    _assert_same(select_items(x, cid, r), select_items(x, cid, r))


def test_topk_mips_is_four_launches_and_no_torch_op(cuda):
    """One `topk_mips` call on the card launches chunk-max, select,
    rescore and select (the launch counters), and the device runs those
    kernels and nothing else (torch.profiler)."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(20_000, 128)).astype(np.float32), device=cuda)
    q = torch.as_tensor(rng.normal(size=(8, 128)).astype(np.float32), device=cuda)
    topk_mips(x, q, 32)
    torch.cuda.synchronize()
    cuda_build.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        topk_mips(x, q, 32)
        torch.cuda.synchronize()
    launches = {k: c.count for k, c in cuda_build.COUNTERS.items() if c.count}
    assert launches == {"topk_chunkmax": 1, "topk_select": 2, "topk_rescore": 1}
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = ("chunkmax", "select_rows", "rescore")
    assert len(kernels) == 4 and all(any(o in k for o in ours) for k in kernels), kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_topk_mips_on_card_matches_the_cpu_plain_route(cuda, dtype, b):
    """A catalog of 30,000 rows, 3,000 of them copies: the card's indices
    are the CPU plain route's wherever no near-tie of two different rows
    straddles a place (copies tie exactly on both, and both put the smaller
    index first), its scores within SCORE_TOL."""
    rng = np.random.default_rng(40 + b)
    x = rng.normal(size=(30_000, 128)).astype(np.float32)
    src, dst = rng.choice(30_000, size=(2, 3000), replace=False)
    x[dst] = x[src]
    xc = torch.as_tensor(x).to(dtype)
    q = (torch.as_tensor(x[rng.choice(30_000, b)]) + 0.1).to(dtype)
    k = 32
    gi, gv = topk_mips(xc.to(cuda), q.to(cuda), k)
    wi, wv = topk_mips(xc, q, k + 1)
    torch.testing.assert_close(gv.cpu(), wv[:, :k], **SCORE_TOL)
    gap = (wv[:, :-1] - wv[:, 1:]).abs()
    near = (gap > 0) & (gap <= TIE_BAND["atol"] + TIE_BAND["rtol"] * wv[:, :-1].abs())
    straddled = torch.zeros_like(wv, dtype=torch.bool)
    straddled[:, :-1] |= near
    straddled[:, 1:] |= near
    keep = ~straddled[:, :k]
    assert torch.equal(gi.cpu()[keep], wi[:, :k][keep])


def test_select_rejects_bad_rows_on_card(cuda):
    x = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError):
        select_chunks(x, 257, 1000)
    with pytest.raises(ValueError):
        select_items(x, torch.zeros((2, 2), dtype=torch.int32), 4)  # chunk ids on another device


def test_chunkmax_rejects_width_over_shared_memory(cuda):
    # the narrowest slab, 8 f32 queries split into hi and lo, is 256 KB at 4,096 features
    x = torch.zeros((256, 4096), device=cuda)
    with pytest.raises(ValueError):
        chunk_max(x, torch.zeros((4, 4096), device=cuda))
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


def test_segment_sum_gives_the_same_bits_twice(cuda):
    """`ops.segment_sum` on the card: a hot segment of 20,000 rows among
    ~50,000 spread ones, ids out of range dropped; the sums and the
    gradient are the same bits on a second call (a fixed order of sums, no
    float atomics), and equal the CPU's within f32 summation error."""
    from plotpointe_tpu_torch.ops import segment_sum

    rng = np.random.default_rng(16)
    e, n = 70_000, 4_000
    ids = np.where(rng.random(e) < 0.3, 17, rng.integers(-3, n + 3, e))
    data = rng.normal(size=(e, 64)).astype(np.float32)
    ct = torch.as_tensor(rng.normal(size=(n, 64)).astype(np.float32), device=cuda)
    runs = []
    for _ in range(2):
        x = torch.as_tensor(data, device=cuda).requires_grad_()
        out = segment_sum(x, torch.as_tensor(ids, device=cuda), n)
        (out * ct).sum().backward()
        torch.cuda.synchronize()
        runs.append((out.detach(), x.grad))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    want = segment_sum(torch.as_tensor(data), torch.as_tensor(ids), n)
    torch.testing.assert_close(runs[0][0].cpu(), want, rtol=1e-5, atol=1e-3)


def test_legacy_v1_two_heads_gives_the_same_bits_twice(cuda):
    """`attention_v1` at 2 heads of 128 with a dropout mask on a graph with a
    destination of 10,000 in-edges and a source of 3,000 out-edges: the
    forward and the gradients of a fixed linear loss are the same bits on a
    second run. The backward is the golden's autograd, so every sum in it
    (softmax denominator, aggregation, the gathers' backward) must run in a
    fixed order on the card."""
    from plotpointe_tpu_torch.ops.gat_kernel import attention_v1, legacy_mask

    rng = np.random.default_rng(12)
    g = _skewed_graph(rng).with_tiling().to(cuda)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, 2, 128)).astype(np.float32), device=cuda)
    a_s, a_d = (torch.as_tensor(rng.normal(size=(2, 128)).astype(np.float32) * 0.1, device=cuda)
                for _ in range(2))
    ct = torch.as_tensor(rng.normal(size=(g.n_nodes, 2, 128)).astype(np.float32), device=cuda)
    mask = legacy_mask(g, 2, 0.1, 7, cuda)
    runs = []
    for _ in range(2):
        x = [t.clone().requires_grad_() for t in (h, a_s, a_d)]
        out = attention_v1(*x, g, mask)
        (out * ct).sum().backward()
        torch.cuda.synchronize()
        runs.append([out.detach()] + [t.grad for t in x])
    for name, a, b in zip(("out", "dh", "da_src", "da_dst"), *runs):
        assert torch.equal(a, b), f"{name}: max diff {float((a - b).abs().max())}"


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


# -- the edge-balanced walk of kernels 1, 8 (csrc/gat_fwd.cu) and 3 (B2) --


def _star_graph(n=4000):
    """Node 0 takes an in-edge from and sends an out-edge to every other
    node: one row of n - 1 entries in each CSR, every other row one entry."""
    leaves = np.arange(1, n)
    return build_graph(np.concatenate([leaves, np.zeros(n - 1, int)]),
                       np.concatenate([np.zeros(n - 1, int), leaves]), n)


def _walk_graph(kind, rng):
    return (_skewed_graph(rng) if kind == "skewed" else _star_graph()).to("cuda")


@pytest.mark.parametrize("kind", ["skewed", "star"])
@pytest.mark.parametrize("heads,d", [(2, 128), (4, 128), (8, 128), (2, 32), (3, 64)])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_mh_walk_on_rows_above_the_cap_matches_plain(cuda, kind, heads, d, hs_dtype, masked):
    """Kernel 8 over rows of 10,000 and 3,000 entries (skewed) or 3,999
    (star), empty rows and one-entry rows, at 2 to 8 heads (lane groups of
    8 to 32 lanes, 1 to 8 chunks a lane): out and den within rtol 1e-4 /
    atol 1e-5 of the plain version, one count per call, the same bits on a
    second call."""
    from plotpointe_tpu_torch.ops.gat_fused import attention_fwd_mh, attention_fwd_mh_plain, dropout_mask_mh

    rng = np.random.default_rng(heads * d)
    g = _walk_graph(kind, rng)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, heads, d)).astype(np.float32), device=cuda)
    a_s, a_d = (torch.as_tensor((rng.normal(size=(heads, d)) * 0.1).astype(np.float32), device=cuda)
                for _ in range(2))
    mask = dropout_mask_mh(g, 0.3, 77, heads, cuda) if masked else None
    before = cuda_build.COUNTERS["gat_fwd_mh"].count
    out, den = attention_fwd_mh(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    again = attention_fwd_mh(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["gat_fwd_mh"].count == before + 2
    want_out, want_den = attention_fwd_mh_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(den, want_den, rtol=1e-4, atol=1e-5)
    assert torch.equal(out, again[0]) and torch.equal(den, again[1])
    if kind == "skewed":
        assert torch.all(out[1:7] == 0) and torch.all(den[1:7] == 0)


@pytest.mark.parametrize("kind", ["skewed", "star"])
@pytest.mark.parametrize("d", [32, 128, 544, 1024])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
def test_bwd_src_walk_on_rows_above_the_cap_matches_plain(cuda, kind, d, hs_dtype, strided):
    """B2 over the transpose CSR's hot rows (3,000 out-edges of node 9, or
    the star's 3,999), with the 0.3 mask, on contiguous rows or on the last
    head's rows of [N, 2, D] tensors read with a row stride; D 544 and
    1,024 run in column strips. The cotangent is scaled by 0.02 so that a
    row of thousands of entries sums to O(1), where the plain version's own
    f32 error stays inside rtol 5e-4 / atol 1e-4. One count per call, the
    same bits on a second call."""
    rng = np.random.default_rng(d + 3)
    g = _walk_graph(kind, rng)
    heads = 2 if strided else 1
    n = g.n_nodes

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=cuda)

    h, ct = t(n, heads, d), t(n, heads, d, scale=0.02)
    a_s, a_d = t(1, d, scale=0.1), t(1, d, scale=0.1)
    mask = hash_mask(99, torch.arange(g.n_edges, device=cuda), 0.3)
    k = heads - 1
    rows, gs, gd = node_terms_plain(h[:, k], a_s, a_d, hs_dtype)
    if strided:
        rows = h.to(hs_dtype)[:, k]
        assert rows.stride(0) == 2 * d
    out, den = attention_fwd_plain(h[:, k:k + 1], a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    godot = (ct[:, k] * out[:, 0]).sum(1)
    gh = ct.to(hs_dtype)[:, k] if strided else ct[:, k].to(hs_dtype)
    args = (rows, gh, a_s, gs, gd, den, godot, g, mask)
    before = cuda_build.COUNTERS["gat_bwd_src"].count
    dh, again = attention_bwd_src(*args), attention_bwd_src(*args)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["gat_bwd_src"].count == before + 2
    torch.testing.assert_close(dh, attention_bwd_src_plain(*args), **GRAD_TOL)
    assert torch.equal(dh, again)
    if kind == "skewed":
        assert torch.all(dh[1:7] == 0)


@pytest.mark.parametrize("kind", ["skewed", "star"])
@pytest.mark.parametrize("d", [32, 96, 128, 544, 1024])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_single_head_walk_on_rows_above_the_cap_matches_plain(cuda, kind, d, hs_dtype, masked):
    """Kernel 1 on the walk over rows of 10,000 and 3,000 entries (skewed)
    or 3,999 (star), empty rows and one-entry rows: D 96 (lane groups of the
    next power of two, tail lanes idle), D 544 and 1,024 (column strips);
    out and den within rtol 1e-4 / atol 1e-5 of the plain version, one count
    per call, the same bits on a second call."""
    rng = np.random.default_rng(d + 5)
    g = _walk_graph(kind, rng)
    h = torch.as_tensor(rng.normal(size=(g.n_nodes, 1, d)).astype(np.float32), device=cuda)
    a_s, a_d = (torch.as_tensor((rng.normal(size=(1, d)) * 0.05).astype(np.float32), device=cuda)
                for _ in range(2))
    mask = hash_mask(99, torch.arange(g.n_edges, device=cuda), 0.3) if masked else None
    before = cuda_build.COUNTERS["gat_fwd"].count
    out, den = attention_fwd(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    again = attention_fwd(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["gat_fwd"].count == before + 2
    want_out, want_den = attention_fwd_plain(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(den, want_den, rtol=1e-4, atol=1e-5)
    assert torch.equal(out, again[0]) and torch.equal(den, again[1])
    if kind == "skewed":
        assert torch.all(out[1:7] == 0) and torch.all(den[1:7] == 0)


def test_single_head_walk_raises_on_misaligned_rows(cuda):
    """Kernel 1's f32 rows (h itself) that do not start on a 16-byte
    boundary raise before any launch; its bf16 rows are a fresh copy."""
    rng = np.random.default_rng(0)
    g = _graph(rng).to(cuda)
    n, d = g.n_nodes, 64
    h = torch.randn(n * d + 1, device=cuda)[1:].view(n, 1, d)
    a = torch.randn((1, d), device=cuda) * 0.1
    before = cuda_build.COUNTERS["gat_fwd"].count
    with pytest.raises(ValueError, match="16-byte"):
        attention_fwd(h, a, a, g, hs_dtype=torch.float32)
    assert cuda_build.COUNTERS["gat_fwd"].count == before
    out, _ = attention_fwd(h, a, a, g, hs_dtype=torch.bfloat16)
    torch.testing.assert_close(out, attention_fwd_plain(h, a, a, g, hs_dtype=torch.bfloat16)[0],
                               rtol=1e-4, atol=1e-5)


def test_walk_kernels_raise_on_misaligned_rows(cuda):
    """Rows that do not start on a 16-byte boundary raise before any launch
    (no plain version runs on the card): kernel 8's f32 rows (h itself) and
    B2's bf16 row view."""
    from plotpointe_tpu_torch.ops.gat_fused import attention_fwd_mh

    rng = np.random.default_rng(0)
    g = _graph(rng).to(cuda)
    n, heads, d = g.n_nodes, 2, 64
    flat = torch.randn(n * heads * d + 1, device=cuda)
    h = flat[1:].view(n, heads, d)
    a = torch.randn((heads, d), device=cuda) * 0.1
    before = {k: cuda_build.COUNTERS[k].count for k in ("gat_fwd_mh", "gat_bwd_src")}
    with pytest.raises(ValueError, match="16-byte"):
        attention_fwd_mh(h, a, a, g, hs_dtype=torch.float32)
    wide = torch.randn((n, d + 8), device=cuda).to(torch.bfloat16)
    rows = wide[:, 1:d + 1]
    vec = torch.rand(n, device=cuda) + 1.0
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd_src(rows, rows, a[:1], vec, vec, vec, vec, g)
    assert {k: cuda_build.COUNTERS[k].count for k in before} == before


# -- the edge-balanced walk of kernels 2 (B1) and 9 (csrc/gat_bwd_dst.cu) --


def _boundary_graph(rng, n=3000):
    """Rows that end exactly at a piece boundary: node 0 takes 100 CAP
    in-edges, nodes 1 and 2 CAP and 2 CAP, node 3 CAP + 1; nodes 4..9 have
    none (a run of empty rows); the rest lognormal in-degrees."""
    from plotpointe_tpu_torch.ops.spmm_kernel import CAP

    deg = np.concatenate([[100 * CAP, CAP, 2 * CAP, CAP + 1], np.zeros(6, int),
                          np.minimum(rng.lognormal(1.5, 1.3, n - 10).astype(int), 400)])
    dst = np.repeat(np.arange(n), deg)
    return build_graph(rng.integers(10, n, dst.shape[0]), dst, n).to("cuda")


def _b1_walk_graph(kind, rng):
    return _boundary_graph(rng) if kind == "boundary" else _walk_graph(kind, rng)


def _b1_walk_inputs(rng, g, heads, d, hs_dtype, masked, cuda):
    """Rows, node terms, and the walk forward's out and den (the same bits
    on every run); the cotangent scaled by 0.02 so a row of thousands of
    entries sums to O(1)."""
    from plotpointe_tpu_torch.ops.gat_fused import attention_fwd_mh, dropout_mask_mh, node_terms_mh_plain

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32), device=cuda)

    h, ct = t(g.n_nodes, heads, d), t(g.n_nodes, heads, d, scale=0.02)
    a_s, a_d = t(heads, d, scale=0.1), t(heads, d, scale=0.1)
    mask = dropout_mask_mh(g, 0.3, 77, max(heads, 2), cuda)[:heads] if masked else None
    if heads == 1:
        out, den = attention_fwd(h, a_s, a_d, g, mask=None if mask is None else mask[0], hs_dtype=hs_dtype)
        den = den[:, None]
    else:
        out, den = attention_fwd_mh(h, a_s, a_d, g, mask=mask, hs_dtype=hs_dtype)
    rows, gs, gd = node_terms_mh_plain(h, a_s, a_d, hs_dtype)
    return rows, gs, gd, ct, out, den, mask


@pytest.mark.parametrize("kind", ["skewed", "star", "boundary"])
@pytest.mark.parametrize("d", [32, 96, 128, 544, 1024])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_dst_walk_on_rows_above_the_cap_matches_plain(cuda, kind, d, hs_dtype, masked):
    """Kernel 2 (B1) on the walk over rows of 10,000 entries (skewed), 3,999
    (star) or exact multiples of the piece cap (boundary), runs of empty
    rows and one-entry rows: D 96 (lane groups with idle tail lanes), D 544
    and 1,024 (column strips after `row_dots`); de_sum and godot within
    GRAD_TOL of the plain version, d a_src against f64 (`_hold_b1`), empty
    rows zero, one count per call, the same bits on a second call."""
    rng = np.random.default_rng(d + 11)
    g = _b1_walk_graph(kind, rng)
    rows, gs, gd, ct, out, den, mask = _b1_walk_inputs(rng, g, 1, d, hs_dtype, masked, cuda)
    args = (rows[:, 0], gs[:, 0].contiguous(), gd[:, 0].contiguous(), ct[:, 0].contiguous(),
            out[:, 0].contiguous(), den[:, 0].contiguous(), g, None if mask is None else mask[0])
    before = cuda_build.COUNTERS["gat_bwd_dst"].count
    got, again = attention_bwd_dst(*args), attention_bwd_dst(*args)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["gat_bwd_dst"].count == before + 2
    _hold_b1(got, attention_bwd_dst_plain(*args), args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if kind != "star":
        empty = slice(1, 7) if kind == "skewed" else slice(4, 10)
        assert torch.all(got[0][empty] == 0) and torch.all(got[1][empty] == 0)


@pytest.mark.parametrize("kind", ["skewed", "star", "boundary"])
@pytest.mark.parametrize("heads,d", [(2, 128), (4, 128), (8, 128), (2, 32), (3, 64)])
@pytest.mark.parametrize("hs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_dst_mh_walk_on_rows_above_the_cap_matches_plain(cuda, kind, heads, d, hs_dtype, masked):
    """Kernel 9 on the same walk at 2 to 8 heads (lane groups of 8 to 32
    lanes, 1 to 8 chunks a lane, heads sharing a lane's chunk slots or
    taking whole ones): de_sum and godot within GRAD_TOL of the plain
    version, d a_src against f64 (`_hold_b1`), one count per call, the same
    bits on a second call."""
    from plotpointe_tpu_torch.ops.gat_fused import attention_bwd_dst_mh, attention_bwd_dst_mh_plain

    rng = np.random.default_rng(heads * d + 13)
    g = _b1_walk_graph(kind, rng)
    rows, gs, gd, ct, out, den, mask = _b1_walk_inputs(rng, g, heads, d, hs_dtype, masked, cuda)
    args = (rows, gs, gd, ct, out, den, g, mask)
    before = cuda_build.COUNTERS["gat_bwd_dst_mh"].count
    got, again = attention_bwd_dst_mh(*args), attention_bwd_dst_mh(*args)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["gat_bwd_dst_mh"].count == before + 2
    _hold_b1(got, attention_bwd_dst_mh_plain(*args), args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bwd_dst_walk_raises_on_misaligned_rows(cuda):
    """Kernels 2 and 9 read rows in 16-byte loads: rows that do not start on
    a 16-byte boundary raise before any launch (no plain version runs on
    the card)."""
    from plotpointe_tpu_torch.ops.gat_fused import attention_bwd_dst_mh

    rng = np.random.default_rng(0)
    g = _graph(rng).to(cuda)
    n, d = g.n_nodes, 64
    vec = torch.rand(n, device=cuda) + 1.0
    before = {k: cuda_build.COUNTERS[k].count for k in ("gat_bwd_dst", "gat_bwd_dst_mh")}
    for dt in (torch.float32, torch.bfloat16):
        rows = torch.randn(n * 2 * d + 8, device=cuda).to(dt)[1:1 + n * 2 * d]
        ct = torch.randn((n, 2, d), device=cuda)
        with pytest.raises(ValueError, match="16-byte"):
            attention_bwd_dst(rows[:n * d].view(n, d), vec, vec, ct[:, 0], ct[:, 1], vec, g)
        with pytest.raises(ValueError, match="16-byte"):
            attention_bwd_dst_mh(rows.view(n, 2, d), vec[:, None].repeat(1, 2), vec[:, None].repeat(1, 2),
                                 ct, ct, vec[:, None].repeat(1, 2), g)
    assert {k: cuda_build.COUNTERS[k].count for k in before} == before


def test_durable_telemetry_logs_what_the_card_served(cuda, tmp_path, monkeypatch):
    """A CUDA runtime (the top-K kernels) behind the micro-batcher with
    durable telemetry: the queue holds, for each of 4 concurrent requests,
    the item ids and scores its reply carried, under its request_id."""
    import threading

    from plotpointe_tpu_torch.serving.endpoints import ServingState
    from plotpointe_tpu_torch.serving.eventqueue import DurableQueue
    from plotpointe_tpu_torch.serving.telemetry import ServingTelemetry

    monkeypatch.setenv("PLOTPOINTE_QUEUE_NOSYNC", "1")
    path = tmp_path / "emb.npy"
    np.save(path, np.random.default_rng(0).normal(size=(5000, 64)).astype(np.float32))
    tel = ServingTelemetry(root=str(tmp_path / "tel"), durable=True)
    st = ServingState(telemetry=tel, micro_batch=True, micro_batch_wait_ms=50.0)
    before = {k: cuda_build.COUNTERS[k].count for k in ("topk_chunkmax", "topk_rescore", "topk_select")}
    try:
        assert st.startup({"item_embeddings_uri": str(path)})[0] == 200
        assert st.runtime._table.device.type == "cuda"
        replies = [None] * 4
        barrier = threading.Barrier(4)

        def client(i):
            barrier.wait()
            replies[i] = st.recommend({"item_ids": [i, 10 + i, 100 + i], "k": 7, "user_key": f"u{i}"})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        st.close()
    assert all(code == 200 for code, _ in replies)
    assert all(cuda_build.COUNTERS[k].count > v for k, v in before.items())
    tel.requests.queue.close()
    logged = {r["request_id"]: r for r in (d for _, d in DurableQueue(tmp_path / "tel" / "requests").pull(10))}
    assert len(logged) == 4
    for i, (_, body) in enumerate(replies):
        rec = logged[body["request_id"]]
        assert rec["item_ids"] == body["indices"] and rec["scores"] == body["scores"]
        assert rec["user_key"] == f"u{i}" and len(rec["item_ids"]) == 7


# -- the embedding towers and the fusion step (plain PyTorch ops on the card) --

TOWER_F32 = dict(rtol=1e-4, atol=1e-5)  # f32 (TF32 off), sums in another order
# bf16 on the card (every op's output rounded) against f32 on the CPU: unit
# rows within ~one bf16 step (2^-8) per entry at these depths
TOWER_BF16 = dict(rtol=0.0, atol=1e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOWER_F32), (torch.bfloat16, TOWER_BF16)])
def test_text_tower_on_the_card_matches_the_cpu(cuda, dtype, tol):
    from plotpointe_tpu_torch.models.encoders import TransformerTextEncoder

    cpu = TransformerTextEncoder(vocab_size=500, hidden=32, n_layers=2, heads=4, ffn=64, max_len=32)
    cpu.init_params(torch.Generator().manual_seed(0)).eval()
    card = TransformerTextEncoder(vocab_size=500, hidden=32, n_layers=2, heads=4, ffn=64, max_len=32)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda, dtype).eval()
    ids, mask = cpu.tokenize([" ".join(f"w{i * j}" for j in range(i)) for i in range(48)])  # row 0 empty
    with torch.no_grad():
        want = cpu(torch.as_tensor(ids), torch.as_tensor(mask))
        got = card(torch.as_tensor(ids, device=cuda), torch.as_tensor(mask, device=cuda).to(dtype))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float().cpu(), want, **tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOWER_F32), (torch.bfloat16, TOWER_BF16)])
def test_vit_tower_on_the_card_matches_the_cpu(cuda, dtype, tol):
    from plotpointe_tpu_torch.models.encoders import ViTImageEncoder

    dims = dict(image_size=64, patch=32, hidden=64, n_layers=2, heads=4, ffn=128, out_dim=32)
    cpu = ViTImageEncoder(**dims).init_params(torch.Generator().manual_seed(0)).eval()
    card = ViTImageEncoder(**dims)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda, dtype).eval()
    imgs = torch.as_tensor(np.random.default_rng(0).normal(size=(40, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want, got = cpu(imgs), card(imgs.to(cuda, dtype))
    torch.testing.assert_close(got.float().cpu(), want, **tol)


def test_fusion_step_gradients_on_the_card_match_the_cpu(cuda):
    """One training step's loss and gradients (one dropout mask, drawn on a
    CPU generator, on both) within the f32 gradient band."""
    from plotpointe_tpu_torch.config import FusionConfig
    from plotpointe_tpu_torch.models.fusion import FusionModel, dropout_keep, fusion_loss

    cfg = FusionConfig()
    rng = np.random.default_rng(0)
    txt = torch.as_tensor(rng.normal(size=(1024, 384)).astype(np.float32))
    img = torch.as_tensor(rng.normal(size=(1024, 512)).astype(np.float32))
    keep = dropout_keep((1024, cfg.hidden_dim), cfg.dropout, torch.Generator().manual_seed(1))
    models = {}
    for dev in ("cpu", cuda):
        m = FusionModel(cfg, dev).init_params(torch.Generator().manual_seed(cfg.seed))
        loss, _, _ = fusion_loss(m, txt.to(dev), img.to(dev), keep.to(dev))
        loss.backward()
        models[str(dev)] = (float(loss.detach()), {k: p.grad.cpu() for k, p in m.named_parameters()})
    (l_cpu, g_cpu), (l_card, g_card) = models["cpu"], models["cuda"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for k in g_cpu:
        torch.testing.assert_close(g_card[k], g_cpu[k], rtol=5e-4, atol=1e-4, msg=k)


# -- sharded training: local graphs and the world of one ----------------------------


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_local_graph_kernels_match_plain(cuda, n_shards):
    """Kernels 1, 2, 3 (bf16 rows, the mask over canonical ids from e_lo),
    8 and 9 at 2 heads and 7 (both directions) on each shard's local graph
    against their plain versions; the owned rows of the shards' forwards
    combined against the unsharded kernels' outputs."""
    from plotpointe_tpu_torch.graphs.csr import symmetric_normalized_weights
    from plotpointe_tpu_torch.ops.gat_fused import (
        attention_bwd_dst_mh, attention_bwd_dst_mh_plain, attention_fwd_mh, attention_fwd_mh_plain,
        dropout_mask, dropout_mask_mh, node_terms_mh_plain)
    from plotpointe_tpu_torch.ops.spmm_kernel import spmm_csr, spmm_csr_plain
    from plotpointe_tpu_torch.parallel.spmd import local_graph, shard_graph_by_edges

    rng = np.random.default_rng(n_shards)
    g = _graph(rng).to(cuda)
    n, d, bf16 = g.n_nodes, 64, torch.bfloat16
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32), device=cuda)  # noqa: E731
    h, a_s, a_d, ct = t(n, 1, d), 0.1 * t(1, d), 0.1 * t(1, d), t(n, d)
    h2, s2, d2, ct2 = t(n, 2, d), 0.1 * t(2, d), 0.1 * t(2, d), t(n, 2, d)
    x, vals = t(n, d), torch.as_tensor(symmetric_normalized_weights(g), device=cuda)
    full = attention_fwd(h, a_s, a_d, g, dropout_mask(g, 0.1, 7, cuda), bf16)
    full_mh = attention_fwd_mh(h2, s2, d2, g, dropout_mask_mh(g, 0.1, 7, 2, cuda), bf16)
    full_y = spmm_csr(x, vals, g.row_ptr, g.src, bf16)
    rows, gs, gd = node_terms_plain(h[:, 0], a_s, a_d, bf16)
    rows2, gs2, gd2 = node_terms_mh_plain(h2, s2, d2, bf16)
    layout = shard_graph_by_edges(g, n_shards)
    owned = [[], [], []]
    for k in range(n_shards):
        loc = local_graph(g, layout, k)
        lg, lo, hi = loc.graph, loc.lo, loc.hi
        mask = dropout_mask(lg, 0.1, 7, cuda, loc.e_lo)
        assert torch.equal(mask, dropout_mask(g, 0.1, 7, cuda)[loc.e_lo:loc.e_lo + lg.n_edges])
        got, want = attention_fwd(h, a_s, a_d, lg, mask, bf16), attention_fwd_plain(h, a_s, a_d, lg, mask, bf16)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
        args = (rows, gs, gd, ct, want[0][:, 0], want[1], lg, mask)
        w1 = attention_bwd_dst_plain(*args)
        for a, b in zip(attention_bwd_dst(*args), w1):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=1e-4)
        args2 = (rows, ct.to(bf16), a_s, gs, gd, want[1], w1[1], lg, mask)
        torch.testing.assert_close(attention_bwd_src(*args2), attention_bwd_src_plain(*args2),
                                   rtol=5e-4, atol=1e-4)
        mask2 = dropout_mask_mh(lg, 0.1, 7, 2, cuda, loc.e_lo)
        got2 = attention_fwd_mh(h2, s2, d2, lg, mask2, bf16)
        want2 = attention_fwd_mh_plain(h2, s2, d2, lg, mask2, bf16)
        torch.testing.assert_close(got2[0], want2[0], rtol=1e-4, atol=1e-5)
        args = (rows2, gs2, gd2, ct2, want2[0], want2[1], lg, mask2)
        for a, b in zip(attention_bwd_dst_mh(*args), attention_bwd_dst_mh_plain(*args)):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=1e-4)
        v_l = vals[loc.e_lo:loc.e_lo + lg.n_edges]
        y = spmm_csr(x, v_l, lg.row_ptr, lg.src, bf16)
        torch.testing.assert_close(y, spmm_csr_plain(x, v_l, lg.row_ptr, lg.src, bf16), rtol=1e-4, atol=1e-5)
        vt = v_l[lg.t_eid.long()].contiguous()
        torch.testing.assert_close(spmm_csr(x, vt, lg.t_ptr, lg.t_dst, bf16),
                                   spmm_csr_plain(x, vt, lg.t_ptr, lg.t_dst, bf16), rtol=1e-4, atol=1e-5)
        for o, full_out in zip(owned, (got[0], got2[0], y)):
            o.append(full_out[lo:hi])
    for o, want in zip(owned, (full[0], full_mh[0], full_y)):
        torch.testing.assert_close(torch.cat(o), want, rtol=1e-4, atol=1e-5)


@pytest.mark.multihost
def test_sharded_world1_nccl_step_matches_unsharded(cuda):
    """One spawned rank on NCCL: the fused step (kernels 1-3, bf16 rows,
    dropout over canonical ids, exact overlays) against the unsharded
    model's forward, loss and autograd on the same card."""
    from plotpointe_tpu_torch.models.gat import GATModel
    from plotpointe_tpu_torch.parallel.cases import run_cases
    from plotpointe_tpu_torch.parallel.multihost import spawn
    from plotpointe_tpu_torch.train.checkpoint import params_to_jax
    from plotpointe_tpu_torch.train.losses import bpr_loss

    rng = np.random.default_rng(1)
    g = _graph(rng)
    nu, ni, f = 200, 100, 16
    model = GATModel(nu, ni, f, hidden_dim=64, n_layers=2, attn_dropout=0.2, hs_dtype=torch.bfloat16)
    model.init_params(torch.Generator().manual_seed(0))
    feats = rng.normal(size=(ni, f)).astype(np.float32)
    u, i, j = (rng.integers(0, m, 256).astype(np.int32) for m in (nu, ni, ni))
    seeds = [11, 22]
    case = dict(kind="gat_step", src=g.src.numpy(), dst=g.dst.numpy(), n_nodes=nu + ni,
                builder="make_sharded_gat_step_fused", model=model.config_dict(),
                params=params_to_jax(model.state_dict()), item_feats=feats, u=u, i=i, j=j,
                hs_dtype="bfloat16", overlay_dtype=None, dropout_rate=0.2, seeds=seeds)
    ((got,),) = spawn(run_cases, 1, ([case], None, "cuda"), device="cuda", timeout_s=300)
    assert [c["op"] for c in got["collectives"]].count("all_gather") == 3
    model.to(cuda)
    z = model(torch.as_tensor(feats, device=cuda), g.to(cuda), train=True, seeds=seeds)
    ut, it, jt = (torch.as_tensor(a, device=cuda).long() for a in (u, i, j))
    loss = bpr_loss((z[ut] * z[nu + it]).sum(-1), (z[ut] * z[nu + jt]).sum(-1))
    loss.backward()
    np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-5)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got["grads"][k], p.grad.cpu().numpy(), rtol=5e-4, atol=1e-4, err_msg=k)
