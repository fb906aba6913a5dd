"""The sampled eval's rank kernel (`ops/eval_kernel.eval_rank`,
`csrc/eval_rank.cu`).

On the CPU: the wrapper's plain version against the dense-product
formulation that `eval_from_negatives` had before the kernel (restated
here), and the chunk sums against the JAX package's `_eval_chunk` fed the
same negatives; the wrapper's refusals. On the card (marked `cuda`, skipped
without one): the kernel's ranks and ties equal to the dense f32 product's
at 2,048 users x 1,001 candidates, on data whose scores are exact in f32;
how many candidate scores of random rows differ bitwise between a one-FMA-
chain recomputation and `U[users] @ I.T`; one launch counted per chunk.

`sampled_eval` against a restatement of its eager chunk loop (before the
CUDA graphs): on the CPU it runs that loop, captures nothing and returns the
same bits; on the card its graphed eval returns the same metrics to the bit,
reuses one capture across evals and leaves the generator where the eager
loop leaves it.

JAX is imported inside the CPU tests, so the card tests run where JAX is
absent:

    python -m pytest --noconftest tests/test_torch_eval_rank.py -q -m cuda -s
"""
import numpy as np
import pytest
import torch

from plotpointe_tpu_torch import full_f32_matmul
from plotpointe_tpu_torch.ops import cuda_build, eval_kernel
from plotpointe_tpu_torch.ops.eval_kernel import eval_rank, eval_rank_plain
from plotpointe_tpu_torch.train.evaluate import eval_from_negatives, sampled_eval


def dense_rank(U, I, users, pos, negs):
    """`eval_from_negatives`' ranks and ties before the kernel: every item
    scored by one f32 product, the candidates gathered from it."""
    neg_k = negs.shape[1]
    scores = U[users.long()] @ I.T
    ps = torch.gather(scores, 1, pos.long()[:, None])
    ns = torch.gather(scores, 1, negs.long())
    rank = 1 + torch.sum(ns > ps, dim=1)
    rank = torch.where(torch.isfinite(ps[:, 0]), rank, torch.full_like(rank, neg_k + 2))
    return rank, torch.sum(ns == ps, dim=1)


def _avoid_rows(rng, n_users, width, n_items):
    """Sorted train positives a user, padded with n_items; every user keeps
    at least two items to draw from."""
    out = np.full((n_users, width), n_items, np.int32)
    for r in range(n_users):
        c = int(rng.integers(0, min(width, n_items - 2) + 1))
        out[r, :c] = np.sort(rng.choice(n_items, c, replace=False))
    return out


# (d, neg_k, n_items, what the case holds besides)
CASES = {
    "d64-k1": (64, 1, 300, ""),
    "d128-k7": (128, 7, 300, ""),
    "d64-k1000": (64, 1000, 3000, ""),
    "d128-k1000": (128, 1000, 3000, ""),
    "nonfinite-positive": (64, 7, 300, "nonfinite"),
    "copied-rows-tie": (128, 100, 300, "ties"),
    "repeated-negatives": (64, 1000, 12, ""),
    "padded-users": (128, 7, 300, "padded"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_rank_plain_matches_dense_and_jax(case):
    import jax
    import jax.numpy as jnp

    from plotpointe_tpu.train.evaluate import _eval_chunk
    from plotpointe_tpu.train.sampling import sample_eval_negatives as jax_eval_negatives

    d, neg_k, n_items, what = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    n_users, c = 40, 64
    U = rng.normal(size=(n_users, d)).astype(np.float32)
    I = rng.normal(size=(n_items, d)).astype(np.float32)
    users = rng.integers(0, n_users, c).astype(np.int32)
    pos = rng.integers(0, n_items, c).astype(np.int32)
    valid = np.ones(c, np.float32)
    if what == "nonfinite":
        U[3] = np.nan  # a NaN positive: ranked last, no ties
        I[pos[1]] = np.inf  # an infinite positive
        users[:2] = [3, users[1]]
    if what == "ties":
        I[1:40] = I[0]  # 40 copies of one row; positives among them tie with copied negatives
        pos[:16] = rng.integers(0, 40, 16)
        U[5] = 0.0  # a collapsed user: every negative ties
        users[16] = 5
    if what == "padded":
        valid[c - 20:] = 0.0
        users[c - 20:] = 0
        pos[c - 20:] = 0
    table = _avoid_rows(rng, n_users, min(20, n_items - 2), n_items)
    deg = (table < n_items).sum(1).astype(np.int32)
    key = jax.random.key(11)
    ja = [jnp.asarray(x) for x in (U, I, users, pos, valid, table, deg)]
    want = jax.tree.map(float, _eval_chunk(*ja, key, neg_k, (10, 20)))
    negs = np.array(jax_eval_negatives(key, ja[2], ja[3], ja[5], ja[6], n_items, neg_k))
    t = [torch.from_numpy(x) for x in (U, I, users, pos, negs, valid)]

    rank, ties = eval_rank(*t[:5])
    assert rank.dtype == ties.dtype == torch.int32 and rank.shape == ties.shape == (c,)
    want_rank, want_ties = dense_rank(*t[:5])
    np.testing.assert_array_equal(rank.numpy(), want_rank.numpy())
    np.testing.assert_array_equal(ties.numpy(), want_ties.numpy())

    got = eval_from_negatives(*t, ks=(10, 20))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-6, err_msg=k)
    if what == "nonfinite":
        assert rank[0] == neg_k + 2 and ties[0] == 0
        assert rank[1] == neg_k + 2
    if what == "ties":
        assert ties[16] == neg_k and rank[16] == 1
        assert want["tie_frac_sum"] > 1.0
    if what == "padded":
        assert got["count"] == c - 20
    if case == "repeated-negatives":
        assert all(len(np.unique(r)) < neg_k for r in negs)


@pytest.mark.parametrize("d", [1, 6])
def test_sampled_eval_takes_rows_of_any_width(d):
    """Rows whose width the kernel does not take (the anchor's one-column
    baselines) are padded with zero columns: the metrics equal those of
    the dense product over the rows as given, with the same negatives."""
    from plotpointe_tpu_torch.train.sampling import sample_eval_negatives

    rng = np.random.default_rng(d)
    n_users, n_items, n, neg_k = 30, 200, 100, 50
    U = torch.from_numpy(rng.normal(size=(n_users, d)).astype(np.float32))
    I = torch.from_numpy(rng.normal(size=(n_items, d)).astype(np.float32))
    I[1:20] = I[0]
    table = torch.from_numpy(_avoid_rows(rng, n_users, 10, n_items))
    deg = (table < n_items).sum(1).to(torch.int32)
    eu, ei = rng.integers(0, n_users, n), rng.integers(0, n_items, n)
    got = sampled_eval(U, I, eu, ei, table, deg, torch.Generator().manual_seed(5), neg_k=neg_k, chunk=128)
    users = torch.zeros(128, dtype=torch.int32)
    pos = torch.zeros(128, dtype=torch.int32)
    users[:n], pos[:n] = torch.from_numpy(eu.astype(np.int32)), torch.from_numpy(ei.astype(np.int32))
    negs = sample_eval_negatives(torch.Generator().manual_seed(5), users, pos, table, deg, n_items, neg_k)
    rank, ties = (x[:n].double() for x in dense_rank(U, I, users, pos, negs))
    assert got["recall@20"] == pytest.approx(float((rank <= 20).double().mean()), abs=1e-7)
    ndcg = torch.where(rank <= 10, 1.0 / torch.log2(rank + 1.0), torch.zeros_like(rank))
    assert got["ndcg@10"] == pytest.approx(float(ndcg.mean()), abs=1e-6)
    assert got["tie_fraction"] == pytest.approx(float((ties / neg_k).mean()), abs=1e-7)


def eager_sampled_eval(U, I, eval_users, eval_pos, table, deg, generator, neg_k, ks=(10, 20),
                       chunk=512):
    """`sampled_eval` as it ran before the CUDA graphs: each chunk's
    negatives, then its sums, added in chunk order, read one by one."""
    from plotpointe_tpu_torch.train.sampling import sample_eval_negatives

    n = len(eval_users)
    chunk = min(chunk, ((n + 127) // 128) * 128)
    n_pad = ((n + chunk - 1) // chunk) * chunk
    dev = U.device
    users = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    pos = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    users[:n] = torch.as_tensor(np.asarray(eval_users, np.int32), device=dev)
    pos[:n] = torch.as_tensor(np.asarray(eval_pos, np.int32), device=dev)
    valid[:n] = 1.0
    if U.shape[1] % 4:
        U, I = (torch.nn.functional.pad(x, (0, -U.shape[1] % 4)) for x in (U, I))
    sums = {}
    for c in range(0, n_pad, chunk):
        sl = slice(c, c + chunk)
        negs = sample_eval_negatives(generator, users[sl], pos[sl], table, deg, I.shape[0], neg_k)
        part = eval_from_negatives(U, I, users[sl], pos[sl], negs, valid[sl], ks)
        for k, v in part.items():
            sums[k] = sums[k] + v if k in sums else v
    totals = {k: float(v) for k, v in sums.items()}
    count = max(totals["count"], 1.0)
    metrics = {}
    for k in ks:
        metrics[f"recall@{k}"] = totals[f"recall@{k}_sum"] / count
        metrics[f"ndcg@{k}"] = totals[f"ndcg@{k}_sum"] / count
    metrics["tie_fraction"] = totals["tie_frac_sum"] / count
    return metrics


def _eval_case(dev, n, n_users=6000, n_items=5000, seed=0):
    """A positives table of up to 16 sorted items a user and `n` eval pairs."""
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(_avoid_rows(rng, n_users, 16, n_items), device=dev)
    deg = (table < n_items).sum(1).to(torch.int32)
    return table, deg, rng.integers(0, n_users, n), rng.integers(0, n_items, n)


def graph_counts():
    return (eval_kernel.EVAL_GRAPH_CAPTURES.count, eval_kernel.EVAL_GRAPH_REPLAYS.count,
            cuda_build.COUNTERS["eval_rank"].count)


@pytest.mark.parametrize("d,n,chunk", [(64, 1000, 256), (6, 300, 512)])
def test_sampled_eval_cpu_is_the_eager_loop(d, n, chunk):
    """On CPU tensors `sampled_eval` captures and replays nothing, and returns
    the eager loop's metrics to the bit, leaving the generator where it does."""
    table, deg, eu, ei = _eval_case("cpu", n, n_users=400, n_items=300)
    g = torch.Generator().manual_seed(7)
    U, I = torch.randn(400, d, generator=g), torch.randn(300, d, generator=g)
    before = graph_counts()
    got_gen, want_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = sampled_eval(U, I, eu, ei, table, deg, got_gen, neg_k=50, chunk=chunk)
    assert graph_counts() == before
    assert got == eager_sampled_eval(U, I, eu, ei, table, deg, want_gen, 50, chunk=chunk)
    assert torch.equal(torch.rand(4, generator=got_gen), torch.rand(4, generator=want_gen))


def _inputs(c=6, d=8, neg_k=5, n=20):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(10, d, generator=g), torch.randn(n, d, generator=g),
            torch.randint(0, 10, (c,), generator=g, dtype=torch.int32),
            torch.randint(0, n, (c,), generator=g, dtype=torch.int32),
            torch.randint(0, n, (c, neg_k), generator=g, dtype=torch.int32))


REFUSED = {
    "U-float64": lambda U, I, u, p, n: (U.double(), I, u, p, n),
    "I-bfloat16": lambda U, I, u, p, n: (U, I.bfloat16(), u, p, n),
    "users-int64": lambda U, I, u, p, n: (U, I, u.long(), p, n),
    "negs-int64": lambda U, I, u, p, n: (U, I, u, p, n.long()),
    "negs-other-device": lambda U, I, u, p, n: (U, I, u, p, n.to("meta")),
    "I-other-device": lambda U, I, u, p, n: (U, I.to("meta"), u, p, n),
    "d-not-multiple-of-4": lambda U, I, u, p, n: (U[:, :6].contiguous(), I[:, :6].contiguous(), u, p, n),
    "d-mismatch": lambda U, I, u, p, n: (U, I[:, :4].contiguous(), u, p, n),
    "pos-short": lambda U, I, u, p, n: (U, I, u, p[:-1], n),
    "negs-rows": lambda U, I, u, p, n: (U, I, u, p, n[:-1]),
    "negs-1d": lambda U, I, u, p, n: (U, I, u, p, n[:, 0].contiguous()),
    "no-negatives": lambda U, I, u, p, n: (U, I, u, p, n[:, :0]),
    "U-1d": lambda U, I, u, p, n: (U[0], I, u, p, n),
    "I-strided": lambda U, I, u, p, n: (U, I.T.contiguous().T, u, p, n),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_eval_rank_refuses(case):
    args = REFUSED[case](*_inputs())
    with pytest.raises(ValueError):
        eval_rank(*args)


def test_eval_rank_plain_is_the_cpu_path():
    args = _inputs()
    for a, b in zip(eval_rank(*args), eval_rank_plain(*args)):
        assert torch.equal(a, b)
    before = cuda_build.COUNTERS["eval_rank"].count
    eval_rank(*args)
    assert cuda_build.COUNTERS["eval_rank"].count == before  # no launch on the CPU


# -- on the card --------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _exact_case(dev, d, neg_k, c=2048, n_items=63_001, seed=0):
    """Rows of quarters in [-2, 2]: every product and partial sum is exact in
    f32 (at most 2^13 sixteenths), so any order of sums gives the same
    scores and two that differ differ by 1/16 at least. Copied rows tie
    exactly; a NaN user and an infinite item give non-finite positives."""
    g = torch.Generator(device=dev).manual_seed(seed)
    U = torch.randint(-8, 9, (4096, d), generator=g, device=dev).float() / 4
    I = torch.randint(-8, 9, (n_items, d), generator=g, device=dev).float() / 4
    I[1:64] = I[0]
    U[7] = float("nan")
    I[5] = float("inf")
    users = torch.randint(0, 4096, (c,), generator=g, device=dev, dtype=torch.int32)
    pos = torch.randint(0, n_items, (c,), generator=g, device=dev, dtype=torch.int32)
    negs = torch.randint(0, n_items, (c, neg_k), generator=g, device=dev, dtype=torch.int32)
    pos[:100] = torch.randint(0, 64, (100,), generator=g, device=dev, dtype=torch.int32)
    half = max(1, neg_k // 2)
    negs[:100, :half] = torch.randint(0, 64, (100, half), generator=g, device=dev, dtype=torch.int32)
    users[100], pos[101], negs[102, 0] = 7, 5, 5
    return U, I, users, pos, negs


@pytest.mark.cuda
@pytest.mark.parametrize("d,neg_k", [(64, 1000), (128, 1000), (128, 1), (64, 7), (96, 300), (4, 130)])
def test_eval_rank_kernel_equals_dense(cuda, d, neg_k):
    args = _exact_case(cuda, d, neg_k)
    before = cuda_build.COUNTERS["eval_rank"].count
    rank, ties = eval_rank(*args)
    torch.cuda.synchronize()
    assert cuda_build.COUNTERS["eval_rank"].count == before + 1
    with full_f32_matmul():
        want_rank, want_ties = dense_rank(*args)
    assert torch.equal(rank, want_rank.to(torch.int32))
    assert torch.equal(ties, want_ties.to(torch.int32))
    assert int((ties > 0).sum()) >= 50  # the copied rows tie
    assert int(rank[100]) == neg_k + 2  # the NaN user
    again = eval_rank(*args)
    assert torch.equal(again[0], rank) and torch.equal(again[1], ties)


def _fma_chain(a, b):
    """f32 scores of rows a [..., D] and b [..., D] as one FMA chain over d
    ascending from 0, each step computed in f64 (the product exact) and
    rounded to f32: a correctly rounded FMA except where the f64 sum lands
    on an f32 midpoint (about 2^-29 of the steps)."""
    s = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        s = (s.double() + a[..., k].double() * b[..., k].double()).float()
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_eval_rank_scores_against_the_dense_product(cuda, d):
    """Random normal rows: the ranks equal the dense path's, and the count of
    candidate scores whose one-FMA-chain value differs bitwise from the
    dense product's is printed (0 where cuBLAS accumulates in one ascending
    chain)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    c, neg_k, n_items = 2048, 1000, 63_001
    U = torch.randn(4096, d, generator=g, device=cuda)
    I = torch.randn(n_items, d, generator=g, device=cuda)
    users = torch.randint(0, 4096, (c,), generator=g, device=cuda, dtype=torch.int32)
    pos = torch.randint(0, n_items, (c,), generator=g, device=cuda, dtype=torch.int32)
    negs = torch.randint(0, n_items, (c, neg_k), generator=g, device=cuda, dtype=torch.int32)
    rank, ties = eval_rank(U, I, users, pos, negs)
    with full_f32_matmul():
        want_rank, want_ties = dense_rank(U, I, users, pos, negs)
        dense = torch.gather(U[users.long()] @ I.T, 1, torch.cat([pos[:, None], negs], 1).long())
    cand = torch.cat([pos[:, None], negs], 1).long()
    chain = torch.cat([_fma_chain(U[users.long()][:, None, :], I[cand[:, j0:j0 + 128]])
                       for j0 in range(0, neg_k + 1, 128)], 1)
    differ = int((chain.view(torch.int32) != dense.view(torch.int32)).sum())
    print(f"\neval_rank d={d}: {differ} of {dense.numel()} candidate scores differ bitwise between "
          f"the FMA chain and U[users] @ I.T; rank mismatches "
          f"{int((rank != want_rank.to(torch.int32)).sum())}, ties mismatches "
          f"{int((ties != want_ties.to(torch.int32)).sum())}")
    assert int((rank != want_rank.to(torch.int32)).sum()) <= max(1, differ)
    assert torch.equal(ties, want_ties.to(torch.int32)) or differ > 0


@pytest.mark.cuda
def test_eval_rank_one_launch_a_chunk(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    n_users, n_items, n_eval, chunk = 6000, 5000, 5000, 2048
    U = torch.randn(n_users, 64, generator=g, device=cuda)
    I = torch.randn(n_items, 64, generator=g, device=cuda)
    table = torch.full((n_users, 4), n_items, dtype=torch.int32, device=cuda)
    deg = torch.zeros(n_users, dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(0)
    eu, ei = rng.integers(0, n_users, n_eval), rng.integers(0, n_items, n_eval)
    before = cuda_build.COUNTERS["eval_rank"].count
    m = sampled_eval(U, I, eu, ei, table, deg, torch.Generator(device=cuda).manual_seed(0),
                     neg_k=1000, chunk=chunk)
    assert cuda_build.COUNTERS["eval_rank"].count == before + -(-n_eval // chunk)
    assert 0.0 <= m["recall@20"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(128, 5000), (64, 5000), (128, 300), (64, 300), (1, 5000)])
def test_sampled_eval_graphed_equals_eager(cuda, d, n):
    """Three evals of one key, each with another seed and fresh U and I: the
    graphed metrics equal the eager loop's to the bit (n 5,000 in chunks of
    2,048, the last padded; n 300 in one chunk cut to 384; D 1 padded to 4);
    the key is captured once, at its second chunk, and then replays two
    graphs a chunk with one `eval_rank` launch counted a chunk; the draws
    after each eval equal those after the eager one."""
    table, deg, eu, ei = _eval_case(cuda, n)
    chunks = -(-n // 2048)
    graphed, eager = torch.Generator(device=cuda), torch.Generator(device=cuda)
    start = graph_counts()
    for seed in (1, 2, 3):
        g = torch.Generator(device=cuda).manual_seed(100 + seed)
        U = torch.randn(6000, d, generator=g, device=cuda)
        I = torch.randn(5000, d, generator=g, device=cuda)
        before = graph_counts()
        got = sampled_eval(U, I, eu, ei, table, deg, graphed.manual_seed(seed), neg_k=1000, chunk=2048)
        after = graph_counts()
        want = eager_sampled_eval(U, I, eu, ei, table, deg, eager.manual_seed(seed), 1000, chunk=2048)
        assert got == want, (seed, got, want)
        assert after[2] - before[2] == chunks  # one eval_rank launch counted a chunk
        if seed == 3:  # steady state: no capture, two replays a chunk
            assert after[:2] == (before[0], before[1] + 2 * chunks)
        assert torch.equal(torch.rand(16, generator=graphed, device=cuda),
                           torch.rand(16, generator=eager, device=cuda))
    end = graph_counts()
    assert end[0] - start[0] == 1  # captured once, at the key's second chunk
    assert end[1] - start[1] == 2 * (3 * chunks - 1)  # every chunk but the key's first replayed
