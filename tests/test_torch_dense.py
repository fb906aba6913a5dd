"""The 3xTF32 dense products (`ops/dense.py`, `csrc/dense_3xtf32.cu`) that
run the HGT layer's typed products on the card.

On the CPU: `linear` is `torch.addmm` bit for bit, forward and gradients,
and `linear_into` the HGT layer's former `addmm`, `split` and `cat`;
the TF32 split (hi and lo each a TF32 value, round to nearest, ties away
from zero); the error model the kernel relies on: a torch emulation of its
arithmetic (`mm_3xtf32_plain`: the split, then lo hi + hi lo + hi hi in f32)
is within 2x plain f32's error against f64 at K 256 and K 63,001; the split
of K for the weight gradient; the HGT layer's products go through the op.

On the card (`-m cuda`, skipped without one): the forward (with its bias),
dx and dw at the HGT product shapes and at 1,003 rows (every M there is a
row tail) against an f64 product of the same f32 inputs, each within 2x the
error of cuBLAS f32 (TF32 off) on the same inputs, the same bits on a second
call; the kernel's split equals `tf32_split`; `linear` and `linear_into`
raise for misshapen operands (no other path on the card); the
ops' outputs and gradients against their plain versions (`linear_into` at
the HGT layer's plan); a traced HGT training step at 256
wide x 8 heads x 3 layers launches the kernel 36 times (3 layers x 4
products x forward, dx, dw) and an eval forward 12.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from plotpointe_tpu_torch import reference_versions  # noqa: E402
from plotpointe_tpu_torch.graphs.hetero import build_hetero_graph  # noqa: E402
from plotpointe_tpu_torch.models import hgt as hgt_model  # noqa: E402
from plotpointe_tpu_torch.ops import cuda_build  # noqa: E402
from plotpointe_tpu_torch.ops import dense  # noqa: E402
from plotpointe_tpu_torch.utils import tracing  # noqa: E402

# the HGT layer's products at hgt-amazon's sizes: (rows, N) of x [rows, 256] @ w [256, N]
HGT_SHAPES = [(192403, 768), (63001, 1280), (192403, 256), (63001, 256), (255404, 256), (1003, 768)]


def _operands(rng, m, k, n):
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.as_tensor(rng.uniform(-1, 1, size=(k, n)).astype(np.float32) / k ** 0.5)
    return x, w


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_linear_is_addmm_on_the_cpu(bias):
    rng = np.random.default_rng(1)
    x, w = _operands(rng, 300, 256, 512)
    b = torch.as_tensor(rng.normal(size=512).astype(np.float32)) if bias else None
    g = torch.as_tensor(rng.normal(size=(300, 512)).astype(np.float32))

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, w) + ((b,) if bias else ())]
        y = fn(*leaves)
        return (y, *torch.autograd.grad((y * g).sum(), leaves))

    got = run(lambda *t: dense.linear(*t))
    want = run(lambda x_, w_, *b_: torch.addmm(b_[0], x_, w_) if b_ else x_ @ w_)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_the_split_is_two_tf32_values_rounded_to_nearest():
    rng = np.random.default_rng(2)
    x = torch.as_tensor((rng.normal(size=100_000) * np.exp(rng.normal(size=100_000) * 4)).astype(np.float32))
    hi, lo = dense.tf32_split(x)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())  # half a TF32 step of x
    assert bool(((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all())  # half a TF32 step of lo
    # ties away from zero: 1 + 2^-11 lies halfway between two TF32 values
    half = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert torch.equal(dense.tf32_split(half)[0], torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10)]))


@pytest.mark.parametrize("m,k,n", [(2000, 256, 768), (128, 63001, 256)], ids=["k256", "k63001"])
def test_the_3xtf32_emulation_is_within_twice_plain_f32(m, k, n):
    """The kernel's error model: TF32 hi and lo of both operands, lo.lo
    dropped, each product exact, the sums in f32, against f64."""
    rng = np.random.default_rng(k)
    a, b = _operands(rng, m, k, n)
    want = a.double() @ b.double()
    plain = float(((a @ b).double() - want).abs().max())
    three = float((dense.mm_3xtf32_plain(a, b).double() - want).abs().max())
    one_pass = float((dense.tf32_split(a)[0] @ dense.tf32_split(b)[0]).double().sub(want).abs().max())
    assert three <= 2 * plain, (three, plain)
    assert one_pass > 20 * plain  # a single TF32 pass is another result


def test_the_weight_gradient_splits_k_into_whole_stages():
    for k, tiles in ((192403, 2), (192403, 6), (63001, 10), (63001, 2), (1003, 6), (16, 2), (255404, 2)):
        splits, chunk = dense.k_split(k, tiles, 132)
        assert chunk % dense.TILE_K == 0 and chunk >= dense.MIN_CHUNK
        assert (splits - 1) * chunk < k <= splits * chunk
        assert splits * tiles <= 132 or splits == 1
    assert dense.k_split(192403, 2, 132) == (66, 2944)


def test_the_kernel_takes_multiples_of_128():
    assert dense.takes(256, 768) and dense.takes(256, 1280) and dense.takes(128, 384)
    assert not any(dense.takes(k, n) for k, n in ((64, 256), (256, 320), (192, 256), (0, 256)))


def test_the_hgt_layer_runs_its_products_through_the_op(monkeypatch):
    """A forward of 2 layers makes its typed products through `linear_into`
    (users' rows into q and kv under rates, items' into q and kv under
    rated_by and similar: the stacked table's blocks) and its 4 output
    products through `linear`."""
    calls = []

    def spy_into(x, plan, *wbs):
        calls.append(("into", plan, tuple(tuple(w.shape) for w in wbs[0::2])))
        return dense.linear_into(x, plan, *wbs)

    def spy(x, w, b=None):
        calls.append(("linear", tuple(x.shape), tuple(w.shape)))
        return dense.linear(x, w, b)

    monkeypatch.setattr(hgt_model, "linear_into", spy_into)
    monkeypatch.setattr(hgt_model, "linear", spy)
    g = _graph(np.random.default_rng(3), 40, 30, 300, 3)
    model = hgt_model.HGTModel(40, 30, 8, hidden_dim=32, n_layers=2, heads=2)
    model.init_params(torch.Generator().manual_seed(0))
    model(torch.randn(30, 8), g)
    plan = (((70, 32), (100, 64)), ((0, 40, ((0, 0), (1, 0))), (40, 70, ((0, 40), (1, 40), (1, 70)))))
    into = ("into", plan, ((32, 96), (32, 160)))
    outs = [("linear", (40, 32), (32, 32)), ("linear", (30, 32), (32, 32))]
    assert calls == [into, *outs, into, *outs]


def test_linear_into_is_addmm_split_and_cat_on_the_cpu():
    """The plain path of `linear_into` is the layer's former code: each
    part's `addmm`, split at its dests' widths, each table the `cat` of its
    pieces in row order; forward and gradients bit for bit."""
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(50, 32)).astype(np.float32))
    wu, wi = (torch.as_tensor(rng.normal(size=(32, n)).astype(np.float32)) for n in (96, 160))
    bu, bi = (torch.as_tensor(rng.normal(size=n).astype(np.float32)) for n in (96, 160))
    plan = (((50, 32), (80, 64)), ((0, 20, ((0, 0), (1, 0))), (20, 50, ((0, 20), (1, 20), (1, 50)))))
    gq, gkv = torch.randn(50, 32), torch.randn(80, 64)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, wu, bu, wi, bi)]
        q, kv = fn(*leaves)
        return (q, kv, *torch.autograd.grad((q * gq).sum() + (kv * gkv).sum(), leaves))

    def former(x_, wu_, bu_, wi_, bi_):
        yu = torch.addmm(bu_, x_[:20], wu_).split([32, 64], 1)
        yi = torch.addmm(bi_, x_[20:], wi_).split([32, 64, 64], 1)
        return torch.cat([yu[0], yi[0]]), torch.cat([yu[1], yi[1], yi[2]])

    for a, c in zip(run(lambda *t: dense.linear_into(t[0], plan, *t[1:])), run(former)):
        assert torch.equal(a, c)


def _graph(rng, n_users, n_items, n_inter, k):
    u = rng.integers(0, n_users, n_inter)
    i = rng.integers(0, n_items, n_inter)
    rows = np.repeat(np.arange(n_items), k)
    cols = (rows + rng.integers(1, n_items, len(rows))) % n_items
    return build_hetero_graph(u, i, n_users, n_items, rows, cols)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    return float((got.double() - want).abs().max())


def _fwd(x, w, b):
    """x @ w + b by the kernel (the weight's split, then mode 0)."""
    y = torch.empty((x.shape[0], w.shape[1]), device=x.device)
    dense.mm(x, dense.split_weight(w, True), b, [y])
    return y


def _dx(g, w):
    """g @ w.T by the kernel (mode 3)."""
    out = torch.empty((g.shape[0], w.shape[0]), device=g.device)
    dense.mm_y([g], dense.split_weight(w, False), out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", HGT_SHAPES, ids=[f"{m}x{n}" for m, n in HGT_SHAPES])
def test_products_within_twice_cublas_f32(cuda, m, n):
    rng = np.random.default_rng(m + n)
    x, w = (t.to(cuda) for t in _operands(rng, m, 256, n))
    b = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(m, n)).astype(np.float32), device=cuda)
    fwd = lambda: _fwd(x, w, b)  # noqa: E731
    dx = lambda: _dx(g, w)  # noqa: E731
    dw = lambda: dense.mm_tn(x, [g])  # noqa: E731
    cases = (("forward", fwd, torch.addmm(b, x, w), torch.addmm(b.double(), x.double(), w.double())),
             ("dx", dx, g @ w.T, g.double() @ w.double().T),
             ("dw", dw, x.T @ g, x.double().T @ g.double()))
    before = dense.LAUNCHES.count
    for name, fn, cublas, exact in cases:
        got = fn()
        assert _err(got, exact) <= 2 * _err(cublas, exact), (name, _err(got, exact), _err(cublas, exact))
        assert torch.equal(got, fn()), name
    assert dense.LAUNCHES.count - before == 6


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True], ids=["as_is", "transposed"])
def test_the_kernel_split_is_tf32_split(cuda, transpose):
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.normal(size=(256, 1280)).astype(np.float32), device=cuda)
    hi, lo = dense.split_weight(w, transpose)
    want = dense.tf32_split(w.T.contiguous() if transpose else w)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])


@pytest.mark.cuda
def test_misshapen_operands_raise(cuda):
    """On the card `linear` and `linear_into` refuse a weight the kernel does
    not take, and rows that are not float32: there is no other path there."""
    x = torch.zeros(100, 256, device=cuda)
    for w in (torch.zeros(256, 320, device=cuda), torch.zeros(256, 64, device=cuda)):
        with pytest.raises(ValueError, match="multiples of 128"):
            dense.linear(x, w)
        with pytest.raises(ValueError, match="multiples of 128"):
            dense.linear_into(x, (((100, w.shape[1]),), ((0, 100, ((0, 0),)),)), w, None)
    with pytest.raises(ValueError, match="float32"):
        dense.linear(x.double(), torch.zeros(256, 256, device=cuda, dtype=torch.float64))


@pytest.mark.cuda
def test_the_op_matches_addmm(cuda):
    rng = np.random.default_rng(5)
    x, w = (t.to(cuda) for t in _operands(rng, 5000, 256, 768))
    b = torch.as_tensor(rng.normal(size=768).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(5000, 768)).astype(np.float32), device=cuda)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = dense.linear(*leaves)
        return (y, *torch.autograd.grad((y * g).sum(), leaves))

    got = run()
    with reference_versions():
        want = run()
    for a, c in zip(got, want):  # f32 sums in another order: 1e-5 of each tensor's largest entry
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5 * float(c.detach().abs().max()))


@pytest.mark.cuda
def test_linear_into_matches_its_plain_version(cuda):
    """The HGT layer's plan at 256 wide over 3,000 users and 1,000 items:
    q, kv and every gradient against `reference_versions()` (addmm, split,
    cat on cuBLAS), within 1e-5 of each tensor's largest entry."""
    rng = np.random.default_rng(9)
    u, i = 3000, 1000
    x = torch.as_tensor(rng.normal(size=(u + i, 256)).astype(np.float32), device=cuda)
    wbs = [torch.as_tensor((rng.normal(size=shape) / 16).astype(np.float32), device=cuda)
           for shape in ((256, 768), (768,), (256, 1280), (1280,))]
    plan = (((u + i, 256), (u + 2 * i, 512)), ((0, u, ((0, 0), (1, 0))), (u, u + i, ((0, u), (1, u), (1, u + i)))))
    gq = torch.as_tensor(rng.normal(size=(u + i, 256)).astype(np.float32), device=cuda)
    gkv = torch.as_tensor(rng.normal(size=(u + 2 * i, 512)).astype(np.float32), device=cuda)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (x, *wbs)]
        q, kv = dense.linear_into(leaves[0], plan, *leaves[1:])
        return (q, kv, *torch.autograd.grad((q * gq).sum() + (kv * gkv).sum(), leaves))

    before = dense.LAUNCHES.count
    got = run()
    assert dense.LAUNCHES.count - before == 6
    with reference_versions():
        want = run()
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5 * float(c.detach().abs().max()))
    assert all(torch.equal(a, c) for a, c in zip(got, run()))


@pytest.mark.cuda
def test_a_traced_hgt_step_launches_36_products(cuda):
    rng = np.random.default_rng(6)
    g = _graph(rng, 3000, 1000, 30000, 5).to(cuda)
    model = hgt_model.HGTModel(3000, 1000, 64, hidden_dim=256, n_layers=3, heads=8,
                               hs_dtype=torch.bfloat16).to(cuda)
    model.init_params(torch.Generator(device=cuda).manual_seed(0))
    feats = torch.randn(1000, 64, device=cuda)
    tracing.clear()
    tracing.enable()
    try:
        before = dense.LAUNCHES.count
        model(feats, g, train=True).square().mean().backward()
        torch.cuda.synchronize()
        assert dense.LAUNCHES.count - before == 36
    finally:
        tracing.disable()
        tracing.clear()
    before = dense.LAUNCHES.count
    with torch.no_grad():
        model(feats, g)
    assert dense.LAUNCHES.count - before == 12
    assert cuda_build.COUNTERS["dense_3xtf32"] is dense.LAUNCHES
    assert not torch.backends.cuda.matmul.allow_tf32
