"""The port's tooling on the CPU against the JAX package: the smoke check
(kernel 12, the hash text encoder, `cli smoke`) and the profiling module
(kernel 6's read-stream probe, `Roofline` on the H100's published peaks,
`measure_device_peaks` at a small size).

Kernels 6 and 12 compute max and x * 2 + 1 (x * 2 exact), so their plain
versions are held to the Pallas kernels in interpret mode bit for bit; the
encoder is numpy on both sides and bit-equal.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from plotpointe_tpu.models.encoders import hash_text_encoder as jax_hash_text_encoder
from plotpointe_tpu.utils.profiling import _stream_probe_kernel
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.models.encoders import hash_text_encoder
from plotpointe_tpu_torch.ops import cuda_build
from plotpointe_tpu_torch.ops.elementwise import affine, affine_plain
from plotpointe_tpu_torch.tools.smoke_gpu import run_smoke
from plotpointe_tpu_torch.utils import profiling
from plotpointe_tpu_torch.utils.profiling import (
    GPU_SPECS, Roofline, measure_device_peaks, stream_probe, stream_probe_plain)


def _jax_probe(x, c, bm):
    """`measure_device_peaks`' pallas_call, built as profiling.py:145-154."""
    m, d = x.shape
    cb = jnp.full((8, 128), c, jnp.float32)
    return pl.pallas_call(
        _stream_probe_kernel(bm, d),
        grid=(m // bm,),
        in_specs=[pl.BlockSpec((bm, d), lambda g: (g, 0)),
                  pl.BlockSpec((8, 128), lambda g: (0, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda g: (g, 0)),
        out_shape=jax.ShapeDtypeStruct((m // bm * 8, 128), jnp.float32),
        interpret=True,
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel",)),
    )(x, cb)


@pytest.mark.parametrize("c", [0.0, 0.375])
def test_stream_probe_matches_pallas(c):
    x = np.random.default_rng(0).normal(size=(512, 256)).astype(np.float32)
    want = np.asarray(_jax_probe(jnp.asarray(x).astype(jnp.bfloat16), c, 64))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = stream_probe(xt, bm=64, c=c)
    assert got.shape == (64, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, stream_probe_plain(xt, 64, c))


def test_stream_probe_rejects_shapes_the_kernel_does_not_take():
    for shape, bm in (((512, 200), 64), ((500, 256), 64), ((512, 256), 60)):
        with pytest.raises(ValueError, match="probe takes"):
            stream_probe(torch.zeros(shape, dtype=torch.bfloat16), bm=bm)
    with pytest.raises(ValueError, match="bfloat16"):
        stream_probe(torch.zeros(512, 256), bm=64)


def test_affine_matches_smoke_pallas_kernel():
    """smoke_tpu.py:60-73's kernel in interpret mode against the port's
    kernel 12 on the CPU (its plain version), on values where x * 2 + 1
    rounds."""
    def kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0 + 1.0

    x = np.random.default_rng(1).normal(size=(256, 128)).astype(np.float32) * 1e3
    want = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                          in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                          out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                          interpret=True)(jnp.asarray(x))
    before = cuda_build.COUNTERS["smoke_affine"].count
    got = affine(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, affine_plain(torch.from_numpy(x)))
    assert cuda_build.COUNTERS["smoke_affine"].count == before  # no launch on the CPU
    with pytest.raises(ValueError, match="float32"):
        affine(torch.ones(4, dtype=torch.float64))


def test_hash_text_encoder_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    words = ["wireless", "mouse", "USB-C", "Kopfhörer", "écran", "наушники", "充電器", "🎧", "4K",
             "", "HDMI 2.1", "ß"]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(0, 12)))) for _ in range(296)]
    texts += ["", "x" * 400, None, "Ünïcödé ✓"]
    for kw in ({}, {"dim": 64, "n_grams": 2, "seed": 3, "max_len": 32}):
        got = hash_text_encoder(**kw)(texts)
        want = jax_hash_text_encoder(**kw)(texts)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_roofline_on_h100_peaks():
    mem = Roofline(name="stream", seconds=0.01, flops=1e6, bytes_accessed=33.5e9,
                   measured_peaks={"tflops": 900.0, "hbm_gbps": 3000.0}).report(gen="h100")
    assert mem["bound_by"] == "memory"
    assert mem["sol_fraction"] == pytest.approx(1.0)  # 33.5 GB at 3,350 GB/s is 10 ms
    assert mem["sol_fraction_dev"] == pytest.approx(3350.0 / 3000.0)
    assert mem["achieved_gbps"] == pytest.approx(3350.0)
    mm = Roofline(name="mm", seconds=0.01, flops=4.945e12, bytes_accessed=1e6).report(gen="h100")
    assert mm["bound_by"] == "compute" and "sol_fraction_dev" not in mm
    assert mm["sol_fraction"] == pytest.approx(0.5) and mm["achieved_tflops"] == pytest.approx(494.5)
    f32 = Roofline(name="f32", seconds=0.01, flops=0.67e12, dtype_tflops_key="f32_tflops")
    assert f32.report(gen="h100")["sol_fraction"] == pytest.approx(1.0)
    for gen in ("h100", "h200", "cpu"):
        assert {"bf16_tflops", "f32_tflops", "tf32_tflops", "hbm_gbps"} <= set(GPU_SPECS[gen])
    assert GPU_SPECS["h200"]["hbm_gbps"] == 4800.0


def test_detect_generation(monkeypatch):
    monkeypatch.setenv(profiling.GEN_ENV, "h200")
    assert profiling.detect_generation() == "h200"
    monkeypatch.delenv(profiling.GEN_ENV)
    want = "cpu" if not torch.cuda.is_available() else profiling.detect_generation()
    assert profiling.detect_generation() == want


def test_measure_device_peaks_small_on_cpu():
    peaks = measure_device_peaks("cpu", mm_shape=(64, 128, 64), probe_shape=(512, 256), bm=64,
                                 n_iter=2, n_rep=2)
    assert set(peaks) == {"tflops", "hbm_gbps"}
    assert all(np.isfinite(v) and v > 0 for v in peaks.values())


def test_run_smoke_on_cpu_and_cli(capsys):
    report = run_smoke("cpu")
    assert report["ok"], report
    assert set(report["checks"]) == {"device", "matmul", "kernel", "encode_one", "encode_batch"}
    assert report["checks"]["kernel"]["sum"] == 256 * 128 * 3.0
    with pytest.raises(SystemExit) as done:
        cli.main(["smoke", "--device", "cpu"])
    assert done.value.code == 0
    assert json.loads(capsys.readouterr().out)["ok"]


def test_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    report = run_smoke()
    assert not report["ok"] and not report["checks"]["device"]["ok"]
    with pytest.raises(SystemExit) as done:
        cli.main(["smoke"])
    assert done.value.code == 1
