"""The port's embedding stages against the JAX package on the CPU: the
WordPiece tokenizer, the MiniLM and CLIP-ViT towers on carried JAX
parameters (f32 rtol 1e-4 / atol 1e-5, the empty-text row included), encoder
npz interchange, CLIP preprocessing and the pixel path, the seeded image
sample, the stage artifacts and their JSON keys, and `cli pipeline
--continue`. Shapes are small (hidden <= 32, <= 2 layers, <= 64 rows)."""
import json

import jax
import numpy as np
import pytest
import torch

from plotpointe_tpu.data.synthetic import synthetic_catalog as jax_catalog
from plotpointe_tpu.data.synthetic import synthetic_interactions as jax_interactions
from plotpointe_tpu.models import embed_stages as jstages
from plotpointe_tpu.models import encoders as jenc
from plotpointe_tpu.models import image_io as jio
from plotpointe_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from plotpointe_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from plotpointe_tpu.utils.artifacts import ArtifactStore as JaxStore
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.data.synthetic import synthetic_catalog, synthetic_interactions
from plotpointe_tpu_torch.models import embed_stages, encoders, image_io
from plotpointe_tpu_torch.models.tokenizer import WordPieceTokenizer
from plotpointe_tpu_torch.train.checkpoint import params_to_jax, save_checkpoint
from plotpointe_tpu_torch.utils.artifacts import ArtifactStore

F32 = dict(rtol=1e-4, atol=1e-5)
TEXT = dict(vocab_size=200, hidden=32, n_layers=2, heads=4, ffn=64, max_len=16)
_JaxVit = jenc.ViTImageEncoder  # kept: a test swaps the module's name for a narrow tower
VIT = dict(image_size=64, patch=32, hidden=32, n_layers=2, heads=4, ffn=64, out_dim=16)
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "un", "##want", "##ed", "runn", "##ing", "the", ",",
         "!", "a", "cafe", "naive", "中", "文", "e", "##e", ".", "-", "(", ")", "usb", "##c", "hub"]
TEXTS = ["unwanted running", "The, zebra!", "Café naïve", "中文 hub", "usb-c (hub).", "",
         "  \t\n ", "ÜNWANTED runńing"]


def _flat(params) -> dict:
    """A JAX pytree -> {key-path string: numpy array}."""
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _carried(module, params):
    module.load_state_dict(encoders.encoder_params_from_jax(_flat(params)))
    return module.eval()


@pytest.mark.parametrize("text", TEXTS)
def test_wordpiece_gives_jax_ids(text):
    assert WordPieceTokenizer(VOCAB).tokenize_ids(text) == JaxWordPiece(VOCAB).tokenize_ids(text)


def test_wordpiece_encode_gives_jax_ids_and_mask(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    ids, mask = WordPieceTokenizer(path).encode(TEXTS, max_len=6)
    want_ids, want_mask = JaxWordPiece(str(path)).encode(TEXTS, max_len=6)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    assert ids.dtype == np.int32 and mask.dtype == np.float32


def test_hash_tokenize_gives_jax_ids():
    ids, mask = encoders.TransformerTextEncoder(**TEXT).tokenize(TEXTS)
    want_ids, want_mask = jenc.TransformerTextEncoder(**TEXT).tokenize(TEXTS)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)


def test_text_tower_matches_jax_on_carried_params():
    """Post-LN blocks, erf-GELU, eps 1e-12, masked mean pooling; the empty
    text's all-zero mask attends uniformly and pools to 0 in both (no NaN)."""
    jt = jenc.TransformerTextEncoder(**TEXT)
    params = jt.init(jax.random.key(3))
    ids, mask = jt.tokenize(["hello world", "a much longer piece of text here", "", "one"])
    want = np.asarray(jax.jit(jt.apply)(params, ids, mask))
    got = _carried(encoders.TransformerTextEncoder(**TEXT), params)(
        torch.as_tensor(ids), torch.as_tensor(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, **F32)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got[2], want[2])  # the empty text: 0, as JAX pools it


def test_text_tower_padded_row_keeps_a_valid_token():
    """`make_minilm_encoder` pads a short batch with rows whose first token is
    valid; their outputs are finite and the real rows are unchanged."""
    jt = jenc.TransformerTextEncoder(**TEXT)
    params = jt.init(jax.random.key(4))
    tower = _carried(encoders.TransformerTextEncoder(**TEXT), params)
    ids, mask = jt.tokenize(["alpha beta", "gamma"])
    pad_ids = np.concatenate([ids, np.zeros((2, 16), np.int32)])
    pad_mask = np.concatenate([mask, np.zeros((2, 16), np.float32)])
    pad_mask[2:, 0] = 1.0
    got = tower(torch.as_tensor(pad_ids), torch.as_tensor(pad_mask)).detach().numpy()
    want = np.asarray(jax.jit(jt.apply)(params, pad_ids, pad_mask))
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got[:2], tower(torch.as_tensor(ids), torch.as_tensor(mask)).detach().numpy(),
                               **F32)


def test_vit_tower_matches_jax_on_carried_params():
    """Pre-LN blocks, QuickGELU, eps 1e-5, (row, col, channel) patches."""
    jv = jenc.ViTImageEncoder(**VIT)
    params = jv.init(jax.random.key(5))
    imgs = np.random.default_rng(0).normal(size=(5, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jv.apply)(params, imgs))
    got = _carried(encoders.ViTImageEncoder(**VIT), params)(torch.as_tensor(imgs)).detach().numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("act", ["gelu_exact", "gelu_tanh", "quick_gelu"])
def test_activations_match_jax(act):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(encoders.ACTIVATIONS[act](torch.as_tensor(x)).numpy(),
                               np.asarray(jenc.ACTIVATIONS[act](x)), **F32)


def test_encoder_npz_loads_across_packages(tmp_path):
    """An npz from JAX's `save_checkpoint` loads into the port's tower, and
    the port's `save_checkpoint` of its `state_dict` into JAX's; the same
    outputs either way."""
    jv = jenc.ViTImageEncoder(**VIT)
    params = jv.init(jax.random.key(6))
    jax_save_checkpoint(tmp_path / "j.npz", params, {"family": "clip-vision"})
    port = encoders.load_params_npz(str(tmp_path / "j.npz"), encoders.ViTImageEncoder(**VIT)).eval()
    imgs = np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jv.apply)(params, imgs))
    np.testing.assert_allclose(port(torch.as_tensor(imgs)).detach().numpy(), want, **F32)

    mine = encoders.TransformerTextEncoder(**TEXT).init_params(torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "p.npz", params_to_jax(mine.state_dict()), {"family": "minilm"})
    jt = jenc.TransformerTextEncoder(**TEXT)
    back = jenc.load_params_npz(str(tmp_path / "p.npz"), jt.init(jax.random.key(0)))
    ids, mask = jt.tokenize(["some words here", ""])
    np.testing.assert_allclose(mine.eval()(torch.as_tensor(ids), torch.as_tensor(mask)).detach().numpy(),
                               np.asarray(jax.jit(jt.apply)(back, ids, mask)), **F32)
    with pytest.raises(RuntimeError):  # a key of another tower: refused, not half-loaded
        encoders.load_params_npz(str(tmp_path / "p.npz"), encoders.ViTImageEncoder(**VIT))


def _pngs(tmp_path, rng, sizes):
    from PIL import Image

    paths = []
    for i, (h, w) in enumerate(sizes):
        p = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


def test_preprocess_clip_and_image_batch_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    paths = _pngs(tmp_path, rng, [(40, 50), (300, 224), (224, 600), (17, 33)])
    (tmp_path / "bad.png").write_bytes(b"not a png")
    uris = paths + [str(tmp_path / "bad.png"), str(tmp_path / "missing.png"), "file://" + paths[0],
                    "http://img.example/x.jpg"]
    pixels, ok = image_io.load_image_batch(uris)
    want_pixels, want_ok = jio.load_image_batch(uris)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(pixels, want_pixels)
    assert list(ok) == [True] * 4 + [False, False, True, False]


# bf16: each package rounds every op's output to bf16 in its own order; on
# unit-norm rows each lands within ~one bf16 step (2^-8) of the f32 result,
# so the two within 1e-2 (measured here: 4.0e-3)
BF16_BAND = dict(rtol=0.0, atol=1e-2)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16_BAND)])
def test_encode_image_files_matches_jax(tmp_path, monkeypatch, dtype, tol):
    """The same weights npz in both packages (a narrow tower at 224 px), two
    failures counted, the last batch padded; bf16 within its band."""
    small = dict(VIT, image_size=224, n_layers=1)
    monkeypatch.setattr(jenc, "ViTImageEncoder", lambda: _JaxVit(**small))
    monkeypatch.setattr(image_io, "ViTImageEncoder", lambda: encoders.ViTImageEncoder(**small))
    params = _JaxVit(**small).init(jax.random.key(7))
    jax_save_checkpoint(tmp_path / "w.npz", params, {})
    rng = np.random.default_rng(3)
    uris = _pngs(tmp_path, rng, [(40, 50)] * 5) + [str(tmp_path / "missing.png")]
    (tmp_path / "bad.png").write_bytes(b"junk")
    uris.insert(2, str(tmp_path / "bad.png"))
    emb, ok, fails = image_io.encode_image_files(uris, weights=str(tmp_path / "w.npz"), batch_size=4,
                                                 compute_dtype=dtype, device="cpu")
    want, want_ok, want_fails = jio.encode_image_files(uris, weights=str(tmp_path / "w.npz"),
                                                       batch_size=4, compute_dtype=dtype)
    assert fails == want_fails == 2
    np.testing.assert_array_equal(ok, want_ok)
    assert emb.shape == want.shape == (5, 16) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, np.asarray(want), **tol)


@pytest.fixture(scope="module")
def tables():
    """The same seeded tables: the port's column dicts and JAX's DataFrames
    (bit-equal generators), with a description column on some rows."""
    inter = synthetic_interactions(n_users=60, n_items=40, n_interactions=800, seed=5)
    items = synthetic_catalog(inter, n_extra_items=24, seed=5)
    jinter = jax_interactions(n_users=60, n_items=40, n_interactions=800, seed=5)
    jitems = jax_catalog(jinter, n_extra_items=24, seed=5)
    desc = np.array(["" if i % 3 else f"desc {i}" for i in range(len(items["asin"]))], dtype=object)
    items["description"], jitems["description"] = desc, desc
    return inter, items, jitems


def test_compose_item_text_equals_jax(tables):
    _, items, jitems = tables
    want = jstages.compose_item_text(jitems)
    assert embed_stages.compose_item_text(items) == want
    assert embed_stages.compose_item_text(jitems) == want
    empty = {"asin": np.array(["a", "b"], dtype=object), "title": np.array(["", None], dtype=object)}
    assert embed_stages.compose_item_text(empty) == ["unknown item", "unknown item"]
    # a missing description reads back from a DataFrame as NaN, which JAX's
    # `if row.get(...)` takes as present ("... . nan"); the port matches it
    missing = jitems.assign(description=[None if i % 3 else "d" for i in range(len(jitems))])
    assert embed_stages.compose_item_text(missing) == jstages.compose_item_text(missing)


@pytest.mark.parametrize("max_items", [1, 7, 10_000])
def test_image_sample_picks_jax_rows(tables, tmp_path, max_items):
    _, items, jitems = tables
    emb, meta = embed_stages.embed_image_stage(items, str(tmp_path / "p"), max_items=max_items, seed=11)
    want, want_meta = jstages.embed_image_stage(jitems, str(tmp_path / "j"), max_items=max_items, seed=11)
    got_asins = ArtifactStore().load_parquet(str(tmp_path / "p" / "img_items.parquet"))["asin"]
    want_asins = JaxStore().load_parquet(str(tmp_path / "j" / "img_items.parquet"))["asin"]
    assert list(got_asins) == list(want_asins)
    np.testing.assert_array_equal(emb, want)
    assert meta.keys() == want_meta.keys() and meta["n_images"] == want_meta["n_images"]


def _artifacts_equal(got_dir, want_dir, npys, parquets, jsons):
    for f in npys:
        np.testing.assert_array_equal(np.load(got_dir / f), np.load(want_dir / f))
    for f in parquets:
        assert list(ArtifactStore().load_parquet(str(got_dir / f))["asin"]) == \
            list(JaxStore().load_parquet(str(want_dir / f))["asin"])
    for f in jsons:
        got, want = json.loads((got_dir / f).read_text()), json.loads((want_dir / f).read_text())
        assert list(got) == list(want), f


def test_stage_artifacts_equal_jax(tables, tmp_path):
    """Text, image chunks + merge, unchunked image and fuse: the same file
    names, JSON keys in JAX's order, and (for the host hash paths) the same
    bits; fuse's trained values differ (its draws are torch's)."""
    from plotpointe_tpu.config import FusionConfig as JaxFusionConfig

    from plotpointe_tpu_torch.config import FusionConfig

    _, items, jitems = tables
    p, j = tmp_path / "p", tmp_path / "j"
    embed_stages.embed_text_stage(items, str(p))
    jstages.embed_text_stage(jitems, str(j))
    n_img = int(jitems["image_url"].notna().sum())
    for c, (a, b) in enumerate([(0, n_img // 2), (n_img // 2, None)]):
        embed_stages.embed_image_stage(items, str(p), chunk_start=a, chunk_end=b, chunk_id=c)
        jstages.embed_image_stage(jitems, str(j), chunk_start=a, chunk_end=b, chunk_id=c)
    _, merged = embed_stages.merge_image_chunks(str(p), 2)
    jstages.merge_image_chunks(str(j), 2)
    _artifacts_equal(p, j, ["txt.npy", "img_chunk0.npy", "img_chunk1.npy", "img.npy"],
                     ["img_items_chunk0.parquet", "img_items_chunk1.parquet", "img_items.parquet"],
                     ["txt_meta.json", "img_meta_chunk0.json", "img_meta_chunk1.json"])
    assert len(merged) == n_img
    embed_stages.embed_image_stage(items, str(p / "whole"))
    np.testing.assert_array_equal(np.load(p / "whole" / "img.npy"), np.load(p / "img.npy"))

    small = dict(output_dim=16, hidden_dim=32, epochs=2, batch_size=16)
    fused, cfg_out = embed_stages.fuse_stage(str(p), cfg=FusionConfig(**small), items=items, device="cpu")
    jfused, jcfg = jstages.fuse_stage(str(j), cfg=JaxFusionConfig(**small), items=jitems)
    assert fused.shape == np.asarray(jfused).shape == (len(items["asin"]), 16)
    np.testing.assert_allclose(np.linalg.norm(fused, axis=1), 1.0, atol=1e-5)
    assert list(cfg_out) == list(jcfg) and cfg_out["n_with_images"] == jcfg["n_with_images"] == n_img
    assert list(cfg_out["train_history"]) == list(jcfg["train_history"])
    _artifacts_equal(p, j, [], [], ["fusion_config.json"])


def test_cli_stage_commands_equal_jax(tmp_path, capsys):
    """`embed-text`, `embed-image`, `merge-images` and `fuse` through the
    port's CLI on JAX's staged parquet; the hash artifacts equal JAX's."""
    from plotpointe_tpu import cli as jcli

    jcli.main(["synth", "--out", f"{tmp_path}/s", "--users", "40", "--items", "30",
               "--interactions", "400", "--extra-items", "6"])
    for pkg, out in ((cli, "p"), (jcli, "j")):
        pkg.main(["embed-text", "--staging-prefix", f"{tmp_path}/s", "--output-prefix", f"{tmp_path}/{out}"]
                 + (["--device", "cpu"] if pkg is cli else []))
        for c, (a, b) in enumerate([(0, 5), (5, 100)]):
            pkg.main(["embed-image", "--staging-prefix", f"{tmp_path}/s", "--output-prefix",
                      f"{tmp_path}/{out}", "--chunk-start", str(a), "--chunk-end", str(b),
                      "--chunk-id", str(c)])
        pkg.main(["merge-images", "--output-prefix", f"{tmp_path}/{out}", "--n-chunks", "2"])
    capsys.readouterr()
    cli.main(["fuse", "--staging-prefix", f"{tmp_path}/s", "--embeddings-prefix", f"{tmp_path}/p",
              "--epochs", "1", "--batch-size", "8", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["shape"] == [len(JaxStore().load_parquet(f"{tmp_path}/s/items.parquet")), 128]
    _artifacts_equal(tmp_path / "p", tmp_path / "j", ["txt.npy", "img.npy"], ["img_items.parquet"],
                     ["txt_meta.json", "img_meta_chunk1.json"])


def test_pipeline_continue_skips_stages(tmp_path, capsys):
    """--continue skips stages whose artifacts exist (the JAX test's tiny
    shape, in-process, on the CPU)."""
    args = ["pipeline", "--workdir", str(tmp_path), "--users", "40", "--items", "30",
            "--interactions", "400", "--extra-items", "5", "--epochs", "1",
            "--samples-per-epoch", "500", "--eval-neg-k", "10", "--hidden-dim", "8",
            "--in-process", "--device", "cpu"]
    cli.main(args)
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done["pipeline"] == "complete" and done["skipped"] == []
    assert set(done["stage_wall_s"]) == {"synth", "validate", "embed_text", "embed_image", "fuse",
                                         "build_ui", "subset_fused", "subset_txt", "build_knn", "train"}

    cli.main(args + ["--continue"])
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "synth" in done["skipped"] and "build_knn" in done["skipped"]
    assert "fuse" in done["skipped"]
    assert set(done["stage_wall_s"]) == {"validate", "train"}


def test_pipeline_steps_carry_the_device():
    args = cli.build_parser().parse_args(["pipeline", "--workdir", "w", "--parallel", "--device", "cpu"])
    steps = cli._pipeline_steps(args)
    with_device = {n for n, s in steps.items() if s and "--device" in (s[0] if isinstance(s[0], list) else s)}
    assert with_device == {"embed_text", "embed_image", "fuse", "build_knn", "train"}
    assert [s[s.index("--chunk-id") + 1] for s in steps["embed_image"]] == ["0", "1", "2", "3"]
    assert steps["merge_images"][0][-1] == "4"
