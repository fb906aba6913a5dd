"""`tools/fetch_fixtures` against the JAX package's, on the CPU, with the
hub patched out: `AutoTokenizer`, `AutoModel` and
`CLIPVisionModelWithProjection.from_pretrained` return seeded random-init
Hugging Face models built in this process and a `BertTokenizer` over a
vocab file in a temporary directory, so nothing is downloaded.

- At tiny dimensions (CLIP at image size 224, which the probes need) both
  tools write npz files with the same keys and the same bits in every
  array, for both families: the same state dict through numpy converters
  and the same CPU forward.
- At the real dimensions (MiniLM 6 x 384, 12 heads, ffn 1,536, vocab
  30,522; CLIP ViT-B/32 12 x 768, patch 32, projection 512) the port's tool
  writes both fixtures; the port's towers loaded from them match HF at rtol
  1e-3 / atol 1e-4 (the band of `tests/test_convert_weights.py`'s
  full-size tests) and pass the gated real-checkpoint checks of
  `tests/test_torch_convert_weights.py` (cosine >= 0.999); JAX's towers
  read the same files through JAX's own fixture reader to cosine >= 0.999.
  One model build a family, for the module.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_convert_weights import _unflatten_params  # JAX's reader of the fixtures
from test_torch_convert_weights import _fixture_params, check_real_clip, check_real_minilm

from plotpointe_tpu.models import encoders as jenc
from plotpointe_tpu.tools import fetch_fixtures as jfetch
from plotpointe_tpu_torch.models.encoders import (
    TransformerTextEncoder, ViTImageEncoder, encoder_params_from_jax)
from plotpointe_tpu_torch.tools import fetch_fixtures as fetch

REAL = dict(rtol=1e-3, atol=1e-4)  # tests/test_convert_weights.py:173,199
COS = 0.999  # the gated real-checkpoint tests' band
FILES = {"minilm": "minilm_real.npz", "clip": "clip_real.npz"}
BERT_TINY = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, max_position_embeddings=40, hidden_act="gelu",
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CLIP_TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                 image_size=224, patch_size=32, projection_dim=24, hidden_act="quick_gelu",
                 attention_dropout=0.0)
BERT_REAL = dict(vocab_size=30522, hidden_size=384, num_hidden_layers=6, num_attention_heads=12,
                 intermediate_size=1536, max_position_embeddings=512, hidden_act="gelu",
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CLIP_REAL = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
                 image_size=224, patch_size=32, projection_dim=512, hidden_act="quick_gelu",
                 attention_dropout=0.0)


def _tokenizer(path):
    """A BertTokenizer over the special tokens and the probe texts' words."""
    words = sorted({w for t in fetch.PROBE_TEXTS for w in re.findall(r"\w+|[^\w\s]", t.lower())})
    path.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]) + "\n")
    return transformers.BertTokenizer(vocab_file=str(path))


def _models(bert_cfg, clip_cfg):
    torch.manual_seed(0)
    bert = transformers.BertModel(transformers.BertConfig(**bert_cfg)).eval()
    clip = transformers.CLIPVisionModelWithProjection(transformers.CLIPVisionConfig(**clip_cfg)).eval()
    return bert, clip


def _patch_hub(mp, tok, bert, clip) -> list:
    """from_pretrained -> the given objects; returns the list of names asked for."""
    asked = []

    def serve(obj):
        return lambda name, *a, **kw: asked.append(name) or obj

    mp.setattr(transformers.AutoTokenizer, "from_pretrained", serve(tok))
    mp.setattr(transformers.AutoModel, "from_pretrained", serve(bert))
    mp.setattr(transformers.CLIPVisionModelWithProjection, "from_pretrained", serve(clip))
    return asked


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cos_rows(a, b):
    return (_unit(a) * _unit(b)).sum(1)


@pytest.mark.parametrize("family", ["minilm", "clip"])
def test_fixtures_equal_the_jax_tools_bits(tmp_path, monkeypatch, family):
    bert, clip = _models(BERT_TINY, CLIP_TINY)
    asked = _patch_hub(monkeypatch, _tokenizer(tmp_path / "vocab.txt"), bert, clip)
    jfetch.main(["--out", str(tmp_path / "jax"), "--family", family])
    fetch.main(["--out", str(tmp_path / "port"), "--family", family, "--device", "cpu"])
    hub = [fetch.MINILM, fetch.MINILM] if family == "minilm" else [fetch.CLIP]
    assert asked == hub + hub
    want, got = np.load(tmp_path / "jax" / FILES[family]), np.load(tmp_path / "port" / FILES[family])
    assert sorted(got.files) == sorted(want.files)
    probes = ({"probe_ids", "probe_mask", "ref_pooled"} if family == "minilm"
              else {"probe_pixels", "ref_embeds"})
    assert set(got.files) - probes == {k for k in got.files if k.startswith("param:")}
    for k in want.files:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_fetch_fixtures_cpu_and_its_errors(tmp_path, monkeypatch):
    """Without `--device` the reference forward asks for the card; without
    `transformers` the tool says which package it needs."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fetch.main(["--out", str(tmp_path), "--family", "clip"])
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        fetch.main(["--out", str(tmp_path), "--family", "minilm", "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """Random-init HF models at the real dimensions, one build a family, and
    the port tool's fixtures written from them."""
    d = tmp_path_factory.mktemp("real_fixtures")
    bert, clip = _models(BERT_REAL, CLIP_REAL)
    with pytest.MonkeyPatch.context() as mp:
        _patch_hub(mp, _tokenizer(d / "vocab.txt"), bert, clip)
        fetch.main(["--out", str(d), "--device", "cpu"])
    return {"dir": d, "minilm": bert, "clip": clip}


def _hf_rows(real, family, blob):
    """HF's output on the file's probes, run here, unit rows."""
    with torch.no_grad():
        if family == "minilm":
            ids, mask = blob["probe_ids"].astype(np.int64), blob["probe_mask"]
            hidden = real["minilm"](input_ids=torch.as_tensor(ids),
                                    attention_mask=torch.as_tensor(mask)).last_hidden_state.numpy()
            return _unit((hidden * mask[..., None]).sum(1) / mask.sum(1, keepdims=True))
        pixels = np.ascontiguousarray(blob["probe_pixels"].transpose(0, 3, 1, 2))
        return _unit(real["clip"](pixel_values=torch.as_tensor(pixels)).image_embeds.numpy())


def test_real_dimension_fixtures_are_written(real):
    mini, clip = (np.load(real["dir"] / FILES[f]) for f in ("minilm", "clip"))
    assert mini["probe_ids"].dtype == np.int32 and mini["probe_ids"].shape == (fetch.TXT_BATCH, fetch.TXT_LEN)
    assert mini["probe_mask"].shape == (4, 32) and mini["ref_pooled"].shape == (4, 384)
    assert mini["param:tok_emb"].shape == (30522, 384) and mini["param:pos_emb"].shape == (32, 384)
    assert clip["probe_pixels"].shape == (2, 224, 224, 3) and clip["ref_embeds"].shape == (2, 512)
    assert clip["param:patch_proj/w"].shape == (32 * 32 * 3, 768) and clip["param:proj/w"].shape == (768, 512)
    n_blocks = {f: len({k.split("/")[1] for k in b.files if k.startswith("param:blocks/")})
                for f, b in (("minilm", mini), ("clip", clip))}
    assert n_blocks == {"minilm": 6, "clip": 12}
    for blob in (mini, clip):
        assert all(np.isfinite(blob[k]).all() for k in blob.files)


@pytest.mark.parametrize("family", ["minilm", "clip"])
def test_real_dimension_port_towers_match_hf(real, family):
    """The port's towers at their defaults (the real dimensions) loaded from
    the written file against HF run here on the same probes; the file's
    reference is HF's output too."""
    blob = np.load(real["dir"] / FILES[family])
    flat = _fixture_params(blob)
    if family == "minilm":
        tower = TransformerTextEncoder(max_len=fetch.TXT_LEN)
        tower.load_state_dict(encoder_params_from_jax(flat))
        got = tower.eval()(torch.as_tensor(blob["probe_ids"]), torch.as_tensor(blob["probe_mask"]))
        ref = blob["ref_pooled"]
    else:
        tower = ViTImageEncoder()
        tower.load_state_dict(encoder_params_from_jax(flat))
        got = tower.eval()(torch.as_tensor(blob["probe_pixels"]))
        ref = blob["ref_embeds"]
    got, want = got.detach().numpy(), _hf_rows(real, family, blob)
    np.testing.assert_allclose(got, want, **REAL)
    np.testing.assert_allclose(_unit(ref), want, **REAL)
    assert (_cos_rows(got, want) >= COS).all()


@pytest.mark.parametrize("family", ["minilm", "clip"])
def test_real_dimension_gated_checks_pass(real, family):
    """The bodies of the gated real-checkpoint tests on the written files."""
    check = check_real_minilm if family == "minilm" else check_real_clip
    got = check(real["dir"] / FILES[family])
    np.testing.assert_allclose(got, _hf_rows(real, family, np.load(real["dir"] / FILES[family])), **REAL)


@pytest.mark.parametrize("family", ["minilm", "clip"])
def test_real_dimension_files_load_in_jax_towers(real, family):
    """One file serves both packages: JAX's towers read the port-written
    file as JAX's gated tests read theirs."""
    blob = np.load(real["dir"] / FILES[family])
    params = _unflatten_params(blob)
    if family == "minilm":
        enc = jenc.TransformerTextEncoder(vocab_size=30522, hidden=384, n_layers=6, heads=12, ffn=1536,
                                          max_len=fetch.TXT_LEN)
        got = enc.apply(params, jnp.asarray(blob["probe_ids"]), jnp.asarray(blob["probe_mask"]))
        ref = blob["ref_pooled"]
    else:
        enc = jenc.ViTImageEncoder(image_size=224, patch=32, hidden=768, n_layers=12, heads=12, ffn=3072,
                                   out_dim=512)
        got = jax.jit(enc.apply)(params, jnp.asarray(blob["probe_pixels"]))
        ref = blob["ref_embeds"]
    assert (_cos_rows(np.asarray(got), ref) >= COS).all()
