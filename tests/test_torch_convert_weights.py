"""The port's weight converter and towers against Hugging Face and the JAX
package, on the CPU: tiny random-init HF models built in-process (no
network) through the port's converter give HF's outputs (f32 rtol 1e-4 /
atol 1e-5), the converter's arrays equal JAX's, `convert` reads
`model.safetensors` and `pytorch_model.bin`, and either package's npz loads
in the other. The real-checkpoint fixtures stay gated on their files, as
`tests/test_convert_weights.py`'s do; their checks (`check_real_minilm`,
`check_real_clip`) also run in `tests/test_torch_fetch_fixtures.py` on
fixtures written from random-init models at the real dimensions."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from plotpointe_tpu.models import encoders as jenc
from plotpointe_tpu.tools import convert_weights as jconv
from plotpointe_tpu_torch import cli
from plotpointe_tpu_torch.models.encoders import (
    TransformerTextEncoder, ViTImageEncoder, encoder_params_from_jax, load_params_npz)
from plotpointe_tpu_torch.tools import convert_weights as conv

F32 = dict(rtol=1e-4, atol=1e-5)
FIXTURES = Path(__file__).parent / "fixtures"
BERT = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=40, hidden_act="gelu",
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CLIP = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            image_size=32, patch_size=16, projection_dim=24, hidden_act="quick_gelu",
            attention_dropout=0.0)


def _load(module, params):
    module.load_state_dict(encoder_params_from_jax(conv._flatten(params)))
    return module.eval()


@pytest.fixture(scope="module")
def bert():
    torch.manual_seed(0)
    return transformers.BertModel(transformers.BertConfig(**BERT)).eval()


@pytest.fixture(scope="module")
def clip():
    torch.manual_seed(0)
    return transformers.CLIPVisionModelWithProjection(transformers.CLIPVisionConfig(**CLIP)).eval()


def _bert_inputs():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 120, (4, 16)).astype(np.int64)
    mask = np.ones((4, 16), np.float32)
    mask[1, 10:] = 0.0
    mask[2, 5:] = 0.0
    mask[3, 1:] = 0.0
    return ids, mask


def _bert_pooled(hf, ids, mask):
    with torch.no_grad():
        hidden = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    m = mask[..., None]
    want = (hidden * m).sum(1) / np.maximum(m.sum(1), 1.0)  # sentence-transformers mean pool
    return want / (np.linalg.norm(want, axis=1, keepdims=True) + 1e-12)


def test_minilm_conversion_output_parity(bert):
    sd = {k: v.numpy() for k, v in bert.state_dict().items()}
    tower = _load(TransformerTextEncoder(vocab_size=120, hidden=32, n_layers=2, heads=4, ffn=64, max_len=16),
                  conv.convert_minilm_state_dict(sd, max_len=16))
    ids, mask = _bert_inputs()
    got = tower(torch.as_tensor(ids), torch.as_tensor(mask)).detach().numpy()
    np.testing.assert_allclose(got, _bert_pooled(bert, ids, mask), **F32)


def test_clip_vision_conversion_output_parity(clip):
    sd = {k: v.numpy() for k, v in clip.state_dict().items()}
    tower = _load(ViTImageEncoder(image_size=32, patch=16, hidden=32, n_layers=2, heads=4, ffn=64,
                                  out_dim=24), conv.convert_clip_vision_state_dict(sd))
    imgs = np.random.default_rng(2).normal(size=(3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = clip(pixel_values=torch.tensor(imgs.transpose(0, 3, 1, 2))).image_embeds.numpy()
    want = want / (np.linalg.norm(want, axis=1, keepdims=True) + 1e-12)
    np.testing.assert_allclose(tower(torch.as_tensor(imgs)).detach().numpy(), want, **F32)


@pytest.mark.parametrize("family", ["minilm", "clip-vision"])
def test_converter_arrays_equal_jax(bert, clip, family):
    hf = bert if family == "minilm" else clip
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    fn = "convert_minilm_state_dict" if family == "minilm" else "convert_clip_vision_state_dict"
    got, want = conv._flatten(getattr(conv, fn)(sd)), conv._flatten(getattr(jconv, fn)(sd))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the key-paths are jax's own keystr of the same tree
    assert set(got) == {jax.tree_util.keystr(kp) for kp, _ in
                        jax.tree_util.tree_flatten_with_path(getattr(jconv, fn)(sd))[0]}


@pytest.mark.parametrize("safe", [True, False])
def test_convert_npz_loads_in_both_packages(bert, tmp_path, safe, capsys):
    """`convert-weights` over a saved HF directory (safetensors, or
    pytorch_model.bin through torch.load(weights_only=True)); the npz loads
    into the port's tower and JAX's, the same outputs; JAX's `convert` npz
    loads into the port's."""
    src = tmp_path / "hf"
    bert.save_pretrained(src, safe_serialization=safe)
    assert (src / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    cli.main(["convert-weights", "--family", "minilm", "--src", str(src), "--out", str(tmp_path / "p.npz"),
              "--max-len", "16"])
    assert '"family": "minilm"' in capsys.readouterr().out
    jconv.convert("minilm", str(src), str(tmp_path / "j.npz"), max_len=16)
    dims = dict(vocab_size=120, hidden=32, n_layers=2, heads=4, ffn=64, max_len=16)
    ids, mask = _bert_inputs()
    want = _bert_pooled(bert, ids, mask)
    jt = jenc.TransformerTextEncoder(**dims)
    for npz in ("p.npz", "j.npz"):
        port = load_params_npz(str(tmp_path / npz), TransformerTextEncoder(**dims)).eval()
        np.testing.assert_allclose(port(torch.as_tensor(ids), torch.as_tensor(mask)).detach().numpy(), want,
                                   **F32)
        jparams = jenc.load_params_npz(str(tmp_path / npz), jt.init(jax.random.key(0)))
        np.testing.assert_allclose(np.asarray(jax.jit(jt.apply)(jparams, ids.astype(np.int32), mask)), want,
                                   **F32)
    with pytest.raises(FileNotFoundError):
        conv.convert("minilm", str(tmp_path), str(tmp_path / "x.npz"))
    with pytest.raises(ValueError, match="unknown family"):
        conv.convert("resnet", str(src), str(tmp_path / "x.npz"))


def test_wordpiece_tokenizer():
    from plotpointe_tpu_torch.models.tokenizer import WordPieceTokenizer

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "un", "##want", "##ed", "runn",
             "##ing", "the", ",", "!", "a"]
    tok = WordPieceTokenizer(vocab)
    assert tok.tokenize_ids("unwanted running") == [4, 5, 6, 7, 8]
    assert tok.tokenize_ids("The, zebra!") == [9, 10, 1, 11]
    assert tok.tokenize_ids("UnWANTed") == [4, 5, 6]
    enc_ids, mask = tok.encode(["unwanted", ""], max_len=6)
    assert list(enc_ids[0, :5]) == [2, 4, 5, 6, 3]
    assert mask[0].sum() == 5 and mask[1].sum() == 2
    assert enc_ids[0, 5] == 0


def _fixture_params(blob):
    """The fixture's `param:a/b/0/c` arrays -> {JAX key-path string: array}."""
    flat = {}
    for k in blob.files:
        if k.startswith("param:"):
            flat["".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in k[6:].split("/"))] = blob[k]
    return flat


def _cos_rows(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return (a * b).sum(1)


def check_real_minilm(path) -> np.ndarray:
    """The MiniLM tower at its real dimensions, loaded from a `minilm_real.npz`
    (`tools/fetch_fixtures`), against the file's HF reference: cosine >=
    0.999 on every probe. Returns the tower's rows."""
    blob = np.load(path)
    ids, mask = blob["probe_ids"], blob["probe_mask"]
    tower = TransformerTextEncoder(max_len=ids.shape[1])
    tower.load_state_dict(encoder_params_from_jax(_fixture_params(blob)))
    got = tower.eval()(torch.as_tensor(ids), torch.as_tensor(mask)).detach().numpy()
    assert (_cos_rows(got, blob["ref_pooled"]) >= 0.999).all()
    return got


def check_real_clip(path) -> np.ndarray:
    """The CLIP ViT-B/32 tower loaded from a `clip_real.npz` against the
    file's HF reference: cosine >= 0.999 on every probe. Returns the tower's
    rows."""
    blob = np.load(path)
    tower = ViTImageEncoder()
    tower.load_state_dict(encoder_params_from_jax(_fixture_params(blob)))
    got = tower.eval()(torch.as_tensor(blob["probe_pixels"])).detach().numpy()
    assert (_cos_rows(got, blob["ref_embeds"]) >= 0.999).all()
    return got


@pytest.mark.skipif(not (FIXTURES / "minilm_real.npz").exists(),
                    reason="real-weight fixture absent (make it with tools/fetch_fixtures on a machine "
                           "with network access)")
def test_real_minilm_checkpoint_parity():
    check_real_minilm(FIXTURES / "minilm_real.npz")


@pytest.mark.skipif(not (FIXTURES / "clip_real.npz").exists(),
                    reason="real-weight fixture absent (make it with tools/fetch_fixtures on a machine "
                           "with network access)")
def test_real_clip_checkpoint_parity():
    check_real_clip(FIXTURES / "clip_real.npz")
