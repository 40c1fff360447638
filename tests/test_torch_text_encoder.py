"""The port's caption encoder (`mcquic_tpu_torch/utils/textEncoder.py`)
against the JAX package's (`mcquic_tpu/utils/textEncoder.py`, which runs
transformers' `CLIPTextModel` and `CLIPProcessor`), on the CPU.

The test writes the model folder: a `CLIPTextModel` at a small geometry (2
layers, width 64, 4 heads) whose every parameter is numpy-seeded, saved
with `save_pretrained`, and a `CLIPProcessor` whose tokenizer is built from
a byte-level `vocab.json` / `merges.txt` (`writeByteLevelVocab`, 200 merges)
with `model_max_length` 77 and saved with its `tokenizer.json`, so that
transformers loads `CLIPTokenizerFast`, as it does for the published folder.

Tolerances: the pooled output, fp32 in both packages, within 1e-5 of its
largest magnitude. In fp64 the port's model within 1e-10 of
`CLIPTextModel`'s, with the attention in fp64; K3's plain version rounds the
scores and probabilities to fp32 as the JAX package's kernel does, and with
it the pooled output is held within 1e-6 of its largest magnitude. Token
ids are identical.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

os.environ.setdefault("USE_TF", "0")          # transformers would import TensorFlow otherwise

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import mcquic_tpu_torch.models.clipText as clipText
from mcquic_tpu.utils.textEncoder import ClipTextEncoder as JaxClipTextEncoder
from mcquic_tpu.utils.textEncoder import tryLoadTextEncoder as jaxTryLoad
from mcquic_tpu_torch.models.clipText import ClipTextModel, textConfig
from mcquic_tpu_torch.utils.clipTokenizer import ClipTokenizer, writeByteLevelVocab
from mcquic_tpu_torch.utils.textEncoder import (CORPUS, ClipTextEncoder, loadTextModel,
                                                readSafetensors, resolveModelFolder,
                                                tryLoadTextEncoder)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=77, hidden_act="quick_gelu", layer_norm_eps=1e-5)
CAPTIONS = [
    "A photo of a cat sitting on the grass.",
    "It's the DOG's ball, isn't it?  They'll say: 'we've won' -- 100% sure!!!",
    "3.14159 and 2,718; 42nd street, 1st of May 2024",
    "Café crème, naïve façade, Ångström, ΣΟΦΙΑΣ, İstanbul, ǅemal, straße, ﬁnale",
    "東京タワーの夜景 と 富士山 (ふじさん), 서울의 밤, 北京",
    "tabs\tand\nnewlines　and odd spaces   collapse",
    "emoji 😀👍🏽 and a family 👨‍👩‍👧, combining é and ä",
    "<|startoftext|> a caption with <|ENDOFTEXT|> inside",
    "",
    " ".join(["a very long caption"] * 40),
]


def seededClipFolder(folder: Path, seed: int = 0, eosTokenId: int = 2, dtype=torch.float32) -> Path:
    """A model folder as `save_pretrained` writes it: a `CLIPTextModel` at
    SMALL's geometry, every parameter numpy-seeded (LayerNorm scales near 1),
    and a `CLIPProcessor` over a byte-level vocabulary."""
    from transformers import (CLIPImageProcessor, CLIPProcessor, CLIPTextConfig, CLIPTextModel,
                              CLIPTokenizerFast)
    vocab = writeByteLevelVocab(folder / "vocab", CORPUS, 200)
    tokenizer = CLIPTokenizerFast(vocab_file=str(folder / "vocab" / "vocab.json"),
                                  merges_file=str(folder / "vocab" / "merges.txt"),
                                  model_max_length=77)
    CLIPProcessor(image_processor=CLIPImageProcessor(), tokenizer=tokenizer).save_pretrained(folder)
    config = CLIPTextConfig(vocab_size=len(vocab), bos_token_id=vocab["<|startoftext|>"],
                            eos_token_id=eosTokenId, pad_token_id=1, **SMALL)
    model = CLIPTextModel(config)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_norm" in name and name.endswith("weight"):
                value = 1 + rng.uniform(-0.2, 0.2, p.shape)
            elif "embedding" in name:
                value = rng.normal(size=p.shape) * 0.5
            elif name.endswith("bias"):
                value = rng.uniform(-0.1, 0.1, p.shape)
            else:
                value = rng.uniform(-1, 1, p.shape) / np.sqrt(p.shape[-1])
            p.copy_(torch.from_numpy(value))
    model.to(dtype).save_pretrained(folder)
    return folder


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return seededClipFolder(tmp_path_factory.mktemp("clip"))


@pytest.fixture(scope="module")
def encoders(folder):
    return JaxClipTextEncoder(str(folder)), ClipTextEncoder(str(folder), device="cpu")


def test_the_jax_wrapper_loads_the_fast_tokenizer(encoders):
    from transformers import CLIPTokenizerFast
    theirs, _ = encoders
    assert type(theirs._processor.tokenizer) is CLIPTokenizerFast


def test_input_ids_are_identical(encoders):
    theirs, ours = encoders
    want = theirs._processor(text=CAPTIONS, return_tensors="pt", padding=True, truncation=True)
    ids, mask = ours.tokenize(CAPTIONS)
    assert ids.shape == (len(CAPTIONS), 77)             # the long caption is cut at 77
    np.testing.assert_array_equal(ids.numpy(), want.input_ids.numpy())
    np.testing.assert_array_equal(mask.numpy(), want.attention_mask.numpy())


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=120))
def test_input_ids_of_unicode_text_are_identical(encoders, text):
    theirs, ours = encoders
    want = theirs._processor.tokenizer([text], truncation=True).input_ids
    assert ours._tokenizer([text])[0] == want


def test_pooled_output_matches_the_jax_wrapper(encoders):
    theirs, ours = encoders
    want = theirs(CAPTIONS)
    got = ours(CAPTIONS)
    assert ours.dim == theirs.dim == 64
    assert got.shape == want.shape == (len(CAPTIONS), 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def _exactAttention(q, k, v, mask=None, scale=None):
    """Softmax attention in the inputs' precision: [B, T, H, D] in and out."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = scores.masked_fill(mask[None, None] == 0, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


@pytest.mark.parametrize("eosTokenId", [2, "eos"], ids=["argmax", "first_eos"])
def test_fp64_model_matches_clip_text_model(tmp_path, eosTokenId, monkeypatch):
    """Both pooling rules; the rows up to each caption's end too."""
    from transformers import CLIPTextModel
    vocab = writeByteLevelVocab(tmp_path / "probe", CORPUS, 200)
    eos = 2 if eosTokenId == 2 else vocab["<|endoftext|>"]
    folder = seededClipFolder(tmp_path / "model", seed=3, eosTokenId=eos)
    theirs = CLIPTextModel.from_pretrained(folder, local_files_only=True).double().eval()
    ours = loadTextModel(folder).double()
    ids, mask = ClipTokenizer(folder)(CAPTIONS)
    ids, mask = torch.tensor(ids), torch.tensor(mask)
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)      # transformers builds the causal mask in it
    try:
        with torch.no_grad():
            want = theirs(ids, attention_mask=mask)
    finally:
        torch.set_default_dtype(default)
    with torch.no_grad():
        rounded = ours(ids, mask)[1]
        monkeypatch.setattr(clipText, "flashAttention", _exactAttention)
        hidden, pooled = ours(ids, mask)
    real = mask.bool()
    np.testing.assert_allclose(pooled.numpy(), want.pooler_output.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(hidden[real].numpy(), want.last_hidden_state[real].numpy(),
                               rtol=0, atol=1e-10)
    scale = float(want.pooler_output.abs().max())
    np.testing.assert_allclose(rounded.numpy(), want.pooler_output.numpy(), rtol=0,
                               atol=1e-6 * scale)


def test_pooling_on_padding_is_refused(folder):
    model = loadTextModel(folder)
    ids = torch.tensor([[5, 6, 7, 8]])                 # no EOS: the argmax (8) is padding below
    with pytest.raises(ValueError, match="padding"):
        model(ids, torch.tensor([[1, 1, 1, 0]]))


def test_encoder_runs_under_no_grad_only(folder):
    model = loadTextModel(folder).requires_grad_(True)
    ids, mask = ClipTokenizer(folder)(["a cat"])
    with pytest.raises(RuntimeError, match="no backward"):
        model(torch.tensor(ids), torch.tensor(mask))


def test_bf16_safetensors_read_by_hand_equal_torch_load(tmp_path):
    from transformers import CLIPTextConfig, CLIPTextModel
    torch.manual_seed(0)
    model = CLIPTextModel(CLIPTextConfig(vocab_size=600, **SMALL)).to(torch.bfloat16)
    model.save_pretrained(tmp_path / "st")
    model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    assert (tmp_path / "st" / "model.safetensors").is_file()
    assert (tmp_path / "bin" / "pytorch_model.bin").is_file()
    ours = readSafetensors(tmp_path / "st" / "model.safetensors")
    theirs = torch.load(tmp_path / "bin" / "pytorch_model.bin", weights_only=True)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype == torch.bfloat16
        assert torch.equal(ours[key], value), key


def test_a_whole_clip_checkpoint_loads_its_text_tower(tmp_path, folder):
    """A `CLIPConfig` folder (`text_config` nested, the vision tower and the
    projections beside the text tower) as the published one is laid out."""
    from transformers import CLIPConfig, CLIPModel
    text = json.loads((folder / "config.json").read_text())
    config = CLIPConfig(text_config=text, vision_config=dict(hidden_size=32, intermediate_size=64,
                        num_hidden_layers=1, num_attention_heads=2, image_size=32, patch_size=16))
    whole = CLIPModel(config)
    whole.text_model.load_state_dict({k[len("text_model."):]: v for k, v in
                                      readSafetensors(folder / "model.safetensors").items()})
    whole.save_pretrained(tmp_path)
    for path in folder.glob("*.json"):
        if path.name != "config.json":
            shutil.copy(path, tmp_path / path.name)
    shutil.copy(folder / "merges.txt", tmp_path / "merges.txt")
    assert textConfig(json.loads((tmp_path / "config.json").read_text()))["hidden_size"] == 64
    got = ClipTextEncoder(str(tmp_path), device="cpu")(CAPTIONS[:3])
    want = ClipTextEncoder(str(folder), device="cpu")(CAPTIONS[:3])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, JaxClipTextEncoder(str(tmp_path))(CAPTIONS[:3]), rtol=0,
                               atol=1e-5 * float(np.abs(got).max()))


RESOLVE = textwrap.dedent('''
    import json, os, sys
    os.environ["USE_TF"] = "0"
    sys.path.insert(0, {root!r})
    from mcquic_tpu.utils.textEncoder import ClipTextEncoder, tryLoadTextEncoder
    from mcquic_tpu_torch.utils import textEncoder as port
    theirs = ClipTextEncoder("acme/clip-small")(["a cat", "two dogs"])
    ours = port.ClipTextEncoder("acme/clip-small", device="cpu")(["a cat", "two dogs"])
    print(json.dumps({{"folder": str(port.resolveModelFolder("acme/clip-small")),
                      "theirs": theirs.tolist(), "ours": ours.tolist(),
                      "missing": [tryLoadTextEncoder("acme/no-such-model") is None,
                                  port.tryLoadTextEncoder("acme/no-such-model", "cpu") is None]}}))
''')


@pytest.mark.parametrize("variable", ["HF_HUB_CACHE", "HF_HOME"])
def test_hub_names_resolve_to_the_same_snapshot(tmp_path, folder, variable):
    """A cache laid out as the hub client writes it, found through HF_HUB_CACHE
    or HF_HOME/hub, in a subprocess (the hub client reads its variables when
    it is imported)."""
    base = tmp_path / "cache"
    hub = base if variable == "HF_HUB_CACHE" else base / "hub"
    repo = hub / "models--acme--clip-small"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abcd" * 5)
    snapshot = repo / "snapshots" / ("0123abcd" * 5)
    shutil.copytree(folder, snapshot, ignore=shutil.ignore_patterns("vocab"))
    shutil.copytree(folder, repo / "snapshots" / "stale")           # another commit, not named
    env = {k: v for k, v in os.environ.items()
           if k not in ("HF_HUB_CACHE", "HF_HOME", "HUGGINGFACE_HUB_CACHE", "TRANSFORMERS_CACHE",
                        "PYTORCH_TRANSFORMERS_CACHE", "PYTORCH_PRETRAINED_BERT_CACHE")}
    env.update({variable: str(base), "HF_HUB_OFFLINE": "1", "OMP_NUM_THREADS": "1"})
    proc = subprocess.run([sys.executable, "-c", RESOLVE.format(root=str(ROOT))], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["folder"] == str(snapshot)
    assert out["missing"] == [True, True]
    theirs, ours = np.array(out["theirs"]), np.array(out["ours"])
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5 * float(np.abs(theirs).max()))


def test_resolution_fails_without_a_snapshot(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        resolveModelFolder("acme/no-such-model")
    assert tryLoadTextEncoder("acme/no-such-model", device="cpu") is None
    assert jaxTryLoad(str(tmp_path / "no-such-folder")) is None


def test_the_encoder_asks_for_the_card_by_default(folder):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClipTextEncoder(str(folder))
