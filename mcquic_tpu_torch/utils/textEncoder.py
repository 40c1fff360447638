"""Caption -> embedding for the text-conditioned generator (counterpart of
`mcquic_tpu/utils/textEncoder.py`), with no `transformers`.

`ClipTextEncoder(modelName)` reads the folder `CLIPTextModel.from_pretrained
(modelName, local_files_only=True)` reads: `modelName` itself where it is a
folder, else the snapshot of the hub name in the local cache
(`resolveModelFolder`). From it:
  * `config.json`, a `CLIPTextConfig` or a whole `CLIPConfig`'s `text_config`;
  * `model.safetensors`, read by hand (`readSafetensors`), else
    `pytorch_model.bin` through `torch.load(weights_only=True)`; the keys
    under `text_model.` load strictly into `models/clipText.py`, the rest
    of a whole CLIP checkpoint (the vision tower, the projections) is not
    read; weights are taken to fp32, as `from_pretrained` loads them;
  * `vocab.json`, `merges.txt` and `tokenizer_config.json`, through
    `utils/clipTokenizer.py`.
The encoder runs on the card unless `device="cpu"` is given; its causal
self-attention launches K3 once per layer per call. `__call__(captions)`
returns the pooled output [n, hidden] as fp32 numpy, as the JAX wrapper's
`pooler_output.numpy()`. The published weights
(`openai/clip-vit-base-patch32`) are not in the repository, and nothing is
downloaded: `writeSeededClipText` writes a folder of seeded weights at a
given geometry over a byte-level vocabulary instead.
"""
import json
import logging
import os
import struct
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mcquic_tpu_torch.models.clipText import ClipTextModel, textConfig
from mcquic_tpu_torch.utils import exactFp32, resolveDevice
from mcquic_tpu_torch.utils.clipTokenizer import ClipTokenizer, writeByteLevelVocab

logger = logging.getLogger("mcquic_tpu_torch.text")

_MODEL = "openai/clip-vit-base-patch32"
PREFIX = "text_model."
# the weights' types, and I64 for the `position_ids` older checkpoints carry
SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64}


def hubCache() -> Path:
    """The cache `from_pretrained` reads: HF_HUB_CACHE, else HF_HOME/hub,
    else ~/.cache/huggingface/hub."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"]).expanduser()
    home = os.environ.get("HF_HOME") or os.path.join("~", ".cache", "huggingface")
    return Path(home).expanduser() / "hub"


def resolveModelFolder(modelName) -> Path:
    """A local folder, or a hub name's snapshot in `hubCache()`:
    `models--{org}--{name}/refs/main` names the commit, whose files are
    under `snapshots/<commit>/`. Raises FileNotFoundError when neither
    holds a `config.json`."""
    path = Path(modelName)
    if path.is_dir():
        return path
    repo = hubCache() / ("models--" + str(modelName).replace("/", "--"))
    ref = repo / "refs" / "main"
    commit = ref.read_text().strip() if ref.is_file() else "main"
    snapshot = repo / "snapshots" / commit
    if not (snapshot / "config.json").is_file():
        raise FileNotFoundError(f"{modelName} is neither a folder nor cached under {repo}")
    return snapshot


def readSafetensors(path) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file: an 8-byte little-endian header length, a JSON
    header of {name: {dtype, shape, data_offsets}}, then the raw
    little-endian tensors."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors are little-endian; this reader runs on little-endian hosts")
    data = bytearray(Path(path).read_bytes())
    (size,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + size].decode("utf-8"))
    base, out = 8 + size, {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {entry['dtype']}, which is not read")
        begin, end = entry["data_offsets"]
        count = int(np.prod(entry["shape"], dtype=np.int64))
        itemSize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemSize:
            raise ValueError(f"{path}: tensor {name} holds {end - begin} bytes for {entry['shape']}")
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=base + begin)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(entry["shape"]).clone()
    return out


def readWeights(folder: Path) -> Dict[str, torch.Tensor]:
    """`model.safetensors`, else `pytorch_model.bin`, as a state dict."""
    if (folder / "model.safetensors").is_file():
        return readSafetensors(folder / "model.safetensors")
    if (folder / "pytorch_model.bin").is_file():
        return torch.load(folder / "pytorch_model.bin", map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{folder} holds neither model.safetensors nor pytorch_model.bin")


def loadTextModel(folder: Path) -> ClipTextModel:
    """The text tower of a model folder, fp32, on the CPU."""
    config = textConfig(json.loads((folder / "config.json").read_text("utf-8")))
    model = ClipTextModel(config)
    weights = {key: value for key, value in readWeights(folder).items()
               if key.startswith(PREFIX) and key != PREFIX + "embeddings.position_ids"}
    model.load_state_dict({key: value.float() for key, value in weights.items()}, strict=True)
    return model.eval().requires_grad_(False)


class ClipTextEncoder:
    """Frozen CLIP text encoder; returns pooled embeddings [n, hidden]."""

    def __init__(self, modelName: str = _MODEL, device=None):
        self.device = resolveDevice("cuda" if device is None else device)
        try:
            folder = resolveModelFolder(modelName)
            model = loadTextModel(folder)
            self._tokenizer = ClipTokenizer(folder)
        except (OSError, KeyError, ValueError, RuntimeError) as e:
            raise RuntimeError(
                f"CLIP weights for {modelName} are not cached locally and this "
                "environment cannot download them. Pre-cache with "
                "`transformers-cli download` on a connected machine, or feed "
                "precomputed caption embeddings to the generator's "
                "textConditioned path directly.") from e
        self._model = model.to(self.device)

    @property
    def dim(self) -> int:
        return self._model.config["hidden_size"]

    def tokenize(self, captions: Sequence[str]):
        """(input_ids, attention_mask) as int64 tensors [n, T] on the encoder's device."""
        ids, mask = self._tokenizer(list(captions))
        return (torch.tensor(ids, dtype=torch.int64, device=self.device),
                torch.tensor(mask, dtype=torch.int64, device=self.device))

    def __call__(self, captions: List[str]) -> np.ndarray:
        ids, mask = self.tokenize(captions)
        with torch.no_grad(), exactFp32():
            _, pooled = self._model(ids, mask)
        return pooled.cpu().numpy()


def tryLoadTextEncoder(modelName: str = _MODEL, device=None) -> Optional[ClipTextEncoder]:
    try:
        return ClipTextEncoder(modelName, device)
    except RuntimeError as e:
        logger.warning("text encoder unavailable: %s", e)
        return None


CORPUS = ("a photo of a cat sitting on the grass in the sun",
          "the quick brown fox jumps over the lazy dog",
          "a red car parked in front of an old house at night",
          "two people walking along the beach with their dog",
          "a bowl of fruit on a wooden table, apples and oranges")


def writeSeededClipText(folder, config: dict = None, seed: int = 0, merges: int = 200,
                        corpus: Sequence[str] = CORPUS) -> Path:
    """A model folder of seeded weights for runs that have no published one:
    `config.json` (the text tower's settings, `config` over `textConfig`'s
    defaults, which are openai/clip-vit-base-patch32's), `pytorch_model.bin`
    (each weight N(0, 0.02) as transformers initializes CLIP, the
    LayerNorms at 1 and 0) and a byte-level vocabulary of `merges` merges
    learned from `corpus`, its start and end tokens at the last two ids."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    c = textConfig(config or {})
    (folder / "config.json").write_text(json.dumps({**c, "model_type": "clip_text_model"}))
    generator = torch.Generator().manual_seed(seed)
    weights = {}
    for key, value in ClipTextModel(c).state_dict().items():
        if "layer_norm" in key:
            weights[key] = torch.ones_like(value) if key.endswith("weight") else torch.zeros_like(value)
        else:
            weights[key] = torch.randn(value.shape, generator=generator) * 0.02
    torch.save(weights, folder / "pytorch_model.bin")
    writeByteLevelVocab(folder, corpus, merges, vocabSize=c["vocab_size"],
                        maxLength=c["max_position_embeddings"])
    return folder
