"""The config system: YAML -> typed dataclasses (counterpart of
`mcquic_tpu/config.py`, reference `mcquic/config.py:52-195`).

  * `General{key, params}`: a registry key and its constructor kwargs, for
    the model, the optimizer, the schedule and the hooks;
  * unknown keys are refused, `$`-prefixed schema-version keys dropped;
  * the learning rate scales with the global batch (`Train.scaledOptim`).

The files are read with the port's own YAML-subset reader
(`utils/yamlsubset.py`): the port does not import `yaml`.
"""
from __future__ import annotations

import math
from copy import deepcopy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from mcquic_tpu_torch.utils import yamlsubset


def _require(d: dict, key: str, ctx: str):
    if key not in d:
        raise KeyError(f"Missing required key `{key}` in config section `{ctx}`.")
    return d[key]


def _reject_unknown(d: dict, allowed: set, ctx: str):
    unknown = set(d.keys()) - allowed
    if unknown:
        raise KeyError(f"Unknown keys {sorted(unknown)} in config section `{ctx}`. Allowed: {sorted(allowed)}.")


@dataclass
class General:
    """A `{key, params}` pair: registry lookup key + ctor kwargs."""
    key: str
    params: Dict[str, Any] = field(default_factory=dict)

    @property
    def Key(self) -> str:
        return self.key

    @property
    def Params(self) -> Dict[str, Any]:
        return self.params

    @staticmethod
    def fromDict(d: dict, ctx: str) -> "General":
        _reject_unknown(d, {"key", "params"}, ctx)
        return General(key=str(_require(d, "key", ctx)), params=dict(d.get("params") or {}))

    def toDict(self) -> dict:
        return {"key": self.key, "params": deepcopy(self.params)}


@dataclass
class GPU:
    """Device-count request, kept for config compatibility (`config.py:63-95`);
    the port trains on one card."""
    gpus: int = 1
    vRam: int = -1
    wantsMore: bool = False

    @staticmethod
    def fromDict(d: dict) -> "GPU":
        _reject_unknown(d, {"gpus", "vRam", "wantsMore"}, "train.gpu")
        return GPU(gpus=int(d.get("gpus", 1)), vRam=int(d.get("vRam", -1)), wantsMore=bool(d.get("wantsMore", False)))

    def toDict(self) -> dict:
        return {"gpus": self.gpus, "vRam": self.vRam, "wantsMore": self.wantsMore}


@dataclass
class Train:
    totalStep: int
    batchSize: int
    epoch: int
    valFreq: int
    trainSet: str
    valSet: str
    saveDir: str
    target: str
    optim: General
    schdr: General
    gpu: GPU
    hooks: Optional[List[General]] = None
    externalLib: Optional[List[str]] = None
    # Optional square crop edge for training batches. Default (None) derives
    # from the model: Neon-family size[0]*16, v1 Compressor 512 (the
    # reference's fixed crop, transforms.py:21). Explicit values let v1 train
    # on smaller crops (more optimizer steps per pixel budget) — the codec is
    # fully convolutional, so train/eval resolutions are independent.
    cropSize: Optional[int] = None

    _ALLOWED = {"totalStep", "batchSize", "epoch", "valFreq", "trainSet", "valSet",
                "saveDir", "target", "optim", "schdr", "gpu", "hooks", "externalLib",
                "cropSize"}

    @property
    def TotalStep(self) -> int:
        return self.totalStep

    @property
    def BatchSize(self) -> int:
        return self.batchSize

    @property
    def Epoch(self) -> int:
        return self.epoch

    @property
    def ValFreq(self) -> int:
        return self.valFreq

    @property
    def TrainSet(self) -> str:
        return self.trainSet

    @property
    def ValSet(self) -> str:
        return self.valSet

    @property
    def SaveDir(self) -> str:
        return self.saveDir

    @property
    def Target(self) -> str:
        return self.target

    @property
    def CropSize(self) -> Optional[int]:
        return self.cropSize

    def scaledOptim(self, worldSize: int) -> General:
        """LR auto-scale by global batch (reference `config.py:144-153`):
        lr / 2^(3 - log2(batchSize * worldSize) / 2), so 1e-4 at batch 8 on
        one card becomes 3.54e-5."""
        globalBatch = self.batchSize * max(1, worldSize)
        exponent = math.log2(globalBatch)
        scale = 3 - exponent / 2
        if "lr" in self.optim.Params:
            optim = General(self.optim.key, deepcopy(self.optim.params))
            optim.params["lr"] /= (2 ** scale)
            return optim
        return self.optim

    @property
    def Optim(self) -> General:
        return self.optim

    @property
    def Schdr(self) -> General:
        return self.schdr

    @property
    def GPU(self) -> GPU:
        return self.gpu

    @property
    def Hooks(self) -> List[General]:
        return list(self.hooks or [])

    @property
    def ExternalLib(self) -> List[str]:
        return list(self.externalLib or [])

    @staticmethod
    def fromDict(d: dict) -> "Train":
        _reject_unknown(d, Train._ALLOWED, "train")
        hooks = d.get("hooks")
        return Train(
            totalStep=int(_require(d, "totalStep", "train")),
            batchSize=int(_require(d, "batchSize", "train")),
            epoch=int(_require(d, "epoch", "train")),
            valFreq=int(_require(d, "valFreq", "train")),
            trainSet=str(_require(d, "trainSet", "train")),
            valSet=str(_require(d, "valSet", "train")),
            saveDir=str(_require(d, "saveDir", "train")),
            target=str(_require(d, "target", "train")),
            optim=General.fromDict(_require(d, "optim", "train"), "train.optim"),
            schdr=General.fromDict(_require(d, "schdr", "train"), "train.schdr"),
            gpu=GPU.fromDict(d.get("gpu") or {}),
            hooks=[General.fromDict(h, "train.hooks[]") for h in hooks] if hooks else None,
            externalLib=[str(x) for x in d["externalLib"]] if d.get("externalLib") else None,
            cropSize=int(d["cropSize"]) if d.get("cropSize") else None,
        )

    def toDict(self) -> dict:
        out = {
            "totalStep": self.totalStep, "batchSize": self.batchSize, "epoch": self.epoch,
            "valFreq": self.valFreq, "trainSet": self.trainSet, "valSet": self.valSet,
            "saveDir": self.saveDir, "target": self.target,
            "optim": self.optim.toDict(), "schdr": self.schdr.toDict(), "gpu": self.gpu.toDict(),
        }
        if self.hooks:
            out["hooks"] = [h.toDict() for h in self.hooks]
        if self.externalLib:
            out["externalLib"] = list(self.externalLib)
        if self.cropSize:
            out["cropSize"] = self.cropSize
        return out


@dataclass
class Config:
    model: General
    train: Optional[Train] = None

    @property
    def Model(self) -> General:
        return self.model

    @property
    def Train(self) -> Train:
        return self.train

    def serialize(self) -> dict:
        out = {"model": self.model.toDict()}
        if self.train is not None:
            out["train"] = self.train.toDict()
        return out

    @staticmethod
    def deserialize(data: dict) -> "Config":
        data = {key: value for key, value in data.items() if "$" not in key}
        _reject_unknown(data, {"model", "train"}, "<root>")
        model = General.fromDict(_require(data, "model", "<root>"), "model")
        train = Train.fromDict(data["train"]) if "train" in data and data["train"] is not None else None
        return Config(model=model, train=train)

    @staticmethod
    def load(path: str) -> "Config":
        return Config.deserialize(yamlsubset.load(path))
