"""`python -m mcquic_tpu_torch validate`: evaluate, export and time a model
(counterpart of `mcquic_tpu/validate/cli.py`, reference
`mcquic/validate/cli.py:40-100`).

MODEL is an exported model or a trainer checkpoint: its `params/...` and
`coder/...` arrays are taken, with the config from its json sidecar. The
export is written before the speed run, so a failing speed run does not lose it.
"""
import json
import logging
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from mcquic_tpu_torch.data import getValLoader
from mcquic_tpu_torch.models.compressor import buildModel
from mcquic_tpu_torch.models.engine import CompressorEngine
from mcquic_tpu_torch.utils import versionCheck
from mcquic_tpu_torch.utils.convert import exportModel, modelGeometry, readExport, stateDictOf
from mcquic_tpu_torch.validate.validator import Validator

logger = logging.getLogger("mcquic_tpu_torch.validate")


def loadAnyCheckpoint(path) -> Tuple[Dict[str, np.ndarray], dict]:
    """(the model's flat `params/...` and `coder/...` arrays in fp32, sidecar
    metadata) of an exported model or a trainer checkpoint."""
    flat, meta = readExport(path)
    if "config" not in meta:
        raise RuntimeError(f"{path} lacks config metadata")
    if "version" in meta:
        versionCheck(meta["version"])
    return {k: v for k, v in flat.items() if k.startswith(("params/", "coder/"))}, meta


def loadEngine(path, device="cuda") -> Tuple[CompressorEngine, Dict[str, np.ndarray], dict]:
    flat, meta = loadAnyCheckpoint(path)
    geometry = modelGeometry(meta)
    model = buildModel(geometry)
    model.load_state_dict(stateDictOf(flat, geometry), strict=True)
    return (CompressorEngine(model.eval().requires_grad_(False), qp=str(meta.get("qp", "-1")),
                             device=device), flat, meta)


def deviceName(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(path, images=None, export=None, bf16: bool = False, device="cuda") -> dict:
    """Print the validation metrics (with IMAGES), the export's path (with
    `export`), and the speed under the reference protocol, each as a line."""
    engine, flat, meta = loadEngine(Path(path), device=device)
    validator = Validator(engine)
    out = {}
    if images is not None:
        out["validation"] = validator.validate(getValLoader(str(images)))
        logger.info("validation: %s", json.dumps(out["validation"]))
        print(json.dumps(out["validation"]), flush=True)
    if export is not None:
        out["export"] = exportModel(Path(export), flat, meta["config"],
                                    qp=str(meta.get("qp", "-1")), bf16=bf16)
        logger.info("exported deploy model to %s", out["export"])
        print(out["export"], flush=True)
    encodeMpps, decodeMpps = validator.speed()
    out["speed"] = {"encodeMpps": encodeMpps, "decodeMpps": decodeMpps,
                    "device": deviceName(engine.device)}
    logger.info("speed: encode %.2f Mpps, decode %.2f Mpps", encodeMpps, decodeMpps)
    print(json.dumps(out["speed"]), flush=True)
    return out
