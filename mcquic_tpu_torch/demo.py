"""Compress / restore by file suffix (counterpart of `mcquic_tpu/demo.py`,
reference `mcquic/demo.py:45-77`): an image becomes a `.mcq`, whole or as a
grid of tiles; a `.mcq` becomes a PNG. Models come from the bundled zoo
(`assets/zoo/`, by `-qp`, sha256-checked) or from a local exported model
file, a v1 Compressor or a Neon tokenizer; nothing is downloaded. The input
image is a PNG or a baseline JPEG (`readImage`).
"""
import logging
from pathlib import Path

from mcquic_tpu_torch.container import File
from mcquic_tpu_torch.data.dataset import readImage
from mcquic_tpu_torch.data.png import writePng
from mcquic_tpu_torch.data.transforms import alignedCrop
import mcquic_tpu_torch
from mcquic_tpu_torch.models.compressor import buildModel, seededModel
from mcquic_tpu_torch.models.engine import CompressorEngine
from mcquic_tpu_torch.models.tiling import TiledFile, compressTiled, decompressTiled
from mcquic_tpu_torch.utils import resolveDevice, versionCheck
from mcquic_tpu_torch.utils.convert import (loadZoo, modelGeometry, modelsHash, toJaxParams,
                                            writeExport)

logger = logging.getLogger("mcquic_tpu_torch")
ZOO_DIR = Path(__file__).resolve().parent.parent / "assets" / "zoo"


def zooPath(qp: int) -> Path:
    slot = f"qp_{qp}_msssim"
    hashes = modelsHash()
    if slot not in hashes:
        raise RuntimeError(f"No model registered for slot `{slot}`; known: {sorted(hashes)}.")
    path = ZOO_DIR / f"{slot}_{hashes[slot].lower()}.mcquic.npz"
    if not path.exists():
        raise RuntimeError(f"Zoo model {path} is not in the checkout (nothing is downloaded); "
                           "pass --local with an exported model file.")
    return path


def loadModel(qp: int = None, local=None, device="cuda") -> CompressorEngine:
    """A zoo slot (`qp`) or a local exported model (v1 Compressor or Neon)
    -> an engine on `device`."""
    device = resolveDevice(device)
    path = Path(local) if local else zooPath(qp)
    stateDict, meta = loadZoo(path, verify=not local)
    versionCheck(meta["version"])
    model = buildModel(modelGeometry(meta))
    model.load_state_dict(stateDict, strict=True)
    return CompressorEngine(model.eval().requires_grad_(False),
                            qp=str(meta.get("qp", qp if qp is not None else -1)), device=device)


def writeSeededExport(path, key: str, geometry: dict, seed: int = 0, qp: str = "-1") -> Path:
    """An exported model of seeded weights (`models/compressor.py::seededModel`)
    in the JAX package's format (npz + json sidecar `{config, version, qp}`),
    for geometries with no trained file; `key` is the config's model key
    (`Compressor` or `Neon`)."""
    flat = toJaxParams(seededModel(geometry, seed).state_dict(), geometry)
    config = {"model": {"key": key, "params": dict(geometry)}}
    return writeExport(path, flat, {"config": config, "version": mcquic_tpu_torch.__version__,
                                    "qp": qp, "seed": seed})


def main(inputPath, outputPath=None, qp: int = None, local=None, device="cuda",
         crop: bool = False, tile: int = 0) -> Path:
    """Compress a PNG to `.mcq`, or restore a `.mcq` to PNG
    (`mcquic_tpu/demo.py:171-213`). `crop` center-crops the image to
    multiples of 128 first; `tile` > 0 codes it as a grid of tile x tile
    tiles (`models/tiling.py`). A tiled `.mcq` is recognized on restore."""
    inputPath = Path(inputPath)
    if inputPath.suffix.lower() == ".mcq":
        data = inputPath.read_bytes()
        tiled = TiledFile.isTiled(data)
        file = TiledFile.deserialize(data) if tiled else File.deserialize(data)
        if local is None and qp is None:      # qp from the file
            qp = int(file.qp if tiled else file.FileHeader.QuantizationParameter)
        engine = loadModel(qp=qp, local=local, device=device)
        restored = decompressTiled(engine, file) if tiled else engine.decompressImage(file)
        out = Path(outputPath) if outputPath else inputPath.with_suffix(".png")
        if out.is_dir():
            out = out / (inputPath.stem + ".png")
        writePng(out, restored)
        logger.info("Restored %s -> %s", inputPath, out)
        return out
    img = readImage(inputPath)
    if crop:
        img = alignedCrop(img, 128)
    engine = loadModel(qp=qp, local=local, device=device)
    file = compressTiled(engine, img, tile=tile) if tile else engine.compressImage(img)
    out = Path(outputPath) if outputPath else inputPath.with_suffix(".mcq")
    if out.is_dir():
        out = out / (inputPath.stem + ".mcq")
    out.write_bytes(file.serialize())
    logger.info("Compressed %s -> %s (%.4f bpp)", inputPath, out, file.BPP)
    return out
