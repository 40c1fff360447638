"""Compress / restore by file suffix (counterpart of `mcquic_tpu/demo.py`,
reference `mcquic/demo.py:45-77`): an image becomes a `.mcq`, whole or as a
grid of tiles; a `.mcq` becomes a PNG. Models come from the zoo, by `-qp`
(and `--mse`), or from a local exported model file, a v1 Compressor or a
Neon tokenizer. The input image is a PNG, a JPEG, a BMP or a WebP, in every
form PIL reads (`readImage`).

A zoo slot resolves as `mcquic_tpu/demo.py:36-129` resolves it, under the
same environment variables, so both packages find the same files:
  * MCQUIC_MODELS_HASH_FILE: the hash table (slot -> sha256 prefix), by
    default the package's `models_hash.json`;
  * MCQUIC_BUNDLED_ZOO: the checkout's zoo, by default `assets/zoo`; a file
    there is checked in place and must have its json sidecar;
  * MCQUIC_CACHE: where fetched files go (`zoo/` under it), by default
    `~/.cache/mcquic_tpu`, the JAX package's cache;
  * MCQUIC_MODELS_URL: the base URL files are fetched from, with
    `urllib.request` (a `file://` mirror is a local directory), payload and
    sidecar; a payload whose sidecar cannot be fetched, or whose sha256 does
    not start with its registered prefix, is removed.
"""
import logging
import os
import urllib.request
from pathlib import Path

from mcquic_tpu_torch.container import File
from mcquic_tpu_torch.data.dataset import readImage
from mcquic_tpu_torch.data.png import writePng
from mcquic_tpu_torch.data.transforms import alignedCrop
import mcquic_tpu_torch
from mcquic_tpu_torch.models.compressor import buildModel, seededModel
from mcquic_tpu_torch.models.engine import CompressorEngine
from mcquic_tpu_torch.models.tiling import TiledFile, compressTiled, decompressTiled
from mcquic_tpu_torch.utils import hashOfFile, resolveDevice, versionCheck
from mcquic_tpu_torch.utils.convert import (loadZoo, modelGeometry, modelsHash, toJaxParams,
                                            writeExport)

logger = logging.getLogger("mcquic_tpu_torch")
ZOO_DIR = Path(__file__).resolve().parent.parent / "assets" / "zoo"


def bundledZooDir() -> Path:
    return Path(os.environ.get("MCQUIC_BUNDLED_ZOO", ZOO_DIR))


def zooCacheDir() -> Path:
    cache = Path(os.environ.get("MCQUIC_CACHE", os.path.expanduser("~/.cache/mcquic_tpu"))) / "zoo"
    cache.mkdir(parents=True, exist_ok=True)
    return cache


def zooPath(qp: int, mse: bool = False) -> Path:
    """The verified local file of zoo slot `qp_{qp}_{mse|msssim}`: the
    bundled zoo's, else the cache's, else fetched into the cache from
    MCQUIC_MODELS_URL (`mcquic_tpu/demo.py::fetchZooModel`)."""
    key = f"qp_{qp}_{'mse' if mse else 'msssim'}"
    hashes = modelsHash()
    if key not in hashes:
        known = sorted(hashes) or ["<none registered>"]
        raise RuntimeError(f"No model registered for slot `{key}`. Known slots: {known}. "
                           "Register artifacts with ci/update_model_hash.py or pass --local.")
    digest = hashes[key].lower()
    name = f"{key}_{digest}.mcquic.npz"
    bundled = bundledZooDir() / name
    if bundled.exists():
        actual = hashOfFile(bundled)
        if not actual.startswith(digest):
            raise RuntimeError(f"Bundled zoo asset {bundled} does not match registered hash "
                               f"prefix {digest} (got {actual[:len(digest)]}).")
        if not bundled.with_suffix(".json").exists():
            raise RuntimeError(f"Bundled zoo asset {bundled} lacks its metadata sidecar "
                               f"{bundled.with_suffix('.json').name}; the artifact is incomplete "
                               "— re-export it with `python -m mcquic_tpu_torch validate -e`.")
        return bundled
    path = zooCacheDir() / name
    if not path.exists():
        base = os.environ.get("MCQUIC_MODELS_URL", "")
        if not base:
            raise RuntimeError("Model zoo URL not configured (set MCQUIC_MODELS_URL); "
                               "this environment has no network egress — use --local or a "
                               "file:// mirror.")
        if not base.endswith("/"):
            base += "/"
        logger.info("downloading %s", base + name)
        urllib.request.urlretrieve(base + name, path)
        sidecar = name[:-len(".npz")] + ".json"
        try:
            urllib.request.urlretrieve(base + sidecar, path.with_suffix(".json"))
        except Exception as exc:
            # a payload without its sidecar is unusable: the next call fetches both
            path.unlink(missing_ok=True)
            raise RuntimeError(f"Failed to fetch model metadata sidecar {sidecar}: {exc}") from exc
    actual = hashOfFile(path)
    if not actual.startswith(digest):
        path.unlink(missing_ok=True)
        raise RuntimeError(f"Hash mismatch for {name}: expected prefix {digest}, got "
                           f"{actual[:len(digest)]} — corrupted download removed.")
    return path


def loadModel(qp: int = None, local=None, device="cuda", mse: bool = False) -> CompressorEngine:
    """A zoo slot (`qp`, the MSE-trained one with `mse`) or a local exported
    model (v1 Compressor or Neon) -> an engine on `device`."""
    device = resolveDevice(device)
    path = Path(local) if local else zooPath(qp, mse)
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
         crop: bool = False, tile: int = 0, mse: bool = False) -> Path:
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
        engine = loadModel(qp=qp, local=local, device=device, mse=mse)
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
    engine = loadModel(qp=qp, local=local, device=device, mse=mse)
    file = compressTiled(engine, img, tile=tile) if tile else engine.compressImage(img)
    out = Path(outputPath) if outputPath else inputPath.with_suffix(".mcq")
    if out.is_dir():
        out = out / (inputPath.stem + ".mcq")
    out.write_bytes(file.serialize())
    logger.info("Compressed %s -> %s (%.4f bpp)", inputPath, out, file.BPP)
    return out
