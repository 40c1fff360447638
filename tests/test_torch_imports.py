"""The PyTorch port needs torch, numpy and the standard library only.

The machine with the card has none of the JAX package's other dependencies,
so a subprocess blocks them (and the JAX package itself) with a
`sys.meta_path` finder, then imports every module of `mcquic_tpu_torch` and
`chip_smoke`, and runs the tiny model's PNG -> .mcq -> PNG round trip
through `python -m mcquic_tpu_torch --device cpu`, a tiny generator's
sampling through `python -m mcquic_tpu_torch generate --device cpu`, and
`train -h` and a 2-step tiny training run through
`python -m mcquic_tpu_torch train --device cpu`, 2-step runs of a tiny
Neon (`train`) and of a tiny generator over it (`train -G`), and the
`dataset` command (JPEG encoder, tar shards) followed by a 2-step run that
reads its shards (JPEG decoder, shard loader), the codec compressing one of
the JPEGs; and the train CLI as two data-parallel processes under
MCQUIC_COORDINATOR, MCQUIC_NUM_PROCESSES and MCQUIC_PROCESS_ID (gloo on the
CPU), each reading its own tar shard, one export between them; and the web
demo's handler and the image decoders (progressive JPEG, BMP, 16-bit PNG)
through `handleUpload` and the codec CLI; and the caption encoder
(`utils/textEncoder.py`) on a seeded folder, with the tokenizer and model
libraries the JAX package's encoder loads blocked too.
"""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from mcquic_tpu_torch.data.png import readPng, writePng

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mcquic_tpu_torch"
TINY = ROOT / "assets" / "tiny_demo_672919fb.mcquic.npz"
BLOCKED = ["jax", "jaxlib", "flax", "optax", "msgpack", "PIL", "ml_dtypes", "yaml", "click",
           "joblib", "triton", "streamlit", "transformers", "tokenizers", "safetensors",
           "huggingface_hub", "regex", "ftfy", "mcquic_tpu"]

GUARD = textwrap.dedent('''
    import importlib, pkgutil, runpy, sys
    BLOCKED = {blocked!r}

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"{{name}} is not on the machine with the card")
            return None

    sys.meta_path.insert(0, Block())
    for name in [n for n in sys.modules if blocked(n)]:
        del sys.modules[name]
    sys.path.insert(0, {root!r})

    import mcquic_tpu_torch
    names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
        mcquic_tpu_torch.__path__, "mcquic_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    print("imported", len(names), flush=True)
    for argv in {runs!r}:
        sys.argv = ["mcquic_tpu_torch", *argv]
        try:
            runpy.run_module("mcquic_tpu_torch", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            if e.code:
                raise
    leaked = sorted(n for n in sys.modules if blocked(n))
    assert not leaked, leaked
    print("round trip ok", flush=True)
''')


def test_port_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    image = readPng(ROOT / "assets" / "photo_768x512.png")[150:230, 300:396]   # 80 x 96
    writePng(tmp_path / "in.png", image)
    runs = [["--device", "cpu", "--local", str(TINY), str(tmp_path / "in.png"),
             str(tmp_path / "out.mcq")],
            ["--device", "cpu", "--local", str(TINY), str(tmp_path / "out.mcq"),
             str(tmp_path / "out.png")]]
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=runs)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "round trip ok" in proc.stdout
    # the JAX package restores the file the guarded port wrote to the same image
    from mcquic_tpu.container import File as JaxFile
    from mcquic_tpu.demo import loadModel
    restored = readPng(tmp_path / "out.png")
    want = loadModel(local=str(TINY)).decompressImage(
        JaxFile.deserialize((tmp_path / "out.mcq").read_bytes()))
    assert restored.shape == image.shape
    np.testing.assert_array_equal(restored, want)


def test_generate_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    from test_torch_generate import writeTinyCheckpoint
    checkpoint = tmp_path / "gen.ckpt.npz"
    writeTinyCheckpoint(checkpoint, seed=2)
    runs = [["generate", "-c", "0,5,9", "--top-k", "3", "--seed", "1", "--device", "cpu",
             str(checkpoint), str(tmp_path / "samples")]]
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=runs)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "round trip ok" in proc.stdout
    pngs = sorted((tmp_path / "samples").iterdir())
    assert [p.name for p in pngs] == ["class0_0.png", "class5_1.png", "class9_2.png"]
    for png in pngs:
        image = readPng(png)
        assert image.shape == (32, 32, 3) and image.dtype == np.uint8


def test_tiled_codec_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    """`--crop` and `--tile` through the guarded CLI; every module of the
    package, `validate/` and `models/tiling.py` among them, is imported."""
    image = readPng(ROOT / "assets" / "photo_768x512.png")[:300, :200]
    writePng(tmp_path / "in.png", image)
    runs = [["--device", "cpu", "--local", str(TINY), "--crop", "--tile", "64",
             str(tmp_path / "in.png"), str(tmp_path / "out.mcq")],
            ["--device", "cpu", "--local", str(TINY), str(tmp_path / "out.mcq"),
             str(tmp_path / "out.png")]]
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=runs)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "round trip ok" in proc.stdout
    import pkgutil
    import mcquic_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(mcquic_tpu_torch.__path__, "mcquic_tpu_torch.")}
    assert {"mcquic_tpu_torch.validate.cli", "mcquic_tpu_torch.validate.validator",
            "mcquic_tpu_torch.models.tiling", "mcquic_tpu_torch.ops.vq_grouped_cuda",
            "mcquic_tpu_torch.loss", "mcquic_tpu_torch.data"} <= names
    assert readPng(tmp_path / "out.png").shape == (256, 128, 3)     # the crop, 4 x 2 tiles


def test_train_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    """`train -h`, then two steps of a tiny config (YAML read by the port's
    own reader, PNG folder, validation, reassign hook, checkpoint, export);
    the `train`, `config` and `data` modules are among those imported."""
    from test_torch_train_cli import tinyConfig
    config = tinyConfig(tmp_path)
    runs = [["train", "-h"], ["train", str(config), "--device", "cpu"]]
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=runs)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "round trip ok" in proc.stdout and "stage-1 training" in proc.stdout.lower()
    assert (tmp_path / "saved" / "latest" / "saved.ckpt.npz").exists()
    assert list((tmp_path / "saved").glob("export_*.mcquic.npz"))
    import pkgutil
    import mcquic_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(mcquic_tpu_torch.__path__, "mcquic_tpu_torch.")}
    assert {"mcquic_tpu_torch.config", "mcquic_tpu_torch.train.trainer", "mcquic_tpu_torch.train.cli",
            "mcquic_tpu_torch.data.augment", "mcquic_tpu_torch.data.dataset",
            "mcquic_tpu_torch.utils.yamlsubset"} <= names


def test_v2_training_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    """Two steps of a tiny Neon (`train CONFIG`, LPIPS warned off, the shared
    reassign, validation, export), then of a tiny generator over it
    (`train -G CONFIG`, class folders, the Neon checkpoint as `loadFrom`);
    the `loss.lpips`, `train.genTrainer`, `train.valueTuners` and
    `data.imagenet_classes` modules are among those imported. Two torch
    threads, so that the subprocess does not spin against the test workers."""
    import os
    from test_torch_train_cli import tinyGenConfig, tinyNeonConfig
    neon = tinyNeonConfig(tmp_path)
    gen = tinyGenConfig(tmp_path, tmp_path / "neon" / "latest" / "saved.ckpt.npz")
    runs = [["train", str(neon), "--device", "cpu"], ["train", "-G", str(gen), "--device", "cpu"]]
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=runs)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LPIPS DISABLED" in proc.stdout and "codebook reassigned" in proc.stderr
    assert list((tmp_path / "neon").glob("export_*.mcquic.npz"))
    assert (tmp_path / "gen" / "latest" / "saved.ckpt.npz").exists()
    import pkgutil
    import mcquic_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(mcquic_tpu_torch.__path__, "mcquic_tpu_torch.")}
    assert {"mcquic_tpu_torch.loss.lpips", "mcquic_tpu_torch.train.genTrainer",
            "mcquic_tpu_torch.train.valueTuners", "mcquic_tpu_torch.data.imagenet_classes"} <= names


def test_dataset_and_shards_run_without_the_jax_package_and_its_dependencies(tmp_path):
    """`dataset -j 2` over two 512x512 photo crops, then `train` on a
    `*.tar.gz` glob of its shards, and a JPEG member through the codec CLI:
    neither PIL nor joblib (the JAX writer's) is imported."""
    import tarfile
    from test_torch_train_cli import tinyConfig
    photo = readPng(ROOT / "assets" / "photo_768x512.png")
    (tmp_path / "images").mkdir()
    for i, left in enumerate((0, 256)):
        writePng(tmp_path / "images" / f"{i}.png", photo[:, left:left + 512])
    config = tinyConfig(tmp_path)
    config.write_text(config.read_text().replace(f"trainSet: {tmp_path / 'pngs'}",
                                                 f"trainSet: {tmp_path / 'shards'}/*.tar.gz"))
    runs = [["dataset", "-j", "2", str(tmp_path / "images"), str(tmp_path / "shards")],
            ["train", str(config), "--device", "cpu"]]
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=runs)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "round trip ok" in proc.stdout
    assert sorted(p.name for p in (tmp_path / "shards").iterdir()) == [
        "mcquic_DATA_00000.tar.gz", "mcquic_DATA_00001.tar.gz", "metadata.json"]
    assert (tmp_path / "saved" / "latest" / "saved.ckpt.npz").exists()
    with tarfile.open(tmp_path / "shards" / "mcquic_DATA_00001.tar.gz", "r:gz") as tf:
        (tmp_path / "in.jpg").write_bytes(tf.extractfile("000000001.jpg").read())
    runs = [["--device", "cpu", "--local", str(TINY), str(tmp_path / "in.jpg"),
             str(tmp_path / "out.mcq")]]
    proc = subprocess.run([sys.executable, "-c", GUARD.format(blocked=BLOCKED, root=str(ROOT),
                                                              runs=runs)],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert (tmp_path / "out.mcq").stat().st_size > 0
    import pkgutil
    import mcquic_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(mcquic_tpu_torch.__path__, "mcquic_tpu_torch.")}
    assert {"mcquic_tpu_torch.data.jpeg", "mcquic_tpu_torch.data.cli"} <= names


def test_service_and_decoders_run_without_the_jax_package_and_its_dependencies(tmp_path):
    """In the guarded process (streamlit blocked too): a progressive JPEG, a
    BMP, a 16-bit RGB PNG, a WebP and a CMYK JPEG through the codec CLI, and
    `handleUpload` on the tiny model for the BMP and its `.mcq`."""
    from PIL import Image
    from test_torch_images import pngForm
    photo = readPng(ROOT / "assets" / "photo_768x512.png")[:64, :96]
    Image.fromarray(photo).save(tmp_path / "p.jpg", quality=90, progressive=True)
    Image.fromarray(photo).save(tmp_path / "b.bmp")
    (tmp_path / "g.png").write_bytes(pngForm(2, 16, shape=(40, 48)))
    Image.fromarray(photo).save(tmp_path / "w.webp", quality=80)
    Image.fromarray(photo).convert("CMYK").save(tmp_path / "k.jpg", quality=95)
    names = ("p.jpg", "b.bmp", "g.png", "w.webp", "k.jpg")
    runs = [["--device", "cpu", "--local", str(TINY), str(tmp_path / name),
             str(tmp_path / (name + ".mcq"))] for name in names]
    extra = textwrap.dedent(f"""
        from pathlib import Path
        from mcquic_tpu_torch.demo import loadModel
        from mcquic_tpu_torch.service.stCompressService import handleUpload
        engine = loadModel(local={str(TINY)!r}, device="cpu")
        data = Path({str(tmp_path / "b.bmp")!r}).read_bytes()
        answer = handleUpload(engine, "b.bmp", data)
        back = handleUpload(engine, answer.fileName, answer.data)
        assert answer.fileName == "b.mcq" and back.fileName == "b.png", answer.fileName
        assert back.preview.shape == (64, 96, 3)
        leaked = sorted(n for n in sys.modules if blocked(n))
        assert not leaked, leaked
        print("handler ok", flush=True)
    """)
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=runs) + extra
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "round trip ok" in proc.stdout and "handler ok" in proc.stdout
    for name in names:
        assert (tmp_path / (name + ".mcq")).stat().st_size > 0, name


def test_caption_encoder_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    """In the guarded process: a seeded CLIP text folder (2 layers, width 64)
    written by `writeSeededClipText`, encoded on the CPU, then loaded through
    a hub name in a cache laid out as the hub client writes it."""
    extra = textwrap.dedent(f"""
        import os
        from pathlib import Path
        from mcquic_tpu_torch.utils.textEncoder import (ClipTextEncoder, tryLoadTextEncoder,
                                                        writeSeededClipText)
        config = dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=4)
        folder = writeSeededClipText(Path({str(tmp_path)!r}) / "clip", config)
        captions = ["a photo of a cat", "Two dogs, one ball!", " ".join(["long"] * 100)]
        pooled = ClipTextEncoder(str(folder), device="cpu")(captions)
        assert pooled.shape == (3, 64) and pooled.dtype.name == "float32", pooled.shape
        assert abs(pooled).max() > 0 and (pooled == pooled).all()
        snapshot = Path({str(tmp_path)!r}) / "hub" / "models--acme--clip" / "snapshots" / "c0ffee"
        snapshot.parent.mkdir(parents=True)
        folder.rename(snapshot)
        (snapshot.parent.parent / "refs").mkdir()
        (snapshot.parent.parent / "refs" / "main").write_text("c0ffee")
        os.environ["HF_HUB_CACHE"] = str(snapshot.parent.parent.parent)
        again = ClipTextEncoder("acme/clip", device="cpu")(captions)
        assert (again == pooled).all()
        assert tryLoadTextEncoder("acme/missing", device="cpu") is None
        leaked = sorted(n for n in sys.modules if blocked(n))
        assert not leaked, leaked
        print("captions ok", flush=True)
    """)
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=[]) + extra
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "captions ok" in proc.stdout


def _portFiles():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_only_torch_numpy_and_the_standard_library():
    allowed = {"torch", "numpy", "mcquic_tpu_torch"} | set(sys.stdlib_module_names)
    found = {}
    for path in _portFiles():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                if name.split(".")[0] not in allowed:
                    found.setdefault(str(path.relative_to(ROOT)), []).append(name)
    assert not found, found


def test_port_never_uses_the_torch_extension_builder():
    """The card machine's builds go through nvcc and ctypes (utils/build.py)."""
    needle = "torch.utils." + "cpp_extension"
    users = [str(p.relative_to(ROOT)) for p in _portFiles() if needle in p.read_text()]
    assert not users, users


def test_ddp_train_cli_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    """`train -D --device cpu CONFIG` as two processes under the three
    variables, on two tar shards: rank r reads shard r only (its debug log
    names it), both exit 0 and print the one export rank 0 wrote, and the
    checkpoint is at the config's last step. `parallel` and
    `models.generator_var` are among the modules the guard imported."""
    import os
    import socket
    from test_torch_train_cli import _jpegShard, tinyConfig
    photo = readPng(ROOT / "assets" / "photo_768x512.png")
    (tmp_path / "shards").mkdir()
    for s in range(2):
        _jpegShard(tmp_path / "shards" / f"mcquic_DATA_{s:05d}.tar.gz",
                   [(f"{2 * s + i:09d}.jpg", photo[i * 120:i * 120 + 256, s * 300:s * 300 + 300])
                    for i in range(2)])
    config = tinyConfig(tmp_path)
    config.write_text(config.read_text().replace(f"trainSet: {tmp_path / 'pngs'}",
                                                 f"trainSet: {tmp_path / 'shards'}/*.tar.gz"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT),
                          runs=[["train", "-D", str(config), "--device", "cpu"]])
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=tmp_path, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(os.environ, OMP_NUM_THREADS="1",
                                       MCQUIC_COORDINATOR=f"localhost:{port}",
                                       MCQUIC_NUM_PROCESSES="2", MCQUIC_PROCESS_ID=str(r)))
             for r in range(2)]
    outputs = []
    for proc in procs:
        try:
            outputs.append(proc.communicate(timeout=300))
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, outputs[-1][1][-4000:]
    exports = list((tmp_path / "saved").glob("export_*.mcquic.npz"))
    assert len(exports) == 1
    for r, (out, err) in enumerate(outputs):
        assert "round trip ok" in out and str(exports[0]) in out
        assert f"rank {r} of 2 joined" in err
        reads = [line for line in err.splitlines() if "host" in line and "shards:" in line]
        assert reads and all(f"host {r} of 2 reads 1 of 2 shards: ['mcquic_DATA_{r:05d}.tar.gz']"
                             in line for line in reads), reads
    from mcquic_tpu_torch.utils.convert import readExport
    flat, _ = readExport(tmp_path / "saved" / "latest" / "saved.ckpt.npz")
    assert int(flat["step"]) == 2
    import pkgutil
    import mcquic_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(mcquic_tpu_torch.__path__, "mcquic_tpu_torch.")}
    assert {"mcquic_tpu_torch.parallel", "mcquic_tpu_torch.models.generator_var"} <= names


def test_tooling_runs_without_the_jax_package_and_its_dependencies(tmp_path):
    """In the guarded process: `-qp 3 --mse` fetched from a `file://` mirror
    into an empty MCQUIC_CACHE compresses a crop; `python -m
    mcquic_tpu_torch.utils.convert` converts a reference-shaped checkpoint;
    the Inception classifier and score run on seeded torchvision-layout
    weights from MCQUIC_INCEPTION_WEIGHTS."""
    import hashlib
    import json
    import os
    import shutil
    import torch
    from test_torch_convert import TINY_V1, referenceCheckpoint
    from mcquic_tpu_torch.validate.inception_v3 import seededStateDict
    image = readPng(ROOT / "assets" / "photo_768x512.png")[:64, :64]
    writePng(tmp_path / "in.png", image)
    digest = hashlib.sha256(TINY.read_bytes()).hexdigest()[:8]
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    shutil.copy(TINY, mirror / f"qp_3_mse_{digest}.mcquic.npz")
    shutil.copy(TINY.with_suffix(".json"), mirror / f"qp_3_mse_{digest}.mcquic.json")
    (tmp_path / "hashes.json").write_text(json.dumps({"qp_3_mse": digest}))
    ckpt = referenceCheckpoint(tmp_path / "ref.ckpt", TINY_V1, "trainer")
    torch.save(seededStateDict(), tmp_path / "inception_v3.pth")
    extra = textwrap.dedent(f'''
        sys.argv = ["convert", {str(ckpt)!r}, {str(tmp_path / "out.npz")!r}, "--channel", "8",
                    "--m", "2", "--k", "16,8", "--qp", "2"]
        runpy.run_module("mcquic_tpu_torch.utils.convert", run_name="__main__", alter_sys=True)
        import numpy as np
        from mcquic_tpu_torch.validate.inception import InceptionScoreHandler
        handler = InceptionScoreHandler("cpu", splits=1)
        handler(restored=np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8))
        print("inception score", handler.result(), flush=True)
        leaked = sorted(n for n in sys.modules if blocked(n))
        assert not leaked, leaked
    ''')
    script = GUARD.format(blocked=BLOCKED, root=str(ROOT), runs=[
        ["-q", "--device", "cpu", "-qp", "3", "--mse", str(tmp_path / "in.png"),
         str(tmp_path / "out.mcq")]]) + extra
    env = dict(os.environ, MCQUIC_MODELS_URL=mirror.as_uri(), MCQUIC_CACHE=str(tmp_path / "cache"),
               MCQUIC_MODELS_HASH_FILE=str(tmp_path / "hashes.json"),
               MCQUIC_INCEPTION_WEIGHTS=str(tmp_path / "inception_v3.pth"))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "round trip ok" in proc.stdout and "inception score" in proc.stdout
    assert (tmp_path / "out.mcq").stat().st_size > 0
    assert (tmp_path / "cache" / "zoo" / f"qp_3_mse_{digest}.mcquic.npz").exists()
    exports = list(tmp_path.glob("out_*.mcquic.npz"))
    assert len(exports) == 1 and str(exports[0]) in proc.stdout
    score = float(proc.stdout.split("inception score")[1].split()[0])
    assert np.isfinite(score) and score >= 1.0
