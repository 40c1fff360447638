"""`python -m mcquic_tpu_torch`: compress a PNG or JPEG to `.mcq`, or restore
a `.mcq` to PNG, by the input's suffix (the default command of
`mcquic_tpu/cli.py`, reference `mcquic/cli.py:40-61`); as
`python -m mcquic_tpu_torch validate [-e EXPORT] [--bf16] MODEL [IMAGES]`,
evaluate a model on a folder of images, export it and time it
(`mcquic_tpu/cli.py:92-110`); as
`python -m mcquic_tpu_torch dataset [-j N] [-G] IMAGES OUTPUT`, write an image
folder into tar shards of JPEGs (`mcquic_tpu/cli.py:116-127`); or, as
`python -m mcquic_tpu_torch generate -c 1,207 model.npz outdir/`, sample
images from a stage-2 generator (`mcquic_tpu/cli.py:130-147`); or, as
`python -m mcquic_tpu_torch train [-G] config.yaml`, train a stage-1 model
(the v1 Compressor or Neon) or, with `-G/--gen`, the stage-2 generator
(`mcquic_tpu/cli.py:84-96`). The console scripts `mcquic-torch`,
`mcquic-torch-train`, `mcquic-torch-validate` and `mcquic-torch-dataset`
(`pyproject.toml`, beside the JAX package's four) are `main`, `train`,
`validate` and `dataset` here."""
import argparse
import logging
import sys

import mcquic_tpu_torch


def loggingOptions(p: argparse.ArgumentParser):
    """-D and -q, as every command of the JAX package's CLI has them."""
    p.add_argument("-D", "--debug", action="store_true", help="verbose logging")
    p.add_argument("-q", "--quiet", action="store_true", help="warnings and errors only")


def setLogging(args):
    """The root logger's level for -D (DEBUG) or -q (WARNING), else INFO."""
    level = logging.DEBUG if args.debug else (logging.WARNING if args.quiet else logging.INFO)
    logging.getLogger().setLevel(level)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch",
        description=f"mcquic_tpu_torch {mcquic_tpu_torch.__version__}: compress IMAGE (PNG or "
                    "JPEG) -> .mcq, or restore .MCQ -> PNG. `generate -h` samples from a "
                    "generator, `train -h` trains, `dataset -h` writes training shards.")
    loggingOptions(p)
    p.add_argument("-qp", type=int, choices=range(0, 14), default=None, metavar="{0..13}",
                   help="quantization parameter (zoo slot); a .mcq records its own")
    p.add_argument("--local", default=None, help="use a local exported model instead of the zoo")
    p.add_argument("--mse", action="store_true", help="use the MSE-optimized zoo models")
    p.add_argument("--crop", action="store_true",
                   help="center-crop the input to multiples of 128 first")
    p.add_argument("--tile", type=int, default=0,
                   help="code the image as a grid of TILE x TILE tiles (0: whole image; "
                        "tiled .mcq files are recognized on restore)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--disable-gpu", action="store_true",
                   help="run on the CPU, the same as --device cpu")
    p.add_argument("-V", "--version", action="version", version=mcquic_tpu_torch.__version__)
    p.add_argument("input")
    p.add_argument("output", nargs="?", default=None)
    return p


def validateParser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch validate",
        description="Evaluate MODEL (an exported model, or a trainer checkpoint with its json "
                    "sidecar) on the PNG and JPEG images under IMAGES: MS-SSIM, PSNR, bpp and ideal bpp; "
                    "optionally export it; then time it under the reference's speed protocol.")
    loggingOptions(p)
    p.add_argument("-e", "--export", default=None,
                   help="write a deploy model here (renamed with its sha256 prefix)")
    p.add_argument("--bf16", action="store_true",
                   help="export params as bfloat16; coder tables stay exact")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("modelPath")
    p.add_argument("images", nargs="?", default=None)
    return p


def generateParser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch generate",
        description="Sample one image per ImageNet class id from a stage-2 generator "
                    "checkpoint (npz + json sidecar) into OUTPUT/class{id}_{i}.png.")
    loggingOptions(p)
    p.add_argument("-c", "--classes", required=True,
                   help="comma-separated ImageNet class ids to sample")
    p.add_argument("--cfg", type=float, default=1.5,
                   help="classifier-free guidance of a GeneratorVAR checkpoint (the other "
                        "generators take --temperature)")
    p.add_argument("--top-k", type=int, default=0, help="sample from the k largest logits (0: all)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("modelPath")
    p.add_argument("output")
    return p


def trainParser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch train",
        description="Stage-1 training (the v1 Compressor, or Neon where the model has a "
                    "`size` pyramid) on tar shards or a folder of PNG or JPEG images, or with -G "
                    "stage-2 training of the generator on class folders or wnid-keyed shards, "
                    "from a YAML config (model, train: "
                    "trainSet, valSet, saveDir, ...). Resumes from saveDir/latest where a "
                    "checkpoint is and writes checkpoints there; prints the deploy model's path "
                    "(stage 1, written into saveDir) or the checkpoint's (stage 2).")
    loggingOptions(p)
    p.add_argument("-r", "--resume", action="store_true",
                   help="resume from saveDir/latest (always done where a checkpoint is)")
    p.add_argument("-G", "--gen", action="store_true", help="train the stage-2 generation model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("configPath", metavar="CONFIG")
    return p


def datasetParser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch dataset",
        description="Write the images under IMAGES that pass the filter (at least 512 x 512, "
                    "textured) into tar shards of quality-95 JPEGs, "
                    "OUTPUT/mcquic_DATA_%05d.tar.gz, and OUTPUT/metadata.json.")
    loggingOptions(p)
    p.add_argument("-j", "--jobs", type=int, default=1, help="parallel shard writers")
    p.add_argument("-G", "--gen", action="store_true",
                   help="write a caption member per image (image-text dataset for generation)")
    p.add_argument("images")
    p.add_argument("output")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if argv[:1] == ["generate"]:
        args = generateParser().parse_args(argv[1:])
        setLogging(args)
        from mcquic_tpu_torch.generate import main as generate
        for path in generate(args.modelPath, [int(c) for c in args.classes.split(",")],
                             args.output, topK=args.top_k, temperature=args.temperature,
                             seed=args.seed, device=args.device, cfg=args.cfg):
            print(path)
        return 0
    if argv[:1] == ["train"]:
        args = trainParser().parse_args(argv[1:])
        setLogging(args)
        from mcquic_tpu_torch.train.cli import main as train
        print(train(args.configPath, gen=args.gen, device=args.device))
        return 0
    if argv[:1] == ["dataset"]:
        args = datasetParser().parse_args(argv[1:])
        setLogging(args)
        from pathlib import Path
        if not Path(args.images).is_dir():
            datasetParser().error(f"IMAGES {args.images!r} is not a directory")
        from mcquic_tpu_torch.data.cli import main as dataset
        print(dataset(args.images, args.output, jobs=args.jobs, gen=args.gen))
        return 0
    if argv[:1] == ["validate"]:
        args = validateParser().parse_args(argv[1:])
        setLogging(args)
        from mcquic_tpu_torch.validate.cli import main as validate
        validate(args.modelPath, args.images, args.export, bf16=args.bf16, device=args.device)
        return 0
    p = parser()
    args = p.parse_args(argv)
    setLogging(args)
    if args.local is None and args.qp is None and not args.input.lower().endswith(".mcq"):
        p.error("compressing needs -qp or --local")
    if args.tile < 0:
        p.error("--tile must be >= 0")
    from mcquic_tpu_torch.demo import main as run
    print(run(args.input, args.output, qp=args.qp, local=args.local,
              device="cpu" if args.disable_gpu else args.device, crop=args.crop, tile=args.tile,
              mse=args.mse))
    return 0


def train() -> int:
    """`mcquic-torch-train`: `python -m mcquic_tpu_torch train`."""
    return main(["train", *sys.argv[1:]])


def validate() -> int:
    """`mcquic-torch-validate`: `python -m mcquic_tpu_torch validate`."""
    return main(["validate", *sys.argv[1:]])


def dataset() -> int:
    """`mcquic-torch-dataset`: `python -m mcquic_tpu_torch dataset`."""
    return main(["dataset", *sys.argv[1:]])
