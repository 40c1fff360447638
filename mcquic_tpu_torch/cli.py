"""`python -m mcquic_tpu_torch`: compress a PNG to `.mcq`, or restore a
`.mcq` to PNG, by the input's suffix (the default command of
`mcquic_tpu/cli.py`, reference `mcquic/cli.py:40-61`); or, as
`python -m mcquic_tpu_torch generate -c 1,207 model.npz outdir/`, sample
images from a stage-2 generator (`mcquic_tpu/cli.py:130-147`)."""
import argparse
import logging

import mcquic_tpu_torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch",
        description=f"mcquic_tpu_torch {mcquic_tpu_torch.__version__}: compress IMAGE.png -> "
                    ".mcq, or restore .MCQ -> PNG. `generate -h` samples from a generator.")
    p.add_argument("-qp", type=int, choices=range(0, 14), default=None, metavar="{0..13}",
                   help="quantization parameter (zoo slot); a .mcq records its own")
    p.add_argument("--local", default=None, help="use a local exported model instead of the zoo")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-V", "--version", action="version", version=mcquic_tpu_torch.__version__)
    p.add_argument("input")
    p.add_argument("output", nargs="?", default=None)
    return p


def generateParser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch generate",
        description="Sample one image per ImageNet class id from a stage-2 generator "
                    "checkpoint (npz + json sidecar) into OUTPUT/class{id}_{i}.png.")
    p.add_argument("-c", "--classes", required=True,
                   help="comma-separated ImageNet class ids to sample")
    p.add_argument("--top-k", type=int, default=0, help="sample from the k largest logits (0: all)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("modelPath")
    p.add_argument("output")
    return p


def main(argv=None) -> int:
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if argv[:1] == ["generate"]:
        args = generateParser().parse_args(argv[1:])
        from mcquic_tpu_torch.generate import main as generate
        for path in generate(args.modelPath, [int(c) for c in args.classes.split(",")],
                             args.output, topK=args.top_k, temperature=args.temperature,
                             seed=args.seed, device=args.device):
            print(path)
        return 0
    p = parser()
    args = p.parse_args(argv)
    if args.local is None and args.qp is None and not args.input.lower().endswith(".mcq"):
        p.error("compressing needs -qp or --local")
    from mcquic_tpu_torch.demo import main as run
    print(run(args.input, args.output, qp=args.qp, local=args.local, device=args.device))
    return 0
