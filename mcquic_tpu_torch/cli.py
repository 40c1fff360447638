"""`python -m mcquic_tpu_torch`: compress a PNG to `.mcq`, or restore a
`.mcq` to PNG, by the input's suffix (the default command of
`mcquic_tpu/cli.py`, reference `mcquic/cli.py:40-61`)."""
import argparse
import logging

import mcquic_tpu_torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mcquic_tpu_torch",
        description=f"mcquic_tpu_torch {mcquic_tpu_torch.__version__}: compress IMAGE.png -> "
                    ".mcq, or restore .MCQ -> PNG.")
    p.add_argument("-qp", type=int, choices=range(0, 14), default=None, metavar="{0..13}",
                   help="quantization parameter (zoo slot); a .mcq records its own")
    p.add_argument("--local", default=None, help="use a local exported model instead of the zoo")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-V", "--version", action="version", version=mcquic_tpu_torch.__version__)
    p.add_argument("input")
    p.add_argument("output", nargs="?", default=None)
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if args.local is None and args.qp is None and not args.input.lower().endswith(".mcq"):
        p.error("compressing needs -qp or --local")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    from mcquic_tpu_torch.demo import main as run
    print(run(args.input, args.output, qp=args.qp, local=args.local, device=args.device))
    return 0
