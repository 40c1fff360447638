"""`python -m mcquic_tpu_torch.train CONFIG [-r] [-G] [--device cpu]`
(counterpart of `mcquic_tpu/train/__main__.py`): the same as
`python -m mcquic_tpu_torch train`."""
import sys

from mcquic_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main(["train", *sys.argv[1:]]))
