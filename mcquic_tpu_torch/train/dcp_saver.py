"""Sharded checkpoints through `torch.distributed.checkpoint` (counterpart of
`mcquic_tpu/train/orbax_saver.py`), which the stage-1 `Trainer` takes for
MCQUIC_CKPT_BACKEND=orbax as the JAX trainer takes orbax
(`mcquic_tpu/train/trainer.py:113-124`).

`saveDir/dcp/<step>` holds one step: every rank writes its own shards of
the state there, a tensor that every rank holds whole is written once, and
rank 0 writes the step's `.metadata` last, so a step without it is
incomplete. A save is asynchronous (`dcp.async_save`): the state is copied
to host memory before `save` returns and written by a background thread
while training goes on; the next save, `restore`, `waitUntilFinished` and
`close` wait for it first. At most `maxItems` complete steps are kept, the
oldest removed by rank 0. A restore reads into the tensors of a template,
resharding where the template is sharded otherwise than the saved state
(another world size).

The background thread's collectives must not interleave with the
training's on one group (gloo matches collectives by their order, and two
threads would cross), and asynchronous saves need a CPU backend: the saver
makes a gloo group of its own over the same ranks, whatever the training's
backend. Every method is collective where a process group exists: every
rank calls it, in the same order.
"""
import shutil
from pathlib import Path
from typing import Any, Optional

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from mcquic_tpu_torch import parallel

METADATA = ".metadata"


class DcpSaver:
    def __init__(self, saveDir, maxItems: int = 25):
        self._root = Path(saveDir).absolute() / "dcp"
        self._root.mkdir(parents=True, exist_ok=True)
        self._maxItems = maxItems
        self._pending = None
        self._group = dist.new_group(backend="gloo") if parallel.initialized() else None

    @property
    def root(self) -> Path:
        return self._root

    def _target(self) -> dict:
        if parallel.initialized():
            return {"process_group": self._group}
        return {"no_dist": True}

    def steps(self) -> list:
        """The complete steps on disk, oldest first."""
        return sorted(int(p.name) for p in self._root.iterdir()
                      if p.name.isdigit() and (p / METADATA).exists())

    def _prune(self, keep: int):
        if parallel.isMain():
            for step in self.steps()[:-keep or None]:
                shutil.rmtree(self._root / str(step), ignore_errors=True)

    def save(self, step: int, state: dict, force: bool = False) -> bool:
        """Start saving `state` (nested dicts of tensors, DTensors and
        picklable values) as `step`; False where that step is on disk and
        not `force`, as orbax's manager skips a step it has."""
        self.waitUntilFinished()
        if step in self.steps() and not force:
            return False
        path = self._root / str(step)
        if parallel.isMain() and path.exists():
            shutil.rmtree(path)
        self._prune(self._maxItems - 1)
        parallel.barrier()
        self._pending = dcp.async_save(state, checkpoint_id=str(path), **self._target())
        return True

    def waitUntilFinished(self):
        """Wait for the save in flight, then keep the newest `maxItems` steps."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        getattr(pending, "upload_completion", pending).result()
        self._prune(self._maxItems)

    def latestStep(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: dict, step: Optional[int] = None) -> Any:
        """Read `step` (the latest by default) into `template`'s tensors, in
        place, and return it with its other values replaced by the saved
        ones."""
        self.waitUntilFinished()
        step = self.latestStep() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no torch.distributed.checkpoint step under {self._root}")
        dcp.load(template, checkpoint_id=str(self._root / str(step)), **self._target())
        return template

    def close(self):
        self.waitUntilFinished()
