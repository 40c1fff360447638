"""Checkpoint save, rotation and resume (counterpart of
`mcquic_tpu/train/saver.py`, reference `mcquic/train/utils.py:63-194`).

A save directory holds `latest/saved.ckpt.npz` (with its json sidecar) and
the earlier `latest/` directories, renamed by time stamp when a new Saver
opens the directory, at most `maxItems` of them. One live Saver owns a
directory: an exclusive `flock` on `.lock`, which the kernel drops with the
process, keeps two trainers from rotating and writing each other's files.
Under data parallelism only rank 0 holds a save directory; a Saver on
another rank is refused.

A checkpoint is a flat npz of '/'-joined keys, the format of the JAX
package's `saveTree`, so `mcquic_tpu.train.saver.loadTree` reads the port's
checkpoints and this package reads the JAX package's (`readExport`);
`OptaxLayout` writes and reads the optimizer's state as optax's leaves.
"""
import fcntl
import os
import shutil
import threading
import time
import weakref
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

import mcquic_tpu_torch
from mcquic_tpu_torch import parallel
from mcquic_tpu_torch.train.optim import Adam
from mcquic_tpu_torch.utils.convert import _applyMap, _invertMap, readExport, writeExport


class Saver:
    """saveDir/latest/saved.ckpt.npz, the previous `latest/` rotated away."""

    CKPT_NAME = "saved.ckpt.npz"
    # resolved path -> [lock file, the Savers holding it]: flock conflicts
    # between two descriptors even in one process, so the process keeps one
    # per directory; a second live Saver is refused, a later one (after
    # close) takes the lock over
    _held: dict = {}
    _heldMutex = threading.Lock()

    def __init__(self, saveDir, maxItems: int = 25):
        if not parallel.isMain():
            raise RuntimeError(f"rank {parallel.rank()} asked for the save directory {saveDir}; "
                               "only rank 0 writes checkpoints")
        self._root = Path(saveDir)
        self._maxItems = maxItems
        self._previous: Optional[Path] = None
        self._root.mkdir(parents=True, exist_ok=True)
        self._lockKey = str(self._root.resolve())
        self._lockHeld = False
        with Saver._heldMutex:
            entry = Saver._held.get(self._lockKey)
            if entry is not None:
                if any(s._lockHeld for s in entry[1]):
                    raise RuntimeError(f"saveDir {self._root} is already owned by a live Saver in "
                                       "this process (close() it first)")
                entry[1].add(self)
            else:
                lockFile = open(self._root / ".lock", "w")
                try:
                    fcntl.flock(lockFile, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    lockFile.close()
                    raise RuntimeError(f"saveDir {self._root} is locked by another live trainer "
                                       "(concurrent trainers on one saveDir corrupt checkpoints)")
                lockFile.write(str(os.getpid()))
                lockFile.flush()
                Saver._held[self._lockKey] = [lockFile, weakref.WeakSet([self])]
            self._lockHeld = True
        latest = self._root / "latest"
        if latest.exists() and any(latest.iterdir()):
            stamp = time.strftime("%Y%m%d_%H%M%S")
            target = self._root / stamp
            while target.exists():
                stamp += "_"
                target = self._root / stamp
            shutil.move(str(latest), str(target))
            self._previous = target
        else:
            # `latest/` empty but history exists: the previous run died between
            # the rotation and its first save; resume from the newest history
            history = sorted((d for d in self._root.iterdir()
                              if d.is_dir() and d.name != "latest"
                              and (d / self.CKPT_NAME).exists()), reverse=True)
            if history:
                self._previous = history[0]
        latest.mkdir(parents=True, exist_ok=True)
        history = sorted(d for d in self._root.iterdir() if d.is_dir() and d.name != "latest")
        while len(history) > self._maxItems:
            shutil.rmtree(history.pop(0), ignore_errors=True)

    def close(self):
        """Release the directory's lock (idempotent)."""
        if not getattr(self, "_lockHeld", False):
            return
        with Saver._heldMutex:
            self._lockHeld = False
            entry = Saver._held.get(self._lockKey)
            if entry is None:
                return
            entry[1].discard(self)
            if not any(s._lockHeld for s in entry[1]):
                entry[0].close()
                del Saver._held[self._lockKey]

    def __del__(self):
        self.close()

    @property
    def PreviousCkpt(self) -> Optional[Path]:
        """Where the rotated `latest` checkpoint lives now (for resume)."""
        if self._previous is None:
            return None
        p = self._previous / self.CKPT_NAME
        return p if p.exists() else None

    @property
    def SaveDir(self) -> Path:
        return self._root / "latest"

    @property
    def CkptPath(self) -> Path:
        return self.SaveDir / self.CKPT_NAME

    def save(self, flat: Dict[str, np.ndarray], meta: Optional[dict] = None):
        """Write the checkpoint through a temporary file and a rename."""
        meta = dict(meta or {})
        meta.setdefault("version", mcquic_tpu_torch.__version__)
        tmp = self.CkptPath.with_suffix(".npz.tmp.npz")
        writeExport(tmp, flat, meta)
        os.replace(tmp, self.CkptPath)
        tmp.with_suffix(".json").replace(self.CkptPath.with_suffix(".json"))

    @staticmethod
    def probeResume(saveDir) -> Optional[Path]:
        """`saveDir/latest/saved.ckpt.npz` where it exists."""
        p = Path(saveDir) / "latest" / Saver.CKPT_NAME
        return p if p.exists() else None

    @staticmethod
    def load(path):
        """(flat arrays, sidecar metadata) of a checkpoint."""
        return readExport(Path(path))


def saveTree(path, flat: Dict[str, np.ndarray], meta: Optional[dict] = None) -> Path:
    """A flat npz and its json sidecar (`saver.py:40-56`), e.g. the best
    checkpoint."""
    return writeExport(path, flat, dict(meta or {}))


def _flaxOrder(key: str) -> tuple:
    return tuple(key.split("/"))


class OptaxLayout:
    """The optimizer's state as optax's leaves, for checkpoints in the JAX
    package's layout: [count, mu..., nu..., count] for the Adam family,
    [trace..., count] or [count] for SGD, each moment list in the order of
    the flax leaves (`jax.tree_util` sorts dict keys at every level). `mp`
    is the model's name map (`utils/convert.py::_Map`); `names` are the
    optimizer's parameters' state-dict keys, in its order. A flax leaf that
    stacks several torch parameters (Neon's temperatures) is one moment
    leaf; frozen parameters have none (`optax.masked`).

    The leaves are global arrays whatever the world size, as the JAX
    package's are: a sharded optimizer's slots are gathered parameter by
    parameter into rank 0's host memory (one parameter's slot on the card
    at a time), and a load keeps each rank's slice of the global leaves,
    so a checkpoint written at one world size resumes at any other."""

    def __init__(self, mp, names):
        self.mp, self.names = mp, list(names)
        self.keys = sorted({mp.entries[n][0] for n in self.names}, key=_flaxOrder)

    def leaves(self, optimizer, stateDict: dict) -> Optional[Dict[str, np.ndarray]]:
        """The leaves on rank 0, None on the other ranks. Every rank calls
        it: the slots' shards are gathered collectively."""
        main = parallel.isMain()

        def moments(slot):
            tensors = {}
            for i, name in enumerate(self.names):
                whole = optimizer.wholeSlot(slot, i)
                if main:
                    tensors[name] = whole.detach().cpu()
            if not main:
                return []
            flat = _invertMap(self.mp, {**stateDict, **tensors})
            return [flat[k].astype(np.float32) for k in self.keys]

        count = np.asarray(optimizer.count, np.int32)
        if isinstance(optimizer, Adam):
            out = [count, *moments("mu"), *moments("nu"), count]
        else:
            out = [*(moments("trace") if "trace" in optimizer.state else []), count]
        return {f"optState/{i:05d}": leaf for i, leaf in enumerate(out)} if main else None

    def load(self, optimizer, stateDict: dict, flat: dict):
        """The inverse of `leaves`, from the port's or the JAX package's
        checkpoint (`flat`), each rank keeping its slice; refuses a
        checkpoint of another layout."""
        leaves = [flat[k] for k in sorted(k for k in flat if k.startswith("optState/"))]
        slots, n = list(optimizer.state), len(self.keys)
        adam = isinstance(optimizer, Adam)
        if len(leaves) != (2 * n + 2 if adam else len(slots) * n + 1):
            raise ValueError(f"optimizer state layout changed ({len(leaves)} leaves for {n} "
                             f"parameters); cannot resume")
        variables = _invertMap(self.mp, stateDict)
        body = leaves[1:-1] if adam else leaves[:-1]
        for s, slot in enumerate(slots):
            tensors = _applyMap(self.mp, {**variables, **dict(zip(self.keys, body[s * n:(s + 1) * n]))})
            with torch.no_grad():
                for i, (name, t) in enumerate(zip(self.names, optimizer.state[slot])):
                    t.copy_(optimizer.local(tensors[name], i))
        optimizer.count = int(leaves[-1])


def restoreGenerator(generator, flat: dict):
    """A trainer's torch generator from a checkpoint: the port's saved state
    (`torch/rng`), or seeded from a JAX checkpoint's `rng` key."""
    if "torch/rng" in flat:
        generator.set_state(torch.from_numpy(flat["torch/rng"]))
    elif "rng" in flat:
        key = np.asarray(flat["rng"]).astype(np.uint64)
        generator.manual_seed(int((key[0] << np.uint64(32)) | key[1]))
