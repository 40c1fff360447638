"""Data-parallel training across processes (counterpart of
`mcquic_tpu/parallel/__init__.py` and of `mcquic_tpu/train/cli.py:33-51`,
`_maybeInitDistributed`).

One process drives one card. The processes find each other through the JAX
package's variables:
  * MCQUIC_COORDINATOR, `host:port` of rank 0's rendezvous;
  * MCQUIC_NUM_PROCESSES, the world size;
  * MCQUIC_PROCESS_ID, this process's rank.
`initDistributed` reads them and starts `torch.distributed` over TCP: NCCL
when the training device is CUDA, gloo on the CPU. With none of them set
nothing starts and every helper below is a no-op, so a run on one process
is the run it was before. `MCQUIC_MULTIHOST=auto` (the JAX package's
Cloud-TPU metadata path) is refused.

What the JAX package gets from one SPMD program under `jit`, the port does
by hand (`train/state.py`): each rank runs the step on its slice of the
global batch, the gradients and the logged metrics are averaged across
ranks in one flat buffer, and the quantizers' code counts are summed before
they are normalized (`models/quantizer.py::emaUpdates`). Every rank seeds
the same generator and draws the batch-axis random values at the global
batch (`shardedRows`), so world w at batch n computes what one process
computes at batch w * n, up to the order of the sums.

The optimizer's state is sharded across the ranks as the JAX trainers
shard theirs (`zeroShardings`, ZeRO): `zeroSpec` picks each parameter's
sharded axis by the JAX package's rule, from its shape and the world size
alone, so every rank agrees on it without a word; the optimizer keeps its
moments for its rank's slice only, updates that slice of the parameter and
all-gathers the slices (`allGather_`, `train/optim.py`). The gradients are
still all-reduced whole.

`generatorShardings` gives the Megatron-style tensor-parallel placement of
each generator parameter, as the JAX package's does for its 'model' mesh
axis. Nothing on the main path calls it: both JAX trainers build their mesh
at `modelParallel=1`.
"""
import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("mcquic_tpu_torch.parallel")

VARIABLES = ("MCQUIC_COORDINATOR", "MCQUIC_NUM_PROCESSES", "MCQUIC_PROCESS_ID")

__all__ = ["VARIABLES", "initDistributed", "destroy", "initialized", "rank", "world", "isMain",
           "localDevice", "barrier", "allReduceSum_", "allReduceMean_", "anyRank",
           "broadcastObject", "shardedRows", "zeroSpec", "shardOf", "allGather_",
           "generatorShardings"]


def initDistributed(device="cuda", backend=None) -> bool:
    """Start the process group from MCQUIC_COORDINATOR, MCQUIC_NUM_PROCESSES
    and MCQUIC_PROCESS_ID; True when it started. `backend` defaults to NCCL
    for a CUDA `device` and gloo otherwise. On CUDA, rank r drives
    `cuda:{r % torch.cuda.device_count()}`."""
    if os.environ.get("MCQUIC_MULTIHOST", "").lower() == "auto":
        raise NotImplementedError(
            "MCQUIC_MULTIHOST=auto is the JAX package's Cloud-TPU metadata path; this package "
            "starts from " + ", ".join(VARIABLES) + " (host:port of rank 0, the number of "
            "processes, this process's rank)")
    coordinator = os.environ.get("MCQUIC_COORDINATOR")
    if not coordinator:
        return False
    missing = [name for name in VARIABLES[1:] if name not in os.environ]
    if missing:
        raise ValueError(f"MCQUIC_COORDINATOR is set but {', '.join(missing)} is not")
    worldSize = int(os.environ["MCQUIC_NUM_PROCESSES"])
    rankId = int(os.environ["MCQUIC_PROCESS_ID"])
    if not 0 <= rankId < worldSize:
        raise ValueError(f"MCQUIC_PROCESS_ID {rankId} is outside [0, {worldSize})")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(rankId % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=worldSize,
                            rank=rankId)
    logger.info("rank %d of %d joined %s over %s", rankId, worldSize, coordinator, backend)
    return True


def destroy():
    """Leave the process group, where one was started."""
    if initialized():
        dist.destroy_process_group()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def isMain() -> bool:
    return rank() == 0


def localDevice(device: torch.device) -> torch.device:
    """The card this rank drives: `cuda:{rank % cards}` for a CUDA device
    without an index inside a process group, `device` otherwise."""
    if device.type == "cuda" and device.index is None and initialized():
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return device


def barrier():
    if initialized():
        dist.barrier()


def allReduceSum_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over the ranks, in place, through one flat buffer per
    dtype (one collective each, at world 1 too). A no-op without a process
    group."""
    tensors = list(tensors)
    if not initialized() or not tensors:
        return tensors
    byType = {}
    for t in tensors:
        byType.setdefault(t.dtype, []).append(t)
    for group in byType.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def allReduceMean_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, in place (`allReduceSum_`,
    then a division by the world size). A no-op without a process group."""
    tensors = allReduceSum_(tensors)
    if world() > 1 and tensors:
        torch._foreach_div_(tensors, float(world()))
    return tensors


def anyRank(flag: bool, device) -> bool:
    """True on every rank when `flag` is true on any (one all-reduce of a
    scalar on `device`); `flag` itself without a process group."""
    if not initialized():
        return flag
    value = torch.tensor([1.0 if flag else 0.0], device=device)
    allReduceSum_([value])
    return bool(value.item() > 0)


def broadcastObject(obj):
    """Rank 0's `obj` on every rank (picklable; a path, a number)."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shardedRows(draw):
    """A draw function (shape -> tensor) for values whose leading axis is
    the batch: it draws world x the rows and keeps this rank's slice
    [rank * n, (rank + 1) * n), so every rank's generator stays in step and
    the ranks' slices together are one process's draw at the global batch."""
    if world() == 1:
        return draw
    r, w = rank(), world()

    def sharded(shape):
        n = shape[0]
        return draw((w * n, *shape[1:]))[r * n:(r + 1) * n]

    return sharded


def zeroSpec(shape: Sequence[int], world: int) -> Optional[int]:
    """The axis along which a leaf of `shape` is sharded over `world` ranks,
    or None to replicate it: the rule of the JAX package's
    `_zeroSpecForLeaf` (`mcquic_tpu/parallel/__init__.py:44-56`), the
    largest axis whose size is a multiple of the world size and at least
    the world size, a tie going to the later axis. Scalars and leaves with
    no such axis are replicated. It reads the shape and the world size
    only, so every rank derives the same spec (two ranks that disagreed
    would wait on each other's collectives forever)."""
    candidates = [(dim, axis) for axis, dim in enumerate(shape)
                  if dim % world == 0 and dim >= world]
    return max(candidates)[1] if shape and candidates else None


def shardOf(t: torch.Tensor, axis: Optional[int], rankId: int = None) -> torch.Tensor:
    """Rank `rankId`'s slice (this rank's by default) of `t` along `axis`,
    a view; `t` itself where `axis` is None."""
    if axis is None:
        return t
    size = t.shape[axis] // world()
    return t.narrow(axis, (rank() if rankId is None else rankId) * size, size)


def allGather_(tensors: Sequence[torch.Tensor], axes: Sequence[Optional[int]]):
    """Complete each tensor from its shards, in place: every rank holds its
    own slice along `axes[i]` (`shardOf`), and afterwards every slice of
    every rank. One flat buffer per dtype, one collective each; tensors
    whose axis is None are left as they are. A no-op without a process
    group."""
    if not initialized():
        return
    byType = {}
    for t, axis in zip(tensors, axes):
        if axis is not None:
            byType.setdefault(t.dtype, []).append((t, axis))
    for group in byType.values():
        flat = torch.cat([shardOf(t, axis).reshape(-1) for t, axis in group])
        gathered = torch.empty(world() * flat.numel(), dtype=flat.dtype, device=flat.device)
        parts = list(gathered.chunk(world()))
        dist.all_gather(parts, flat)
        del flat
        for r, part in enumerate(parts):
            offset = 0
            for t, axis in group:
                shard = shardOf(t, axis, r)
                if r != rank():
                    shard.copy_(part[offset:offset + shard.numel()].view(shard.shape))
                offset += shard.numel()


# Column-parallel (output dim sharded) / row-parallel (input dim sharded)
# projection names in the generators' transformers
# (`mcquic_tpu/parallel/__init__.py:76-80`).
_COL_PARALLEL = {"wq", "wk", "wv", "wkY", "wvY", "w1", "w3", "qkv", "fc1"}
_ROW_PARALLEL = {"wo", "w2", "proj", "fc2"}


def generatorShardings(model: torch.nn.Module, tpSize: int):
    """{parameter name: `Shard(0)`, `Shard(1)` or `Replicate()`} for a
    generator (`GeneratorV3SelfAttention` and its variants, `GeneratorVAR`)
    at tensor-parallel size `tpSize` (counterpart of
    `mcquic_tpu/parallel/__init__.py:83 generatorShardings`).

    Attention q/k/v and the FFN up-projections are column-parallel, the
    output projections row-parallel, everything else (biases, norms,
    embeddings, the frozen compressor) replicated; a projection whose
    sharded dim `tpSize` does not divide stays replicated, and so does
    everything at `tpSize` 1. `nn.Linear.weight` is [out, in], so
    column-parallel is `Shard(0)` and row-parallel `Shard(1)` (the JAX
    package's flax kernels are [in, out])."""
    from torch.distributed.tensor import Replicate, Shard
    placements = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        placement = Replicate()
        if tpSize > 1 and len(parts) >= 2 and parts[-1] == "weight" and p.dim() == 2:
            if parts[-2] in _COL_PARALLEL and p.shape[0] % tpSize == 0:
                placement = Shard(0)
            elif parts[-2] in _ROW_PARALLEL and p.shape[1] % tpSize == 0:
                placement = Shard(1)
        placements[name] = placement
    return placements
