"""Optimizers with optax's update rules (counterpart of
`mcquic_tpu/train/optim.py`, reference `mcquic/train/ddp.py:53-76`): Adam,
AdamW, SGD and LAMB, which is also registered as `FusedLAMB`.

optax's rules, which differ from `torch.optim`'s:
  * Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, and the update
    mu_hat / (sqrt(nu_hat) + eps) with ε added after the bias-corrected
    root (`scale_by_adam`); torch adds ε to sqrt(nu) before its correction;
  * AdamW adds weight_decay * p to that update (`add_decayed_weights`);
    Adam with a weight decay is AdamW, as the JAX package builds it;
  * LAMB is `scale_by_adam` -> `add_decayed_weights` -> `scale_by_trust_ratio`:
    each tensor's update is scaled by ||p|| / ||update||, or by 1 where
    either norm is 0; torch has no LAMB;
  * SGD: the trace g + momentum * trace (Nesterov: g + momentum * new trace),
    after g + weight_decay * p;
  * the step is -lr(count) * update, lr from the schedule at the count of
    updates already applied.

The optimizer updates its parameters in place, under `torch.no_grad`, so a
codebook keeps its tensor (and kernel K1's norm cache sees the write through
the version counter). `count` advances only with an applied update: a skipped
step leaves the whole state as it was, as the JAX step does.

Inside a process group of more than one rank the state is sharded, as the
JAX trainers shard it (`zeroShardings`): each parameter whose shape has an
axis `parallel.zeroSpec` picks keeps its slots for this rank's slice of that
axis only; the others keep them whole. A step reads the gradients (already
averaged over the ranks), computes the update of the rank's slice, writes it
into the parameter in place and all-gathers the slices, so every rank holds
the whole parameter again. Adam and SGD are elementwise, so the parameters
are bit-identical to the unsharded optimizer's; LAMB's trust ratio takes
each sharded tensor's norms from the ranks' sums of squares (one all-reduce
per step), equal up to the order of the sum. `count` and the schedule are
the same on every rank. With one rank, or no process group, nothing is
sharded.
"""
from typing import Callable, Dict, List, Sequence

import torch

from mcquic_tpu_torch import parallel
from mcquic_tpu_torch.utils.registry import OptimizerRegistry


class Optimizer:
    """optax-style state over a fixed list of parameters: `count` and, by
    rule, the moments `mu` / `nu` (Adam family) or the `trace` (SGD with
    momentum), each a list parallel to the parameters."""

    slots: Sequence[str] = ()

    def __init__(self, params: List[torch.Tensor], schedule: Callable[[int], float]):
        self.params = list(params)
        self.schedule = schedule
        self.count = 0
        world = parallel.world()
        # the sharded axis of each parameter (None: whole on every rank)
        self.axes = [parallel.zeroSpec(tuple(p.shape), world) if world > 1 and self.slots
                     else None for p in self.params]
        self.state: Dict[str, List[torch.Tensor]] = {
            slot: [torch.zeros_like(self.local(p, i)) for i, p in enumerate(self.params)]
            for slot in self.slots}

    def local(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of `t`, a tensor shaped as parameter i (a view)."""
        return parallel.shardOf(t, self.axes[i])

    def stateBytes(self) -> int:
        """The bytes of the slots this rank holds."""
        return sum(t.numel() * t.element_size() for ts in self.state.values() for t in ts)

    def wholeSlot(self, slot: str, i: int) -> torch.Tensor:
        """Parameter i's whole `slot` tensor on every rank: its shards
        all-gathered where it is sharded (a collective: every rank calls it
        for the same i in the same order), the slot itself otherwise."""
        shard, axis = self.state[slot][i], self.axes[i]
        if axis is None:
            return shard
        parts = [torch.empty_like(shard) for _ in range(parallel.world())]
        torch.distributed.all_gather(parts, shard.contiguous())
        return torch.cat(parts, axis)

    def direction(self, params: List[torch.Tensor],
                  grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The update of `params` (this rank's slices) from their `grads`."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        """Apply one update from `grads` (parallel to the parameters, whole
        on every rank)."""
        params = [self.local(p, i) for i, p in enumerate(self.params)]
        updates = self.direction(params, [self.local(g, i) for i, g in enumerate(grads)])
        torch._foreach_add_(params, torch._foreach_mul(updates, -self.schedule(self.count)))
        self.count += 1
        parallel.allGather_(self.params, self.axes)


class Adam(Optimizer):
    """`optax.adam`, `optax.adamw` (weight_decay > 0) and, with `trustRatio`,
    `optax.lamb`."""

    slots = ("mu", "nu")

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, trustRatio: bool = False):
        super().__init__(params, schedule)
        self.b1, self.b2 = betas
        self.eps, self.weightDecay, self.trustRatio = eps, weight_decay, trustRatio

    def direction(self, params, grads):
        mu, nu = self.state["mu"], self.state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - self.b2))
        t = self.count + 1
        muHat = torch._foreach_div(mu, 1 - self.b1 ** t)
        nuHat = torch._foreach_div(nu, 1 - self.b2 ** t)
        updates = torch._foreach_div(muHat, torch._foreach_add(torch._foreach_sqrt(nuHat), self.eps))
        if self.weightDecay:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weightDecay))
        if self.trustRatio:
            paramNorms, updateNorms = self.wholeNorms(params, updates)
            ratios = [torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                      for pn, un in zip(paramNorms, updateNorms)]
            torch._foreach_mul_(updates, ratios)
        return updates

    def wholeNorms(self, params, updates):
        """Each whole parameter's and update's 2-norm from this rank's
        slices: a sharded tensor's from the ranks' sums of squares, all in
        one all-reduce."""
        paramNorms = list(torch._foreach_norm(params))
        updateNorms = list(torch._foreach_norm(updates))
        sharded = [i for i, axis in enumerate(self.axes) if axis is not None]
        if sharded:
            squares = torch.stack([paramNorms[i] ** 2 for i in sharded]
                                  + [updateNorms[i] ** 2 for i in sharded])
            parallel.allReduceSum_([squares])
            roots = squares.sqrt()
            for j, i in enumerate(sharded):
                paramNorms[i], updateNorms[i] = roots[j], roots[len(sharded) + j]
        return paramNorms, updateNorms


class SGD(Optimizer):
    """`optax.sgd`, after `add_decayed_weights` where weight_decay > 0."""

    def __init__(self, params, schedule, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        self.slots = ("trace",) if momentum else ()
        super().__init__(params, schedule)
        self.momentum, self.nesterov, self.weightDecay = momentum, nesterov, weight_decay

    def direction(self, params, grads):
        if self.weightDecay:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, self.weightDecay))
        if not self.momentum:
            return list(grads)
        trace = self.state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        if self.nesterov:
            return torch._foreach_add(grads, torch._foreach_mul(trace, self.momentum))
        return [t.clone() for t in trace]


@OptimizerRegistry.register(key="Adam")
def adam(params, schedule, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **_):
    return Adam(params, schedule, betas, eps, weight_decay)


@OptimizerRegistry.register(key="AdamW")
def adamw(params, schedule, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2, **_):
    return Adam(params, schedule, betas, eps, weight_decay)


@OptimizerRegistry.register(key="Lamb")
@OptimizerRegistry.register(key="FusedLAMB")
def lamb(params, schedule, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0, **_):
    return Adam(params, schedule, betas, eps, weight_decay, trustRatio=True)


@OptimizerRegistry.register(key="SGD")
def sgd(params, schedule, momentum=0.0, nesterov=False, weight_decay=0.0, **_):
    return SGD(params, schedule, momentum, nesterov, weight_decay)


def getOptimizer(key: str, schedule, params: dict, parameters: List[torch.Tensor]) -> Optimizer:
    """The optimizer of a config's `optim` section over `parameters`; its
    `lr` is the schedule's base and dropped here, and the apex-only
    `use_nvlamb` is ignored, as `mcquic_tpu/train/optim.py::getOptimizer` does."""
    kwargs = {k: v for k, v in params.items() if k not in ("lr", "use_nvlamb")}
    return OptimizerRegistry.get(key)(parameters, schedule, **kwargs)
