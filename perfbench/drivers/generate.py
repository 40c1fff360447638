"""Class-conditional sampling through the `generate` CLI's path.

Closed loop, one process: each call is `generate.sample(model, classes,
seed, temperature, topK)` for `batch` class ids drawn from the seed, which
samples every level's codes through the KV-cached loop, decodes them with
Neon and brings the uint8 images to the host. Every `greedy_every`-th call
is greedy (topK 1), the others draw at temperature 1.0 with no top-k, the
CLI's defaults. The model is the configuration's generator on weights made
from the seed (`weights.seeded`), loaded as `generate.loadGenerator` loads
a checkpoint.

Held to the reference, after the window: `sample_greedy` greedy calls and
`sample_drawn` drawing calls, drawn from the seed. `greedy_gap` is the
widest gap by which a greedy token's logit lies below the reference's
best at its position, the reference run teacher-forced over the call's
codes; `image_err` the largest difference, in levels, between a call's
images and the reference's decode of its codes, less the half level that
rounding to uint8 alone gives.
"""
import itertools
import time

import numpy as np
import torch

from perfbench import count, weights
from perfbench.reference.generator import Generator

ROUNDING = 0.5       # levels: a uint8 is its value rounded
GEOMETRY = ("channel", "k", "size", "hiddenSize", "depth", "nHeads", "numClasses")


def calls(classes: int, batch: int, every: int, seed: int):
    """(class ids, sampling seed, greedy) of every call in order, from the seed."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, classes, batch).tolist(), int(rng.integers(1 << 62)),
             i % every == every - 1) for i in range(4096)]


class Driver:
    def __init__(self, run):
        self.run = run
        self.geometry = {key: run.config[key] for key in GEOMETRY}
        self.batch = int(run.traffic["batch"])
        self.every = int(run.traffic["greedy_every"])

    def _state(self):
        return weights.seeded(weights.shapesOf(lambda: Generator(**self.geometry)),
                              self.run.seed, self.run.device)

    def setup(self):
        run = self.run
        from mcquic_tpu_torch import generate
        from mcquic_tpu_torch.utils.registry import GeneratorRegistry
        self.sample = generate.sample
        state = self._state()
        with torch.device(run.device):
            model = GeneratorRegistry.get(run.config["model"])(**self.geometry)
        model.load_state_dict(state, strict=True)
        del state
        self.model = model.eval().requires_grad_(False)
        self.calls = calls(self.geometry["numClasses"], self.batch, self.every, run.seed)
        for classes, seed, greedy in (self.calls[0], self.calls[self.every - 1]):
            self._call(classes, seed, greedy)
        run.synchronize()

    def _call(self, classes, seed, greedy):
        return self.sample(self.model, classes, seed, 1.0, 1 if greedy else 0)

    def _spans(self):
        """The benchmark's spans around the sampling loop (host clock, ending
        in a synchronize) and Neon's decode (CUDA events), traced runs only."""
        model, run = self.model, self.run
        sampleCodes, decode = model.sampleCodes, model.compressor.decode
        events = []

        def timedCodes(*args, **kwargs):
            start = time.perf_counter()
            out = sampleCodes(*args, **kwargs)
            run.synchronize()
            run.spans["sampleCodes"].append(time.perf_counter() - start)
            return out

        def timedDecode(*args, **kwargs):
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin.record()
            out = decode(*args, **kwargs)
            end.record()
            events.append((begin, end))
            return out
        model.sampleCodes = timedCodes
        if torch.device(run.device).type == "cuda":
            model.compressor.decode = timedDecode
        return events

    def window(self):
        run = self.run
        events = self._spans() if run.traceOn else []
        self.done = 0
        rng = np.random.default_rng(run.seed + 1)
        keep = {True: int(run.traffic["sample_greedy"]), False: int(run.traffic["sample_drawn"])}
        seen = {True: 0, False: 0}
        self.kept = {True: [], False: []}
        run.startWindow()
        with run.phase("generate"):
            start = time.perf_counter()
            for classes, seed, greedy in itertools.cycle(self.calls):
                codes, images = self._call(classes, seed, greedy)
                self.done += 1
                seen[greedy] += 1          # a reservoir of each kind, drawn from the seed
                item = (classes, [c.cpu() for c in codes], images)
                if seen[greedy] <= keep[greedy]:
                    self.kept[greedy].append(item)
                elif rng.integers(seen[greedy]) < keep[greedy]:
                    self.kept[greedy][int(rng.integers(keep[greedy]))] = item
                if time.perf_counter() - start >= run.seconds:
                    break
            elapsed = time.perf_counter() - start
        run.attempted = self.done * self.batch
        run.endToEnd["images_per_s"] = self.done * self.batch / elapsed
        if run.traceOn:
            run.synchronize()
            run.spans["neonDecode"] = [b.elapsed_time(e) / 1e3 for b, e in events]
            self._work()

    def _work(self):
        """K3's calls per generate and the reference's operations per call."""
        g, n = self.geometry, self.batch
        heads, width = g["nHeads"], g["hiddenSize"] // g["nHeads"]
        lengths = [s * s for s in sorted(g["size"])]
        perCall, prefix = [], 0
        for hw in lengths:
            prefix += hw
            perCall += [count.k3(n, heads, hw, prefix, width)] * g["depth"]

        def codes():
            return [torch.zeros(n, 1, s, s, dtype=torch.long) for s in sorted(g["size"])]
        flops = count.modelFlops(lambda: Generator(**g), lambda model: (
            model.logits(codes(), torch.zeros(n, dtype=torch.long)),
            model.compressor.decode(codes())))
        calls = self.done
        self.run.work["generate"] = {"k3": perCall * calls, "flops": flops * calls}

    def release(self):
        del self.model

    def check(self, control: bool = False):
        """Hold the sampled calls to the reference; with `control`, the
        reference in TF32 takes the program's place: its first token at each
        position of the same codes, its decode of the same codes."""
        run = self.run
        from perfbench.reference import precision
        with torch.device(run.device):
            ref = Generator(**self.geometry)
        ref.load_state_dict(self._state(), strict=True)
        ref.eval()
        gap, imageErr = 0.0, -ROUNDING
        with precision():
            for greedy in (True, False):
                for classes, codes, images in self.kept[greedy]:
                    codes = [c.to(run.device) for c in codes]
                    if greedy:
                        labels = torch.tensor(classes, device=run.device)
                        chosen = [c.reshape(c.shape[0], -1, 1).long() for c in codes]
                        if control:
                            with precision(tf32=True):
                                chosen = [lg.argmax(-1, keepdim=True)
                                          for lg in ref.logits(codes, labels)]
                        for logits, token in zip(ref.logits(codes, labels), chosen):
                            best = logits.max(-1, keepdim=True).values
                            gap = max(gap, float((best - logits.gather(-1, token)).max()))
                    if control:
                        with precision(tf32=True):
                            y = ref.compressor.decode(codes).permute(0, 2, 3, 1)
                        images = np.clip(np.round((y.cpu().numpy() * 0.5 + 0.5) * 255.0), 0, 255)
                    y = ref.compressor.decode(codes).permute(0, 2, 3, 1).double()
                    level = ((y * 0.5 + 0.5) * 255.0).clamp(0, 255).cpu().numpy()
                    imageErr = max(imageErr, float(np.abs(level - images.astype(np.float64)).max())
                                   - ROUNDING)
        limits = run.config["limits"]
        run.check("greedy_gap", gap, limits["greedy_gap"])
        run.check("image_err", imageErr, limits["image_err"])
