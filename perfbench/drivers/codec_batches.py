"""Batches of photos through the codec engine's pipelined entries.

Closed loop, one process. Set-up makes a pool of `pool` images of the
photo's size from the seed (`images.variants`) and cycles it in a seeded
order, `batch` images at a time. The first half of the window runs
`CompressorEngine.compressMany` over as many batches as it takes for half
the window, the second half `decompressMany` over the streams the first
half wrote, again for half the window, `chunk` batches to a call, as a user
restoring a folder hands out what each call restored before the next: a
call returns every restored batch at once, and holding a whole half's
(gigabytes of float images) would pin new host memory for every batch.
Each half's rate is its pixels over its whole time, the last batch
included.

Traffic parameters: `batch`, `pool`, `chunk`, `sample` (batches of each
half held to the reference, drawn from the seed).
"""
import time

import numpy as np
import torch

from perfbench import codec, count, images


def order(pool: int, seed: int) -> np.ndarray:
    """The pool's images in the order the window sends them: a fresh
    permutation per pass, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.permutation(pool) for _ in range(256)])


class Driver:
    def __init__(self, run):
        self.run = run
        self.traffic = run.traffic
        self.batch = int(self.traffic["batch"])
        self.chunk = int(self.traffic["chunk"])

    def setup(self):
        run = self.run
        self.engine = codec.engine(run.config, run.seed, run.device)
        self.pool = images.variants(images.readPng(), int(self.traffic["pool"]), run.seed,
                                    run.device)
        self.h, self.w = self.pool.shape[1:3]
        self.order = order(len(self.pool), run.seed)
        warm = self.engine.compressMany([self.pool[:self.batch]] * 2)
        self.engine.decompressMany(warm)
        run.synchronize()

    def _batches(self, deadline: float, out: list):
        at = 0
        while not out or time.perf_counter() < deadline:
            rows = self.order[at:at + self.batch]
            at = (at + self.batch) % (len(self.order) - self.batch)
            out.append(rows)
            yield self.pool[rows]

    def _items(self, written, deadline: float, out: list, count: int):
        """Up to `count` more batches of streams, while the half lasts."""
        for _ in range(count):
            if out and time.perf_counter() >= deadline:
                return
            out.append(len(out) % len(written))
            yield written[out[-1]]

    def window(self):
        run, half = self.run, self.run.seconds / 2
        sample = int(self.traffic["sample"])
        rng = np.random.default_rng(run.seed + 1)
        run.startWindow()
        self.compressed = []
        with run.phase("compress"):
            start = time.perf_counter()
            self.written = self.engine.compressMany(self._batches(start + half, self.compressed))
            compressS = time.perf_counter() - start
        self.decompressed, self.checkRestored = [], {}
        with run.phase("decompress"):
            start = time.perf_counter()
            while not self.decompressed or time.perf_counter() < start + half:
                first = len(self.decompressed)
                chunk = self.engine.decompressMany(
                    self._items(self.written, start + half, self.decompressed, self.chunk))
                for j, restored in enumerate(chunk, first):     # a reservoir of batches
                    if j < sample:
                        self.checkRestored[j] = restored
                    elif rng.integers(j + 1) < sample:
                        del self.checkRestored[sorted(self.checkRestored)[rng.integers(sample)]]
                        self.checkRestored[j] = restored
            decompressS = time.perf_counter() - start
        pixels = self.h * self.w * self.batch
        run.endToEnd["compress_mpps"] = len(self.compressed) * pixels / compressS / 1e6
        run.endToEnd["decompress_mpps"] = len(self.decompressed) * pixels / decompressS / 1e6
        run.attempted = (len(self.compressed) + len(self.decompressed)) * self.batch
        self.checkCompressed = rng.choice(len(self.compressed), min(sample, len(self.compressed)),
                                          replace=False)
        if run.traceOn:
            self._work()

    def _work(self):
        """Shapes of each half's kernel calls and the model's operations."""
        run, cfg = self.run, self.run.config
        c, m, ks = cfg["channel"], cfg["m"], cfg["k"]
        H, W = self.h + (-self.h) % 128, self.w + (-self.w) % 128
        n = self.batch
        perBatch = [count.k1(m, n * (H // 16 >> lv) * (W // 16 >> lv), k, c // m)
                    for lv, k in enumerate(ks)]
        geometry = codec.geometry(cfg)
        grids = [(H // 16 >> lv, W // 16 >> lv) for lv in range(len(ks))]

        def flops(fn):
            from perfbench.reference import v1
            return count.modelFlops(lambda: v1.Compressor(**geometry), fn)
        encode = flops(lambda model: model.encode(torch.zeros(n, 3, H, W)))
        decode = flops(lambda model: model.decode(
            [torch.zeros(n, m, gh, gw, dtype=torch.long) for gh, gw in grids]))
        run.work["compress"] = {"k1": perBatch * len(self.compressed),
                                "flops": encode * len(self.compressed)}
        run.work["decompress"] = {"k2": [count.k2(n, c, H // 2, W // 2, 3, 2)]
                                  * len(self.decompressed),
                                  "flops": decode * len(self.decompressed)}

    def release(self):
        del self.engine

    def check(self, control: bool = False):
        """Hold the sampled outputs to the reference; with `control`, hold
        the reference's own outputs in TF32 in the program's place."""
        run = self.run
        ref = codec.reference(run.config, run.seed, run.device)
        judge = codec.Judge(ref, run.device)
        from perfbench.reference import precision
        with precision():
            for i in self.checkCompressed:
                binaries, headers = self.written[i]
                batch = self.pool[self.compressed[i]]
                codes = judge.batchCodes(headers, binaries, self.h, self.w)
                if control:
                    with precision(tf32=True):
                        codes = ref.encode(codec.toInput(batch, run.device))
                if codes is not None:
                    judge.gap(batch, codes)
            for j, restored in self.checkRestored.items():
                binaries, headers = self.written[self.decompressed[j]]
                codes = judge.batchCodes(headers, binaries, self.h, self.w)
                if codes is not None:
                    if control:
                        with precision(tf32=True):
                            restored = judge.decode(codes, self.h, self.w)
                    err = np.abs(judge.decode(codes, self.h, self.w) - restored).max()
                    judge.decodeErr = max(judge.decodeErr, float(err))
        limits = run.config["limits"]
        run.check("stream_faults", judge.streamFaults, 0)
        run.check("code_gap", judge.codeGap, limits["code_gap"])
        run.check("decode_err", judge.decodeErr, limits["decode_err"])
