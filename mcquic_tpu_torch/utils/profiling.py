"""Where the time goes on the card.

    python -m mcquic_tpu_torch.utils.profiling [-qp 2] [--image PATH] [--iters 10]
    python -m mcquic_tpu_torch.utils.profiling --mode generate [--checkpoint PATH]
                                               [--classes 1,207,360,980] [--iters 10]
    python -m mcquic_tpu_torch.utils.profiling --mode speed [--iters 50]

The codec mode loads the zoo model and reports compress and restore of one
image. The generate mode loads a generator checkpoint, or, without one,
writes a seeded gen_stage2_neonA checkpoint (`generate.writeSeededGenerator`)
to a temporary directory, and reports greedy sampling of the given classes:
the whole `generate` with and without the KV cache, its codes alone and
Neon's decode alone. The speed mode runs the reference's speed protocol
(`Validator.speed`: 50 iterations of a [10, 768, 512, 3] batch through
`compress`, then `decompress`, rANS and transfers included) and the model
alone (`Validator.speedModel`), in Mpps, for the qp-2 zoo model and for the
seeded qp-12 (channel 192, m 12, k [8192, 2048, 512]) and past-budget
(channel 128, m 2, k [16384, 2048, 512]) geometries, then profiles one
compress and one decompress of that batch. For each profiled call it reports:
  * wall ms (host clock around a call that ends in synchronize; median),
  * device busy ms: the time in which any CUDA kernel, copy or fill ran
    over one call under torch.profiler (the union of their intervals, so
    work on two streams at once counts once), and the idle share
    1 - busy / wall,
  * the kernels that take the most device time,
  * the port's spans (`utils/tracing.py`) the call left, by name: how many,
    their total ms, how many ran on another thread than the call's, and
    their summed `images`, `bytes` and `tokens` with each one's rate over
    the spans' time (images/s, MB/s: for `engine.ransEncode` the rANS
    coder's throughput); then the call's batches, each from its first
    span's start to its last span's end, across threads.
Needs a CUDA card; it prints the card's name and power limit first.
"""
import argparse
import statistics
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mcquic_tpu_torch.utils import tracing


PHOTO = Path(__file__).resolve().parent.parent.parent / "assets" / "photo_768x512.png"


def _wallMs(fn, iters: int) -> float:
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def unionLength(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


class SpanSummary(NamedTuple):
    count: int
    ms: float                   # summed over the spans
    counts: Dict[str, int]      # each count summed over the spans
    elsewhere: int              # spans on another thread than the caller's


def spanTable(spans: Sequence[tracing.Span], caller: int
              ) -> Tuple[Dict[str, SpanSummary], List[float]]:
    """The spans summed by name, and the ms of each batch they belong to,
    from its first span's start to its last span's end. `caller`: the OS id
    of the thread that made the call."""
    table: Dict[str, SpanSummary] = {}
    batches: Dict[int, Tuple[int, int]] = {}
    for s in spans:
        count, ms, counts, elsewhere = table.get(s.name, (0, 0.0, {}, 0))
        counts = {k: counts.get(k, 0) + s.counts.get(k, 0) for k in {*counts, *s.counts}}
        table[s.name] = SpanSummary(count + 1, ms + (s.end - s.start) / 1e6, counts,
                                    elsewhere + (s.thread != caller))
        first, last = batches.get(s.batch, (s.start, s.end))
        batches[s.batch] = (min(first, s.start), max(last, s.end))
    return table, [(last - first) / 1e6 for first, last in batches.values()]


def _rate(key: str, total: int, ms: float) -> str:
    """A count summed over spans, and its rate over their time."""
    rate = f"{total / 1e3 / ms:.1f} MB/s" if key == "bytes" else f"{total * 1e3 / ms:.1f}/s"
    return f"{key} {total} ({rate})" if ms > 0 else f"{key} {total}"


def report(name: str, fn, iters: int, top: int):
    """Prints the call's wall ms, device busy ms, idle share, top kernels and
    spans; returns (wall ms, busy ms, idle share)."""
    wall = _wallMs(fn, iters)
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    byName, intervals = {}, []
    for e in prof.events():
        # kernels, copies and fills on the card: not the device-side copies of
        # annotations (`Optimizer.step`'s), nor the runtime's calls or waits
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation \
                and not e.name.startswith("cuda") and "Sync" not in e.name:
            total, count = byName.get(e.name, (0.0, 0))
            byName[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
            intervals.append((e.time_range.start, e.time_range.end))
    busy = unionLength(intervals) / 1e3
    print(f"{name}: wall {wall:.3f} ms (median of {iters}), device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for kernel, (total, count) in sorted(byName.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {total:9.3f} ms  {count:5d}x  {kernel[:110]}")
    table, batches = spanTable([s for s in tracing.spans() if s.start >= since],
                               threading.get_native_id())
    for span, summary in sorted(table.items(), key=lambda kv: -kv[1].ms):
        where = f", {summary.elsewhere} on another thread" if summary.elsewhere else ""
        counts = "; ".join(_rate(k, v, summary.ms) for k, v in sorted(summary.counts.items()))
        print(f"  span {span}: {summary.count}x, {summary.ms:.3f} ms{where}; {counts}")
    if batches:
        print(f"  spans' batches: {len(batches)}, first start to last end "
              f"{statistics.mean(batches):.3f} ms each")
    return wall, busy, 1 - busy / wall


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=("codec", "generate", "speed"), default="codec")
    p.add_argument("--checkpoint", default=None, help="generator checkpoint (generate mode)")
    p.add_argument("--classes", default="1,207,360,980", help="class ids (generate mode)")
    p.add_argument("-qp", type=int, default=2)
    p.add_argument("--image", default=str(PHOTO))
    p.add_argument("--iters", type=int, default=None,
                   help="iterations (default 10; 50 in speed mode, the reference's protocol)")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=20).stdout.strip())
    if args.mode == "speed":
        return speedReport(args.iters or 50, args.top)
    args.iters = args.iters or 10
    if args.mode == "generate":
        return generateReport(args)
    from mcquic_tpu_torch.data.dataset import readImage
    from mcquic_tpu_torch.demo import loadModel
    engine = loadModel(qp=args.qp, device="cuda")
    img = readImage(args.image)
    file = engine.compressImage(img)
    engine.decompressImage(file)
    print(f"{Path(args.image).name} {img.shape[1]}x{img.shape[0]}, qp {args.qp}: "
          f"{file.BPP:.4f} bpp")
    report("compress", lambda: engine.compressImage(img), args.iters, args.top)
    report("restore", lambda: engine.decompressImage(file), args.iters, args.top)


def generateReport(args):
    import tempfile

    from mcquic_tpu_torch.generate import loadGenerator, writeSeededGenerator
    from mcquic_tpu_torch.utils import exactFp32
    with tempfile.TemporaryDirectory() as tmp:
        path = args.checkpoint or writeSeededGenerator(Path(tmp) / "gen_stage2_neonA.npz")
        model = loadGenerator(path, device="cuda")
    classes = [int(c) for c in args.classes.split(",")]
    condition = torch.tensor(classes, device="cuda")
    print(f"generator {model.hiddenSize} wide, depth {model.depth}, {sum(model.lengths)} tokens "
          f"over {len(model.lengths)} levels, batch {len(classes)} (greedy, fp32, TF32 off)")
    with exactFp32(), torch.inference_mode():
        codes = model.sampleCodes(condition)
        for kvCache in (True, False):
            report(f"generate kvCache={kvCache}",
                   lambda: model.generate(condition, kvCache=kvCache), args.iters, args.top)
        report("codes only (kvCache)", lambda: model.sampleCodes(condition), args.iters, args.top)
        report("Neon decode", lambda: model.compressor.decode(codes), args.iters, args.top)


SPEED_GEOMETRIES = {"qp-12": (192, 12, [8192, 2048, 512]),
                    "past-budget": (128, 2, [16384, 2048, 512])}


def speedReport(iters: int, top: int):
    import json

    from mcquic_tpu_torch.demo import loadModel
    from mcquic_tpu_torch.models.compressor import seededCompressor
    from mcquic_tpu_torch.models.engine import CompressorEngine
    from mcquic_tpu_torch.validate.validator import Validator
    name = torch.cuda.get_device_name(0)
    for cell in ("qp-2", *SPEED_GEOMETRIES):
        if cell == "qp-2":
            engine = loadModel(qp=2, device="cuda")
        else:
            engine = CompressorEngine(seededCompressor(*SPEED_GEOMETRIES[cell]), qp="-1",
                                      device="cuda")
        validator = Validator(engine)
        encode, decode = validator.speed(iters)
        modelEncode, modelDecode = validator.speedModel(iters)
        print(json.dumps({"cell": cell, "iters": iters, "batch": [10, 768, 512, 3],
                          "encodeMpps": encode, "decodeMpps": decode,
                          "modelEncodeMpps": modelEncode, "modelDecodeMpps": modelDecode,
                          "device": name}), flush=True)
        x = validator.speedBatch(10, 768, 512)
        _, binaries, headers = engine.compress(x)
        report(f"{cell} compress [10, 768, 512]", lambda: engine.compress(x), 3, top)
        report(f"{cell} decompress [10, 768, 512]",
               lambda: engine.decompress(binaries, headers), 3, top)
        del engine, validator
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
