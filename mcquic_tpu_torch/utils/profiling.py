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
  * device busy ms: the sum of CUDA kernel and copy time that
    torch.profiler records over one call, and the idle share
    1 - busy / wall,
  * the kernels that take the most device time.
Needs a CUDA card; it prints the card's name and power limit first.
"""
import argparse
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


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


def report(name: str, fn, iters: int, top: int):
    """Prints the call's wall ms, device busy ms, idle share and top kernels;
    returns (wall ms, busy ms, idle share)."""
    wall = _wallMs(fn, iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    byName = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:            # kernels and copies on the card
            total, count = byName.get(e.name, (0.0, 0))
            byName[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    busy = sum(total for total, _ in byName.values())
    print(f"{name}: wall {wall:.3f} ms (median of {iters}), device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for kernel, (total, count) in sorted(byName.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {total:9.3f} ms  {count:5d}x  {kernel[:110]}")
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
