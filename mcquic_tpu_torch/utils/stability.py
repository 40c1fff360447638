"""Are the codec's codes a function of the image and the model alone?

    python -m mcquic_tpu_torch.utils.stability [--processes 24] [--parallel 4]
                                               [--settings autotuned,heuristic,native]
                                               [--speed-iters 50] [--out DIR]

For each setting of cuDNN under which the engine encodes, it compresses the
photo (`assets/photo_768x512.png`) as `--tile 256` tiles with the qp-2 zoo
model through the codec CLI (`cli.main`) in `--processes` fresh processes,
`--parallel` at a time. One more process then compresses the same tiles in
process, as one batch (`compressTiled`) and one tile at a time
(`compressImage`), and counts the rANS streams and the codes of every other
process and of the batch-1 run that differ from the in-process batch. For
each code that differs it prints the gap, in the in-process latent, between
the best and the second-best squared distance of that token, the gap to the
other process's codeword, and whether a coarser level of that tile differed
first. Over every token of the tiles it also reports the gap between the
best and the second-best codeword, in fp64 and relative to the token's
squared norm, and keeps the tokens; once every setting has run, it reports
how far each setting's latents moved that gap from the first setting's, and
how many tokens lie closer to a tie than that. The same process then runs
the reference's speed protocol
(`Validator.speed`: encode and decode Mpps of a seeded [10, 768, 512, 3]
batch, rANS and transfers included) on the qp-2 zoo model and on the seeded
qp-12 geometry.

The settings (TF32 off in all):
  * autotuned: cuDNN times its candidate algorithms in each process
    (`benchmark=True, deterministic=False`);
  * heuristic: cuDNN's heuristics choose, and only deterministic algorithms
    (`benchmark=False, deterministic=True`): the choice depends on the shape,
    the card and the library;
  * native: cuDNN off, PyTorch's own CUDA convolutions.
Each process is told its setting through its command line, and the engine's
numerics are replaced for that process only. Needs a CUDA card; prints the
card's name and power limit first, and the results as JSON last.
"""
import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
PHOTO = ROOT / "assets" / "photo_768x512.png"
QP = 2
TILE = 256
QP12 = (192, 12, [8192, 2048, 512])
SLOW_CALL_S = 2.0           # a speed call slower than this is timed SLOW_ITERS times only
SLOW_ITERS = 2

SETTINGS = {
    "autotuned": dict(enabled=True, benchmark=True, deterministic=False),
    "heuristic": dict(enabled=True, benchmark=False, deterministic=True),
    "native": dict(enabled=False, benchmark=False, deterministic=False),
}


def useSetting(name: str):
    """Replace the engine's numerics by the setting `name`, in this process."""
    from mcquic_tpu_torch.models import engine
    flags = SETTINGS[name]

    @contextlib.contextmanager
    def numerics():
        matmulTf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.backends.cudnn.flags(allow_tf32=False, **flags):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmulTf32

    engine.exactFp32 = numerics


def worker(setting: str, out: str) -> int:
    """One fresh process: the codec CLI's tiled compress under `setting`."""
    useSetting(setting)
    from mcquic_tpu_torch.cli import main
    return main(["-q", "-qp", str(QP), "--tile", str(TILE), str(PHOTO), out])


def margins(tokens, codebook, ref, other, level, earlier):
    """One record per code where `other` differs from `ref` ([n, m, h, w]),
    from the in-process tokens [m, n*h*w, d] and codebook [m, k, d]."""
    records = []
    n, m, h, w = ref.shape
    for i, g, y, x in zip(*np.nonzero(ref != other)):
        token = tokens[g, (i * h + y) * w + x].astype(np.float64)
        dist = ((codebook[g].astype(np.float64) - token) ** 2).sum(-1)
        first, second = np.partition(dist, 1)[:2]
        records.append({"level": level, "tile": int(i), "group": int(g),
                        "top2_gap": float(second - first),
                        "flip_gap": float(dist[other[i, g, y, x]] - dist[ref[i, g, y, x]]),
                        "token_norm2": float((token ** 2).sum()),
                        "ref_is_fp64_argmin": bool(dist[ref[i, g, y, x]] == first),
                        "after_coarser_flip": bool(earlier.get(int(i), False))})
    return records


def compareCodes(tokens, codebooks, ref, other):
    """Codes differing per level and their margins; levels run coarse to fine
    in the encoder's order (level 0 first)."""
    records, earlier = [], {}
    for level, (r, o) in enumerate(zip(ref, other)):
        records += margins(tokens[level], codebooks[level], r, o, level, earlier)
        for i in np.nonzero((r != o).reshape(r.shape[0], -1).any(1))[0]:
            earlier[int(i)] = True
    return records


def distances(tokens, codebook):
    """fp64 squared distances [m, T, k] of tokens [m, T, d] to codebook [m, k, d]."""
    t, c = tokens.astype(np.float64), codebook.astype(np.float64)
    return ((t * t).sum(-1)[..., None] + (c * c).sum(-1)[:, None, :]
            - 2.0 * t @ c.transpose(0, 2, 1))


def gapStats(tokens, codebooks) -> tuple:
    """Per level: the best and second-best codeword of each token, and the
    distribution of the gap between them relative to the token's squared
    norm."""
    pairs, stats = [], []
    for t, c in zip(tokens, codebooks):
        dist = distances(t, c)
        order = np.argpartition(dist, 1, axis=-1)[..., :2]
        near = np.take_along_axis(dist, order, -1)
        order = np.take_along_axis(order, np.argsort(near, -1), -1)
        near = np.sort(near, -1)
        relative = (near[..., 1] - near[..., 0]) / np.maximum((t.astype(np.float64) ** 2).sum(-1),
                                                              1e-30)
        pairs.append(order)
        stats.append({"tokens": int(relative.size), "min_relative_gap": float(relative.min()),
                      **{f"below_{e:g}": int((relative < e).sum()) for e in (1e-7, 1e-6, 1e-5, 1e-4)}})
    return pairs, stats


def pairGaps(tokens, codebooks, pairs):
    """The gap d(second) - d(best) of each token for the given pairs."""
    gaps = []
    for t, c, pair in zip(tokens, codebooks, pairs):
        dist = distances(t, c)
        near = np.take_along_axis(dist, pair, -1)
        gaps.append(near[..., 1] - near[..., 0])
    return gaps


def compareLatents(out: Path, settings) -> list:
    """How far each setting's tokens move the first setting's top-2 gaps,
    and how many of those gaps are smaller than the largest move."""
    def load(setting):
        data = np.load(out / setting / "tokens.npz")
        levels = len([k for k in data if k.startswith("tokens")])
        return ([data[f"tokens{i}"] for i in range(levels)],
                [data[f"codebook{i}"] for i in range(levels)])

    tokens, codebooks = load(settings[0])
    pairs, _ = gapStats(tokens, codebooks)
    base = pairGaps(tokens, codebooks, pairs)
    report = []
    for setting in settings[1:]:
        other, _ = load(setting)
        moved = [np.abs(g - b) for g, b in zip(pairGaps(other, codebooks, pairs), base)]
        report.append({"against": settings[0], "setting": setting,
                       "max_token_diff": [float(np.abs(o - t).max()) for o, t in zip(other, tokens)],
                       "max_gap_move": [float(m.max()) for m in moved],
                       "gaps_within_max_move": [int((b < m.max()).sum())
                                                for b, m in zip(base, moved)]})
    return report


def speed(engine, iters: int) -> dict:
    from mcquic_tpu_torch.validate.validator import Validator
    batch = np.random.default_rng(0).uniform(-1, 1, (10, 768, 512, 3)).astype(np.float32)
    engine.compress(batch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    engine.compress(batch)
    oneCall = time.perf_counter() - start
    if oneCall > SLOW_CALL_S:
        iters = SLOW_ITERS
    encode, decode = Validator(engine).speed(iters)
    return {"encodeMpps": encode, "decodeMpps": decode, "iters": iters,
            "first_compress_s": oneCall}


def reference(setting: str, folder: str, speedIters: int) -> int:
    """The in-process runs under `setting`, against the workers' files."""
    useSetting(setting)
    import mcquic_tpu_torch.models.quantizer as quantizerModule
    from mcquic_tpu_torch.data.png import readPng
    from mcquic_tpu_torch.demo import loadModel
    from mcquic_tpu_torch.models.compressor import seededCompressor
    from mcquic_tpu_torch.models.engine import CompressorEngine
    from mcquic_tpu_torch.models.tiling import TiledFile, compressTiled, toTiles

    img = readPng(PHOTO)
    engine = loadModel(qp=QP, device="cuda")
    captured = []
    original = quantizerModule.vqEncode

    def capture(x, codebook):
        from mcquic_tpu_torch.ops.vq import latentTokens
        captured.append((latentTokens(x).cpu().numpy(), codebook.float().cpu().numpy()))
        return original(x, codebook)

    quantizerModule.vqEncode = capture
    try:
        tiled = compressTiled(engine, img, TILE)
    finally:
        quantizerModule.vqEncode = original
    tokens, codebooks = [t for t, _ in captured], [c for _, c in captured]
    np.savez(Path(folder) / "tokens.npz", **{f"tokens{i}": t for i, t in enumerate(tokens)},
             **{f"codebook{i}": c for i, c in enumerate(codebooks)})
    n = len(tiled.binaries)
    codeSizes = [tiled.codeSize] * n
    refCodes = engine.coder.decompress(tiled.binaries, codeSizes)

    tiles, _, _ = toTiles(img, TILE)
    single = [engine.compressImage(t) for t in tiles]
    singleCodes = [np.concatenate(c) for c in zip(*(
        engine.coder.decompress([f.Content], [f.FileHeader.CodeSize]) for f in single))]
    batch1 = {"streams_differ": sum(f.Content != b for f, b in zip(single, tiled.binaries)),
              "flips": compareCodes(tokens, codebooks, refCodes, singleCodes)}

    processes = []
    for path in sorted(Path(folder).glob("worker_*.mcq")):
        tf = TiledFile.deserialize(path.read_bytes())
        codes = engine.coder.decompress(tf.binaries, codeSizes)
        processes.append({"file": path.name,
                          "bytes_equal": tf.serialize() == tiled.serialize(),
                          "streams_differ": sum(a != b for a, b in zip(tf.binaries, tiled.binaries)),
                          "flips": compareCodes(tokens, codebooks, refCodes, codes)})
    result = {"setting": setting, "flags": SETTINGS[setting], "tiles": n,
              "tokens_per_tile": [int(np.prod(c.shape[1:])) for c in refCodes],
              "processes": len(processes),
              "processes_differing": sum(not p["bytes_equal"] for p in processes),
              "streams_differing": sum(p["streams_differ"] for p in processes),
              "batch1": batch1, "per_process": processes,
              "gaps": gapStats(tokens, codebooks)[1]}
    if not speedIters:
        print(json.dumps(result), flush=True)
        return 0
    result["speed_qp2"] = speed(engine, speedIters)
    del engine
    torch.cuda.empty_cache()
    result["speed_qp12"] = speed(CompressorEngine(seededCompressor(*QP12), device="cuda"),
                                 speedIters)
    print(json.dumps(result), flush=True)
    return 0


def run(args) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=20).stdout.strip()
    print(smi, flush=True)
    from mcquic_tpu_torch.coding import rans
    from mcquic_tpu_torch.ops import subpixel_cuda, vq_cuda, vq_grouped_cuda
    for build in (rans.build, vq_cuda.build, vq_grouped_cuda.build, subpixel_cuda.build):
        build()
    out = Path(args.out) if args.out else Path(tempfile.mkdtemp())
    results = []
    for setting in args.settings.split(","):
        folder = out / setting
        folder.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        pending = list(range(args.processes))
        while pending:
            wave, pending = pending[:args.parallel], pending[args.parallel:]
            procs = [subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch.utils.stability",
                                       "--worker", setting, str(folder / f"worker_{i:03d}.mcq")],
                                      cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                      text=True) for i in wave]
            for i, proc in zip(wave, procs):
                _, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(f"worker {i} ({setting}) exited {proc.returncode}:\n{err}")
        workersS = time.perf_counter() - start
        proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch.utils.stability",
                               "--reference", setting, str(folder), "--speed-iters",
                               str(args.speed_iters)], cwd=ROOT, capture_output=True, text=True,
                              timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"reference ({setting}) exited {proc.returncode}:\n{proc.stderr}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["workers_s"] = workersS
        result["card"] = smi
        results.append(result)
        flips = [f for p in result["per_process"] for f in p["flips"]]
        print(f"{setting}: {result['processes_differing']} of {result['processes']} processes "
              f"differ from the in-process tiled batch ({result['streams_differing']} streams, "
              f"{len(flips)} codes); batch 1 against the batch of {result['tiles']}: "
              f"{result['batch1']['streams_differ']} streams, {len(result['batch1']['flips'])} "
              f"codes; top-2 gaps by level {result['gaps']}; speed qp-2 "
              f"{result.get('speed_qp2')}, qp-12 {result.get('speed_qp12')} ({smi})", flush=True)
        for f in flips + result["batch1"]["flips"]:
            print(f"  flip: {f}", flush=True)
    latents = compareLatents(out, args.settings.split(","))
    for entry in latents:
        print(f"latents: {entry}", flush=True)
    print(json.dumps({"settings": results, "latents": latents}), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:
        return worker(*argv[1:3])
    p = argparse.ArgumentParser(prog="python -m mcquic_tpu_torch.utils.stability")
    p.add_argument("--reference", nargs=2, metavar=("SETTING", "DIR"), default=None)
    p.add_argument("--processes", type=int, default=24)
    p.add_argument("--parallel", type=int, default=4)
    p.add_argument("--settings", default="autotuned,heuristic,native")
    p.add_argument("--speed-iters", type=int, default=50)
    p.add_argument("--out", default=None, help="where the processes' files go")
    args = p.parse_args(argv)
    if args.reference:
        return reference(*args.reference, args.speed_iters)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
