#!/usr/bin/env python3
"""Drive the PyTorch port (`mcquic_tpu_torch/`) once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and g++. It imports torch, numpy, the standard library and
`mcquic_tpu_torch` only. The phases, each printed with its seconds as it
ends:

  1. environment: torch / CUDA / nvcc versions, the card, its power limit;
  2. build: kernels K1 (csrc/vq_encode.cu), K1b (csrc/vq_grouped.cu), K2
     (csrc/thin_head.cu) and K3 (csrc/flash_attention.cu) with nvcc and the
     rANS runtime with g++, all started together; ptxas's registers and
     spills of every kernel;
  3. kernels against their plain versions on the card, fp32 with TF32 off,
     at the main paths' shapes, with two times each for the kernel, the
     plain version and one library call computing the same function: `ms`,
     the CUDA-event median of single calls (the wrapper's host work before
     the launch included, as in earlier runs), and `device_ms`, the device
     time of one call in a run of 20 back-to-back calls (`deviceMs`); the
     per-call host microseconds of K1, K2 and K3 beside their library
     calls'. K1 at the qp-2 levels, Neon's nine levels and the qp-12 speed
     batch's level 0, with the pairs its filter handed to the fp32
     rescoring; K2 at the photo's head and the speed batch's (B 10). Bounds
     at the rate each kernel runs (one TF32 product for K1's filter, three
     for K2 and K3) with the fp32 FMA bound beside;
  4. the codec path at full width: the qp-2 zoo model compresses
     assets/photo_768x512.png to a `.mcq` and restores it (K1's rescored
     pairs per token counted on its real latents); bpp and PSNR are
     held to the registered 0.1090 bpp / 25.15 dB, the codes and the restore
     to the CPU plain path on a crop, and the kernels' launch counts show
     that the path went through them;
  5. the CLI round trip, `python -m mcquic_tpu_torch`, in a subprocess;
  6. generation at the full width and depth of gen_stage2_neonA: a seeded
     checkpoint in the JAX package's format goes through the loader; greedy
     `generate` for four classes with and without the KV cache must give the
     same codes at all 9 levels, through K3 (depth x levels launches each);
     K3 is held to its plain version on the q/k/v of every call; the card's
     codes are held to the CPU plain path at depth 2; one Neon encode and
     decode of a seeded 256x256 image runs K1, whose codes must equal the
     plain version's; `python -m mcquic_tpu_torch generate` writes 4 PNGs;
  7. the validation, batched and tiled codec paths: `python -m
     mcquic_tpu_torch validate -e` on a folder holding the photo with the
     qp-2 zoo model (bpp and PSNR held to phase 4's; the reference's speed
     protocol, 50 iterations); `Validator.speed` and the model alone at qp-2
     and at the qp-12 geometry (seeded), cut to SPEED_ITERS iterations; the
     past-budget model (channel 128, m 2, k [16384, 2048, 512], seeded),
     whose level 0 takes K1b, compresses and restores the photo (K1b once
     and K1 twice per compress; K1b's codes equal the plain version's on its
     real latents, and the card's codes the CPU's on a crop);
     `compressMany` / `decompressMany` against per-batch calls; a `--tile
     256` round trip through the CLI against the same tiles coded whole.

Any failure ends the run with a non-zero exit and no result line. The last
two lines are the kernel table as JSON and
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHOTO = ROOT / "assets" / "photo_768x512.png"
QP = 2
REGISTERED_BPP = 0.1090          # VERDICT.md / README.md, qp-2 on the photo
REGISTERED_PSNR = 25.15
VALIDATE_PSNR_ATOL = 0.01        # validate's fp32 PSNR vs phase 4's fp64 one, same images
BPP_RTOL = 0.01
PSNR_ATOL = 0.1
K1_NEAR_TIE_RTOL = 1e-5          # a code mismatch must be a near-tie at this scale
K1_MAX_MISMATCH = 1e-3           # ... and mismatches at most 0.1 % of tokens
K2_ATOL = 1e-4
K3_ATOL = 1e-4
GEN_CLASSES = [1, 207, 360, 980]
GEN_CPU_DEPTH = 2                # depth of the card-vs-CPU comparison
GEN_TIE_ATOL = 1e-3              # a card/CPU code mismatch must be a near-tie of the CPU logits
GEN_LOGITS_ATOL = 1e-3           # card vs CPU teacher-forced logits, same codes
RESTORE_ATOL = 1e-3              # card vs CPU restore of the same codes, in [-1, 1]
CODES_MIN_AGREEMENT = 0.99       # card vs CPU codes of a crop
CLI_TIMEOUT = 300
SPEED_ITERS = 10                 # the in-process speed runs; the validate CLI runs the full 50
K1B_SHAPES = [(2, 1536, 16384, 64),      # level 0 of the past-budget model on the photo
              (2, 1536, 65536, 64), (1, 512, 1024, 512)]
QP12 = (192, 12, [8192, 2048, 512])      # channel, m, k (no zoo file: seeded weights)
PAST_BUDGET = (128, 2, [16384, 2048, 512])
TILE = 256
TILE_BATCH_MAX_DIFF = 1          # uint8 levels: cuDNN picks algorithms by batch size, so the same
                                 # codes decoded one by one and as a batch of 6 round differently

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W): fp32 on the CUDA cores, HBM3,
# TF32 on the tensor cores (K3 takes three TF32 products per fp32 product)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12


class Phase:
    """Prints one line when a phase ends, with its seconds; raises through."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        print(f"[{self.name}] ...", flush=True)
        return self

    def __exit__(self, kind, value, tb):
        seconds = time.perf_counter() - self.start
        state = "ok" if kind is None else f"FAILED ({kind.__name__}: {value})"
        print(f"[{self.name}] {state} in {seconds:.2f} s", flush=True)
        return False


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """(least ms the card could take, what bounds it): `flops` operations
    at `peak` per second against `nbytes` at the HBM rate."""
    compute, memory = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(compute, memory) * 1e3, "operations" if compute >= memory else "bytes"


def deviceMs(torch, fn, cyclesPerMs: float, iters: int = 20, repeats: int = 3):
    """(device ms of one call, host us of one call).

    CUDA events around `iters` back-to-back calls, over `iters`, the median
    of `repeats` runs after warm-up. A sleep kernel queued first holds the
    card until the host has queued the calls, so the wrapper's host work does
    not show in the device time. The host time is the host clock around
    `iters` calls, after a synchronize, with nothing queued before them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    hostS = time.perf_counter() - start
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * hostS * 1e3 * cyclesPerMs) + 100000)
        begin.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end) / iters)
    return statistics.median(times), hostS / iters * 1e6


def sleepCyclesPerMs(torch) -> float:
    """The rate of `torch.cuda._sleep`, from CUDA events around one sleep."""
    torch.cuda._sleep(1000000)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    torch.cuda._sleep(10000000)
    end.record()
    end.synchronize()
    return 10000000 / begin.elapsed_time(end)


def medianMs(torch, fn, warmup: int = 5, iters: int = 20) -> float:
    """CUDA-event median of `iters` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def psnr(a, b) -> float:
    import numpy as np
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def checkCodes(torch, tokens, codebook, got, want, label):
    """K1 codes vs the plain version's: every mismatch must be a near-tie.

    For token x with codes a (kernel) and b (plain), the squared distances
    |x - c_a|^2 and |x - c_b|^2 are recomputed in fp64; they must agree to
    K1_NEAR_TIE_RTOL of |x|^2 + max(|c_a|^2, |c_b|^2), the magnitude that
    fp32 rounding acts on. Returns (mismatches, max |distance difference|)."""
    got, want = got.long(), want.long()
    bad = (got != want).nonzero(as_tuple=False)            # [N, 2] (group, token)
    if bad.numel() == 0:
        print(f"  {label}: all {got.numel()} codes identical", flush=True)
        return 0, 0.0
    g, t = bad[:, 0], bad[:, 1]
    x = tokens[g, t].double()
    ca, cb = codebook[g, got[g, t]].double(), codebook[g, want[g, t]].double()
    da, db = ((x - ca) ** 2).sum(-1), ((x - cb) ** 2).sum(-1)
    scale = (x * x).sum(-1) + torch.maximum((ca * ca).sum(-1), (cb * cb).sum(-1))
    rel = ((da - db).abs() / scale).max().item()
    n, total = bad.shape[0], got.numel()
    print(f"  {label}: {n} of {total} codes differ, all near-ties (max rel gap {rel:.2e})"
          if rel <= K1_NEAR_TIE_RTOL else f"  {label}: {n} codes differ, rel gap {rel:.2e}",
          flush=True)
    if rel > K1_NEAR_TIE_RTOL or n > K1_MAX_MISMATCH * total:
        raise AssertionError(f"K1 {label}: {n} of {total} codes differ, max rel gap {rel:.2e}")
    return n, (da - db).abs().max().item()


def k3Check(torch, flashAttention, flashAttentionPlain, q, k, v, mask=None, scale=None) -> float:
    """Max |K3 - plain| on one set of inputs; raises past K3_ATOL."""
    err = (flashAttention(q, k, v, mask, scale)
           - flashAttentionPlain(q, k, v, mask, scale)).abs().max().item()
    if not err <= K3_ATOL:
        raise AssertionError(f"K3 differs from its plain version by {err} at q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, mask {mask is not None}")
    return err


def teacherForcedLogits(model, condition, codes, level):
    """The logits of `level` given the codes of the levels before it, through
    the uncached, masked transformer."""
    capPooled = model._condEmbed(condition)
    scaffolds, former = [], None
    for lv in range(level):
        former = model.residual_forward(codes[lv], former, lv)
        scaffolds.append(former)
    seq = model._assembleSequence(scaffolds, capPooled, condition.shape[0])
    prefix = seq.shape[1]
    logits = model.transformer(seq, model._mask[:prefix, :prefix], capPooled, capPooled)
    return logits[:, prefix - model.lengths[level]:]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card.",
              file=sys.stderr)
        return 2
    if not (ROOT / "mcquic_tpu_torch" / "__init__.py").is_file() or not PHOTO.is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(mcquic_tpu_torch/ or assets/ missing).", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mcquic_tpu_torch.coding import rans
    from mcquic_tpu_torch.container import File
    from mcquic_tpu_torch.data.png import readPng, writePng
    from mcquic_tpu_torch.demo import loadModel, zooPath
    from mcquic_tpu_torch.models.compressor import Compressor, seededCompressor
    from mcquic_tpu_torch.models.engine import CompressorEngine
    from mcquic_tpu_torch.models.tiling import (TiledFile, compressTiled, decompressTiled,
                                                fromTiles, toTiles)
    import mcquic_tpu_torch.models.generator as generatorModule
    import mcquic_tpu_torch.models.quantizer as quantizerModule
    from mcquic_tpu_torch.data.transforms import imageToModelInput, modelOutputToImage
    from mcquic_tpu_torch.generate import GEN_STAGE2_NEON_A, loadGenerator, writeSeededGenerator
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention, blockCausalMask
    from mcquic_tpu_torch.ops import attention_cuda, subpixel_cuda, vq_cuda, vq_grouped_cuda
    from mcquic_tpu_torch.ops.attention import flashAttentionPlain
    from mcquic_tpu_torch.ops.attention_cuda import attentionPlan, flashAttention
    from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelPlain, conv3x3SubpixelThin
    from mcquic_tpu_torch.ops.vq import groupLatent, latentTokens, vqEncodePlain
    from mcquic_tpu_torch.ops.vq_cuda import k1Plan, vqNearest
    from mcquic_tpu_torch.ops.vq_grouped_cuda import vqNearestGrouped
    from mcquic_tpu_torch.utils import exactFp32
    from mcquic_tpu_torch.utils.build import buildLog, findNvcc
    from mcquic_tpu_torch.utils.convert import readExport
    from mcquic_tpu_torch.validate.validator import Validator

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    with Phase("1 environment"):
        print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, numpy {np.__version__}", flush=True)
        print(f"  device {kind}, {torch.cuda.device_count()} visible, "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        nvcc = findNvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.strip().splitlines()[-1]
        print(f"  nvcc {nvcc}: {version}", flush=True)

    with Phase("2 build"):
        def timed(name, fn):
            start = time.perf_counter()
            fn()
            return name, time.perf_counter() - start
        with ThreadPoolExecutor(5) as pool:
            jobs = [pool.submit(timed, name, fn) for name, fn in
                    (("K1 vq_encode.cu (nvcc)", vq_cuda.build),
                     ("K1b vq_grouped.cu (nvcc)", vq_grouped_cuda.build),
                     ("K2 thin_head.cu (nvcc)", subpixel_cuda.build),
                     ("K3 flash_attention.cu (nvcc)", attention_cuda.build),
                     ("rANS mcquic_rans.cpp (g++)", rans.build))]
            for job in jobs:
                name, seconds = job.result()
                print(f"  built {name} in {seconds:.2f} s", flush=True)
        for stem in ("vq_encode", "vq_grouped", "thin_head", "flash_attention"):
            for line in buildLog(stem).splitlines():
                if "entry function" in line or "spill" in line or "Used" in line:
                    print(f"  ptxas {stem}: {line.strip()}", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    levels = [(2, 1536, 8192, 64), (2, 384, 2048, 64), (2, 96, 512, 64)]   # (m, T, k, d)
    k3 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
          "flops": 0.0, "bytes": 0.0, "device_ms": 0.0, "plain_device_ms": 0.0,
          "library_device_ms": 0.0, "host_us": 0.0, "library_host_us": 0.0,
          "bound_fp32_ms": 0.0}
    geometry = GEN_STAGE2_NEON_A
    lengths = [s * s for s in sorted(geometry["size"])]         # 1, 1, 4, ..., 256: 426 tokens
    heads, headDim = geometry["nHeads"], geometry["hiddenSize"] // geometry["nHeads"]
    batch = len(GEN_CLASSES)
    with Phase("3 kernels vs plain"), exactFp32(), torch.inference_mode():
        print("  kernels: K1 vq_nearest (csrc/vq_encode.cu), K1b vq_grouped (csrc/vq_grouped.cu), "
              "K2 thin_head (csrc/thin_head.cu), K3 flash_attention (csrc/flash_attention.cu)",
              flush=True)
        cyclesPerMs = sleepCyclesPerMs(torch)

        def devicePair(kernel, plain, library):
            """Device ms of the kernel, its plain version and the library call."""
            return [deviceMs(torch, fn, cyclesPerMs)[0] for fn in (kernel, plain, library)]

        def timeAll(kernel, plain, library):
            """Single-call and device ms of the kernel, its plain version and
            the library call, and the host us per call of the kernel and the
            library call."""
            row = {"ms": medianMs(torch, kernel), "plain_ms": medianMs(torch, plain),
                   "library_ms": medianMs(torch, library)}
            row["device_ms"], row["host_us"] = deviceMs(torch, kernel, cyclesPerMs)
            row["plain_device_ms"], _ = deviceMs(torch, plain, cyclesPerMs)
            row["library_device_ms"], row["library_host_us"] = deviceMs(torch, library, cyclesPerMs)
            return row

        def k1Inputs(m, T, k, d):
            """Random tokens and codebook; the codebook a normal tensor, as the
            model's parameter is, so that K1 keeps its norms across calls."""
            with torch.inference_mode(False):
                return (torch.randn((m, T, d), device=device, generator=gen),
                        torch.randn((m, k, d), device=device, generator=gen))

        def k1Row(m, T, k, d, label):
            """K1 at one shape: codes against the plain version, the rescored
            pairs per token, the times and both bounds (one TF32 product for
            the filter; fp32 FMA)."""
            tokens, codebook = k1Inputs(m, T, k, d)
            counter = torch.zeros(1, dtype=torch.int64, device=device)
            got, want = vqNearest(tokens, codebook, counter), vqEncodePlain(tokens, codebook)
            _, err = checkCodes(torch, tokens, codebook, got, want, f"K1 random {label} (m,T,k,d)={m, T, k, d}")
            row = timeAll(lambda: vqNearest(tokens, codebook), lambda: vqEncodePlain(tokens, codebook),
                          lambda: torch.cdist(tokens, codebook).argmin(-1))
            nbytes = 4.0 * (m * T * d + m * k * d + m * T)
            row["bound_ms"], row["bound_by"] = bound(2.0 * m * T * k * d, nbytes, PEAK_TF32_FLOPS)
            row["bound_fp32_ms"], _ = bound(2.0 * m * T * k * (d + 1), nbytes)
            row["err"], row["rescored"] = err, counter.item() / (m * T)
            print(f"  K1 {label} (m,T,k,d)={m, T, k, d}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, cdist+argmin {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms at one TF32 product ({row['bound_by']}), "
                  f"{row['bound_fp32_ms']:.5f} at fp32 FMA; device time kernel "
                  f"{row['device_ms']:.4f} ms, plain {row['plain_device_ms']:.4f} ms, cdist+argmin "
                  f"{row['library_device_ms']:.4f} ms; host per call kernel {row['host_us']:.1f} us, "
                  f"cdist+argmin {row['library_host_us']:.1f} us; rescored {row['rescored']:.2f} "
                  f"pairs per token; plan (block tokens, splits, tiles per split) "
                  f"{k1Plan(m, T, k, d, sms)}", flush=True)
            return row

        def summed(rows):
            total = {key: sum(row[key] for row in rows) for key in rows[0]
                     if key not in ("bound_by", "err", "rescored")}
            total["bound_by"] = rows[0]["bound_by"]
            total["err"] = max(row["err"] for row in rows)
            return total

        def k1Summary(label, row):
            print(f"  K1 {label}: kernel {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, "
                  f"cdist+argmin device {row['library_device_ms']:.4f} ms (kernel / library "
                  f"{row['device_ms'] / row['library_device_ms']:.3f}), bound {row['bound_ms']:.5f} ms "
                  f"at one TF32 product, {row['bound_fp32_ms']:.5f} at fp32 FMA; host per call summed "
                  f"kernel {row['host_us']:.1f} us, cdist+argmin {row['library_host_us']:.1f} us",
                  flush=True)

        k1 = summed([k1Row(m, T, k, d, f"qp-{QP} level {i}") for i, (m, T, k, d) in enumerate(levels)])
        k1Summary(f"qp-{QP}, 3 levels", k1)
        # K1 at the Neon tokenizer's shapes (m 1, k 1024, d 8, T the 9 levels' grids)
        neonK1 = summed([k1Row(1, T, geometry["k"], 8, "Neon") for T in lengths])
        k1Summary("Neon, 9 levels (T 1..256, k 1024, d 8)", neonK1)
        # K1 at the qp-12 speed batch's level 0 (10 images of 768x512: 96x160 latents)
        qp12K1 = k1Row(QP12[1], 10 * (768 // 16) * (512 // 16), QP12[2][0], QP12[0] // QP12[1],
                       "qp-12 speed batch level 0")
        k1Summary("qp-12 speed batch level 0", qp12K1)
        torch.cuda.empty_cache()

        # K1b past the resident budget and past K1's d: every code must equal the
        # plain version's; the JSON row is the past-budget model's level-0 shape
        k1b = {}
        for m, T, k, d in K1B_SHAPES:
            tokens = torch.randn((m, T, d), device=device, generator=gen)
            codebook = torch.randn((m, k, d), device=device, generator=gen)
            differ = int((vqNearestGrouped(tokens, codebook) != vqEncodePlain(tokens, codebook)).sum())
            print(f"  K1b random (m,T,k,d)={m, T, k, d}: " + (
                f"all {m * T} codes identical" if differ == 0 else f"{differ} of {m * T} codes differ"),
                flush=True)
            if differ:
                raise AssertionError(f"K1b differs from the plain version at {m, T, k, d}")
            row = {"ms": medianMs(torch, lambda: vqNearestGrouped(tokens, codebook)),
                   "plain_ms": medianMs(torch, lambda: vqEncodePlain(tokens, codebook)),
                   "library_ms": medianMs(torch, lambda: torch.cdist(tokens, codebook).argmin(-1))}
            row["device_ms"], row["plain_device_ms"], row["library_device_ms"] = devicePair(
                lambda: vqNearestGrouped(tokens, codebook), lambda: vqEncodePlain(tokens, codebook),
                lambda: torch.cdist(tokens, codebook).argmin(-1))
            row["bound_ms"], row["bound_by"] = bound(2.0 * m * T * k * (d + 1),
                                                     4.0 * (m * T * d + m * k * d + m * T))
            print(f"  K1b (m,T,k,d)={m, T, k, d}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, cdist+argmin {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); device time kernel "
                  f"{row['device_ms']:.4f} ms, plain {row['plain_device_ms']:.4f} ms, cdist+argmin "
                  f"{row['library_device_ms']:.4f} ms (kernel / library "
                  f"{row['device_ms'] / row['library_device_ms']:.3f})", flush=True)
            k1b = k1b or dict(row, err=0.0)
            del tokens, codebook

        def k2Row(B, label):
            """K2 at the decoder head's shape for B images: error against the
            plain version, times, and both bounds (three TF32 products; fp32
            FMA)."""
            x = torch.randn((B, 128, 256, 384), device=device, generator=gen)
            w = torch.randn((12, 128, 3, 3), device=device, generator=gen) * 0.05
            b = torch.randn((12,), device=device, generator=gen)
            got, want = conv3x3SubpixelThin(x, w, b, 2), conv3x3SubpixelPlain(x, w, b, 2)
            if tuple(got.shape) != (B, 3, 512, 768):
                raise AssertionError(f"K2 output shape {tuple(got.shape)}")
            err = (got - want).abs().max().item()
            print(f"  K2 random {label} [{B},128,256,384]: max abs diff {err:.3e}", flush=True)
            if not err <= K2_ATOL:
                raise AssertionError(f"K2 differs from conv2d + pixel_shuffle by {err}")
            row = timeAll(lambda: conv3x3SubpixelThin(x, w, b, 2),
                          lambda: conv3x3SubpixelPlain(x, w, b, 2),
                          lambda: torch.nn.functional.pixel_shuffle(
                              torch.nn.functional.conv2d(x, w, b, padding=1), 2))
            flops = B * (2.0 * 256 * 384 * 128 * 9 * 12 + 256 * 384 * 12)
            nbytes = 4.0 * (x.numel() + w.numel() + 12 + got.numel())
            row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            row["bound_fp32_ms"], _ = bound(flops, nbytes)
            row["err"] = err
            print(f"  K2 {label} [{B},128,256,384]: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, conv2d+pixel_shuffle {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.5f} ms at three TF32 products ({row['bound_by']}), "
                  f"{row['bound_fp32_ms']:.5f} at fp32 FMA; device time kernel {row['device_ms']:.4f} ms, "
                  f"plain {row['plain_device_ms']:.4f} ms, conv2d+pixel_shuffle "
                  f"{row['library_device_ms']:.4f} ms (kernel / library "
                  f"{row['device_ms'] / row['library_device_ms']:.3f}); host per call kernel "
                  f"{row['host_us']:.1f} us, conv2d+pixel_shuffle {row['library_host_us']:.1f} us",
                  flush=True)
            return row

        k2 = k2Row(1, "photo head")
        k2Batch = k2Row(10, "speed batch head")
        torch.cuda.empty_cache()

        # K3 at the generation path's shapes: each level's queries against the
        # running prefix of a [B, 426, H, D] KV cache, then the uncached path's
        # largest call, 426 tokens under the block-causal mask.
        sdpa = torch.nn.functional.scaled_dot_product_attention
        total = sum(lengths)
        cache = torch.randn((2, batch, total, heads, headDim), device=device, generator=gen)
        prefix = 0
        for hw in lengths:
            prefix += hw
            q = torch.randn((batch, hw, heads, headDim), device=device, generator=gen)
            k, v = cache[0, :, :prefix], cache[1, :, :prefix]
            err = k3Check(torch, flashAttention, flashAttentionPlain, q, k, v)
            ms = medianMs(torch, lambda: flashAttention(q, k, v))
            plainMs = medianMs(torch, lambda: flashAttentionPlain(q, k, v))
            libMs = medianMs(torch, lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                                 v.transpose(1, 2)))
            devMs, hostUs = deviceMs(torch, lambda: flashAttention(q, k, v), cyclesPerMs)
            plainDevMs, _ = deviceMs(torch, lambda: flashAttentionPlain(q, k, v), cyclesPerMs)
            libDevMs, libHostUs = deviceMs(torch, lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                                               v.transpose(1, 2)), cyclesPerMs)
            flops = 4.0 * batch * heads * hw * prefix * headDim
            nbytes = 4.0 * batch * heads * headDim * (2 * hw + 2 * prefix)
            # the kernel takes three TF32 products per fp32 product; the fp32
            # FMA bound is kept beside it
            boundMs, k3["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            fp32BoundMs, _ = bound(flops, nbytes)
            print(f"  K3 (B,H,Tq,Tk,D)={batch, heads, hw, prefix, headDim}: max abs diff {err:.3e}, "
                  f"kernel {ms:.4f} ms, plain {plainMs:.4f} ms, SDPA {libMs:.4f} ms, "
                  f"bound {boundMs:.5f} ms (fp32 FMA {fp32BoundMs:.5f}); device time kernel {devMs:.4f} ms, plain "
                  f"{plainDevMs:.4f} ms, SDPA {libDevMs:.4f} ms; host per call kernel "
                  f"{hostUs:.1f} us, SDPA {libHostUs:.1f} us; plan (warps, splits, keys per split) "
                  f"{attentionPlan(batch, heads, hw, prefix, sms)}", flush=True)
            for key, value in (("ms", ms), ("plain_ms", plainMs), ("library_ms", libMs),
                               ("bound_ms", boundMs), ("bound_fp32_ms", fp32BoundMs),
                               ("flops", flops), ("bytes", nbytes),
                               ("device_ms", devMs), ("plain_device_ms", plainDevMs),
                               ("library_device_ms", libDevMs), ("host_us", hostUs),
                               ("library_host_us", libHostUs)):
                k3[key] += value
            k3["err"] = max(k3["err"], err)
        print(f"  K3 over the 9 levels: kernel {k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms, "
              f"SDPA {k3['library_ms']:.4f} ms, bound {k3['bound_ms']:.5f} ms at three TF32 "
              f"products, {k3['bound_fp32_ms']:.5f} ms at fp32 FMA ({k3['flops'] / 1e9:.3f} GFLOP, {k3['bytes'] / 1e6:.3f} MB); device time kernel "
              f"{k3['device_ms']:.4f} ms, plain {k3['plain_device_ms']:.4f} ms, SDPA "
              f"{k3['library_device_ms']:.4f} ms (kernel / SDPA "
              f"{k3['device_ms'] / k3['library_device_ms']:.3f}); host per call summed kernel "
              f"{k3['host_us']:.1f} us, SDPA {k3['library_host_us']:.1f} us", flush=True)
        q, k, v = (torch.randn((batch, total, heads, headDim), device=device, generator=gen)
                   for _ in range(3))
        mask = torch.from_numpy(blockCausalMask(lengths)).to(device, torch.int8)
        err = k3Check(torch, flashAttention, flashAttentionPlain, q, k, v, mask)
        k3["err"] = max(k3["err"], err)
        maskBool = mask.bool()
        masked = {"ms": medianMs(torch, lambda: flashAttention(q, k, v, mask)),
                  "plain_ms": medianMs(torch, lambda: flashAttentionPlain(q, k, v, mask)),
                  "library_ms": medianMs(torch, lambda: sdpa(
                      q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=maskBool))}
        masked["device_ms"], masked["host_us"] = deviceMs(
            torch, lambda: flashAttention(q, k, v, mask), cyclesPerMs)
        masked["plain_device_ms"], _ = deviceMs(
            torch, lambda: flashAttentionPlain(q, k, v, mask), cyclesPerMs)
        masked["library_device_ms"], masked["library_host_us"] = deviceMs(torch, lambda: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=maskBool), cyclesPerMs)
        maskedFlops = 4.0 * batch * heads * total * total * headDim
        maskedBytes = 4.0 * batch * heads * headDim * 4 * total + total * total
        masked["bound_ms"], _ = bound(3 * maskedFlops, maskedBytes, PEAK_TF32_FLOPS)
        masked["bound_fp32_ms"], _ = bound(maskedFlops, maskedBytes)
        print(f"  K3 masked (B,H,T,D)={batch, heads, total, headDim}: max abs diff {err:.3e}, "
              f"kernel {masked['ms']:.4f} ms, plain {masked['plain_ms']:.4f} ms, "
              f"SDPA {masked['library_ms']:.4f} ms, bound {masked['bound_ms']:.5f} ms at three "
              f"TF32 products, {masked['bound_fp32_ms']:.5f} ms at fp32 FMA; device time "
              f"kernel {masked['device_ms']:.4f} ms, plain {masked['plain_device_ms']:.4f} ms, SDPA "
              f"{masked['library_device_ms']:.4f} ms (kernel / SDPA "
              f"{masked['device_ms'] / masked['library_device_ms']:.3f}); host per call kernel "
              f"{masked['host_us']:.1f} us, SDPA {masked['library_host_us']:.1f} us; plan "
              f"{attentionPlan(batch, heads, total, total, sms)}", flush=True)
        torch.cuda.synchronize()

    with Phase("4 main path"):
        with tempfile.TemporaryDirectory() as tmp:
            start = time.perf_counter()
            engine = loadModel(qp=QP, device="cuda")
            print(f"  loaded the qp-{QP} zoo model in {time.perf_counter() - start:.2f} s",
                  flush=True)
            img = readPng(PHOTO)
            model = engine.model

            # warm-up run, with hooks keeping the real inputs of K1 and K2
            captured = {"q": [], "head": None}
            hooks = [level._quantizationHead.register_forward_hook(
                lambda mod, inp, out: captured["q"].append(out.clone()))
                for level in model._quantizer._encoders]
            hooks.append(model._decoder[6].register_forward_pre_hook(
                lambda mod, inp: captured.__setitem__("head", inp[0].clone())))
            engine.decompressImage(engine.compressImage(img))
            for hook in hooks:
                hook.remove()
            with exactFp32(), torch.inference_mode():
                rescored = []
                for i, q in enumerate(captured["q"]):
                    tokens = latentTokens(groupLatent(q, model.m))
                    codebook = model._quantizer.codebook(i).contiguous()
                    counter = torch.zeros(1, dtype=torch.int64, device=device)
                    _, err = checkCodes(torch, tokens, codebook, vqNearest(tokens, codebook, counter),
                                        vqEncodePlain(tokens, codebook),
                                        f"K1 photo level {i} {tuple(tokens.shape)}")
                    k1["err"] = max(k1["err"], err)
                    rescored.append(counter.item() / tokens.shape[0] / tokens.shape[1])
                k1["photo_rescored"] = rescored
                print("  K1 rescored pairs per token on the photo's qp-2 latents, by level: "
                      + ", ".join(f"{r:.2f}" for r in rescored), flush=True)
                head = model._decoder[6][0]
                hx = captured["head"]
                err = (conv3x3SubpixelThin(hx, head.weight, head.bias, 2)
                       - conv3x3SubpixelPlain(hx, head.weight, head.bias, 2)).abs().max().item()
                print(f"  K2 photo decoder head {tuple(hx.shape)}: max abs diff {err:.3e}",
                      flush=True)
                if not err <= K2_ATOL:
                    raise AssertionError(f"K2 differs on the photo by {err}")
                k2["err"] = max(k2["err"], err)
            torch.cuda.synchronize()

            # the main path, counted
            vqNearest.launches = 0
            conv3x3SubpixelThin.launches = 0
            start = time.perf_counter()
            file = engine.compressImage(img)
            compressS = time.perf_counter() - start
            mcq = Path(tmp) / "photo.mcq"
            mcq.write_bytes(file.serialize())
            start = time.perf_counter()
            restored = engine.decompressImage(File.deserialize(mcq.read_bytes()))
            restoreS = time.perf_counter() - start
            launches = {"K1": vqNearest.launches, "K2": conv3x3SubpixelThin.launches}
            print(f"  kernel launches on the main path: {launches}", flush=True)
            if launches["K1"] < 1 or launches["K2"] < 1:
                raise AssertionError(f"a kernel of the main path never ran: {launches}")

            writePng(Path(tmp) / "restored.png", restored)
            if not np.array_equal(readPng(Path(tmp) / "restored.png"), restored):
                raise AssertionError("the written PNG does not read back")
            if restored.shape != img.shape or restored.dtype != np.uint8:
                raise AssertionError(f"restored {restored.shape} {restored.dtype}")
            bpp, quality = file.BPP, psnr(img, restored)
            print(f"  photo {img.shape[1]}x{img.shape[0]}: {bpp:.4f} bpp, PSNR {quality:.2f} dB, "
                  f"{mcq.stat().st_size} bytes; compress {compressS * 1e3:.1f} ms, "
                  f"restore {restoreS * 1e3:.1f} ms (host clock, .mcq I/O between)", flush=True)
            if abs(bpp - REGISTERED_BPP) > BPP_RTOL * REGISTERED_BPP:
                raise AssertionError(f"bpp {bpp} is not within 1 % of {REGISTERED_BPP}")
            if abs(quality - REGISTERED_PSNR) > PSNR_ATOL:
                raise AssertionError(f"PSNR {quality} is not within 0.1 dB of {REGISTERED_PSNR}")

            # the card against the CPU plain path on a 128x128 crop
            cpuModel = Compressor(model.channel, model.m, model.k)
            cpuModel.load_state_dict(model.state_dict())
            cpuEngine = CompressorEngine(cpuModel, qp=str(QP), device="cpu")
            crop = img[192:320, 320:448]
            cardCodes, cpuCodes = engine.encode(crop[None]), cpuEngine.encode(crop[None])
            agreement = (sum(int((a == c).sum()) for a, c in zip(cardCodes, cpuCodes))
                         / sum(a.size for a in cardCodes))
            restoreDiff = float(np.abs(engine.decode(cpuCodes) - cpuEngine.decode(cpuCodes)).max())
            print(f"  crop 128x128 card vs CPU: codes agree on {agreement:.4%}, restore of "
                  f"the same codes differs by {restoreDiff:.2e}", flush=True)
            if agreement < CODES_MIN_AGREEMENT or not restoreDiff <= RESTORE_ATOL:
                raise AssertionError("the card disagrees with the CPU plain path")

    with Phase("5 CLI round trip"):
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp)
            for args in (["-qp", str(QP), str(PHOTO), str(out / "cli.mcq")],
                         [str(out / "cli.mcq"), str(out / "cli.png")]):
                proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", *args],
                                      cwd=ROOT, capture_output=True, text=True,
                                      timeout=CLI_TIMEOUT)
                if proc.returncode != 0:
                    raise RuntimeError(f"CLI {args} exited {proc.returncode}:\n{proc.stderr}")
            cliFile = File.deserialize((out / "cli.mcq").read_bytes())
            cliQuality = psnr(img, readPng(out / "cli.png"))
            print(f"  CLI: {cliFile.BPP:.4f} bpp, PSNR {cliQuality:.2f} dB, .mcq identical to "
                  f"the in-process one: {(out / 'cli.mcq').read_bytes() == file.serialize()}",
                  flush=True)
            if (abs(cliFile.BPP - REGISTERED_BPP) > BPP_RTOL * REGISTERED_BPP
                    or abs(cliQuality - REGISTERED_PSNR) > PSNR_ATOL):
                raise AssertionError("the CLI round trip misses the registered bpp / PSNR")

    with Phase("6 generation"), tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        ckpt = writeSeededGenerator(Path(tmp) / "gen_stage2_neonA.ckpt.npz", geometry, seed=0)
        model = loadGenerator(ckpt, device="cuda")
        levels, depth = len(lengths), geometry["depth"]
        print(f"  seeded gen_stage2_neonA checkpoint (configs/rd5/gen_stage2_neonA.yaml widths and "
              f"depth), {ckpt.stat().st_size / 1e6:.1f} MB, written and loaded in "
              f"{time.perf_counter() - start:.2f} s", flush=True)
        condition = torch.tensor(GEN_CLASSES, device=device)

        # warm-up of both modes, decode included, keeping the q/k/v of every K3 call
        calls = []
        original = generatorModule.flashAttention

        def capture(q, k, v, mask=None, scale=None):
            calls.append((q.clone(), k.clone(), v.clone(), mask, scale))
            return original(q, k, v, mask, scale)

        generatorModule.flashAttention = capture
        try:
            with exactFp32(), torch.inference_mode():
                for kvCache in (True, False):
                    model.generate(condition, kvCache=kvCache)
        finally:
            generatorModule.flashAttention = original
        if len(calls) != 2 * depth * levels:
            raise AssertionError(f"{len(calls)} attention calls, expected {2 * depth * levels}")
        with torch.inference_mode():
            for mode, kvCache in enumerate((True, False)):
                worst = []
                for level in range(levels):
                    errs = [k3Check(torch, flashAttention, flashAttentionPlain, *calls[i])
                            for i in range((mode * levels + level) * depth,
                                           (mode * levels + level + 1) * depth)]
                    worst.append(max(errs))
                q, k = calls[(mode * levels + levels - 1) * depth][:2]
                print(f"  K3 on the path's own q/k/v, kvCache={kvCache}, max abs diff by level: "
                      + ", ".join(f"{e:.2e}" for e in worst)
                      + f" (last level q {tuple(q.shape)}, k {tuple(k.shape)})", flush=True)
                k3["err"] = max(k3["err"], max(worst))
        del calls

        # the generation path, counted, in both modes
        results = {}
        for kvCache in (True, False):
            with exactFp32(), torch.inference_mode():
                flashAttention.launches = 0
                torch.cuda.synchronize()
                start = time.perf_counter()
                codes, restored = model.generate(condition, kvCache=kvCache)
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
                k3Launches = flashAttention.launches
                finite = bool(torch.isfinite(restored).all())
                images = modelOutputToImage(restored.permute(0, 2, 3, 1).cpu().numpy())
            results[kvCache] = codes
            print(f"  greedy generate, kvCache={kvCache}, classes {GEN_CLASSES}: {wall * 1e3:.1f} ms "
                  f"(host clock, Neon decode included), K3 launches {k3Launches}, restored "
                  f"{tuple(restored.shape)} finite {finite}, range [{restored.min().item():.3f}, "
                  f"{restored.max().item():.3f}]", flush=True)
            if k3Launches != depth * levels:
                raise AssertionError(f"K3 launched {k3Launches} times, expected {depth * levels}")
            if not finite or images.shape != (batch, 256, 256, 3):
                raise AssertionError(f"restored images {images.shape}, finite {finite}")
            if kvCache:
                k3["launches"] = k3Launches
        same = [torch.equal(a, b) for a, b in zip(results[True], results[False])]
        print(f"  codes with and without the KV cache identical by level: {same}; "
              f"{sum(c.numel() for c in results[True]) // batch} tokens per image", flush=True)
        if not all(same) or len(same) != levels:
            raise AssertionError("the KV-cached codes differ from the uncached ones")

        # the card against the CPU plain path, same weights, depth cut to GEN_CPU_DEPTH
        kept = {key: value for key, value in model.state_dict().items()
                if not key.startswith("transformer.blocks.")
                or int(key.split(".")[2]) < GEN_CPU_DEPTH}
        small = dict(geometry, depth=GEN_CPU_DEPTH)
        cardSmall, cpuSmall = GeneratorV3SelfAttention(**small), GeneratorV3SelfAttention(**small)
        cardSmall.load_state_dict(kept)
        cpuSmall.load_state_dict(kept)
        cardSmall, cpuSmall = cardSmall.to(device).eval(), cpuSmall.eval()
        with exactFp32(), torch.inference_mode():
            cardCodes = [c.cpu() for c in cardSmall.sampleCodes(condition)]
            cpuCodes = cpuSmall.sampleCodes(condition.cpu())
            agree = (sum(int((a == b).sum()) for a, b in zip(cardCodes, cpuCodes))
                     / sum(a.numel() for a in cardCodes))
            firstDiff = next((lv for lv, (a, b) in enumerate(zip(cardCodes, cpuCodes))
                              if not torch.equal(a, b)), None)
            tie = 0.0
            if firstDiff is not None:
                cpuLogits = teacherForcedLogits(cpuSmall, condition.cpu(), cpuCodes, firstDiff)
                a, b = cardCodes[firstDiff].reshape(batch, -1), cpuCodes[firstDiff].reshape(batch, -1)
                gap = (cpuLogits.gather(-1, b[..., None].long())
                       - cpuLogits.gather(-1, a[..., None].long()))
                tie = gap.abs().max().item()
            last = levels - 1
            cardLogits = teacherForcedLogits(cardSmall, condition, [c.to(device) for c in cardCodes],
                                             last).cpu()
            cpuLogits = teacherForcedLogits(cpuSmall, condition.cpu(), cardCodes, last)
            logitsDiff = (cardLogits - cpuLogits).abs().max().item()
        print(f"  depth {GEN_CPU_DEPTH}, card vs CPU: greedy codes agree on {agree:.4%}"
              + ("" if firstDiff is None else
                 f", first differing level {firstDiff} (CPU logit gap there {tie:.2e})")
              + f"; teacher-forced level-{last} logits on the card's codes differ by "
                f"{logitsDiff:.2e}", flush=True)
        if tie > GEN_TIE_ATOL or not logitsDiff <= GEN_LOGITS_ATOL:
            raise AssertionError("the card's generation disagrees with the CPU plain path")
        del cardSmall, cpuSmall

        # Neon encode -> decode of a seeded 256x256 image: K1 at (m, k, d) = (1, 1024, 8)
        neon = model.compressor
        image = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 3, 256, 256))
                                 .astype(np.float32)).to(device)
        searches = []
        originalEncode = quantizerModule.vqEncode

        def captureSearch(x, codebook):
            searches.append((latentTokens(x), codebook.float().contiguous()))
            return originalEncode(x, codebook)

        quantizerModule.vqEncode = captureSearch
        try:
            with exactFp32(), torch.inference_mode():
                neon.encode(image)
        finally:
            quantizerModule.vqEncode = originalEncode
        with exactFp32(), torch.inference_mode():
            for level, (tokens, codebook) in enumerate(searches):
                n, _ = checkCodes(torch, tokens, codebook, vqNearest(tokens, codebook),
                                  vqEncodePlain(tokens, codebook),
                                  f"K1 Neon level {level} {tuple(tokens.shape)} k {codebook.shape[1]}")
                if n:
                    raise AssertionError(f"K1 codes differ from the plain version at level {level}")
            vqNearest.launches = 0
            neonCodes = neon.encode(image)
            neonLaunches = vqNearest.launches
            neonRestored = neon.decode(neonCodes)
        print(f"  Neon round trip of a seeded 256x256 image: K1 launches {neonLaunches}, codes "
              f"{[tuple(c.shape[2:]) for c in neonCodes]}, restored {tuple(neonRestored.shape)} "
              f"finite {bool(torch.isfinite(neonRestored).all())}", flush=True)
        if neonLaunches != levels or not torch.isfinite(neonRestored).all():
            raise AssertionError(f"Neon round trip: K1 launched {neonLaunches} times")

        # the CLI, in a subprocess
        out = Path(tmp) / "samples"
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", "generate", "-c",
                               ",".join(map(str, GEN_CLASSES)), str(ckpt), str(out)],
                              cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"generate CLI exited {proc.returncode}:\n{proc.stderr}")
        pngs = sorted(out.glob("*.png"))
        shapes = [readPng(p).shape for p in pngs]
        print(f"  CLI generate: {[p.name for p in pngs]}, {shapes} in "
              f"{time.perf_counter() - start:.2f} s (process start and load included)", flush=True)
        if len(pngs) != batch or any(sh != (256, 256, 3) for sh in shapes):
            raise AssertionError("the generate CLI did not write 4 256x256 PNGs")

    with Phase("7 validation path"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        folder = tmp / "val"
        folder.mkdir()
        shutil.copy(PHOTO, folder / PHOTO.name)
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", "validate", "-e",
                               str(tmp / "export.npz"), str(zooPath(QP)), str(folder)],
                              cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"validate CLI exited {proc.returncode}:\n{proc.stderr}")
        lines = proc.stdout.strip().splitlines()
        results, exported, speed = json.loads(lines[-3]), Path(lines[-2]), json.loads(lines[-1])
        exportedFlat, exportedMeta = readExport(exported)
        print(f"  validate CLI, {PHOTO.name}, qp-{QP} zoo: {results['bpp']:.4f} bpp, PSNR "
              f"{results['psnr']:.2f} dB, MS-SSIM {results['msssim']:.4f}, ideal bpp "
              f"{results['idealBpp']:.4f}; export {exported.name} ({len(exportedFlat)} arrays, qp "
              f"{exportedMeta['qp']}); {time.perf_counter() - start:.1f} s with process start",
              flush=True)
        print(f"  validate CLI speed, the reference protocol (50 x [10, 768, 512, 3], rANS and "
              f"transfers in): encode {speed['encodeMpps']:.2f} Mpps, decode "
              f"{speed['decodeMpps']:.2f} Mpps on {speed['device']} ({smi})", flush=True)
        if (results["images"] != 1 or results["bpp"] != bpp
                or abs(results["psnr"] - quality) > VALIDATE_PSNR_ATOL):
            raise AssertionError(f"validate gives {results}, phase 4 {bpp} bpp / {quality} dB")
        zooFlat, _ = readExport(zooPath(QP))
        if speed["device"] != kind or set(exportedFlat) != set(zooFlat) or not all(
                np.array_equal(exportedFlat[key], zooFlat[key]) for key in zooFlat):
            raise AssertionError(f"validate ran on {speed['device']}, or its export differs "
                                 "from the zoo file")

        qp12 = CompressorEngine(seededCompressor(*QP12), device="cuda")
        for cell, cellEngine in ((f"qp-{QP}", engine), ("qp-12 (seeded)", qp12)):
            validator = Validator(cellEngine)
            vqNearest.launches = vqNearestGrouped.launches = 0
            encode, decode = validator.speed(SPEED_ITERS)
            perCompress = vqNearest.launches / (SPEED_ITERS + 1)
            modelEncode, modelDecode = validator.speedModel(SPEED_ITERS)
            print(f"  {cell} speed, {SPEED_ITERS} x [10, 768, 512, 3]: encode {encode:.2f} / decode "
                  f"{decode:.2f} Mpps with rANS and transfers; model alone encode "
                  f"{modelEncode:.2f} / decode {modelDecode:.2f} Mpps; K1 {perCompress:g} and K1b "
                  f"{vqNearestGrouped.launches} per compress ({smi})", flush=True)
            if perCompress != 3 or vqNearestGrouped.launches:
                raise AssertionError(f"{cell}: the VQ searches did not all take K1")
        del qp12, validator, cellEngine
        torch.cuda.empty_cache()

        # the past-budget model: level 0 takes K1b, levels 1 and 2 take K1
        pastModel = seededCompressor(*PAST_BUDGET)
        cpuPast = Compressor(*PAST_BUDGET)
        cpuPast.load_state_dict(pastModel.state_dict())
        past = CompressorEngine(pastModel, device="cuda")
        latents = []
        hook = past.model._quantizer._encoders[0]._quantizationHead.register_forward_hook(
            lambda mod, inp, out: latents.append(out.clone()))
        past.decompressImage(past.compressImage(img))
        hook.remove()
        with exactFp32(), torch.inference_mode():
            tokens = latentTokens(groupLatent(latents[0], PAST_BUDGET[1]))
            codebook = past.model._quantizer.codebook(0).contiguous()
            differ = int((vqNearestGrouped(tokens, codebook) != vqEncodePlain(tokens, codebook)).sum())
        print(f"  K1b past-budget level 0 on the photo {tuple(tokens.shape)} k {codebook.shape[1]}: "
              + ("all codes identical" if differ == 0 else f"{differ} codes differ"), flush=True)
        if differ:
            raise AssertionError("K1b differs from the plain version on the real level-0 latents")
        vqNearest.launches = vqNearestGrouped.launches = 0
        start = time.perf_counter()
        pastFile = past.compressImage(img)
        pastRestored = past.decompressImage(File.deserialize(pastFile.serialize()))
        pastS = time.perf_counter() - start
        pastLaunches = {"K1b": vqNearestGrouped.launches, "K1": vqNearest.launches}
        crop = img[192:320, 320:448]
        cardCodes = past.encode(crop[None])
        cpuCodes = CompressorEngine(cpuPast, device="cpu").encode(crop[None])
        same = all(np.array_equal(a, c) for a, c in zip(cardCodes, cpuCodes))
        print(f"  past-budget model {PAST_BUDGET} (seeded): launches per compress {pastLaunches}; "
              f"{pastFile.BPP:.4f} bpp, restored {pastRestored.shape} {pastRestored.dtype}, "
              f"compress + restore {pastS * 1e3:.1f} ms; crop 128x128 codes card == CPU: {same}",
              flush=True)
        if pastLaunches != {"K1b": 1, "K1": 2} or not same or pastRestored.shape != img.shape:
            raise AssertionError("the past-budget path did not run as it should")
        del past, pastModel, cpuPast, latents, tokens, codebook
        torch.cuda.empty_cache()

        # compressMany / decompressMany against one call per batch
        batches = [np.random.default_rng(i).uniform(-1, 1, (10, 768, 512, 3)).astype(np.float32)
                   for i in range(4)]
        engine.compressMany(batches[:1])
        start = time.perf_counter()
        many = engine.compressMany(batches)
        manyS = time.perf_counter() - start
        start = time.perf_counter()
        once = [engine.compress(b)[1:] for b in batches]
        onceS = time.perf_counter() - start
        sameBytes = all(m[0] == o[0] for m, o in zip(many, once))
        start = time.perf_counter()
        restoredMany = engine.decompressMany(many)
        manyRestoreS = time.perf_counter() - start
        start = time.perf_counter()
        restoredOnce = [engine.decompress(*o) for o in once]
        onceRestoreS = time.perf_counter() - start
        sameImages = all(np.array_equal(a, b) for a, b in zip(restoredMany, restoredOnce))
        print(f"  compressMany of 4 x [10, 768, 512, 3]: bytes equal to per-batch compress: "
              f"{sameBytes}, {manyS * 1e3:.1f} ms against {onceS * 1e3:.1f} ms; decompressMany "
              f"equal: {sameImages}, {manyRestoreS * 1e3:.1f} ms against {onceRestoreS * 1e3:.1f} ms "
              f"(host clock)", flush=True)
        if not (sameBytes and sameImages):
            raise AssertionError("the pipelined batches differ from per-batch calls")
        del batches, many, once, restoredMany, restoredOnce

        # --tile through the CLI, against the same tiles coded whole
        tiled, tiledPng = tmp / "tiled.mcq", tmp / "tiled.png"
        for args in (["-qp", str(QP), "--tile", str(TILE), str(PHOTO), str(tiled)],
                     [str(tiled), str(tiledPng)]):
            proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", *args], cwd=ROOT,
                                  capture_output=True, text=True, timeout=CLI_TIMEOUT)
            if proc.returncode != 0:
                raise RuntimeError(f"CLI {args} exited {proc.returncode}:\n{proc.stderr}")
        data = tiled.read_bytes()
        tf = TiledFile.deserialize(data)
        cliRestored = readPng(tiledPng)
        sameFile = data == compressTiled(engine, img, TILE).serialize()
        sameRestore = np.array_equal(cliRestored, decompressTiled(engine, tf))
        tiles, rows, cols = toTiles(img, TILE)
        files = [engine.compressImage(t) for t in tiles]
        sameStreams = sum(f.Content == b for f, b in zip(files, tf.binaries))
        together = fromTiles(engine.decompress([f.Content for f in files],
                                               [f.FileHeader for f in files], toImage=True),
                             rows, cols, *img.shape[:2])
        oneByOne = fromTiles(np.stack([engine.decompressImage(f) for f in files]), rows, cols,
                             *img.shape[:2])
        diff = np.abs(oneByOne.astype(np.int16) - cliRestored.astype(np.int16))
        print(f"  --tile {TILE} CLI: {rows}x{cols} tiles, {tf.BPP:.4f} bpp, PSNR "
              f"{psnr(img, cliRestored):.2f} dB; .mcq identical to in-process: {sameFile}; restore "
              f"equal to in-process: {sameRestore}. The tiles coded whole: {sameStreams} of "
              f"{len(files)} streams identical; restored as one batch, pixels equal: "
              f"{np.array_equal(together, cliRestored)}; restored one by one, pixels equal on "
              f"{(diff == 0).mean():.6%}, max diff {int(diff.max())}", flush=True)
        if not (TiledFile.isTiled(data) and sameFile and sameRestore and sameStreams == len(files)
                and np.array_equal(together, cliRestored) and diff.max() <= TILE_BATCH_MAX_DIFF):
            raise AssertionError("the tiled round trip disagrees")

    kernels = [
        {"name": "vq_nearest", "route": "cuda", "source": "mcquic_tpu_torch/csrc/vq_encode.cu",
         "replaces": "mcquic_tpu/ops/vq_pallas.py:162", "launches": launches["K1"],
         "max_abs_err": k1["err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "device_ms": k1["device_ms"], "library_device_ms": k1["library_device_ms"],
         "bound_fp32_ms": k1["bound_fp32_ms"], "host_us": k1["host_us"],
         "library_host_us": k1["library_host_us"], "photo_rescored": k1["photo_rescored"],
         "neon_device_ms": neonK1["device_ms"], "neon_ms": neonK1["ms"],
         "neon_library_device_ms": neonK1["library_device_ms"],
         "qp12_device_ms": qp12K1["device_ms"],
         "qp12_library_device_ms": qp12K1["library_device_ms"]},
        {"name": "vq_grouped", "route": "cuda", "source": "mcquic_tpu_torch/csrc/vq_grouped.cu",
         "replaces": "mcquic_tpu/ops/vq_pallas.py:75", "launches": pastLaunches["K1b"],
         "max_abs_err": k1b["err"], "ms": k1b["ms"], "plain_ms": k1b["plain_ms"],
         "bound_ms": k1b["bound_ms"], "bound_by": k1b["bound_by"], "library_ms": k1b["library_ms"],
         "device_ms": k1b["device_ms"], "library_device_ms": k1b["library_device_ms"]},
        {"name": "thin_head", "route": "cuda", "source": "mcquic_tpu_torch/csrc/thin_head.cu",
         "replaces": "mcquic_tpu/ops/subpixel_pallas.py:118", "launches": launches["K2"],
         "max_abs_err": k2["err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "device_ms": k2["device_ms"], "library_device_ms": k2["library_device_ms"],
         "bound_fp32_ms": k2["bound_fp32_ms"], "host_us": k2["host_us"],
         "library_host_us": k2["library_host_us"], "batch_device_ms": k2Batch["device_ms"],
         "batch_library_device_ms": k2Batch["library_device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "mcquic_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mcquic_tpu/ops/attention_pallas.py:144", "launches": k3["launches"],
         "max_abs_err": k3["err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "device_ms": k3["device_ms"], "library_device_ms": k3["library_device_ms"],
         "bound_fp32_ms": k3["bound_fp32_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
