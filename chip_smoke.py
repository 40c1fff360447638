#!/usr/bin/env python3
"""Drive the PyTorch port (`mcquic_tpu_torch/`) once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and g++. It imports torch, numpy, the standard library and
`mcquic_tpu_torch` only. The phases, each printed with its seconds as it
ends:

  1. environment: torch / CUDA / nvcc versions, the card, its power limit;
  2. build: kernels K1 (csrc/vq_encode.cu), K1b (csrc/vq_grouped.cu), K2
     (csrc/thin_head.cu) and K3 (csrc/flash_attention.cu) with nvcc, the
     rANS runtime, the JPEG codec (csrc/jpeg.cpp) and the WebP decoder
     (csrc/webp.cpp) with g++, all started together; ptxas's registers and
     spills of every kernel; the host decoders against the fixtures
     tests/golden/torch_jpeg/ (baseline, progressive, smoothed, arithmetic,
     lossless, CMYK, YCCK and 4:1:1 JPEG; the full-size progressive, CMYK
     and arithmetic photos among them), tests/golden/torch_images/ (the PNG
     forms and PIL's BMP forms) and tests/golden/torch_webp/ (lossy,
     lossless, alpha, animated; the full-size lossy and lossless photos), by
     the SHA-256 of PIL's decode of each file, and the codec's decode and
     encode rates on the host, in megapixels per second, on the photo at
     q95, beside the progressive, arithmetic, CMYK and WebP decoders' on
     their photos;
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
  5. the CLI round trip, `python -m mcquic_tpu_torch`, in a subprocess; then
     the photo as a q95 JPEG (the port's encoder): the CLI compresses it, and
     a PNG holding the port's decode of it, to the same `.mcq` bytes; in
     process the JPEG compresses to those bytes with 3 K1 launches and the
     file restores with 1 K2 launch (phase 2 holds the port's q95 bytes of
     the photo and its decode of them to PIL's); the same for PIL's
     progressive JPEG of the photo, whose codes equal those of a PNG of its
     decode; and for the WebP photo (PIL's default quality) and the CMYK
     photo (PIL's q95): each `.mcq` equals the CLI's for a PNG of the port's
     decode, with K1 3 and K2 1 in process;
  6. generation at the full width and depth of gen_stage2_neonA: a seeded
     checkpoint in the JAX package's format goes through the loader; greedy
     `generate` for four classes with and without the KV cache must give the
     same codes at all 9 levels, through K3 (depth x levels launches each);
     K3 is held to its plain version on the q/k/v of every call; the card's
     codes are held to the CPU plain path at depth 2; one Neon encode and
     decode of a seeded 256x256 image runs K1, whose codes must equal the
     plain version's; `python -m mcquic_tpu_torch generate`, started beside
     the phase's in-process work, writes 4 PNGs;
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
     256` round trip through the CLI against the same tiles coded whole, the
     compress in TILED_PROCESSES fresh processes beside the phase's other
     work, each `.mcq` equal to the in-process one and to the tiles coded
     one at a time (ROADMAP C8);
  8. the Neon codec: a seeded Neon export at configs/rd5/neon_v2_60k.yaml's
     geometry goes through `demo.loadModel(local=...)` and compresses and
     restores a 256x256 crop of the photo through a `.mcq` (9 K1 launches
     per compress, K1's codes equal to the plain version's on its real
     latents, the card's codes to the CPU's on CODES_MIN_AGREEMENT of the
     tokens, as phase 4), and the `--local` CLI, started beside the phase's
     in-process work, writes the same file;
  9. stage-1 training at full width: 512x512 crops of the photo go through
     `python -m mcquic_tpu_torch dataset -j 2` in a subprocess (tar shards of
     q95 JPEGs), whose tar bytes must equal the JAX writer's and whose
     members' decode by the port must equal PIL's (`photo.json`);
     configs/rd3/rd_qp2.yaml's model and recipe (batch 8, crop 256, Adam at
     the world-rule lr, the cosine warm-up schedule; seeded initial
     weights) with its trainSet a glob of those shards, for TRAIN_STEPS
     steps through `Trainer.train`, CodebookReassign firing once mid-run.
     The loader's images/s alone (batch 8, crop 256; on these shards and on
     shards of 640x640 crops, the configs' size) and the time the trainer
     waited on it are printed beside the step's images/s. Gates: the first
     step's loss and gradient norm equal the CPU's on the same weights,
     the shard loader's first batch and uniforms (TRAIN_CPU_RTOL); every
     loss finite, no step skipped; the validation inside the trainer launches
     K1 3 times and K2 once per image, K1's codes equal the plain version's
     after the optimizer steps and after the reassign, and the model stays in
     training mode with its gradients on; it logs the code-frequency
     histograms, `val/codeMaps`, `val/raw` and `val/restored` in the JAX
     trainer's order; a checkpoint resumes to the same
     step and parameters; the export loads through `demo.loadModel` and
     round-trips the photo. Printed: steps/s, images/s, a step's device idle
     share (`utils/profiling.py::report`) and the peak memory.
 10. Neon training at full width: configs/rd5/neon_v2_60k.yaml's model and
     recipe (channel 256, k 1024, 9 levels; batch 2, input 256, Adam at the
     world-rule lr, the cosine warm-up, MS-SSIM; LPIPS on a seeded VGG16
     backbone written to MCQUIC_VGG16_WEIGHTS) on PNG crops of the photo for
     NEON_TRAIN_STEPS steps through `Trainer.train`, CodebookReassign cut to
     fire once. Gates: the first step's loss and gradient norm equal the
     CPU's (TRAIN_CPU_RTOL) and its LPIPS (LPIPS_CPU_RTOL); its gradients
     with remat and without agree (REMAT_RTOL; cuDNN's deterministic
     algorithms, no LPIPS term), both peaks printed; no step
     skipped; the validation launches K1 9 times per image, whose codes equal
     the plain version's after the steps and the reassign, and logs as in
     phase 9; checkpoint and
     export written; a few steps under MCQUIC_LPIPS_PROXY=1 give a finite,
     non-zero lpips;
 11. generator training at full width: configs/rd5/gen_stage2_neonA.yaml
     (hidden 512, depth 8, 8 heads, batch 8, Adam, the cosine warm-up) with
     `loadFrom` phase 10's checkpoint, on class folders of `.JPEG` crops
     (the port's encoder, q95), a CMYK `.JPEG` and a `.webp` (the decoder
     fixtures' photos) under two real wnids. Gates: the first step's loss, per-level CE and gradient
     norm equal the CPU's (TRAIN_CPU_RTOL); in process, K1 launches 9 times
     per step with codes equal to the plain version's, K3 never, and the
     tokenizer stays bit-identical; GEN_TRAIN_STEPS steps through
     `python -m mcquic_tpu_torch.train CONFIG -G` (started first, beside the
     in-process build and the CPU's first step), whose config's
     `externalLib` plugin registers a hook that sees every step, keep the
     tokenizer identical to phase 10's; sampling from the trained checkpoint launches K3 72 times,
     each held to its plain version, and the generate CLI writes 2 PNGs.
     Both phases print steps/s, images/s, idle share, device busy per step
     and peak memory.
 12. data parallelism on the one card: (a) the train CLI's `main` on
     rd_qp2 (phase 9's shards, DDP_CLI_STEPS steps) under
     MCQUIC_COORDINATOR / MCQUIC_NUM_PROCESSES=1 / MCQUIC_PROCESS_ID=0, which
     is NCCL at world 1, against the same run without the variables in the
     same process: the checkpoints must be bit-identical (the backend and
     NCCL's version printed); (b) two ranks (`chip_smoke.py --ddp-worker`,
     gloo, which reduces CUDA tensors) sharing the card at full width, rd_qp2
     and gen_stage2_neonA at batch 4 each against one process at batch 8 (run
     in this process while the ranks run) on
     the same 8 images, DDP_STEPS steps, the optimizer state sharded across
     the ranks (ZeRO): the first step's loss and gradient norm within
     TRAIN_CPU_RTOL, the ranks' parameter checksums equal after every step,
     each rank's optimizer state the one process's less half the sharded
     parameters' slots, the rd_qp2 ranks saving DCP steps
     (MCQUIC_CKPT_BACKEND=orbax) that this process resumes at world 1, the
     resumed state through the npz route bit-identical to the ranks' own, K1 equal to its plain version on the codebooks after
     every sharded step (its norm cache must see the step's writes), rank 0's
     validation K1 3 and K2 1 per image (rank 1 none), K1 9 per generator
     step on each rank; steps/s and peak per rank (two ranks on one card
     measure no scaling); (c) NCCL at world 2 on the one card, beside (b), its outcome
     printed verbatim;
 13. GeneratorVAR at the JAX package's defaults (depth 24, width 1536, 16
     heads, about 1.0 B transformer parameters) over the neonA tokenizer,
     seeded: `generate --cfg 1.5` writes 4 PNGs; in process K3 is held to its
     plain version on every call's q/k/v, 216 launches per generate (24
     blocks x 9 levels); the card's codes equal the CPU plain path's at depth
     2 with the same Gumbel noise; K3 timed at the last level (B 8, H 16, Tq
     256, Tk 426, D 96) beside SDPA; the first VAR training step at depth 2
     equals the CPU's (TRAIN_CPU_RTOL); `train -G` on a VAR config at batch 8
     through the CLI's `main` takes VAR_TRAIN_STEPS steps (K1 9 per step,
     none skipped) and its checkpoint samples (K3 216); the Inception Score
     of the four generated images through `validate/inception.py` with a
     seeded torchvision-layout InceptionV3 on the card, the classifier's ms
     and its logits against the CPU's (INCEPTION_CPU_RTOL);
 14. a reference trainer checkpoint at the qp-2 geometry (seeded, under the
     reference names) through `python -m mcquic_tpu_torch.utils.convert`:
     the export's arrays equal the seeded model's, and it compresses and
     restores the photo through K1 (3) and K2 (1);
 15. the web demo's handler (`service/stCompressService.py::handleUpload`) on
     the qp-2 zoo engine: the photo's PNG and the progressive photo give the
     CLI's `.mcq` bytes of phase 5 (K1 3, K2 1), the photo's `.mcq` restores
     to the CLI's PNG, an image past MAX_PIXELS is refused; a seeded
     denseNorm Neon export at neon_v2_60k's geometry through the engine and
     the `--local` CLI (K1 9 per compress, codes equal to the CPU's on phase
     8's crop); one step of that model through `Trainer` at batch 1 on the
     card and on the CPU (TRAIN_CPU_RTOL; the CPU's in a thread); a seeded
     text-conditioned generator at gen_stage2_neonA's geometry (capDim 512)
     sampling greedily from seeded caption embeddings (K3 72), its depth-2
     cut held to the CPU's as in phase 6;
 16. serving over a device list: the qp-2 zoo engine over ["cuda:0",
     "cuda:0"], one replica each, on the speed batch (split 5 and 5) and a
     batch of 3 (whole on the first), `.mcq` bytes equal to the one-device
     engine's, K1 3 and K2 1 per replica, the wall times beside one
     device's; the seeded past-budget model over the same list, K1b once
     and K1 twice per replica, every search equal to the plain version;
 17. captions: a seeded caption encoder (`utils/textEncoder.py`) at
     openai/clip-vit-base-patch32's text geometry (hidden 512, 12 layers, 8
     heads, 77 positions, vocabulary 49408, quick_gelu) over a byte-level
     vocabulary written to a temporary folder encodes eight captions (one
     cut at 77 tokens) on the card: K3 12 times per encode, each call held
     to its plain version, the pooled [8, 512] held to the CPU plain path
     (CAPTION_RTOL); phase 15's text-conditioned generator samples greedily
     from them (K3 72), its depth-2 cut held to the CPU's; K3 at the
     encoder's shape (B 8, H 8, T 77, D 64, causal) timed beside its plain
     version and SDPA with `is_causal`, with its bound.
     The CPU reference steps of phases 10 and 15 run in a thread while the
     card works (`startCpuStep`), and phase 13's generate CLI runs on through
     phases 14 and 15 (`finishVarCli`), to keep the run inside its limit.
     Phases 9-11 run fewer steps than before these phases (TRAIN_STEPS,
     NEON_TRAIN_STEPS, GEN_TRAIN_STEPS) to keep the run inside its limit.

`python3 chip_smoke.py --multi-card` needs two cards or more (at most four
are used): after the environment (with `nvidia-smi topo -m` and NCCL's
version) and the build, it runs phase 12 (b)'s cases with a card per rank
over NCCL, the rd_qp2 ranks' DCP steps resumed at worlds 2 and 1, the
engine over every card against one, and VAR-d24's `train -G` at batch 8
per rank against one card (`multiCard`). `chip_smoke.py --ddp-worker ...` is one
rank of phase 12 or of `--multi-card`, started by it.

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
from contextlib import ExitStack
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
NEON_V2_60K = dict(channel=256, k=1024, size=[16, 8, 8, 4, 4, 2, 2, 1, 1])  # configs/rd5/neon_v2_60k.yaml
RD_QP2 = ROOT / "configs" / "rd3" / "rd_qp2.yaml"
TRAIN_STEPS = 12                 # cut from 30 to make room for phases 12 and 13
REASSIGN_AT = 6                  # CodebookReassign's freq: fires once, mid-run
TRAIN_CPU_RTOL = 1e-3            # first step, card vs CPU, loss and grad norm (fp32, TF32 off;
                                 # cuDNN and the CPU sum in other orders)
NEON_V2_60K_CONFIG = ROOT / "configs" / "rd5" / "neon_v2_60k.yaml"
GEN_NEON_A_CONFIG = ROOT / "configs" / "rd5" / "gen_stage2_neonA.yaml"
NEON_TRAIN_STEPS = 2             # cut from 30, then 6 (room for phase 14): a save every step
NEON_REASSIGN_AT = 1             # CodebookReassign's freq, cut from 3000 so that one runs
LPIPS_CPU_RTOL = 1e-4            # the first Neon step's LPIPS, card vs CPU
REMAT_RTOL = 1e-5                # the first Neon step's gradients, remat vs plain, on the card
PROXY_STEPS = 3
GEN_WNIDS = ["n01440764", "n02099601"]
GEN_TRAIN_STEPS = 5              # through the CLI, cut from 10000 (and from 30, then 10, here)
GEN_TIMED_STEPS = 5              # in process, counted step by step (cut from 8)
GEN_SAMPLE_CLASSES = [1, 207]
TILE = 256
TILED_PROCESSES = 3              # phase 7: the tiled CLI compress in this many fresh processes
JPEG_FIXTURE = ROOT / "tests" / "golden" / "torch_jpeg"
IMAGE_FIXTURE = ROOT / "tests" / "golden" / "torch_images"   # the PNG and BMP forms
PHOTO_PROGRESSIVE = JPEG_FIXTURE / "photo_progressive.jpg"   # PIL's progressive q90 of the photo
PHOTO_CMYK = JPEG_FIXTURE / "photo_cmyk_q95.jpg"              # PIL's CMYK q95 of the photo
WEBP_FIXTURE = ROOT / "tests" / "golden" / "torch_webp"
PHOTO_WEBP = WEBP_FIXTURE / "photo_q80.webp"                  # PIL's default-quality WebP of the photo
PHOTO_WEBP_LOSSLESS = WEBP_FIXTURE / "photo_lossless.webp"    # PIL's lossless WebP of the photo
PHOTO_ARITHMETIC = JPEG_FIXTURE / "photo_arithmetic.jpg"      # the test writer's arithmetic q-table JPEG
PHOTO_DIGESTS = JPEG_FIXTURE / "photo.json"   # PIL's q95 of the photo, the JAX writer's shards
JPEG_RATE_ITERS = 20
SHARD_CROPS = 16                 # 512x512 crops into the dataset CLI: two batches of 8 per epoch
LOADER_EPOCHS = 4                # the loader timed alone
CONFIG_CROP = 640                # the configs' shards hold 640x640 crops
                                 # (examples/prepare_photo_dataset.py:49)
DDP_CLI_STEPS = 3                # phase 12 (a): the train CLI's steps, with and without NCCL
DDP_STEPS = 3                    # phase 12 (b): steps of each case, ranks and one process
DDP_GLOBAL_BATCH = 8             # rd_qp2's and gen_stage2_neonA's batch: 2 ranks x 4
DDP_TIMEOUT = 480                # seconds for the two ranks of a phase-12 case
NCCL_TIMEOUT = 90                # seconds for NCCL at world 2 on one card to succeed or fail
VAR_D24 = dict(channel=256, k=1024, size=[16, 8, 8, 4, 4, 2, 2, 1, 1], depth=24, embedDim=1536,
               nHeads=16, numClasses=1000)   # GeneratorVAR's defaults over the neonA tokenizer
VAR_TRAIN_STEPS = 3              # train -G on the VAR config
INCEPTION_CPU_RTOL = 1e-3        # phase 13: InceptionV3's logits, card vs CPU, of the largest
CAPTIONS = ["a photo of a cat sitting on the grass in the sun",
            "The quick brown fox jumps over the lazy dog.",
            "A red car parked in front of an old house at night, 2024",
            "two people walking along the beach with their dog!!!",
            "Café crème, naïve façade, ΣΟΦΙΑ, 東京タワー",
            "a bowl of fruit on a wooden table: apples, oranges & pears",
            "",
            " ".join(["a very long caption that runs past the context"] * 12)]   # cut at 77
CAPTION_RTOL = 1e-4              # phase 17: pooled embeddings, card vs CPU, of the largest
TILE_BATCH_MAX_DIFF = 1          # uint8 levels: cuDNN picks algorithms by batch size, so the same
                                 # codes decoded one by one and as a batch of 6 round differently

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W): fp32 on the CUDA cores, HBM3,
# TF32 on the tensor cores (K3 takes three TF32 products per fp32 product)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
COUNTING_PLUGIN = '''"""A config's externalLib file: a hook that writes each step it sees."""
from pathlib import Path

from mcquic_tpu_torch.utils.registry import HookRegistry


@HookRegistry.register(key="SmokeCountSteps")
class CountSteps:
    def __init__(self, path):
        self.path = Path(path)

    def __call__(self, trainer, step):
        with self.path.open("a") as f:
            f.write(f"{step}\\n")
'''
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


def generatorVsCpu(torch, state: dict, geometry: dict, condition, levels: int):
    """The greedy codes of a `GeneratorV3SelfAttention`'s first GEN_CPU_DEPTH
    blocks on the card against the CPU plain path, same weights: a differing
    code must be a near-tie of the CPU's logits (GEN_TIE_ATOL), and the
    teacher-forced logits of the last level on the card's codes must agree
    (GEN_LOGITS_ATOL). `condition` lives on the card: class ids, or caption
    embeddings for a text-conditioned geometry."""
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    from mcquic_tpu_torch.utils import exactFp32
    device = torch.device("cuda")
    batch = condition.shape[0]
    kept = {key: value for key, value in state.items()
            if not key.startswith("transformer.blocks.") or int(key.split(".")[2]) < GEN_CPU_DEPTH}
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
    return agree


def k1MatchesPlain(torch, model, gen, label):
    """K1 against its plain version on random tokens and the model's live
    codebooks, level by level; raises on any differing code."""
    from mcquic_tpu_torch.ops.vq import vqEncodePlain
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    from mcquic_tpu_torch.utils import exactFp32
    with exactFp32(), torch.no_grad():
        for level in range(len(model.k)):
            codebook = model._quantizer.codebook(level).detach()
            tokens = torch.randn((model.m, 4096, codebook.shape[-1]), device=codebook.device,
                                 generator=gen)
            if not torch.equal(vqNearest(tokens, codebook), vqEncodePlain(tokens, codebook)):
                raise AssertionError(f"K1 differs from the plain version {label}, level {level}")
    print(f"  K1 codes equal the plain version's on the live codebooks {label}", flush=True)


def shardCrops(img) -> dict:
    """The SHARD_CROPS 512x512 crops of the photo that phase 9 writes into
    shards, by file name, every other one mirrored; `photo.json` holds the
    digests of the JAX writer's shards of them (tests/test_torch_dataset_cli.py)."""
    crops = {}
    for i in range(SHARD_CROPS):
        left = i * (img.shape[1] - 512) // (SHARD_CROPS - 1)
        crop = img[:512, left:left + 512]
        crops[f"{i:02d}.png"] = crop[:, ::-1] if i % 2 else crop
    return crops


def shardDigests(folder: Path, decode) -> list:
    """For each shard in `folder`, by name: the SHA-256 of its tar bytes
    after gzip decompression, and of its `.jpg` members' decodes by
    `decode(bytes)`, concatenated in member order."""
    import gzip
    import hashlib
    import io
    import tarfile
    digests = []
    for path in sorted(Path(folder).glob("*.tar.gz")):
        raw = gzip.decompress(path.read_bytes())
        decoded = hashlib.sha256()
        with tarfile.open(fileobj=io.BytesIO(raw)) as tf:
            for member in tf:
                if member.name.endswith(".jpg"):
                    decoded.update(decode(tf.extractfile(member).read()).tobytes())
        digests.append({"tar_sha256": hashlib.sha256(raw).hexdigest(),
                        "decode_sha256": decoded.hexdigest()})
    return digests


class RecordingLogger:
    """A metrics logger that keeps what the trainer hands it."""

    def __init__(self):
        self.calls = []

    def log(self, step, metrics):
        self.calls.append(("log", step, sorted(metrics)))

    def histogram(self, step, name, values):
        self.calls.append(("histogram", step, name, values))

    def images(self, step, name, images):
        self.calls.append(("images", step, name, images))


def checkValLogging(np, recorder: RecordingLogger, model, step: int, valImages: int, label: str):
    """The trainer's validation logged the code-frequency histograms,
    `val/codeMaps`, `val/raw` and `val/restored` in the JAX trainer's order
    (`mcquic_tpu/train/trainer.py:360-374`): one histogram per level, one
    uint8 code map per level and group, and the raw / restored pair of every
    validation image at one shape."""
    logged = [c for c in recorder.calls if c[0] != "log" and c[1] == step]
    names = [c[2] for c in logged]
    levels = len(model._quantizer.frequencies())
    want = [f"freq/freqEMA{i}" for i in range(levels)] + ["val/codeMaps", "val/raw", "val/restored"]
    images = {c[2]: [np.asarray(i) for i in c[3]] for c in logged if c[0] == "images"}
    maps, raw, restored = (images.get(name, []) for name in ("val/codeMaps", "val/raw",
                                                              "val/restored"))
    ok = (names == want and len(maps) >= levels and all(m.dtype == np.uint8 and m.ndim == 3
                                                        for m in maps)
          and len(raw) == len(restored) == valImages
          and all(a.shape == b.shape and b.dtype == np.uint8 for a, b in zip(raw, restored)))
    print(f"  {label} validation logging at step {step}: {names}; {len(maps)} code maps "
          f"{sorted({m.shape for m in maps})}, {len(restored)} restored "
          f"{[r.shape for r in restored]}", flush=True)
    if not ok:
        raise AssertionError(f"the {label} trainer's validation logging: {names}")


def startShards(tmp: Path, img):
    """`shardCrops` into `python -m mcquic_tpu_torch dataset -j 2`, started
    in the background; returns (the process, its start time, the shards'
    glob)."""
    from mcquic_tpu_torch.data.png import writePng
    images, shards = tmp / "images", tmp / "shards"
    images.mkdir()
    for name, crop in shardCrops(img).items():
        writePng(images / name, crop)
    proc = subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch", "dataset", "-j", "2",
                             str(images), str(shards)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter(), str(shards / "*.tar.gz")


def finishShards(proc, started: float, pattern: str):
    """Wait for the dataset CLI and check what it wrote: the metadata, and
    every shard's tar bytes and its members' decodes by the port against
    the JAX writer's shards and PIL's decode (`photo.json`)."""
    from mcquic_tpu_torch.data.jpeg import readJpeg
    _, stderr = proc.communicate(timeout=CLI_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"the dataset CLI exited {proc.returncode}:\n{stderr}")
    shards = Path(pattern).parent
    metadata = json.loads((shards / "metadata.json").read_text())
    print(f"  dataset CLI -j 2: {metadata} in {time.perf_counter() - started:.1f} s "
          f"(process start included): "
          + ", ".join(f"{p.name} {p.stat().st_size} bytes" for p in sorted(shards.glob("*.tar.gz"))),
          flush=True)
    if metadata != {"count": SHARD_CROPS, "shards": 2, "imageText": False}:
        raise AssertionError(f"the dataset CLI wrote {metadata}")
    got = shardDigests(shards, readJpeg)
    want = json.loads(PHOTO_DIGESTS.read_text())["shard_crops"]
    print(f"  shards: tar bytes equal the JAX writer's {[g['tar_sha256'] == w['tar_sha256'] for g, w in zip(got, want)]}, "
          f"the port's decode of their {SHARD_CROPS} members equals PIL's "
          f"{[g['decode_sha256'] == w['decode_sha256'] for g, w in zip(got, want)]}", flush=True)
    if got != want:
        raise AssertionError(f"the shards or their decode differ from the JAX writer's and PIL's: "
                             f"{got} against {want}")


def timeLoader(getTrainLoader, pattern: str, batchSize: int, cropSize: int) -> tuple:
    """(images, images/s) of the shard loader alone over LOADER_EPOCHS epochs."""
    loaderFn = getTrainLoader(pattern, batchSize, cropSize=cropSize)
    start, loaded = time.perf_counter(), 0
    for _ in range(LOADER_EPOCHS):
        for b in loaderFn():
            loaded += b.shape[0]
    return loaded, loaded / (time.perf_counter() - start)


def configSizeShards(tmp: Path, img) -> str:
    """SHARD_CROPS crops of CONFIG_CROP x CONFIG_CROP, the photo's rows
    mirrored past its bottom edge, written into shards in process by the
    dataset writer with 2 jobs; returns their glob."""
    import numpy as np
    from mcquic_tpu_torch.data.cli import main as writeShards
    from mcquic_tpu_torch.data.png import writePng
    tall = np.pad(img, ((0, CONFIG_CROP - img.shape[0]), (0, 0), (0, 0)), mode="reflect")
    images = tmp / f"images{CONFIG_CROP}"
    images.mkdir()
    for i in range(SHARD_CROPS):
        left = i * (img.shape[1] - CONFIG_CROP) // (SHARD_CROPS - 1)
        writePng(images / f"{i:02d}.png", tall[:, left:left + CONFIG_CROP])
    if writeShards(images, tmp / f"shards{CONFIG_CROP}", jobs=2) != SHARD_CROPS:
        raise AssertionError(f"the {CONFIG_CROP}x{CONFIG_CROP} crops did not all pass the filter")
    return str(tmp / f"shards{CONFIG_CROP}" / "*.tar.gz")


def train9(torch, np, tmp: Path, img, smi: str, codec: dict) -> dict:
    """Phase 9: rd_qp2's model and recipe trained on the card for
    TRAIN_STEPS steps from shards the dataset CLI wrote, with every gate of
    the phase; returns the K1 and K2 launches per image of the validation
    inside the trainer."""
    datasetCli, started, shards = startShards(tmp, img)
    try:
        return trainFromShards(torch, np, tmp, img, smi, codec, datasetCli, started, shards)
    finally:
        if datasetCli.poll() is None:
            datasetCli.kill()
            datasetCli.wait()


def trainFromShards(torch, np, tmp: Path, img, smi: str, codec: dict, datasetCli, started,
                    shards: str) -> dict:
    """Phase 9 after the dataset CLI started: the run and its gates."""
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.container import File
    from mcquic_tpu_torch.data import getTrainLoader, getValLoader
    from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
    from mcquic_tpu_torch.demo import loadModel
    from mcquic_tpu_torch.loss import PSNR
    from mcquic_tpu_torch.models.compressor import Compressor
    from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelThin
    from mcquic_tpu_torch.ops.vq import groupLatent, latentTokens, vqEncodePlain
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    from mcquic_tpu_torch.train.optim import getOptimizer
    from mcquic_tpu_torch.train.state import makeTrainStep, trainableParameters
    from mcquic_tpu_torch.train.trainer import Trainer
    from mcquic_tpu_torch.utils import exactFp32
    from mcquic_tpu_torch.utils.convert import exportModel
    from mcquic_tpu_torch.utils.profiling import report

    device = torch.device("cuda")
    val = tmp / "val"
    val.mkdir()
    shutil.copy(PHOTO, val / PHOTO.name)
    data = Config.load(str(RD_QP2)).serialize()
    data["train"].update(totalStep=TRAIN_STEPS, valFreq=TRAIN_STEPS, trainSet=shards,
                         valSet=str(val), saveDir=str(tmp / "saved"),
                         hooks=[{"key": "CodebookReassign", "params": {"freq": REASSIGN_AT}}])
    config = Config.deserialize(data)
    trainer = Trainer(config, device="cuda")
    model = trainer.model
    print(f"  configs/rd3/rd_qp2.yaml: {config.Model.Params}, batch {config.Train.BatchSize}, "
          f"crop {trainer.inputSize}, {config.Train.Optim.Key} at the world-rule lr "
          f"{trainer._baseLr:.4e}, {config.Train.Schdr.Key} {config.Train.Schdr.Params}; "
          f"{sum(p.numel() for p in trainableParameters(model)) / 1e6:.2f} M parameters; "
          f"{TRAIN_STEPS} steps, CodebookReassign every {REASSIGN_AT}", flush=True)
    if abs(trainer._baseLr - 1e-4 / 2 ** 1.5) > 1e-12:
        raise AssertionError(f"lr {trainer._baseLr} is not rd_qp2's 1e-4 under the world rule")

    # the shards, checked; the first step on the card against the CPU: same
    # weights, batch (the shard loader's first), uniforms
    finishShards(datasetCli, started, shards)
    batch = next(iter(getTrainLoader(shards, config.Train.BatchSize, cropSize=trainer.inputSize)()))
    cpuGen = torch.Generator().manual_seed(0)
    x = trainingTransform(torch.from_numpy(batch), augmentDraws(cpuGen, batch.shape[0]))
    recorded = recordedDraws(torch, cpuGen)
    first = {}
    for dev in (torch.device("cpu"), device):
        copy = Compressor(model.channel, model.m, model.k)
        copy.load_state_dict(model.state_dict())
        copy = copy.to(dev).train()
        optimizer = getOptimizer("Adam", trainer._schedule, {}, trainableParameters(copy))
        start = time.perf_counter()
        with exactFp32():
            metrics = makeTrainStep(copy, optimizer, PSNR())(x.to(dev), recorded(dev))
        first[dev.type] = {k: float(v) for k, v in metrics.items()}
        print(f"  first step on the {dev.type}: loss {first[dev.type]['loss']:.8f}, grad norm "
              f"{first[dev.type]['gradNorm']:.8f}, {time.perf_counter() - start:.1f} s", flush=True)
        del copy, optimizer
    for key in ("loss", "gradNorm"):
        cpu, card = first["cpu"][key], first["cuda"][key]
        if not abs(card - cpu) <= TRAIN_CPU_RTOL * abs(cpu):
            raise AssertionError(f"first step {key}: card {card}, CPU {cpu}")
    print(f"  first step card vs CPU: loss differs by {abs(first['cuda']['loss'] - first['cpu']['loss']) / abs(first['cpu']['loss']):.2e} "
          f"relative, grad norm by {abs(first['cuda']['gradNorm'] - first['cpu']['gradNorm']) / abs(first['cpu']['gradNorm']):.2e} "
          f"(tolerance {TRAIN_CPU_RTOL:g})", flush=True)
    del recorded, x
    torch.cuda.empty_cache()

    # the loader alone, on these shards and on shards of the configs' crop size
    loaded, loaderRate = timeLoader(getTrainLoader, shards, config.Train.BatchSize,
                                    trainer.inputSize)
    _, loaderRateConfig = timeLoader(getTrainLoader, configSizeShards(tmp, img),
                                     config.Train.BatchSize, trainer.inputSize)
    print(f"  the shard loader alone: {loaded} images (batch {config.Train.BatchSize}, crop "
          f"{trainer.inputSize}, {LOADER_EPOCHS} epochs) at {loaderRate:.2f} images/s from the "
          f"512x512 shards, {loaderRateConfig:.2f} images/s from {CONFIG_CROP}x{CONFIG_CROP} "
          f"shards ({smi})", flush=True)

    # the run, through Trainer.train, instrumented
    stepS, losses, skipped, valInfo = [], [], [], {}
    gen = torch.Generator(device=device).manual_seed(5)
    trainStep, reassign, validate = trainer.trainStep, trainer.reassignCodebooks, trainer.validate

    def timedStep(b):
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = trainStep(b)
        torch.cuda.synchronize()
        stepS.append(time.perf_counter() - start)
        losses.append(float(metrics["loss"]))
        skipped.append(float(metrics["skipped"]))
        return metrics

    def checkedReassign():
        prop = reassign()
        print(f"  step {trainer.step}: CodebookReassign moved {prop:.4f} of the codewords", flush=True)
        k1MatchesPlain(torch, model, gen, f"after the reassign at step {trainer.step}")
        return prop

    def countedValidate(valLoader):
        latents = []
        hooks = [level._quantizationHead.register_forward_hook(
            lambda mod, inp, out: latents.append(out.detach().clone()))
            for level in model._quantizer._encoders]
        vqNearest.launches = conv3x3SubpixelThin.launches = 0
        try:
            results = validate(valLoader)
        finally:
            for hook in hooks:
                hook.remove()
        valInfo.update(results=results, K1=vqNearest.launches / results["images"],
                   K2=conv3x3SubpixelThin.launches / results["images"], training=model.training,
                   grads=all(p.requires_grad for p in trainableParameters(model)))
        with exactFp32(), torch.no_grad():
            for level, q in enumerate(latents[:len(model.k)]):
                tokens = latentTokens(groupLatent(q, model.m))
                codebook = model._quantizer.codebook(level).detach()
                if not torch.equal(vqNearest(tokens, codebook), vqEncodePlain(tokens, codebook)):
                    raise AssertionError(f"K1 differs from the plain version on the validation's "
                                         f"level-{level} latents at step {trainer.step}")
        print(f"  validation at step {trainer.step}: {results}; K1 {valInfo['K1']:g} and K2 "
              f"{valInfo['K2']:g} launches per image; K1 codes equal the plain version's on its "
              f"latents after {trainer.step} optimizer steps", flush=True)
        return results

    trainer.trainStep, trainer.reassignCodebooks, trainer.validate = (timedStep, checkedReassign,
                                                                      countedValidate)
    waits = []
    shardLoader = getTrainLoader(shards, config.Train.BatchSize, cropSize=trainer.inputSize)

    def waitedLoader():
        """The shard loader, timing each wait of the trainer for a batch."""
        batches = iter(shardLoader())
        while True:
            start = time.perf_counter()
            b = next(batches, None)
            if b is None:
                return
            waits.append(time.perf_counter() - start)
            yield b

    recorder = RecordingLogger()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    trainer.train(waitedLoader, valLoader=getValLoader(val), onStep=recorder.log,
                  metricsLogger=recorder)
    runS = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(stepS[1:])
    print(f"  {len(stepS)} steps in {runS:.1f} s with saves and validation; step median "
          f"{steady * 1e3:.1f} ms (first {stepS[0] * 1e3:.1f} ms): {1 / steady:.3f} steps/s, "
          f"{config.Train.BatchSize / steady:.2f} images/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({smi})", flush=True)
    print(f"  data: the shard loader alone {loaderRate:.2f} images/s ({loaderRateConfig:.2f} at "
          f"{CONFIG_CROP}x{CONFIG_CROP}) against the step's "
          f"{config.Train.BatchSize / steady:.2f}; the trainer waited {sum(waits):.2f} s for "
          f"{len(waits)} batches (median {statistics.median(waits) * 1e3:.1f} ms, first "
          f"{waits[0] * 1e3:.1f} ms); JPEG decode {codec['decode_mp_s']:.2f} MP/s, encode "
          f"{codec['encode_mp_s']:.2f} MP/s on the host ({smi})", flush=True)
    print(f"  losses: first {losses[0]:.6f}, last {losses[-1]:.6f}, all finite "
          f"{all(np.isfinite(losses))}, skipped {int(sum(skipped))}", flush=True)
    if len(stepS) != TRAIN_STEPS or not all(np.isfinite(losses)) or any(skipped):
        raise AssertionError("a training step was skipped or not finite")
    if (not valInfo or valInfo["K1"] != 3 or valInfo["K2"] != 1 or not valInfo["training"]
            or not valInfo["grads"]):
        raise AssertionError(f"the validation inside the trainer: {valInfo}")
    checkValLogging(np, recorder, model, TRAIN_STEPS, 1, "rd_qp2")

    # resume: a fresh trainer on the save directory comes back to this state
    resumed = Trainer(config, device="cuda")
    try:
        if not resumed.tryResume() or resumed.step != TRAIN_STEPS:
            raise AssertionError(f"resume came back at step {resumed.step}")
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                     resumed.model.state_dict().values()))
        sameMoments = all(torch.equal(a, b) for a, b in zip(trainer.optimizer.state["mu"],
                                                            resumed.optimizer.state["mu"]))
        print(f"  resumed at step {resumed.step}: parameters identical {same}, first moments "
              f"identical {sameMoments}", flush=True)
        if not (same and sameMoments):
            raise AssertionError("the resumed state differs")
        wall, busy, idle = report(f"  training step (batch {config.Train.BatchSize}, crop "
                                  f"{trainer.inputSize})", lambda: resumed.trainStep(batch), 3, 8)
    finally:
        resumed.close()

    # the export through demo.loadModel and a .mcq of the photo
    export = exportModel(tmp / "export.npz", trainer.variables(), config.serialize(), qp="train")
    engine = loadModel(local=export, device="cuda")
    file = engine.compressImage(img)
    restored = engine.decompressImage(File.deserialize(file.serialize()))
    print(f"  export {export.name}: the photo at {file.BPP:.4f} bpp, PSNR {psnr(img, restored):.2f} "
          f"dB after {TRAIN_STEPS} warm-up steps", flush=True)
    if restored.shape != img.shape or restored.dtype != np.uint8:
        raise AssertionError("the export does not round-trip the photo")
    return {"K1": valInfo["K1"], "K2": valInfo["K2"], "steps_per_s": 1 / steady,
            "images_per_s": config.Train.BatchSize / steady, "idle_share": idle,
            "peak_gib": peak / 2 ** 30, "loader_images_per_s": loaderRate,
            "loader_images_per_s_config_crop": loaderRateConfig,
            "loader_wait_s": sum(waits)}


def seededVgg16(torch, path: Path, seed: int = 0) -> Path:
    """A torchvision-layout VGG16 `features` state dict of seeded He-scaled
    weights, for the LPIPS backbone slot (no pretrained file is on the
    machine); the cost of the term does not depend on the weights."""
    from mcquic_tpu_torch.loss.lpips import VGG_STAGES
    generator = torch.Generator().manual_seed(seed)
    index = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    state, inChannels, i = {}, 3, 0
    for channels, count in VGG_STAGES:
        for _ in range(count):
            state[f"features.{index[i]}.weight"] = (torch.randn(
                (channels, inChannels, 3, 3), generator=generator) * (2 / (9 * inChannels)) ** 0.5)
            state[f"features.{index[i]}.bias"] = (torch.rand(channels, generator=generator) - 0.5) * 0.1
            inChannels, i = channels, i + 1
    torch.save(state, path)
    return path


def cropFolder(folder: Path, img, count: int, size: int = 320, seed: int = 0,
               jpeg: bool = False):
    """`count` crops of the photo, every other one mirrored: PNGs, or q95
    `.JPEG` files of the port's encoder."""
    from mcquic_tpu_torch.data.jpeg import encodeJpeg
    from mcquic_tpu_torch.data.png import writePng
    folder.mkdir(parents=True)
    h, w = img.shape[:2]
    for i in range(count):
        top, left = (i * 37 + seed * 11) % (h - size), (i * 61 + seed * 23) % (w - size)
        crop = img[top:top + size, left:left + size]
        crop = crop[:, ::-1] if i % 2 else crop
        if jpeg:
            (folder / f"{folder.name}_{i:02d}.JPEG").write_bytes(encodeJpeg(crop, 95))
        else:
            writePng(folder / f"{i:02d}.png", crop)


def writeConfig(path: Path, data: dict) -> Path:
    """A config as YAML the port's reader takes: top-level keys, JSON values."""
    path.write_text("".join(f"{key}: {json.dumps(value)}\n" for key, value in data.items()))
    return path


def recordedDraws(torch, generator):
    """(draw(device)): uniforms drawn on the CPU at first use, replayed on
    every later device, so two runs of a step sample alike."""
    uniforms = []

    def recorded(dev):
        queue = iter(uniforms)

        def draw(shape):
            u = next(queue, None)
            if u is None:
                u = torch.rand(shape, generator=generator)
                uniforms.append(u)
            return u.to(dev)
        return draw
    return recorded


def startCpuStep(torch, step, recorded, draws: int):
    """Run `step(draw)`, a CPU reference step, in a thread while the card
    works. It must set no process-wide state: TF32 and cuDNN's flags
    (`exactFp32`) are global, apply to the card only, and a thread's exit
    from them would reset them under the card's step. The CPU draws the
    run's uniforms through `recorded` (`recordedDraws`). Returns (wait,
    join): `wait()` returns once the CPU has drawn `draws` uniforms, so the
    card's steps can replay them; `join()` returns the step's result. Both
    raise the thread's error."""
    import threading
    drawn, box, count = threading.Event(), {}, [0]
    inner = recorded(torch.device("cpu"))

    def draw(shape):
        u = inner(shape)
        count[0] += 1
        if count[0] == draws:
            drawn.set()
        return u

    def run():
        try:
            box["result"] = step(draw)
        except BaseException as e:      # raised again on the main thread
            box["error"] = e
        finally:
            drawn.set()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        drawn.wait()
        if "error" in box:
            raise box["error"]

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]
    return wait, join


def relativeGap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train10(torch, np, tmp: Path, img, smi: str) -> dict:
    """Phase 10: Neon trained at configs/rd5/neon_v2_60k.yaml's model and
    recipe for NEON_TRAIN_STEPS steps through `Trainer.train`, with every
    gate of the phase; returns its numbers and the checkpoint's path."""
    import os
    import mcquic_tpu_torch.models.quantizer as quantizerModule
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.data import getTrainLoader, getValLoader
    from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
    from mcquic_tpu_torch.loss import MsSSIM
    from mcquic_tpu_torch.loss.lpips import makeDefaultLpipsFn
    from mcquic_tpu_torch.models.compressor import Neon
    from mcquic_tpu_torch.ops.vq import latentTokens, vqEncodePlain
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    from mcquic_tpu_torch.train.optim import Optimizer
    from mcquic_tpu_torch.train.state import makeTrainStep, trainableParameters
    from mcquic_tpu_torch.train.trainer import Trainer
    from mcquic_tpu_torch.utils import exactFp32
    from mcquic_tpu_torch.utils.convert import exportModel
    from mcquic_tpu_torch.utils.profiling import report

    class Keep(Optimizer):
        """Keeps the clipped gradients it is given and applies nothing."""

        def step(self, grads):
            self.kept = [g.detach().cpu() for g in grads]

    device = torch.device("cuda")
    pngs, val = tmp / "neon_train", tmp / "neon_val"
    cropFolder(pngs, img, 8)
    val.mkdir()
    shutil.copy(PHOTO, val / PHOTO.name)
    os.environ.pop("MCQUIC_LPIPS_PROXY", None)
    os.environ["MCQUIC_VGG16_WEIGHTS"] = str(seededVgg16(torch, tmp / "vgg16_seeded.pth"))
    data = Config.load(str(NEON_V2_60K_CONFIG)).serialize()
    data["train"].update(totalStep=NEON_TRAIN_STEPS, valFreq=NEON_TRAIN_STEPS, trainSet=str(pngs),
                         valSet=str(val), saveDir=str(tmp / "neon"),
                         hooks=[{"key": "CodebookReassign", "params": {"freq": NEON_REASSIGN_AT}}])
    config = Config.deserialize(data)
    trainer = Trainer(config, device="cuda")
    model = trainer.model
    bs = config.Train.BatchSize
    print(f"  configs/rd5/neon_v2_60k.yaml: {config.Model.Params}, batch {bs}, input "
          f"{trainer.inputSize}, {config.Train.Optim.Key} at the world-rule lr {trainer._baseLr:.4e}, "
          f"{config.Train.Schdr.Key} {config.Train.Schdr.Params}, target {config.Train.Target}; "
          f"{sum(p.numel() for p in trainableParameters(model)) / 1e6:.2f} M parameters; "
          f"{NEON_TRAIN_STEPS} steps (cut from 60000), CodebookReassign every {NEON_REASSIGN_AT} "
          f"(cut from 3000); LPIPS on a seeded VGG16 backbone (MCQUIC_VGG16_WEIGHTS)", flush=True)
    if abs(trainer._baseLr - 1.3e-4 / 2 ** 2.5) > 1e-12 or trainer.inputSize != 256:
        raise AssertionError(f"lr {trainer._baseLr} / input {trainer.inputSize} are not the recipe's")
    if trainer._lpipsFn is None or not model.useRemat:
        raise AssertionError("the trainer lacks its LPIPS term or Neon its remat")

    # the first step: card against the CPU (LPIPS included); then remat
    # against the plain pass on the card, without the LPIPS term and with
    # cuDNN's deterministic algorithms, so that only the remat differs
    batch = next(iter(getTrainLoader(pngs, bs, cropSize=trainer.inputSize)()))
    cpuGen = torch.Generator().manual_seed(0)
    x = trainingTransform(torch.from_numpy(batch), augmentDraws(cpuGen, batch.shape[0]))
    recorded = recordedDraws(torch, cpuGen)
    first, grads, peaks = {}, {}, {}

    def firstStep(label, dev, remat, lpips, draw):
        copy = Neon(model.channel, model.k, model.size, useRemat=remat)
        copy.load_state_dict(model.state_dict())
        copy = copy.to(dev).train()
        keep = Keep(trainableParameters(copy), trainer._schedule)
        step = makeTrainStep(copy, keep, MsSSIM(), makeDefaultLpipsFn(dev) if lpips else None)
        start = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with exactFp32(), torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                                         deterministic=not lpips, allow_tf32=False):
                metrics = step(x.to(dev), draw)
            peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        else:                           # in a thread, with no process-wide flag (`startCpuStep`)
            metrics = step(x.to(dev), draw)
        first[label] = {k: float(v) for k, v in metrics.items()}
        grads[label] = keep.kept
        print(f"  first step, {label}: loss {first[label]['loss']:.8f}, lpips "
              f"{first[label]['lpips']:.8f}, grad norm {first[label]['gradNorm']:.8f}, "
              f"{time.perf_counter() - start:.1f} s"
              + (f", peak memory {peaks[label]:.2f} GiB" if label in peaks else "")
              + (" (in a thread while the card's steps ran)" if dev.type == "cpu" else ""),
              flush=True)
        del copy, keep, step

    waitDraws, joinCpu = startCpuStep(
        torch, lambda draw: firstStep("cpu", torch.device("cpu"), True, True, draw), recorded,
        2 * len(model.size))
    waitDraws()
    for label, remat, lpips in (("card", True, True),
                                ("card, warm-up of the deterministic algorithms", True, False),
                                ("card, remat", True, False), ("card, no remat", False, False)):
        firstStep(label, device, remat, lpips, recorded(device))
        torch.cuda.empty_cache()
    rematGap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(grads["card, remat"], grads["card, no remat"]))
    print(f"  first step, remat vs plain gradients on the card: {rematGap:.2e} relative, the "
          f"largest of any tensor's (tolerance {REMAT_RTOL:g}); peak memory of the step with "
          f"remat {peaks['card, remat']:.2f} GiB, without {peaks['card, no remat']:.2f} GiB "
          f"({smi})", flush=True)
    if rematGap > REMAT_RTOL or not first["card"]["lpips"] > 0:
        raise AssertionError(f"first step: remat {rematGap}, lpips {first['card']['lpips']}")
    joinCpu()
    gaps = {key: relativeGap(first["card"][key], first["cpu"][key])
            for key in ("loss", "gradNorm", "lpips")}
    print(f"  first step card vs CPU: loss {gaps['loss']:.2e}, grad norm {gaps['gradNorm']:.2e} "
          f"relative (tolerance {TRAIN_CPU_RTOL:g}); LPIPS {gaps['lpips']:.2e} (tolerance "
          f"{LPIPS_CPU_RTOL:g}) ({smi})", flush=True)
    if (gaps["loss"] > TRAIN_CPU_RTOL or gaps["gradNorm"] > TRAIN_CPU_RTOL
            or gaps["lpips"] > LPIPS_CPU_RTOL):
        raise AssertionError(f"first step, card vs CPU: {gaps}")
    del grads, x

    # the run, through Trainer.train, instrumented
    stepS, losses, skipped, lpipsValues, valInfo = [], [], [], [], {}
    gen = torch.Generator(device=device).manual_seed(5)
    trainStep, reassign, validate = trainer.trainStep, trainer.reassignCodebooks, trainer.validate

    def timedStep(b):
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = trainStep(b)
        torch.cuda.synchronize()
        stepS.append(time.perf_counter() - start)
        if len(stepS) == 1:                   # the peak after cuDNN's autotuning
            torch.cuda.reset_peak_memory_stats()
        losses.append(float(metrics["loss"]))
        lpipsValues.append(float(metrics["lpips"]))
        skipped.append(float(metrics["skipped"]))
        return metrics

    def sharedCodebookMatchesPlain(label):
        codebook = model._quantizer.codebook.detach()
        tokens = torch.randn((1, 65536, codebook.shape[-1]), device=device, generator=gen)
        with exactFp32(), torch.no_grad():
            if not torch.equal(vqNearest(tokens, codebook), vqEncodePlain(tokens, codebook)):
                raise AssertionError(f"K1 differs from the plain version {label}")
        print(f"  K1 codes equal the plain version's on the live shared codebook {label}", flush=True)

    def checkedReassign():
        prop = reassign()
        print(f"  step {trainer.step}: CodebookReassign moved {prop:.4f} of the codewords", flush=True)
        sharedCodebookMatchesPlain(f"after the reassign at step {trainer.step}")
        return prop

    def countedValidate(valLoader):
        searches = []
        original = quantizerModule.vqEncode

        def capture(x, codebook):
            searches.append((latentTokens(x), codebook.detach().float().contiguous()))
            return original(x, codebook)

        quantizerModule.vqEncode = capture
        vqNearest.launches = 0
        try:
            results = validate(valLoader)
        finally:
            quantizerModule.vqEncode = original
        valInfo.update(results=results, K1=vqNearest.launches / results["images"],
                       training=model.training)
        with exactFp32(), torch.no_grad():
            for level, (tokens, codebook) in enumerate(searches):
                if not torch.equal(vqNearest(tokens, codebook), vqEncodePlain(tokens, codebook)):
                    raise AssertionError(f"K1 differs from the plain version on the validation's "
                                         f"level-{level} latents at step {trainer.step}")
        print(f"  validation at step {trainer.step}: {results}; K1 {valInfo['K1']:g} launches per "
              f"image; K1 codes equal the plain version's on its {len(searches)} searches after "
              f"{trainer.step} optimizer steps and the reassign", flush=True)
        return results

    trainer.trainStep, trainer.reassignCodebooks, trainer.validate = (timedStep, checkedReassign,
                                                                      countedValidate)
    recorder = RecordingLogger()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    trainer.train(getTrainLoader(pngs, bs, cropSize=trainer.inputSize),
                  valLoader=getValLoader(val), onStep=recorder.log, metricsLogger=recorder)
    runS = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(stepS[1:])
    checkpoint = tmp / "neon" / "latest" / "saved.ckpt.npz"
    export = exportModel(tmp / "neon_export.npz", trainer.variables(), config.serialize(), qp="train")
    print(f"  {len(stepS)} steps in {runS:.1f} s with saves and validation; step median "
          f"{steady * 1e3:.1f} ms (first {stepS[0] * 1e3:.1f} ms): {1 / steady:.3f} steps/s, "
          f"{bs / steady:.2f} images/s; peak memory after the first step {peak:.2f} GiB ({smi})",
          flush=True)
    print(f"  losses: first {losses[0]:.6f}, last {losses[-1]:.6f}, lpips first "
          f"{lpipsValues[0]:.6f}, last {lpipsValues[-1]:.6f}; all finite "
          f"{all(np.isfinite(losses))}, skipped {int(sum(skipped))}; checkpoint "
          f"{checkpoint.exists()}, export {export.name}", flush=True)
    if len(stepS) != NEON_TRAIN_STEPS or not all(np.isfinite(losses)) or any(skipped):
        raise AssertionError("a Neon training step was skipped or not finite")
    if not valInfo or valInfo["K1"] != len(NEON_V2_60K["size"]) or not valInfo["training"]:
        raise AssertionError(f"the validation inside the Neon trainer: {valInfo}")
    checkValLogging(np, recorder, model, NEON_TRAIN_STEPS, 1, "Neon")
    if not (checkpoint.exists() and export.exists()):
        raise AssertionError("the Neon checkpoint or export is missing")
    wall, busy, idle = report(f"  Neon training step (batch {bs}, input {trainer.inputSize})",
                              lambda: trainStep(batch), 3, 8)

    # a reassign that moves codewords: in a run this short no frequency falls
    # under the threshold (ema 0.998), so a quarter of the live frequencies is
    # zeroed and K1 is held to its plain version on the rewritten codebook
    with torch.no_grad():
        for freq in model._quantizer.frequencies():
            freq[:, ::4] = 0.0
    moved = checkedReassign()
    if not moved > 0:
        raise AssertionError(f"the forced reassign moved {moved} of the codewords")

    # the proxy in the lpips slot
    os.environ.pop("MCQUIC_VGG16_WEIGHTS")
    os.environ["MCQUIC_LPIPS_PROXY"] = "1"
    proxyData = dict(data, train=dict(data["train"], saveDir=str(tmp / "neon_proxy")))
    proxy = Trainer(Config.deserialize(proxyData), device="cuda")
    try:
        values = [float(proxy.trainStep(batch)["lpips"]) for _ in range(PROXY_STEPS)]
    finally:
        proxy.close()
        os.environ.pop("MCQUIC_LPIPS_PROXY")
    print(f"  {PROXY_STEPS} steps under MCQUIC_LPIPS_PROXY=1: proxy lpips "
          + ", ".join(f"{v:.6f}" for v in values), flush=True)
    if not all(np.isfinite(values)) or not all(v > 0 for v in values):
        raise AssertionError(f"the LPIPS proxy gave {values}")
    del proxy, trainer, model
    torch.cuda.empty_cache()
    return {"K1": valInfo["K1"], "steps_per_s": 1 / steady, "images_per_s": bs / steady,
            "idle_share": idle, "busy_ms": busy, "wall_ms": wall, "peak_gib": peak,
            "checkpoint": checkpoint}


def train11(torch, np, tmp: Path, img, smi: str, neonCheckpoint: Path, lengths,
            stopAtExit) -> dict:
    """Phase 11: the generator of configs/rd5/gen_stage2_neonA.yaml trained
    over phase 10's tokenizer: GEN_TRAIN_STEPS steps through the CLI in a
    subprocess (`stopAtExit` stops it should the phase fail), beside the
    in-process build and the CPU's first step; then the card's first step
    against the CPU's and the instrumented steps in process, then sampling
    from the CLI's checkpoint through K3."""
    import mcquic_tpu_torch.models.generator as generatorModule
    import mcquic_tpu_torch.models.quantizer as quantizerModule
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
    from mcquic_tpu_torch.data.imagenet_classes import getGenLoader
    from mcquic_tpu_torch.data.transforms import modelOutputToImage
    from mcquic_tpu_torch.generate import loadGenerator
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    from mcquic_tpu_torch.ops.attention import flashAttentionPlain
    from mcquic_tpu_torch.ops.attention_cuda import flashAttention
    from mcquic_tpu_torch.ops.vq import latentTokens, vqEncodePlain
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    from mcquic_tpu_torch.train.genTrainer import GenTrainer, makeGenTrainStep
    from mcquic_tpu_torch.train.optim import Optimizer
    from mcquic_tpu_torch.utils import exactFp32
    from mcquic_tpu_torch.utils.convert import readExport
    from mcquic_tpu_torch.utils.profiling import report

    class Keep(Optimizer):
        def step(self, grads):
            self.kept = [g.detach().cpu() for g in grads]

    device = torch.device("cuda")
    classes = tmp / "classes"
    for j, wnid in enumerate(GEN_WNIDS):
        cropFolder(classes / wnid, img, 8, size=300, seed=j + 1, jpeg=True)
    # a CMYK .JPEG and a WebP among the class folders' files
    (classes / GEN_WNIDS[0] / f"{GEN_WNIDS[0]}_cmyk.JPEG").write_bytes(PHOTO_CMYK.read_bytes())
    (classes / GEN_WNIDS[1] / f"{GEN_WNIDS[1]}_photo.webp").write_bytes(PHOTO_WEBP.read_bytes())
    data = Config.load(str(GEN_NEON_A_CONFIG)).serialize()
    data["model"]["params"]["loadFrom"] = str(neonCheckpoint)
    data["train"].update(totalStep=GEN_TRAIN_STEPS, trainSet=str(classes), valSet=str(classes),
                         saveDir=str(tmp / "gen"))
    levels = len(lengths)

    # GEN_TRAIN_STEPS steps through the train module's entry, with a plugin file whose
    # hook counts the steps it sees: started now, beside the in-process build and the
    # CPU's first step, and joined before the card's steps in process
    plugin, seen = tmp / "smoke_plugin.py", tmp / "plugin_steps.txt"
    plugin.write_text(COUNTING_PLUGIN)
    config = writeConfig(tmp / "gen_stage2_neonA.yaml", dict(data, train=dict(
        data["train"], externalLib=[str(plugin)],
        hooks=[{"key": "SmokeCountSteps", "params": {"path": str(seen)}}])))
    cliStart = time.perf_counter()
    cli = subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch.train", str(config), "-G"],
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    stopAtExit.callback(stopProcess, cli)          # should the phase fail before its join
    inProcess = dict(data, train=dict(data["train"], totalStep=GEN_TIMED_STEPS,
                                      saveDir=str(tmp / "gen_in_process")))
    trainer = GenTrainer(Config.deserialize(inProcess), device="cuda")
    model = trainer.model
    bs = data["train"]["batchSize"]
    depth = model.depth
    frozen = {k: v.detach().clone() for k, v in model.compressor.state_dict().items()}
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"  configs/rd5/gen_stage2_neonA.yaml: {data['model']['params']}, batch {bs}, "
          f"{data['train']['optim']}, {data['train']['schdr']['key']}; {trainable / 1e6:.2f} M "
          f"trainable parameters, the tokenizer frozen ({sum(v.numel() for v in frozen.values()) / 1e6:.2f} M, "
          f"from phase 10's checkpoint); class folders {GEN_WNIDS} of .JPEG crops with a CMYK "
          f".JPEG and a .webp", flush=True)
    if abs(trainer._baseLr - 1e-4 / 2 ** 1.5) > 1e-12:
        raise AssertionError(f"lr {trainer._baseLr} is not the recipe's 1e-4 under the world rule")

    # the first step: card against the CPU, same weights and batch
    images, labels = next(iter(getGenLoader(classes, bs, cropSize=256)()))
    x = trainingTransform(torch.from_numpy(images), augmentDraws(torch.Generator().manual_seed(0), bs),
                          gen=True)
    y = torch.from_numpy(labels.astype(np.int64))
    first = {}

    def firstStep(dev):
        copy = GeneratorV3SelfAttention(**{k: v for k, v in data["model"]["params"].items()
                                           if k != "loadFrom"})
        copy.load_state_dict(model.state_dict())
        copy = copy.to(dev).train()
        copy.compressor.requires_grad_(False)
        keep = Keep([p for p in copy.parameters() if p.requires_grad], trainer._schedule)
        start = time.perf_counter()
        with exactFp32():
            metrics = makeGenTrainStep(copy, keep)(x.to(dev), y.to(dev))
        first[dev.type] = {k: float(v) for k, v in metrics.items()}
        print(f"  first step on the {dev.type}: loss {first[dev.type]['loss']:.8f}, grad norm "
              f"{first[dev.type]['gradNorm']:.8f}, CE by level "
              + ", ".join(f"{first[dev.type][f'ceLv{i:02d}']:.5f}" for i in range(levels))
              + f", {time.perf_counter() - start:.1f} s", flush=True)
        del copy, keep

    firstStep(torch.device("cpu"))
    cliOut, cliErr = cli.communicate(timeout=CLI_TIMEOUT)
    cliS = time.perf_counter() - cliStart
    if cli.returncode != 0:
        raise RuntimeError(f"train -G exited {cli.returncode}:\n{cliErr[-4000:]}")
    firstStep(device)
    gaps = {key: relativeGap(first["cuda"][key], first["cpu"][key]) for key in first["cpu"]
            if key != "skipped"}
    print(f"  first step card vs CPU: largest relative gap {max(gaps.values()):.2e} "
          f"({max(gaps, key=gaps.get)}; tolerance {TRAIN_CPU_RTOL:g})", flush=True)
    if max(gaps.values()) > TRAIN_CPU_RTOL:
        raise AssertionError(f"first generator step, card vs CPU: {gaps}")
    torch.cuda.empty_cache()

    # the steps in process, through GenTrainer.train, counted step by step
    stepS, perStep, searches = [], [], []
    trainStep = trainer.trainStep
    original = quantizerModule.vqEncode

    def capture(x, codebook):
        searches.append((latentTokens(x), codebook.detach().float().contiguous()))
        return original(x, codebook)

    def countedStep(imgs, lbls):
        if not perStep:
            quantizerModule.vqEncode = capture
        vqNearest.launches = flashAttention.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            metrics = trainStep(imgs, lbls)
            torch.cuda.synchronize()
        finally:
            quantizerModule.vqEncode = original
        stepS.append(time.perf_counter() - start)
        if len(stepS) == 1:                   # the peak after cuDNN's autotuning
            torch.cuda.reset_peak_memory_stats()
        perStep.append((vqNearest.launches, flashAttention.launches, float(metrics["loss"]),
                        float(metrics["skipped"])))
        return metrics

    trainer.trainStep = countedStep
    torch.cuda.reset_peak_memory_stats()
    trainer.train(getGenLoader(classes, bs, cropSize=256))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(stepS[1:])
    k1Steps = sorted({s[0] for s in perStep})
    k3Steps = sorted({s[1] for s in perStep})
    with exactFp32(), torch.no_grad():
        for level, (tokens, codebook) in enumerate(searches):
            if not torch.equal(vqNearest(tokens, codebook), vqEncodePlain(tokens, codebook)):
                raise AssertionError(f"K1 differs from the plain version on the frozen encode's "
                                     f"level-{level} latents")
    same = all(torch.equal(v, frozen[k]) for k, v in model.compressor.state_dict().items())
    print(f"  {len(stepS)} steps in process: K1 launches per step {k1Steps}, K3 launches per "
          f"step {k3Steps}; K1 codes equal the plain version's on the first step's "
          f"{len(searches)} searches; losses {perStep[0][2]:.5f} -> {perStep[-1][2]:.5f}, skipped "
          f"{int(sum(s[3] for s in perStep))}; the tokenizer bit-identical {same}; step median "
          f"{steady * 1e3:.1f} ms (first {stepS[0] * 1e3:.1f} ms): {1 / steady:.3f} steps/s, "
          f"{bs / steady:.2f} images/s; peak memory after the first step {peak:.2f} GiB ({smi})",
          flush=True)
    if (k1Steps != [levels] or k3Steps != [0] or len(searches) != levels or not same
            or any(s[3] for s in perStep) or not all(np.isfinite([s[2] for s in perStep]))):
        raise AssertionError(f"the in-process generator steps: {perStep}")
    wall, busy, idle = report(f"  generator training step (batch {bs})",
                              lambda: trainStep(images, labels), 3, 8)
    del trainer, model, trainStep
    torch.cuda.empty_cache()

    # the CLI's run, joined above
    hookSteps = [int(line) for line in seen.read_text().split()] if seen.exists() else []
    checkpoint = Path(cliOut.strip().splitlines()[-1])
    flat, _ = readExport(checkpoint)
    neon, _ = readExport(neonCheckpoint)
    tokenizerSame = all(np.array_equal(flat[k.replace("/", "/compressor/", 1)], v)
                        for k, v in neon.items() if k.startswith(("params/", "coder/")))
    print(f"  python -m mcquic_tpu_torch.train CONFIG -G: {int(flat['step'])} steps in "
          f"{cliS:.1f} s (process included, beside the in-process build and the CPU's first "
          f"step), checkpoint {checkpoint.name}; "
          f"its tokenizer bit-identical to phase 10's checkpoint: {tokenizerSame}; the plugin's "
          f"hook (externalLib) saw steps {hookSteps}", flush=True)
    if (int(flat["step"]) != GEN_TRAIN_STEPS or not tokenizerSame
            or hookSteps != list(range(1, GEN_TRAIN_STEPS + 1))):
        raise AssertionError("the CLI's generator training did not run as it should")

    # sampling from the trained checkpoint: K3 on every call, held to its plain version
    sampler = loadGenerator(checkpoint, device="cuda")
    condition = torch.tensor(GEN_SAMPLE_CLASSES, device=device)
    calls = []
    originalAttention = generatorModule.flashAttention

    def captureAttention(q, k, v, mask=None, scale=None):
        calls.append((q.clone(), k.clone(), v.clone(), mask, scale))
        return originalAttention(q, k, v, mask, scale)

    generatorModule.flashAttention = captureAttention
    try:
        with exactFp32(), torch.inference_mode():
            sampler.generate(condition)
    finally:
        generatorModule.flashAttention = originalAttention
    with torch.inference_mode():
        worst = max(k3Check(torch, flashAttention, flashAttentionPlain, *call) for call in calls)
    with exactFp32(), torch.inference_mode():
        flashAttention.launches = 0
        _, restored = sampler.generate(condition)
        k3Launches = flashAttention.launches
        pictures = modelOutputToImage(restored.permute(0, 2, 3, 1).cpu().numpy())
    out = tmp / "generated"
    proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", "generate", "-c",
                           ",".join(map(str, GEN_SAMPLE_CLASSES)), str(checkpoint), str(out)],
                          cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"generate exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    written = sorted(out.glob("*.png"))
    print(f"  generate from the trained checkpoint, classes {GEN_SAMPLE_CLASSES}: K3 launches "
          f"{k3Launches}, K3 within {worst:.2e} of its plain version on all {len(calls)} calls' "
          f"q/k/v, images {pictures.shape}; the generate CLI wrote {[p.name for p in written]}",
          flush=True)
    if (k3Launches != depth * levels or len(calls) != depth * levels or len(written) != 2
            or pictures.shape != (len(GEN_SAMPLE_CLASSES), 256, 256, 3)):
        raise AssertionError("sampling from the trained generator did not run as it should")
    del sampler
    torch.cuda.empty_cache()
    return {"K1": k1Steps[0], "K3_in_step": k3Steps[0], "K3_after": k3Launches, "err": worst,
            "steps_per_s": 1 / steady, "images_per_s": bs / steady, "idle_share": idle,
            "busy_ms": busy, "wall_ms": wall, "peak_gib": peak}


def paramChecksum(torch, tensors) -> int:
    """The sum of every float's bits read as int32: any changed bit in any
    tensor changes it (bar compensating changes)."""
    return int(sum(int(t.detach().float().contiguous().view(torch.int32).long().sum())
                   for t in tensors))


def ddpCase(torch, np, case: str, config: Path, device: str = "cuda") -> dict:
    """One rank's run of a phase-12 case (or the one-process reference
    outside a process group): DDP_STEPS steps through the trainer on this
    rank's rows of the same DDP_GLOBAL_BATCH images per step; per step the
    metrics, the parameters' checksum, the seconds and the K1 launches;
    rank 0's validation's K1 and K2 launches per image (rd_qp2). Under
    MCQUIC_CKPT_BACKEND=orbax the run saves DCP steps, and rank 0 writes the
    gathered checkpoint of the end state (the npz route) beside them."""
    from mcquic_tpu_torch import parallel
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelThin
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    cfg = Config.load(str(config))
    rank, world = parallel.rank(), parallel.world()
    n = DDP_GLOBAL_BATCH // world
    rows = slice(rank * n, (rank + 1) * n)
    trainSet = cfg.Train.TrainSet
    if case == "gen":
        from mcquic_tpu_torch.data.imagenet_classes import getGenLoader
        from mcquic_tpu_torch.train.genTrainer import GenTrainer
        trainer = GenTrainer(cfg, device=device)
        loaderFn = getGenLoader(trainSet, DDP_GLOBAL_BATCH, cropSize=256)
        tensors = [p for p in trainer.model.parameters() if p.requires_grad]
    else:
        from mcquic_tpu_torch.data import getTrainLoader
        from mcquic_tpu_torch.train.trainer import Trainer
        trainer = Trainer(cfg, device=device)
        loaderFn = getTrainLoader(trainSet, DDP_GLOBAL_BATCH, cropSize=trainer.inputSize)
        tensors = list(trainer.model.state_dict().values())
    batches = []
    while len(batches) < DDP_STEPS:                    # the whole set on every rank, by epochs
        epoch = list(loaderFn())
        if not epoch:
            raise AssertionError(f"{trainSet} holds no batch of {DDP_GLOBAL_BATCH}")
        batches += epoch
    batches = batches[:DDP_STEPS]
    optimizer = trainer.optimizer
    out = {"rank": rank, "world": world, "metrics": [], "checksums": [], "seconds": [], "K1": [],
           "val": None, "state_bytes": optimizer.stateBytes(),
           "sharded_bytes": sum(t.numel() * t.element_size() for ts in optimizer.state.values()
                                for t, axis in zip(ts, optimizer.axes) if axis is not None),
           "k1_after_zero_steps": 0}
    trainStep = trainer.trainStep
    # K1 keeps each codebook's norms by tensor and version: warmed before a
    # sharded step, it must see the step's writes (this rank's slice, then
    # the all-gathered slices) on the stage-1 codebooks
    checkK1 = case != "gen" and world > 1
    k1Gen = torch.Generator(device=trainer.model._quantizer.codebook(0).device) if checkK1 else None

    def step(*args):
        if checkK1:
            k1MatchesPlain(torch, trainer.model, k1Gen.manual_seed(len(out["seconds"])),
                           f"rank {rank} before step {len(out['seconds']) + 1}")
        vqNearest.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = trainStep(*args)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - start)
        if len(out["seconds"]) == 1:              # the peak after cuDNN's autotuning
            torch.cuda.reset_peak_memory_stats()
        out["K1"].append(vqNearest.launches)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["checksums"].append(paramChecksum(torch, tensors))
        if checkK1:
            k1MatchesPlain(torch, trainer.model, k1Gen.manual_seed(len(out["seconds"])),
                           f"rank {rank} after ZeRO step {len(out['seconds'])}")
            out["k1_after_zero_steps"] += 1
        return metrics

    trainer.trainStep = step
    if case == "gen":
        trainer.train(lambda: iter([(b[0][rows], b[1][rows]) for b in batches]))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    else:
        from mcquic_tpu_torch.data import getValLoader
        validate = trainer.validate

        def countedValidate(loader):
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30    # the steps'
            vqNearest.launches = conv3x3SubpixelThin.launches = 0
            results = validate(loader)
            out["val"] = {"K1": vqNearest.launches / results["images"],
                          "K2": conv3x3SubpixelThin.launches / results["images"]}
            return results

        trainer.validate = countedValidate
        trainer.train(lambda: iter([b[rows] for b in batches]),
                      valLoader=getValLoader(cfg.Train.ValSet))
        out.setdefault("peak_gib", torch.cuda.max_memory_allocated() / 2 ** 30)
        if trainer._dcp is not None:           # MCQUIC_CKPT_BACKEND=orbax: the npz route beside
            out["dcp_steps"] = trainer._dcp.steps()
            flat = trainer.checkpoint()
            if flat is not None:
                np.savez(Path(cfg.Train.SaveDir) / "npz_route.npz", **flat)
    del trainer
    torch.cuda.empty_cache()
    return out


def ddpWorker(argv) -> int:
    """`chip_smoke.py --ddp-worker CASE BACKEND RANK WORLD PORT OUT [CONFIG]`:
    one rank of phase 12 or of `--multi-card`, started by it. CASE rd_qp2 or
    gen: `ddpCase` over BACKEND (gloo between ranks that share one card,
    NCCL with a card each), its result as JSON in OUT. CASE dcp_resume:
    `dcpResume` of CONFIG's DCP steps at WORLD, the npz route's checkpoint
    beside OUT. CASE var: `varCase`,
    the train CLI's `main` joining the group itself (NCCL). CASE nccl: NCCL
    at world WORLD, one all-reduce; what happened, verbatim, in OUT."""
    import os
    case, backend, rank, world, port, out = argv[:6]
    os.environ.update(MCQUIC_COORDINATOR=f"localhost:{port}", MCQUIC_NUM_PROCESSES=world,
                      MCQUIC_PROCESS_ID=rank)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from mcquic_tpu_torch import parallel
    if case == "nccl":
        try:
            parallel.initDistributed("cuda")
            value = torch.full((4,), float(rank) + 1, device="cuda")
            parallel.allReduceSum_([value])
            torch.cuda.synchronize()
            result = {"ok": True, "sum": value.tolist()}
        except Exception as err:                  # the outcome is the measurement
            result = {"ok": False, "error": f"{type(err).__name__}: {err}"}
        finally:
            parallel.destroy()
        Path(out).write_text(json.dumps(result))
        return 0
    if case == "var":
        result = varCase(torch, Path(argv[6]))
    elif case == "dcp_resume":
        parallel.initDistributed("cuda", backend=backend)
        try:
            result = dcpResume(torch, np, Path(argv[6]), Path(out).with_suffix(".npz"))
        finally:
            parallel.destroy()
    else:
        parallel.initDistributed("cuda", backend=backend)
        try:
            result = ddpCase(torch, np, case, Path(argv[6]))
        finally:
            parallel.destroy()
    Path(out).write_text(json.dumps(result))
    return 0


def startRanks(case: str, world: int, tmp: Path, config=None, backend: str = "gloo",
               env: dict = None) -> list:
    """`world` ranks of `case`, each with its share of the host's cores for
    torch's threads (the VAR ranks draw a billion parameters on the host),
    and `env` added to their environment."""
    import os
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS=str(max((os.cpu_count() or world) // world, 1)),
               **(env or {}))
    return [(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker", case,
                               backend, str(r), str(world), str(port),
                               str(tmp / f"{case}_rank{r}.json")]
                              + ([str(config)] if config else []),
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True),
             tmp / f"{case}_rank{r}.json") for r in range(world)]


def joinRanks(ranks, timeout: float) -> list:
    """Each rank's JSON; a rank that fails or outlives `timeout` fails the
    phase (all are killed first)."""
    deadline = time.perf_counter() + timeout
    errors = []
    for proc, _ in ranks:
        try:
            _, err = proc.communicate(timeout=max(deadline - time.perf_counter(), 1))
            if proc.returncode != 0:
                errors.append(f"exit {proc.returncode}: {err[-3000:]}")
        except subprocess.TimeoutExpired:
            errors.append("timed out")
    for proc, _ in ranks:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if errors:
        raise RuntimeError(f"phase-12 ranks failed: {errors}")
    return [json.loads(path.read_text()) for _, path in ranks]


def ddpConfigs(tmp: Path, case: str, base: dict, world: int, trainSet, val: Path) -> dict:
    """The configs of a data-parallel case, {1: one process at
    DDP_GLOBAL_BATCH, world: batch DDP_GLOBAL_BATCH / world per rank}: rd_qp2
    validates at its last step and saves every step at world > 1, the
    generator neither."""
    extra = {"valFreq": DDP_STEPS, "valSet": str(val)} if case == "rd_qp2" else {"valFreq": 1000}
    configs = {}
    for w in (1, world):
        train = dict(base["train"], totalStep=DDP_STEPS, batchSize=DDP_GLOBAL_BATCH // w,
                     trainSet=str(trainSet), hooks=[],
                     saveDir=str(tmp / f"ddp_{case}") if w > 1 and case == "rd_qp2" else "",
                     **extra)
        configs[w] = writeConfig(tmp / f"ddp_{case}_{w}.yaml", dict(base, train=train))
    return configs


def ddpCompare(torch, np, tmp: Path, smi: str, case: str, configs: dict, backend: str,
               how: str, note: str, env: dict = None) -> dict:
    """The ranks of `configs` (its larger world, over `backend`) against one
    process at the global batch, DDP_STEPS steps each. Gates: the first
    step's loss and gradient norm within TRAIN_CPU_RTOL, the ranks'
    parameter checksums equal after every step, no step skipped, the
    optimizer state sharded (each rank holds 1/world of the sharded
    parameters' slots, the rest whole), K1 on the stage-1 codebooks equal to
    its plain version after every sharded step, rank 0's validation K1 3 and
    K2 1 per image and none elsewhere (rd_qp2), K1 per level in every
    generator step."""
    world = max(configs)
    start = time.perf_counter()
    started = startRanks(case, world, tmp, configs[world], backend, env)
    try:
        one = ddpCase(torch, np, case, configs[1])   # the reference, while the ranks run
    finally:
        ranks = joinRanks(started, DDP_TIMEOUT)
    ranksS = time.perf_counter() - start
    first = ranks[0]["metrics"][0]
    for r in ranks:
        print(f"  {case} rank {r['rank']}: step seconds {[round(t, 3) for t in r['seconds']]}, "
              f"parameter checksums {r['checksums']}", flush=True)
    gaps = {key: relativeGap(first[key], one["metrics"][0][key]) for key in ("loss", "gradNorm")}
    sameRanks = all(r["checksums"] == ranks[0]["checksums"] for r in ranks)
    steady = [statistics.median(r["seconds"][1:]) for r in ranks]
    sharded = ranks[0]["sharded_bytes"]
    bytesOk = sharded > 0 and all(r["sharded_bytes"] == sharded and r["state_bytes"]
                                  == one["state_bytes"] - sharded * (world - 1) for r in ranks)
    print(f"  {case}, {world} ranks x batch {DDP_GLOBAL_BATCH // world} {how} ({ranksS:.1f} s, "
          f"processes and the one-process reference beside them included) against 1 process x "
          f"batch {DDP_GLOBAL_BATCH}: first step loss "
          f"{first['loss']:.8f} against {one['metrics'][0]['loss']:.8f}, grad norm "
          f"{first['gradNorm']:.8f} against {one['metrics'][0]['gradNorm']:.8f} (gaps "
          f"{gaps['loss']:.2e}, {gaps['gradNorm']:.2e}; tolerance {TRAIN_CPU_RTOL:g}); the ranks' "
          f"parameter checksums equal after every step: {sameRanks}; optimizer state per rank "
          f"{[r['state_bytes'] for r in ranks]} bytes against one process's "
          f"{one['state_bytes']} (the sharded parameters' slots {sharded * world} bytes, "
          f"{sharded} per rank); K1 equal to its plain version after "
          f"{[r['k1_after_zero_steps'] for r in ranks]} sharded steps; K1 per step "
          f"{[r['K1'] for r in ranks]}, rank 0's validation {ranks[0]['val']}, the others' "
          f"{[r['val'] for r in ranks[1:]]}; per rank {[f'{1 / t:.3f}' for t in steady]} "
          f"steps/s, peak of the steps {[round(r['peak_gib'], 2) for r in ranks]} GiB; one "
          f"process {1 / statistics.median(one['seconds'][1:]):.3f} steps/s, peak "
          f"{one['peak_gib']:.2f} GiB. {note} ({smi})", flush=True)
    if max(gaps.values()) > TRAIN_CPU_RTOL or not sameRanks or any(
            m["skipped"] for r in ranks for m in r["metrics"]):
        raise AssertionError(f"{case} at world {world}: {gaps}, ranks equal {sameRanks}")
    if not bytesOk:
        raise AssertionError(f"{case} at world {world}: the optimizer state is not sharded: "
                             f"{[(r['state_bytes'], r['sharded_bytes']) for r in ranks]} against "
                             f"{one['state_bytes']}")
    if case == "rd_qp2" and (ranks[0]["val"] != {"K1": 3, "K2": 1}
                             or any(r["val"] for r in ranks[1:])
                             or any(r["k1_after_zero_steps"] != DDP_STEPS for r in ranks)):
        raise AssertionError(f"the validation ran off rank 0 or missed its kernels, or K1 was "
                             f"not checked after every sharded step: "
                             f"{[(r['val'], r['k1_after_zero_steps']) for r in ranks]}")
    if case == "gen" and any(k != len(NEON_V2_60K["size"]) for r in ranks for k in r["K1"]):
        raise AssertionError(f"a rank's generator step did not launch K1 per level: "
                             f"{[r['K1'] for r in ranks]}")
    return {"ranks_steps_per_s": [1 / t for t in steady],
            "ranks_peak_gib": [r["peak_gib"] for r in ranks], "gaps": gaps,
            "checksums_equal": sameRanks, "K1": ranks[0]["K1"], "val": ranks[0]["val"],
            "state_bytes": [r["state_bytes"] for r in ranks], "one_state_bytes": one["state_bytes"],
            "one_steps_per_s": 1 / statistics.median(one["seconds"][1:]),
            "dcp_steps": ranks[0].get("dcp_steps")}


def dcpAcrossWorlds(torch, np, tmp: Path, smi: str, config: Path, saved: int, worlds) -> dict:
    """The rd_qp2 ranks' DCP steps (MCQUIC_CKPT_BACKEND=orbax, saved at world
    `saved` by `ddpCompare`) resumed at each world of `worlds`: at 1 in this
    process, above 1 as NCCL ranks with a card each (`dcpResume`). Gates:
    the resumed step is the run's last, and the resumed state through the
    npz route is bit-identical to the ranks' own npz route of their end
    state."""
    from mcquic_tpu_torch.config import Config
    saveDir = Path(Config.load(str(config)).Train.SaveDir)
    results = {}
    for world in worlds:
        start = time.perf_counter()
        out = tmp / f"dcp_resume_{world}.npz"
        if world == 1:
            result = dcpResume(torch, np, config, out)
        else:
            result = joinRanks(startRanks("dcp_resume", world, tmp, config, "nccl"),
                               DDP_TIMEOUT)[0]
            out = tmp / "dcp_resume_rank0.npz"
        differ = checkpointsDiffer(np, out, saveDir / "npz_route.npz")
        print(f"  DCP steps {result['steps']} saved by {saved} ranks (MCQUIC_CKPT_BACKEND=orbax, "
              f"{sum(f.stat().st_size for f in (saveDir / 'dcp').rglob('*') if f.is_file()) / 1e6:.1f} "
              f"MB on disk) resumed at world {world} at step {result['step']} in "
              f"{result['resume_s']:.2f} s ({time.perf_counter() - start:.1f} s with the processes): "
              f"the state through the npz route differs from the ranks' npz route in "
              f"{len(differ)} arrays {differ[:5]} ({smi})", flush=True)
        if differ or result["step"] != DDP_STEPS:
            raise AssertionError(f"the DCP resume at world {world} differs: {differ}")
        results[world] = result
    return results


def ddp12(torch, np, tmp: Path, smi: str, shards: str, val: Path, classes: Path,
          neonCheckpoint: Path) -> dict:
    """Phase 12: data parallelism on the one card. (a) the train CLI's
    `main` on rd_qp2 at world 1 under the three variables (NCCL) against
    the same run without them, in one process so that cuDNN's algorithm
    choices are the same; (b) two ranks sharing the card over gloo against
    one process at the global batch, rd_qp2 and gen_stage2_neonA at full
    width, the rd_qp2 ranks saving DCP steps (MCQUIC_CKPT_BACKEND=orbax)
    that this process resumes at world 1 (`dcpAcrossWorlds`); (c) NCCL at
    world 2 on the one card, beside (b)."""
    import logging
    import os
    import socket
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.train import cli as trainCli
    from mcquic_tpu_torch.utils.convert import readExport

    # (a) world 1 under NCCL against no variables, the same config
    data = Config.load(str(RD_QP2)).serialize()
    data["train"].update(totalStep=DDP_CLI_STEPS, valFreq=DDP_CLI_STEPS, trainSet=shards,
                         valSet=str(tmp / "no_validation"), hooks=[])
    joined = []

    class Joined(logging.Handler):
        def emit(self, record):
            joined.append(record.getMessage())

    handler = Joined()
    parallelLog = logging.getLogger("mcquic_tpu_torch.parallel")
    parallelLog.addHandler(handler)
    parallelLog.setLevel(logging.INFO)
    checkpoints, seconds = {}, {}
    try:
        for name in ("plain", "nccl"):
            config = writeConfig(tmp / f"rd_qp2_{name}.yaml",
                                 dict(data, train=dict(data["train"],
                                                       saveDir=str(tmp / f"cli_{name}"))))
            if name == "nccl":
                with socket.socket() as s:
                    s.bind(("localhost", 0))
                    port = s.getsockname()[1]
                os.environ.update(MCQUIC_COORDINATOR=f"localhost:{port}",
                                  MCQUIC_NUM_PROCESSES="1", MCQUIC_PROCESS_ID="0")
            start = time.perf_counter()
            try:
                trainCli.main(config, device="cuda")
            finally:
                for key in ("MCQUIC_COORDINATOR", "MCQUIC_NUM_PROCESSES", "MCQUIC_PROCESS_ID"):
                    os.environ.pop(key, None)
            seconds[name] = time.perf_counter() - start
            checkpoints[name], _ = readExport(tmp / f"cli_{name}" / "latest" / "saved.ckpt.npz")
    finally:
        parallelLog.removeHandler(handler)
    a, b = checkpoints["plain"], checkpoints["nccl"]
    differ = sorted(k for k in a if k not in b or not np.array_equal(a[k], b[k]))
    print(f"  (a) train CLI main on configs/rd3/rd_qp2.yaml, {DDP_CLI_STEPS} steps: without the "
          f"variables {seconds['plain']:.1f} s, under MCQUIC_COORDINATOR / MCQUIC_NUM_PROCESSES=1 "
          f"/ MCQUIC_PROCESS_ID=0 {seconds['nccl']:.1f} s; {joined}; NCCL "
          f"{torch.cuda.nccl.version()}; checkpoints at step {int(b['step'])}: {len(a)} arrays, "
          f"{len(differ)} differ {differ[:5]}", flush=True)
    if differ or set(a) != set(b) or int(b["step"]) != DDP_CLI_STEPS or not any(
            "over nccl" in m for m in joined):
        raise AssertionError("the NCCL world-1 run differs from the run without the variables")

    # (c) NCCL at world 2 on the one card, its outcome verbatim: started now, beside (b)
    ncclStart = time.perf_counter()
    ncclRanks = startRanks("nccl", 2, tmp, backend="nccl")

    # (b) two ranks on the one card over gloo against one process at batch 8
    results = {}
    gen = Config.load(str(GEN_NEON_A_CONFIG)).serialize()
    gen["model"]["params"]["loadFrom"] = str(neonCheckpoint)
    try:
        for case, base in (("rd_qp2", data), ("gen", gen)):
            configs = ddpConfigs(tmp, case, base, 2, shards if case == "rd_qp2" else classes, val)
            results[case] = ddpCompare(torch, np, tmp, smi, case, configs, "gloo",
                                       "over gloo on the one card",
                                       "Two ranks sharing one card measure no scaling",
                                       {"MCQUIC_CKPT_BACKEND": "orbax"} if case == "rd_qp2"
                                       else None)
            if case == "rd_qp2":
                results["dcp"] = dcpAcrossWorlds(torch, np, tmp, smi, configs[2], 2, [1])
    except BaseException:
        for proc, _ in ncclRanks:
            stopProcess(proc)
        raise

    # (c), joined
    try:
        outcome = joinRanks(ncclRanks, NCCL_TIMEOUT)
    except RuntimeError as err:
        outcome = [str(err)]
    print(f"  (c) NCCL at world 2 on the one card ({time.perf_counter() - ncclStart:.1f} s, beside "
          f"(b)): {outcome}", flush=True)
    results["nccl_world2"] = outcome
    return results


def inceptionScore(torch, np, tmp: Path, restored, smi: str) -> dict:
    """The Inception Score of the generated images ([B, 3, H, W] in [-1, 1]
    on the card) through `validate/inception.py`'s handler on the card, with
    a seeded torchvision-layout InceptionV3 found through
    MCQUIC_INCEPTION_WEIGHTS; the classifier's ms at this batch (CUDA-event
    median of single calls) and its logits on the card against the CPU's on
    the same resized images (INCEPTION_CPU_RTOL of the largest)."""
    import os
    from mcquic_tpu_torch.data.transforms import modelOutputToImage
    from mcquic_tpu_torch.validate.inception import InceptionScoreHandler, resizeBilinear
    from mcquic_tpu_torch.validate.inception_v3 import (classifierOf, inceptionFromStateDict,
                                                       seededStateDict)
    images = modelOutputToImage(restored.permute(0, 2, 3, 1).float().cpu().numpy())
    path = tmp / "inception_v3.pth"
    torch.save(seededStateDict(), path)
    os.environ["MCQUIC_INCEPTION_WEIGHTS"] = str(path)
    try:
        handler = InceptionScoreHandler("cuda", splits=1)
    finally:
        del os.environ["MCQUIC_INCEPTION_WEIGHTS"]
    start = time.perf_counter()
    handler(restored=images)
    score = handler.result()
    handlerMs = (time.perf_counter() - start) * 1e3
    resized = resizeBilinear(torch.from_numpy(images).cuda())
    weights = torch.load(path, map_location="cpu")
    card = classifierOf(inceptionFromStateDict(weights, "cuda"))
    ms = medianMs(torch, lambda: card(resized))
    cardLogits = card(resized).cpu()
    cpuLogits = classifierOf(inceptionFromStateDict(weights, "cpu"))(resized.cpu())
    gap = float((cardLogits - cpuLogits).abs().max() / cpuLogits.abs().max())
    print(f"  Inception Score of the {len(images)} generated {images.shape[1]}x{images.shape[2]} "
          f"images (seeded InceptionV3, one split): {score:.6f}; the handler's first call "
          f"{handlerMs:.1f} ms (resize, cuDNN's autotuning); the classifier at batch "
          f"{len(images)}, 299x299: {ms:.3f} ms; logits on the card against the CPU's: max gap "
          f"{gap:.2e} of the largest (tolerance {INCEPTION_CPU_RTOL:g}) ({smi})", flush=True)
    if not (np.isfinite(score) and score >= 1.0 and gap <= INCEPTION_CPU_RTOL):
        raise AssertionError(f"the Inception Score on the card: {score}, logits gap {gap}")
    return {"score": score, "ms": ms, "logits_gap": gap}


def var13(torch, np, tmp: Path, smi: str, neonCheckpoint: Path, classes: Path, k3: dict) -> dict:
    """Phase 13: GeneratorVAR at the JAX package's defaults (depth 24, width
    1536, 16 heads) over the neonA tokenizer: in-process sampling from a
    seeded checkpoint held to K3's plain version on every call, the card
    against the CPU at depth 2 with the same Gumbel noise, K3 timed at the
    last level, the first training step against the CPU at depth 2, `train
    -G` on a VAR config through the CLI's `main`, and the generate CLI on
    its checkpoint."""
    import mcquic_tpu_torch.models.generator_var as varModule
    from torch.profiler import ProfilerActivity, profile
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
    from mcquic_tpu_torch.data.imagenet_classes import getGenLoader
    from mcquic_tpu_torch.generate import seededGeneratorState
    from mcquic_tpu_torch.models.generator_var import GeneratorVAR
    from mcquic_tpu_torch.ops.attention import flashAttentionPlain
    from mcquic_tpu_torch.ops.attention_cuda import flashAttention
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    from mcquic_tpu_torch.train import cli as trainCli
    from mcquic_tpu_torch.train.genTrainer import GenTrainer, makeGenTrainStep
    from mcquic_tpu_torch.train.optim import Optimizer
    from mcquic_tpu_torch.utils import exactFp32
    from mcquic_tpu_torch.utils.profiling import report

    device = torch.device("cuda")
    start = time.perf_counter()
    # seeded in memory: the checkpoint loader is held by the generate CLI on
    # the trained checkpoint at the end of the phase
    with torch.device("cuda"):
        model = GeneratorVAR(**VAR_D24)
    model.load_state_dict(seededGeneratorState(VAR_D24, seed=0, key="GeneratorVAR"))
    model = model.eval().requires_grad_(False)
    params = sum(p.numel() for n, p in model.named_parameters() if not n.startswith("compressor."))
    print(f"  seeded GeneratorVAR {VAR_D24}: {params / 1e9:.3f} B transformer parameters, "
          f"built on the card in {time.perf_counter() - start:.1f} s", flush=True)
    levels, depth = len(model.patchNums), model.depth
    condition = torch.tensor(GEN_CLASSES, device=device)
    noiseGen = torch.Generator().manual_seed(1)
    noise = [-torch.log(-torch.log(torch.rand((len(GEN_CLASSES), n, model.k), generator=noiseGen)
                                   .clamp_min(1e-30))) for n in model.lengths]

    def handed(dev):
        """The same Gumbel noise, level by level, on `dev`."""
        queue = iter(noise)
        return lambda shape: next(queue).to(dev)

    calls = []
    original = varModule.flashAttention

    def capture(q, k, v, mask=None, scale=None):
        calls.append((q.clone(), k.clone(), v.clone(), mask, scale))
        return original(q, k, v, mask, scale)

    varModule.flashAttention = capture
    try:
        with exactFp32(), torch.inference_mode():
            model.generate(condition, cfg=1.5, gumbel=handed(device))
    finally:
        varModule.flashAttention = original
    with torch.inference_mode():
        worst = max(k3Check(torch, flashAttention, flashAttentionPlain, *call) for call in calls)
    k3["err"] = max(k3["err"], worst)
    timesMs = []
    for _ in range(3):
        with exactFp32(), torch.inference_mode():
            flashAttention.launches = 0
            torch.cuda.synchronize()
            begin = time.perf_counter()
            _, restored = model.generate(condition, cfg=1.5, gumbel=handed(device))
            torch.cuda.synchronize()
            timesMs.append((time.perf_counter() - begin) * 1e3)
            launches = flashAttention.launches
    finite = bool(torch.isfinite(restored).all())
    with exactFp32(), torch.inference_mode():
        _, genBusy, genIdle = report(f"  VAR generate, {len(GEN_CLASSES)} classes, cfg 1.5",
                                     lambda: model.generate(condition, cfg=1.5,
                                                            gumbel=handed(device)), 3, 6)
    print(f"  VAR-d24 generate, classes {GEN_CLASSES}, cfg 1.5: "
          f"{statistics.median(timesMs):.1f} ms (host clock, median of 3, Neon decode included), "
          f"K3 launches {launches}, K3 within {worst:.2e} of its plain version on all "
          f"{len(calls)} calls' q/k/v (last q {tuple(calls[-1][0].shape)}, k "
          f"{tuple(calls[-1][1].shape)}), restored {tuple(restored.shape)} finite {finite} ({smi})",
          flush=True)
    if launches != depth * levels or len(calls) != depth * levels or not finite:
        raise AssertionError(f"VAR generate: {launches} K3 launches, {len(calls)} calls")

    inception = inceptionScore(torch, np, tmp, restored, smi)

    # K3 at VAR's last level, timed beside its plain version and SDPA
    q, k, v, _, scale = calls[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    cycles = sleepCyclesPerMs(torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.inference_mode():
        B, Tq, H, D = q.shape
        Tk = k.shape[1]
        flops = 4.0 * B * H * Tq * Tk * D
        nbytes = 4.0 * (2 * q.numel() + k.numel() + v.numel())
        k3Var = {"shape": [B, H, Tq, Tk, D],
                 "ms": medianMs(torch, lambda: flashAttention(q, k, v, None, scale)),
                 "plain_ms": medianMs(torch, lambda: flashAttentionPlain(q, k, v, None, scale)),
                 "library_ms": medianMs(torch, lambda: sdpa(qh, kh, vh, scale=scale)),
                 "device_ms": deviceMs(torch, lambda: flashAttention(q, k, v, None, scale),
                                       cycles)[0],
                 "library_device_ms": deviceMs(torch, lambda: sdpa(qh, kh, vh, scale=scale),
                                               cycles)[0]}
        k3Var["bound_ms"], k3Var["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        k3Var["bound_fp32_ms"] = bound(flops, nbytes)[0]
    print(f"  K3 at VAR's last level (B {B}, H {H}, Tq {Tq}, Tk {Tk}, D {D}): {k3Var['ms']:.4f} "
          f"ms, device {k3Var['device_ms']:.4f} ms; plain {k3Var['plain_ms']:.4f}; SDPA "
          f"{k3Var['library_ms']:.4f}, device {k3Var['library_device_ms']:.4f}; bound "
          f"{k3Var['bound_ms']:.5f} ms 3xTF32 ({k3Var['bound_by']}), {k3Var['bound_fp32_ms']:.5f} "
          f"fp32 ({smi})", flush=True)
    del calls, q, k, v, qh, kh, vh

    # the card against the CPU at depth 2, the same Gumbel noise
    small = dict(VAR_D24, depth=GEN_CPU_DEPTH)
    smallState = {key: value.cpu() for key, value in model.state_dict().items()
                  if not key.startswith("blocks.") or int(key.split(".")[1]) < GEN_CPU_DEPTH}
    del model
    torch.cuda.empty_cache()
    cardSmall, cpuSmall = GeneratorVAR(**small), GeneratorVAR(**small)
    cardSmall.load_state_dict(smallState)
    cpuSmall.load_state_dict(smallState)
    cardSmall, cpuSmall = cardSmall.to(device).eval(), cpuSmall.eval()
    with exactFp32(), torch.inference_mode():
        cardCodes = [c.cpu() for c in cardSmall.sampleCodes(condition, cfg=1.5,
                                                            gumbel=handed(device))]
        cpuCodes = cpuSmall.sampleCodes(condition.cpu(), cfg=1.5, gumbel=handed("cpu"))
    same = [torch.equal(a, b) for a, b in zip(cardCodes, cpuCodes)]
    print(f"  depth {GEN_CPU_DEPTH} at width {VAR_D24['embedDim']}, the same Gumbel noise: card "
          f"codes equal the CPU's by level {same}", flush=True)
    if not all(same):
        raise AssertionError("the card's VAR sampling differs from the CPU plain path")
    del cardSmall, cpuSmall
    torch.cuda.empty_cache()

    # train -G on a VAR config: the first step against the CPU at depth 2, then the CLI's main
    data = {"model": {"key": "GeneratorVAR", "params": dict(VAR_D24, loadFrom=str(neonCheckpoint))},
            "train": dict(Config.load(str(GEN_NEON_A_CONFIG)).serialize()["train"],
                          totalStep=VAR_TRAIN_STEPS, valFreq=10 * VAR_TRAIN_STEPS,
                          trainSet=str(classes), valSet=str(classes), saveDir=str(tmp / "var"))}
    config = writeConfig(tmp / "var_d24.yaml", data)
    bs = data["train"]["batchSize"]
    images, labels = next(iter(getGenLoader(classes, bs, cropSize=256)()))
    x = trainingTransform(torch.from_numpy(images),
                          augmentDraws(torch.Generator().manual_seed(0), bs), gen=True)
    y = torch.from_numpy(labels.astype(np.int64))
    drop = torch.rand((bs,), generator=torch.Generator().manual_seed(2))

    class Keep(Optimizer):
        """Applies nothing."""

        def step(self, grads):
            pass

    first = {}
    for dev in (torch.device("cpu"), device):
        copy = GeneratorVAR(**small)
        copy.load_state_dict(smallState)
        GenTrainer.loadCompressor(copy, neonCheckpoint)
        copy = copy.to(dev).train()
        copy.compressor.requires_grad_(False)
        keep = Keep([p for p in copy.parameters() if p.requires_grad], lambda step: 0.0)
        with exactFp32():
            metrics = makeGenTrainStep(copy, keep)(x.to(dev), y.to(dev),
                                                   lambda shape: drop.to(dev))
        first[dev.type] = {key: float(v) for key, v in metrics.items()}
        del copy, keep
    gaps = {key: relativeGap(first["cuda"][key], first["cpu"][key]) for key in ("loss", "gradNorm")}
    print(f"  VAR first step at depth {GEN_CPU_DEPTH}, card vs CPU: loss {first['cuda']['loss']:.8f} "
          f"/ {first['cpu']['loss']:.8f}, grad norm {first['cuda']['gradNorm']:.8f} / "
          f"{first['cpu']['gradNorm']:.8f} (gaps {gaps['loss']:.2e}, {gaps['gradNorm']:.2e}; "
          f"tolerance {TRAIN_CPU_RTOL:g})", flush=True)
    if max(gaps.values()) > TRAIN_CPU_RTOL:
        raise AssertionError(f"the VAR step's first loss or grad norm, card vs CPU: {gaps}")
    del smallState
    torch.cuda.empty_cache()

    perStep, stepBusy = [], []
    trainStep = GenTrainer.trainStep

    def countedStep(self, imgs, lbls):
        """One step of the CLI's trainer, timed and counted; the third also
        traced, for the card's busy time."""
        vqNearest.launches = 0
        torch.cuda.synchronize()
        begin = time.perf_counter()
        if len(perStep) == 2:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                metrics = trainStep(self, imgs, lbls)
                torch.cuda.synchronize()
            stepBusy.append(sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA))
        else:
            metrics = trainStep(self, imgs, lbls)
        torch.cuda.synchronize()
        perStep.append((time.perf_counter() - begin, vqNearest.launches, float(metrics["loss"]),
                        float(metrics["skipped"])))
        if len(perStep) == 1:
            torch.cuda.reset_peak_memory_stats()
        return metrics

    GenTrainer.trainStep = countedStep
    start = time.perf_counter()
    try:
        checkpoint = trainCli.main(config, gen=True, device="cuda")
    finally:
        GenTrainer.trainStep = trainStep
    runS = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = perStep[1][0]                        # the second step; the third is traced
    print(f"  train -G on the VAR config (batch {bs}, {data['train']['optim']}): {len(perStep)} "
          f"steps in {runS:.1f} s (build, load and the checkpoint's save included), K1 per step "
          f"{sorted({s[1] for s in perStep})}, losses {[round(s[2], 5) for s in perStep]}, "
          f"skipped {int(sum(s[3] for s in perStep))}; the second step {steady * 1e3:.1f} ms "
          f"(first {perStep[0][0] * 1e3:.1f} ms): {1 / steady:.3f} steps/s, device busy "
          f"{stepBusy[0]:.3f} ms in the third step (traced, {perStep[2][0] * 1e3:.1f} ms host "
          f"clock); peak after the first step {peak:.2f} GiB; checkpoint "
          f"{checkpoint.stat().st_size / 1e9:.2f} GB ({smi})", flush=True)
    if (len(perStep) != VAR_TRAIN_STEPS or {s[1] for s in perStep} != {levels}
            or any(s[3] for s in perStep) or not all(np.isfinite([s[2] for s in perStep]))):
        raise AssertionError(f"the VAR training steps: {perStep}")
    torch.cuda.empty_cache()

    # the trained checkpoint samples through the generate CLI, which runs on
    # through phases 14 and 15 and is finished by `finishVarCli`
    out = tmp / "var_generated"
    cli = (subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch", "generate", "--cfg", "1.5",
                             "-c", ",".join(map(str, GEN_CLASSES)), str(checkpoint), str(out)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
           out, time.perf_counter())
    return {"generate_ms": statistics.median(timesMs), "generate_busy_ms": genBusy,
            "generate_idle": genIdle, "K3_per_generate": launches, "err": worst, "k3": k3Var,
            "steps_per_s": 1 / steady, "busy_ms": stepBusy[0], "peak_gib": peak,
            "K1_per_step": levels, "inception": inception, "cli": cli}


def stopProcess(proc):
    """Kill `proc` if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def finishVarCli(cli):
    """Phase 13's generate CLI on VAR-d24's trained checkpoint, started at
    the end of phase 13: one PNG per class."""
    proc, out, start = cli
    try:
        _, stderr = proc.communicate(timeout=CLI_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"generate --cfg exited {proc.returncode}:\n{stderr[-4000:]}")
    written = sorted(out.glob("*.png"))
    print(f"  python -m mcquic_tpu_torch generate --cfg 1.5 -c {GEN_CLASSES} on VAR-d24's trained "
          f"checkpoint (phase 13): {[p.name for p in written]} in {time.perf_counter() - start:.1f} "
          f"s (process, load and build included; it ran through phases 14 and 15)", flush=True)
    if len(written) != len(GEN_CLASSES):
        raise AssertionError("the generate CLI did not write one PNG per class")


def tooling14(torch, np, tmp: Path, img, smi: str) -> dict:
    """Phase 14: a reference trainer checkpoint at the qp-2 geometry (a
    seeded state dict under the reference names, `module._compressor.`
    prefixed) through `python -m mcquic_tpu_torch.utils.convert`; the
    export's arrays must equal the seeded model's under the flax names, and
    it compresses and restores the photo on the card through K1 (3 per
    compress) and K2 (1 per restore)."""
    from mcquic_tpu_torch.container import File
    from mcquic_tpu_torch.demo import loadModel
    from mcquic_tpu_torch.models.compressor import seededModel
    from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelThin
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    from mcquic_tpu_torch.utils.convert import readExport, toJaxParams
    channel, m, k = 128, 2, [8192, 2048, 512]
    geometry = {"channel": channel, "m": m, "k": k}
    stateDict = seededModel(geometry, seed=5).state_dict()
    reference = tmp / "reference.ckpt"
    torch.save({"trainer": {"_model": {"module._compressor." + key: value
                                       for key, value in stateDict.items()}}}, reference)
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch.utils.convert", str(reference),
                           str(tmp / "converted.npz"), "--channel", str(channel), "--m", str(m),
                           "--k", ",".join(map(str, k)), "--qp", "2"],
                          cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"the convert CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    convertS = time.perf_counter() - start
    export = Path(proc.stdout.strip().splitlines()[-1])
    flat, meta = readExport(export)
    want = toJaxParams(stateDict, geometry)
    differ = sorted(key for key in want if key not in flat or not np.array_equal(flat[key],
                                                                                  want[key]))
    engine = loadModel(local=export, device="cuda")
    vqNearest.launches = conv3x3SubpixelThin.launches = 0
    file = engine.compressImage(img)
    k1 = vqNearest.launches
    restored = engine.decompressImage(File.deserialize(file.serialize()))
    k2 = conv3x3SubpixelThin.launches
    print(f"  reference checkpoint at the qp-2 geometry ({reference.stat().st_size / 1e6:.1f} MB) "
          f"-> {export.name} through the convert CLI in {convertS:.1f} s (process included): "
          f"{len(flat)} arrays, {len(differ)} differ from the seeded model's {differ[:3]}, config "
          f"{meta['config']['model']}, qp {meta['qp']}; the photo at {file.BPP:.4f} bpp, PSNR "
          f"{psnr(img, restored):.2f} dB (seeded weights), K1 {k1} per compress, K2 {k2} per "
          f"restore ({smi})", flush=True)
    if differ or len(flat) != len(want) or k1 != len(k) or k2 != 1 or restored.shape != img.shape:
        raise AssertionError("the converted reference checkpoint did not load or run as it should")
    return {"K1": k1, "K2": k2}


def varCase(torch, config: Path) -> dict:
    """`train -G` on a VAR config through the CLI's `main` (which joins the
    process group where the three variables are set): each step's seconds,
    loss and skip, each save's seconds (the optimizer's shards gathered into
    rank 0's host memory, then written), the peak after the first step and
    the optimizer state's bytes on this rank."""
    from mcquic_tpu_torch.train import cli as trainCli
    from mcquic_tpu_torch.train.genTrainer import GenTrainer
    steps, saves, info = [], [], {}
    trainStep, save = GenTrainer.trainStep, GenTrainer.save

    def countedStep(self, imgs, lbls):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        metrics = trainStep(self, imgs, lbls)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - begin, float(metrics["loss"]),
                      float(metrics["skipped"])))
        if len(steps) == 1:
            torch.cuda.reset_peak_memory_stats()
            info["state_bytes"] = self.optimizer.stateBytes()
        return metrics

    def timedSave(self):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        save(self)
        saves.append(time.perf_counter() - begin)

    GenTrainer.trainStep, GenTrainer.save = countedStep, timedSave
    try:
        checkpoint = trainCli.main(config, gen=True, device="cuda")
    finally:
        GenTrainer.trainStep, GenTrainer.save = trainStep, save
    return {"steps": steps, "saves": saves, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "state_bytes": info["state_bytes"],
            "checkpoint_bytes": checkpoint.stat().st_size if checkpoint.exists() else 0}


def multiCard() -> int:
    """`python3 chip_smoke.py --multi-card`: the environment and build phases,
    then data parallelism with a card per rank over NCCL, on every visible
    card (at least 2, at most 4 used):
      M1. the topology (`nvidia-smi topo -m`), NCCL's version, every card;
      M2. rd_qp2 and gen_stage2_neonA at batch DDP_GLOBAL_BATCH / world per
          rank against one process at DDP_GLOBAL_BATCH on card 0, gated as
          phase 12 (b) (`ddpCompare`): the first step's gaps, the checksums,
          the sharded optimizer state, K1 after every sharded step;
          The rd_qp2 ranks save DCP steps (MCQUIC_CKPT_BACKEND=orbax);
      M3. VAR-d24 through `train -G`'s `main` at batch 8 per rank for
          VAR_TRAIN_STEPS steps against one process at batch 8: steps/s per
          rank, images/s in all against one card's, the peak per rank, the
          optimizer state per rank and the save of the gathered checkpoint;
      M6. those DCP steps resumed at world 2 (NCCL ranks) and at world 1,
          each resumed state through the npz route bit-identical to the
          ranks' own (`dcpAcrossWorlds`);
      M7. the qp-2 zoo engine over cuda:0..N-1 against one card on a seeded
          [8, 768, 512, 3] batch: equal `.mcq` bytes, K1 and K2 on every
          card, images/s against one card's (`servingOverDevices`).
    The data are crops of the photo; the tokenizer is a seeded Neon export at
    neon_v2_60k's geometry. The last line is the `{"ok": true, ...}` JSON
    with the count of cards."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs CUDA cards.",
              file=sys.stderr)
        return 2
    if not (ROOT / "mcquic_tpu_torch" / "__init__.py").is_file() or not PHOTO.is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(mcquic_tpu_torch/ or assets/ missing).", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"chip_smoke --multi-card: {cards} card visible; this mode needs at least 2.",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.data.png import readPng
    from mcquic_tpu_torch.demo import writeSeededExport
    from mcquic_tpu_torch.utils.build import findNvcc

    kind = torch.cuda.get_device_name(0)
    world = min(cards, 4)
    with Phase("M1 environment"):
        nccl = torch.cuda.nccl.version()
        print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, numpy {np.__version__}, NCCL "
              f"{'.'.join(map(str, nccl)) if isinstance(nccl, tuple) else nccl}", flush=True)
        smiLines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  timeout=20, check=True).stdout.strip().splitlines()
        for i in range(cards):
            print(f"  card {i}: {torch.cuda.get_device_name(i)}, "
                  f"{torch.cuda.get_device_properties(i).multi_processor_count} SMs; "
                  f"{smiLines[i] if i < len(smiLines) else 'not in nvidia-smi'}", flush=True)
        smi = smiLines[0]
        topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                              timeout=20).stdout.rstrip()
        print("  nvidia-smi topo -m:\n" + "\n".join("    " + line for line in topo.splitlines()),
              flush=True)
        nvcc = findNvcc()
        print(f"  nvcc {nvcc}: " + subprocess.run([nvcc, "--version"], capture_output=True,
                                                  text=True, timeout=60, check=True)
              .stdout.strip().splitlines()[-1], flush=True)
    with Phase("M2 build"):
        buildAll()

    results = {"cards": cards, "world": world, "topology": topo, "smi": smiLines}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        img = readPng(PHOTO)
        with Phase("M3 data"):
            cropFolder(tmp / "crops", img, 16)
            cropFolder(tmp / "val", img, 1, size=256, seed=3)
            for j, wnid in enumerate(GEN_WNIDS):
                (tmp / "classes").mkdir(exist_ok=True)
                cropFolder(tmp / "classes" / wnid, img, 5 * world, seed=j + 1, jpeg=True)
            neon = writeSeededExport(tmp / "neon.npz", "Neon", dict(NEON_V2_60K), seed=0)
            print(f"  {len(list((tmp / 'crops').iterdir()))} PNG crops, "
                  f"{sum(1 for _ in (tmp / 'classes').rglob('*.JPEG'))} JPEG crops under "
                  f"{GEN_WNIDS}, a seeded Neon export at neon_v2_60k's geometry", flush=True)
        rd = Config.load(str(RD_QP2)).serialize()
        gen = Config.load(str(GEN_NEON_A_CONFIG)).serialize()
        gen["model"]["params"]["loadFrom"] = str(neon)
        with Phase(f"M4 world {world} over NCCL"):
            for case, base, trainSet in (("rd_qp2", rd, tmp / "crops"),
                                         ("gen", gen, tmp / "classes")):
                configs = ddpConfigs(tmp, case, base, world, trainSet, tmp / "val")
                results[case] = ddpCompare(
                    torch, np, tmp, smi, case, configs, "nccl", "over NCCL, a card each",
                    "One process runs on card 0",
                    {"MCQUIC_CKPT_BACKEND": "orbax"} if case == "rd_qp2" else None)
                if case == "rd_qp2":
                    rdConfig = configs[world]
        with Phase(f"M6 DCP steps of world {world} resumed at worlds 2 and 1"):
            results["dcp"] = dcpAcrossWorlds(torch, np, tmp, smi, rdConfig, world, [2, 1])
        with Phase(f"M7 the qp-{QP} engine over {world} cards"):
            from mcquic_tpu_torch.demo import loadModel
            one = loadModel(qp=QP, device="cuda")
            results["serving"] = servingOverDevices(torch, np, smi, one.model,
                                                    [f"cuda:{i}" for i in range(world)], one, 8)
            del one
        with Phase(f"M5 VAR-d24 at world {world}"):
            results["var"] = varWorld(torch, np, tmp, smi, neon, world)
    print(json.dumps({"multi_card": results}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": cards}}),
          flush=True)
    return 0


def varWorld(torch, np, tmp: Path, smi: str, neon: Path, world: int) -> dict:
    """M5: VAR-d24 at batch 8 per rank over `world` cards against one process
    at batch 8 on card 0, each through `train -G`'s `main` (`varCase`)."""
    from mcquic_tpu_torch.config import Config
    bs = Config.load(str(GEN_NEON_A_CONFIG)).serialize()["train"]["batchSize"]
    configs = {}
    for w in (1, world):
        train = dict(Config.load(str(GEN_NEON_A_CONFIG)).serialize()["train"],
                     totalStep=VAR_TRAIN_STEPS, valFreq=1000, batchSize=bs,
                     trainSet=str(tmp / "classes"), valSet=str(tmp / "classes"),
                     saveDir=str(tmp / f"var_{w}"))
        configs[w] = writeConfig(tmp / f"var_{w}.yaml", {
            "model": {"key": "GeneratorVAR", "params": dict(VAR_D24, loadFrom=str(neon))},
            "train": train})
    start = time.perf_counter()
    ranks = joinRanks(startRanks("var", world, tmp, configs[world], "nccl"), DDP_TIMEOUT)
    ranksS = time.perf_counter() - start
    for path in (tmp / f"var_{world}").rglob("*.npz"):
        path.unlink()
    one = varCase(torch, configs[1])
    steady = [statistics.median(s[0] for s in r["steps"][1:]) for r in ranks]
    oneSteady = statistics.median(s[0] for s in one["steps"][1:])
    imagesPerS = world * bs / max(steady)
    print(f"  VAR-d24 train -G, {world} ranks x batch {bs} over NCCL ({ranksS:.1f} s, processes, "
          f"builds and the save included): step seconds by rank "
          f"{[[round(s[0], 3) for s in r['steps']] for r in ranks]}; per rank "
          f"{[f'{1 / t:.3f}' for t in steady]} steps/s; {imagesPerS:.2f} images/s in all against "
          f"one process's {bs / oneSteady:.2f} at batch {bs} on card 0 "
          f"({imagesPerS * oneSteady / bs:.2f}x); peak after the first step per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB against {one['peak_gib']:.2f}; "
          f"optimizer state per rank {[r['state_bytes'] for r in ranks]} bytes against "
          f"{one['state_bytes']}; the gathered checkpoint's save {ranks[0]['saves']} s "
          f"({ranks[0]['checkpoint_bytes'] / 1e9:.2f} GB), one process's {one['saves']} s "
          f"({smi})", flush=True)
    losses = [s[1] for r in ranks for s in r["steps"]] + [s[1] for s in one["steps"]]
    if (any(len(r["steps"]) != VAR_TRAIN_STEPS for r in ranks) or not all(np.isfinite(losses))
            or any(s[2] for r in ranks for s in r["steps"])
            or any(r["state_bytes"] >= one["state_bytes"] for r in ranks)):
        raise AssertionError(f"VAR-d24 at world {world}: {ranks}")
    return {"ranks_steps_per_s": [1 / t for t in steady], "images_per_s": imagesPerS,
            "one_images_per_s": bs / oneSteady, "ranks_peak_gib": [r["peak_gib"] for r in ranks],
            "one_peak_gib": one["peak_gib"], "state_bytes": [r["state_bytes"] for r in ranks],
            "one_state_bytes": one["state_bytes"], "save_s": ranks[0]["saves"],
            "checkpoint_bytes": ranks[0]["checkpoint_bytes"], "one_save_s": one["saves"]}


def web15(torch, np, tmp: Path, img, smi: str, engine, cliMcq: bytes, cliRestored,
          progressiveMcq: bytes) -> dict:
    """Phase 15: (a) the web demo's handler on the qp-2 zoo engine for the
    photo's PNG, the progressive photo and the photo's `.mcq`, held to the
    CLI's bytes and restore of phase 5, and its refusal past MAX_PIXELS;
    (b) a seeded denseNorm Neon export at neon_v2_60k's geometry through the
    engine and the `--local` CLI, K1 at its nine levels, codes equal to the
    CPU's on phase 8's crop; (c) one step of that model through `Trainer`
    at batch 1 on the card and on the CPU (the CPU's in a thread while the
    card works), held to TRAIN_CPU_RTOL; (d) a seeded text-conditioned
    generator at gen_stage2_neonA's geometry (capDim 512) sampling greedily
    from seeded caption embeddings, 72 K3 launches, its depth-2 cut held to
    the CPU's as phase 6 holds the class generator."""
    import mcquic_tpu_torch.models.quantizer as quantizerModule
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
    from mcquic_tpu_torch.data.png import decodePng, encodePng, writePng
    from mcquic_tpu_torch.demo import loadModel, writeSeededExport
    from mcquic_tpu_torch.generate import GEN_STAGE2_NEON_A, seededGeneratorState
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    from mcquic_tpu_torch.ops.attention_cuda import flashAttention
    from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelThin
    from mcquic_tpu_torch.ops.vq import latentTokens, vqEncodePlain
    from mcquic_tpu_torch.ops.vq_cuda import vqNearest
    from mcquic_tpu_torch.service.stCompressService import MAX_PIXELS, TooLarge, handleUpload
    from mcquic_tpu_torch.train.trainer import Trainer
    from mcquic_tpu_torch.utils import exactFp32
    seconds, trace = {}, {}

    # (c)'s CPU step starts first, in a thread: the card's parts run meanwhile
    start = time.perf_counter()
    pngs = tmp / "dense_train"
    cropFolder(pngs, img, 2)
    data = Config.load(str(NEON_V2_60K_CONFIG)).serialize()
    data["model"]["params"]["denseNorm"] = True
    data["train"].update(totalStep=1, batchSize=1, valFreq=1, trainSet=str(pngs),
                         valSet=str(pngs), saveDir="", hooks=[])
    config = Config.deserialize(data)
    cpuGen = torch.Generator().manual_seed(15)
    crop256 = np.ascontiguousarray(img[100:356, 300:556])[None]
    x = trainingTransform(torch.from_numpy(crop256), augmentDraws(cpuGen, 1))
    recorded = recordedDraws(torch, cpuGen)
    steps = {}

    def step(label, dev, draw):
        trainer = Trainer(config, device=dev, lpipsFn=False)
        first = time.perf_counter()
        if dev == "cuda":
            with exactFp32(deterministic=True):
                metrics = trainer._stepFn(x.to(dev), draw)
        else:                           # in a thread, with no process-wide flag (`startCpuStep`)
            metrics = trainer._stepFn(x, draw)
        steps[label] = ({k: float(v) for k, v in metrics.items()}, time.perf_counter() - first,
                        trainer.model.denseNorm)

    waitDraws, joinCpu = startCpuStep(torch, lambda draw: step("cpu", "cpu", draw), recorded,
                                      2 * len(NEON_V2_60K["size"]))
    seconds["c_start"] = time.perf_counter() - start

    # (a) the handler
    start = time.perf_counter()
    photoPng = PHOTO.read_bytes()
    vqNearest.launches = conv3x3SubpixelThin.launches = 0
    answer = handleUpload(engine, "photo.png", photoPng)
    handlerK1, handlerK2 = vqNearest.launches, conv3x3SubpixelThin.launches
    progressive = handleUpload(engine, "photo_progressive.jpg", PHOTO_PROGRESSIVE.read_bytes())
    restore = handleUpload(engine, "photo.mcq", cliMcq)
    restored = decodePng(restore.data)
    huge = encodePng(np.zeros((MAX_PIXELS // 3000 + 1, 3000, 3), np.uint8))
    try:
        handleUpload(engine, "huge.png", huge)
        refused = None
    except TooLarge as e:
        refused = str(e)
    seconds["a"] = time.perf_counter() - start
    print(f"  (a) handleUpload on the qp-{QP} zoo: photo.png -> {answer.fileName} "
          f"({len(answer.data)} bytes) equal to the CLI's .mcq: {answer.data == cliMcq}, K1 "
          f"{handlerK1} and K2 {handlerK2} launches (compress and preview); "
          f"photo_progressive.jpg -> .mcq equal to the CLI's: {progressive.data == progressiveMcq}; "
          f"photo.mcq -> {restore.fileName} decoding to the CLI's restore: "
          f"{np.array_equal(restored, cliRestored)}; {MAX_PIXELS // 3000 + 1}x3000 refused: "
          f"{refused!r}; {seconds['a']:.2f} s", flush=True)
    if not (answer.data == cliMcq and progressive.data == progressiveMcq and handlerK1 == 3
            and handlerK2 == 1 and np.array_equal(restored, cliRestored)
            and np.array_equal(restore.preview, restored)
            and refused == f"Image too large (> {MAX_PIXELS} pixels)."):
        raise AssertionError("the web demo's handler disagrees with the CLI")
    trace["handler"] = {"K1": handlerK1, "K2": handlerK2}

    # (b) the denseNorm Neon codec: engine, CLI (a subprocess, meanwhile), CPU
    start = time.perf_counter()
    geometry = dict(NEON_V2_60K, denseNorm=True)
    export = writeSeededExport(tmp / "neon_dense.npz", "Neon", geometry, seed=0, qp="-1")
    crop = img[128:384, 128:384]
    writePng(tmp / "crop.png", crop)
    cliProc = subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch", "--local", str(export),
                                str(tmp / "crop.png"), str(tmp / "dense.mcq")], cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        denseEngine = loadModel(local=export, device="cuda")
        denseEngine.decompressImage(denseEngine.compressImage(crop))            # warm-up
        searches = []
        originalEncode = quantizerModule.vqEncode

        def captureNeon(x, codebook):
            if x.is_cuda:                   # not the CPU step's, in its thread
                searches.append((latentTokens(x), codebook.float().contiguous()))
            return originalEncode(x, codebook)
        quantizerModule.vqEncode = captureNeon
        try:
            cardCodes = denseEngine.encode(crop[None])
        finally:
            quantizerModule.vqEncode = originalEncode
        with exactFp32(), torch.inference_mode():
            for level, (tokens, codebook) in enumerate(searches):
                n, _ = checkCodes(torch, tokens, codebook, vqNearest(tokens, codebook),
                                  vqEncodePlain(tokens, codebook),
                                  f"K1 denseNorm Neon level {level} {tuple(tokens.shape)}")
                if n:
                    raise AssertionError(f"K1 differs from the plain version at level {level}")
        vqNearest.launches = 0
        denseFile = denseEngine.compressImage(crop)
        denseK1 = vqNearest.launches
        denseRestored = denseEngine.decompressImage(denseFile)
        cpuCodes = loadModel(local=export, device="cpu").encode(crop[None])
        identical = all(np.array_equal(a, c) for a, c in zip(cardCodes, cpuCodes))
        _, stderr = cliProc.communicate(timeout=CLI_TIMEOUT)
    finally:
        if cliProc.poll() is None:
            cliProc.kill()
            cliProc.wait()
    if cliProc.returncode != 0:
        raise RuntimeError(f"denseNorm Neon CLI exited {cliProc.returncode}:\n{stderr}")
    sameCli = (tmp / "dense.mcq").read_bytes() == denseFile.serialize()
    seconds["b"] = time.perf_counter() - start
    print(f"  (b) seeded denseNorm Neon export at {geometry} ({export.stat().st_size / 1e6:.1f} MB):"
          f" the 256x256 crop at {denseFile.BPP:.4f} bpp, K1 launches per compress {denseK1}, "
          f"card codes identical to the CPU's: {identical}, the --local CLI's .mcq identical: "
          f"{sameCli}, restored {denseRestored.shape}; {seconds['b']:.2f} s", flush=True)
    if not (denseK1 == len(NEON_V2_60K["size"]) and identical and sameCli
            and denseRestored.shape == crop.shape):
        raise AssertionError("the denseNorm Neon codec did not run as it should")
    trace["dense_neon"] = {"K1": denseK1}
    del denseEngine
    torch.cuda.empty_cache()

    # (d) the text-conditioned generator
    start = time.perf_counter()
    textGeometry = dict(GEN_STAGE2_NEON_A, textConditioned=True, capDim=512)
    state = seededGeneratorState(textGeometry, seed=0)
    with torch.device("cuda"):
        textModel = GeneratorV3SelfAttention(**textGeometry)
    textModel.load_state_dict(state)
    textModel.eval().requires_grad_(False)
    captions = torch.from_numpy(np.random.default_rng(15).normal(size=(len(GEN_CLASSES), 512))
                                .astype(np.float32)).cuda()
    levels = len(textGeometry["size"])
    with exactFp32(), torch.inference_mode():
        textModel.generate(captions)                                           # warm-up
        flashAttention.launches = 0
        textCodes, textRestored = textModel.generate(captions)
        textK3 = flashAttention.launches
    finite = bool(torch.isfinite(textRestored).all())
    agree = generatorVsCpu(torch, state, textGeometry, captions, levels)
    seconds["d"] = time.perf_counter() - start
    print(f"  (d) seeded text-conditioned generator at gen_stage2_neonA's geometry, capDim 512: "
          f"greedy from {len(GEN_CLASSES)} seeded caption embeddings, K3 launches {textK3}, "
          f"restored {tuple(textRestored.shape)} finite {finite}, depth-{GEN_CPU_DEPTH} codes "
          f"card vs CPU agree on {agree:.4%}; {seconds['d']:.2f} s", flush=True)
    if (textK3 != textGeometry["depth"] * levels or not finite
            or tuple(textRestored.shape) != (len(GEN_CLASSES), 3, 256, 256)):
        raise AssertionError(f"text-conditioned generation: K3 {textK3}, finite {finite}")
    trace["text"] = {"K3": textK3, "state": state}        # phase 17 samples from it again
    del textModel
    torch.cuda.empty_cache()

    # (c) the card's step, then the CPU's
    start = time.perf_counter()
    waitDraws()
    step("card", "cuda", recorded(torch.device("cuda")))
    joinCpu()
    (cpu, cpuS, cpuDense), (card, cardS, cardDense) = steps["cpu"], steps["card"]
    gaps = {key: relativeGap(card[key], cpu[key]) for key in ("loss", "gradNorm")}
    seconds["c"] = time.perf_counter() - start + seconds["c_start"]
    print(f"  (c) denseNorm Neon (neon_v2_60k.yaml's model with denseNorm, batch 1, input 256) "
          f"through Trainer, one step: CPU loss {cpu['loss']:.8f}, grad norm {cpu['gradNorm']:.8f}"
          f" ({cpuS:.1f} s, in a thread); card loss {card['loss']:.8f}, grad norm "
          f"{card['gradNorm']:.8f} ({cardS:.1f} s); gaps {gaps['loss']:.2e}, "
          f"{gaps['gradNorm']:.2e} relative (tolerance {TRAIN_CPU_RTOL:g}); skipped "
          f"{card['skipped']:.0f}/{cpu['skipped']:.0f} ({smi})", flush=True)
    if (not (cpuDense and cardDense) or card["skipped"] or cpu["skipped"]
            or gaps["loss"] > TRAIN_CPU_RTOL or gaps["gradNorm"] > TRAIN_CPU_RTOL):
        raise AssertionError(f"the denseNorm Neon's step: {gaps}")
    trace["seconds"] = seconds
    return trace


class ReplicaLaunches:
    """Counts K1, K1b and K2 launches per replica of a device-list engine
    while it is entered: a search by the replica whose codebook it takes, a
    thin head by the replica it belongs to. With `plain`, every search's
    codes are also held to the plain version on its tokens."""

    def __init__(self, torch, engine, plain: bool = False):
        self.torch, self.engine, self.plain = torch, engine, plain
        self.counts = [{"K1": 0, "K1b": 0, "K2": 0} for _ in engine.replicas]
        self.searches = self.differ = 0

    def __enter__(self):
        import mcquic_tpu_torch.models.quantizer as quantizerModule
        from mcquic_tpu_torch.nn.convs import PixelShuffleConv
        from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelThin
        from mcquic_tpu_torch.ops.vq import latentTokens, vqEncodePlain
        from mcquic_tpu_torch.ops.vq_cuda import vqNearest
        from mcquic_tpu_torch.ops.vq_grouped_cuda import vqNearestGrouped
        owners = {id(replica._quantizer.codebook(level)): i
                  for i, replica in enumerate(self.engine.replicas)
                  for level in range(len(replica.k))}
        self.module, self.original = quantizerModule, quantizerModule.vqEncode

        def counted(x, codebook):
            k1, k1b = vqNearest.launches, vqNearestGrouped.launches
            codes = self.original(x, codebook)
            count = self.counts[owners[id(codebook)]]
            count["K1"] += vqNearest.launches - k1
            count["K1b"] += vqNearestGrouped.launches - k1b
            if self.plain:
                n, m, _, h, w = x.shape
                plain = vqEncodePlain(latentTokens(x), codebook.float().contiguous())
                self.differ += int((plain.reshape(m, n, h, w).permute(1, 0, 2, 3) != codes).sum())
            self.searches += 1
            return codes

        quantizerModule.vqEncode = counted
        self.hooks = []
        for i, replica in enumerate(self.engine.replicas):
            for module in replica.modules():
                if isinstance(module, PixelShuffleConv) and module.thin:
                    self.hooks.append(module.register_forward_pre_hook(
                        lambda mod, args: setattr(self, "k2", conv3x3SubpixelThin.launches)))
                    self.hooks.append(module.register_forward_hook(
                        lambda mod, args, out, i=i: self.counts[i].__setitem__(
                            "K2", self.counts[i]["K2"] + conv3x3SubpixelThin.launches - self.k2)))
        return self

    def __exit__(self, *exc):
        self.module.vqEncode = self.original
        for hook in self.hooks:
            hook.remove()
        return False


def captions17(torch, np, tmp: Path, smi: str, textState: dict) -> dict:
    """Phase 17: (a) a seeded caption encoder (`utils/textEncoder.py`) at
    openai/clip-vit-base-patch32's text geometry over a byte-level
    vocabulary the phase writes encodes CAPTIONS on the card: K3 once per layer,
    each call held to its plain version on its q/k/v, the pooled [8, 512]
    held to the CPU plain path (CAPTION_RTOL); (b) phase 15's seeded
    text-conditioned generator samples greedily from those embeddings (K3
    72), its depth-2 cut held to the CPU's; (c) K3 at the encoder's shape
    (B 8, H 8, T 77, D 64, causal) timed beside its plain version and SDPA
    with `is_causal`."""
    import mcquic_tpu_torch.models.clipText as clipText
    from mcquic_tpu_torch.generate import GEN_STAGE2_NEON_A
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    from mcquic_tpu_torch.ops.attention import flashAttentionPlain
    from mcquic_tpu_torch.ops.attention_cuda import flashAttention
    from mcquic_tpu_torch.utils import exactFp32
    from mcquic_tpu_torch.utils.textEncoder import ClipTextEncoder, writeSeededClipText
    seconds, trace = {}, {}

    # (a) the encoder on the card against the CPU
    start = time.perf_counter()
    folder = writeSeededClipText(tmp / "clip", dict(eos_token_id=2), seed=17)
    encoder = ClipTextEncoder(str(folder), device="cuda")
    layers = encoder._model.config["num_hidden_layers"]
    ids, mask = encoder.tokenize(CAPTIONS)
    truncated = int(mask.sum(1).max())
    encoder(CAPTIONS)                                                        # warm-up
    calls, original = [], clipText.flashAttention

    def captured(q, k, v, causal, scale):
        calls.append((q.clone(), k.clone(), v.clone(), causal, scale))
        return original(q, k, v, causal, scale)
    flashAttention.launches = 0
    clipText.flashAttention = captured
    try:
        pooled = encoder(CAPTIONS)
    finally:
        clipText.flashAttention = original
    launches = flashAttention.launches
    with exactFp32(), torch.inference_mode():
        worst = max(k3Check(torch, flashAttention, flashAttentionPlain, *call) for call in calls)
    cpu = ClipTextEncoder(str(folder), device="cpu")(CAPTIONS)
    gap = float(np.abs(pooled - cpu).max() / np.abs(cpu).max())
    seconds["a"] = time.perf_counter() - start
    print(f"  (a) seeded caption encoder at openai/clip-vit-base-patch32's text geometry "
          f"({encoder._model.config}): {len(CAPTIONS)} captions, {truncated} tokens at the longest "
          f"(truncated at 77: {truncated == 77}), K3 launches per encode {launches}, each within "
          f"{worst:.2e} of its plain version (tolerance {K3_ATOL:g}); pooled {pooled.shape} against "
          f"the CPU plain path: max gap {gap:.2e} of the largest (tolerance {CAPTION_RTOL:g}); "
          f"{seconds['a']:.2f} s ({smi})", flush=True)
    if (launches != layers or len(calls) != layers or truncated != 77
            or pooled.shape != (len(CAPTIONS), 512) or not np.isfinite(pooled).all()
            or not gap <= CAPTION_RTOL):
        raise AssertionError(f"the caption encoder: K3 {launches}, gap {gap}")
    trace["encoder"] = {"K3": launches, "gap": gap}
    q, k, v, causal, scale = calls[0]
    del encoder, calls

    # (b) the text-conditioned generator on the encoder's embeddings
    start = time.perf_counter()
    textGeometry = dict(GEN_STAGE2_NEON_A, textConditioned=True, capDim=512)
    with torch.device("cuda"):
        textModel = GeneratorV3SelfAttention(**textGeometry)
    textModel.load_state_dict(textState)
    textModel.eval().requires_grad_(False)
    embeddings = torch.from_numpy(pooled).cuda()
    levels = len(textGeometry["size"])
    with exactFp32(), torch.inference_mode():
        textModel.generate(embeddings)                                       # warm-up
        flashAttention.launches = 0
        _, restored = textModel.generate(embeddings)
        generateK3 = flashAttention.launches
    finite = bool(torch.isfinite(restored).all())
    agree = generatorVsCpu(torch, textState, textGeometry, embeddings, levels)
    seconds["b"] = time.perf_counter() - start
    print(f"  (b) phase 15's text-conditioned generator sampling greedily from the {len(CAPTIONS)} "
          f"encoded captions: K3 launches {generateK3}, restored {tuple(restored.shape)} finite "
          f"{finite}, depth-{GEN_CPU_DEPTH} codes card vs CPU agree on {agree:.4%}; "
          f"{seconds['b']:.2f} s", flush=True)
    if (generateK3 != textGeometry["depth"] * levels or not finite
            or tuple(restored.shape) != (len(CAPTIONS), 3, 256, 256)):
        raise AssertionError(f"generation from captions: K3 {generateK3}, finite {finite}")
    trace["generate"] = {"K3": generateK3}
    del textModel, restored
    torch.cuda.empty_cache()

    # (c) K3 at the encoder's shape against its plain version and SDPA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    cycles = sleepCyclesPerMs(torch)
    with exactFp32(), torch.inference_mode():
        B, T, H, D = q.shape
        pairs = T * (T + 1) // 2                          # the causal mask's attended pairs
        flops = 4.0 * B * H * pairs * D
        nbytes = 4.0 * 4 * q.numel() + causal.numel()
        row = {"shape": [B, H, T, T, D],
               "ms": medianMs(torch, lambda: flashAttention(q, k, v, causal, scale)),
               "plain_ms": medianMs(torch, lambda: flashAttentionPlain(q, k, v, causal, scale)),
               "library_ms": medianMs(torch, lambda: sdpa(qh, kh, vh, is_causal=True, scale=scale)),
               "device_ms": deviceMs(torch, lambda: flashAttention(q, k, v, causal, scale),
                                     cycles)[0],
               "plain_device_ms": deviceMs(torch, lambda: flashAttentionPlain(
                   q, k, v, causal, scale), cycles)[0],
               "library_device_ms": deviceMs(torch, lambda: sdpa(qh, kh, vh, is_causal=True,
                                                                 scale=scale), cycles)[0]}
        row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        row["bound_fp32_ms"] = bound(flops, nbytes)[0]
        sdpaErr = (sdpa(qh, kh, vh, is_causal=True, scale=scale).permute(0, 2, 1, 3)
                   - flashAttention(q, k, v, causal, scale)).abs().max().item()
    print(f"  (c) K3 at the caption encoder's shape (B {B}, H {H}, T {T}, D {D}, causal): "
          f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms; plain {row['plain_ms']:.4f}, "
          f"device {row['plain_device_ms']:.4f}; SDPA (is_causal) {row['library_ms']:.4f}, device "
          f"{row['library_device_ms']:.4f} (max gap to K3 {sdpaErr:.2e}); bound "
          f"{row['bound_ms']:.5f} ms 3xTF32 ({row['bound_by']}; {pairs} of {T * T} pairs), "
          f"{row['bound_fp32_ms']:.5f} fp32 ({smi})", flush=True)
    if not sdpaErr <= K3_ATOL:
        raise AssertionError(f"K3 and SDPA differ by {sdpaErr} at the caption encoder's shape")
    trace["k3"] = row
    trace["seconds"] = seconds
    return trace


def wallMs(torch, fn, iters: int = 3) -> float:
    """The median host-clock ms of `fn`, synchronized on every card."""
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def enqueueMs(torch, fn, iters: int = 3) -> float:
    """The median host-clock ms until `fn` returns, before the cards finish
    (each run is synchronized on every card after its reading)."""
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    return statistics.median(times)


def servingOverDevices(torch, np, smi: str, model, devices: list, one, batchSize: int) -> dict:
    """`model` served by one engine over `devices` against `one`, the engine
    of the same model on one device: a seeded speed batch of `batchSize`
    rows (split among the replicas) and a batch of 3 (whole on the first)
    must give `one`'s `.mcq` bytes; every replica launches K1 per level in
    its compress and K2 once in its restore; the wall times of compress and
    restore of the batch on both engines, and the host's time to enqueue the
    compress (until the engine starts waiting for the cards), as a
    measurement only."""
    from mcquic_tpu_torch.models.engine import CompressorEngine
    engine = CompressorEngine(model, qp=one.QuantizationParameter, devices=devices)
    batch = np.random.default_rng(0).uniform(-1, 1, (batchSize, 768, 512, 3)).astype(np.float32)
    engine.decompress(*engine.compress(batch)[1:])             # the replicas' autotuning
    one.decompress(*one.compress(batch)[1:])
    with ReplicaLaunches(torch, engine) as launches:
        _, binaries, headers = engine.compress(batch)
        restored = engine.decompress(binaries, headers)
    _, oneBinaries, _ = one.compress(batch)
    oneRestored = one.decompress(oneBinaries, headers)
    small = batch[:3]
    sameSmall = engine.compress(small)[1] == one.compress(small)[1]
    sameBytes = binaries == oneBinaries
    levels = len(model.k)
    times = {"compress_ms": wallMs(torch, lambda: engine.compress(batch)),
             "one_compress_ms": wallMs(torch, lambda: one.compress(batch)),
             "restore_ms": wallMs(torch, lambda: engine.decompress(binaries, headers)),
             "one_restore_ms": wallMs(torch, lambda: one.decompress(binaries, headers)),
             "enqueue_ms": enqueueMs(torch, lambda: engine._encodeDispatch(batch)),
             "one_enqueue_ms": enqueueMs(torch, lambda: one._encodeDispatch(batch))}
    print(f"  the qp-{one.QuantizationParameter} zoo engine over {devices} against one device, "
          f"[{batchSize}, 768, 512, 3] split {batchSize // len(devices)} per replica: .mcq bytes "
          f"equal {sameBytes}, restored max |diff| {float(np.abs(restored - oneRestored).max()):.3g}; "
          f"a batch of 3 (whole on the first replica) equal {sameSmall}; launches per replica "
          f"{launches.counts}; compress {times['compress_ms']:.1f} ms against "
          f"{times['one_compress_ms']:.1f} ({batchSize * 1e3 / times['compress_ms']:.2f} against "
          f"{batchSize * 1e3 / times['one_compress_ms']:.2f} images/s), restore "
          f"{times['restore_ms']:.1f} ms against {times['one_restore_ms']:.1f} "
          f"({batchSize * 1e3 / times['restore_ms']:.2f} against "
          f"{batchSize * 1e3 / times['one_restore_ms']:.2f} images/s); the compress enqueued in "
          f"{times['enqueue_ms']:.1f} ms against {times['one_enqueue_ms']:.1f}; host clock, a "
          f"measurement only ({smi})", flush=True)
    if not (sameBytes and sameSmall) or any(c != {"K1": levels, "K1b": 0, "K2": 1}
                                            for c in launches.counts):
        raise AssertionError(f"the engine over {devices} differs from one device: bytes "
                             f"{sameBytes}, batch of 3 {sameSmall}, launches {launches.counts}")
    del engine
    torch.cuda.empty_cache()
    return {"devices": devices, "batch": batchSize, "launches": launches.counts, **times}


def devices16(torch, np, img, smi: str, engine) -> dict:
    """Phase 16: the qp-2 zoo engine over ["cuda:0", "cuda:0"] against
    `engine` on the speed batch (`servingOverDevices`), then the seeded
    past-budget model over the same list: the photo and its mirror, one per
    replica, every search (K1b at level 0, K1 at levels 1 and 2) held to the
    plain version on its tokens."""
    from mcquic_tpu_torch.models.compressor import seededCompressor
    from mcquic_tpu_torch.models.engine import CompressorEngine
    devices = ["cuda:0", "cuda:0"]
    trace = servingOverDevices(torch, np, smi, engine.model, devices, engine, 10)
    past = CompressorEngine(seededCompressor(*PAST_BUDGET), devices=devices)
    with ReplicaLaunches(torch, past, plain=True) as launches:
        past.encode(np.stack([img, img[:, ::-1]]))
    print(f"  the past-budget model {PAST_BUDGET} (seeded) over {devices}, the photo and its "
          f"mirror: launches per replica {launches.counts}; {launches.differ} codes of "
          f"{launches.searches} searches differ from the plain version's", flush=True)
    if launches.differ or launches.searches != 6 or any(
            c != {"K1": 2, "K1b": 1, "K2": 0} for c in launches.counts):
        raise AssertionError("the past-budget model over the device list did not run as it should")
    del past
    torch.cuda.empty_cache()
    return dict(trace, past_budget=launches.counts)


def dcpResume(torch, np, config: Path, out: Path) -> dict:
    """The DCP steps of `config`'s run (MCQUIC_CKPT_BACKEND=orbax) resumed at
    this process's world, and the resumed state through the npz route
    (`Trainer.checkpoint`, gathered on rank 0) written to `out`."""
    from mcquic_tpu_torch import parallel
    from mcquic_tpu_torch.config import Config
    from mcquic_tpu_torch.models.compressor import buildModel
    from mcquic_tpu_torch.train.trainer import Trainer, resolveStage1Model
    cfg = Config.load(str(config))
    # the weights come from the checkpoint: the model's own initialization is enough
    trainer = Trainer(cfg, model=buildModel(resolveStage1Model(cfg)[1]), device="cuda",
                      lpipsFn=False, ckptBackend="orbax")
    try:
        start = time.perf_counter()
        if not trainer.tryResume():
            raise AssertionError(f"no DCP step to resume under {config}")
        seconds = time.perf_counter() - start
        flat = trainer.checkpoint()
    finally:
        trainer.close()
    if flat is not None:
        np.savez(out, **flat)
    return {"step": trainer.step, "world": parallel.world(), "resume_s": seconds,
            "steps": trainer._dcp.steps()}


def checkpointsDiffer(np, a: Path, b: Path) -> list:
    """The keys whose arrays differ between two npz checkpoints."""
    x, y = np.load(a), np.load(b)
    return sorted(k for k in set(x) | set(y)
                  if k not in x or k not in y or not np.array_equal(x[k], y[k]))


def buildAll():
    """Build K1, K1b, K2 and K3 (nvcc) and the rANS runtime, the JPEG codec
    and the WebP decoder (g++), all started together; print ptxas's
    registers and spills of every kernel."""
    from mcquic_tpu_torch.coding import rans
    from mcquic_tpu_torch.data import jpeg, webp
    from mcquic_tpu_torch.ops import attention_cuda, subpixel_cuda, vq_cuda, vq_grouped_cuda
    from mcquic_tpu_torch.utils.build import buildLog

    def timed(name, fn):
        start = time.perf_counter()
        fn()
        return name, time.perf_counter() - start
    with ThreadPoolExecutor(7) as pool:
        jobs = [pool.submit(timed, name, fn) for name, fn in
                (("K1 vq_encode.cu (nvcc)", vq_cuda.build),
                 ("K1b vq_grouped.cu (nvcc)", vq_grouped_cuda.build),
                 ("K2 thin_head.cu (nvcc)", subpixel_cuda.build),
                 ("K3 flash_attention.cu (nvcc)", attention_cuda.build),
                 ("rANS mcquic_rans.cpp (g++)", rans.build),
                 ("JPEG jpeg.cpp (g++)", jpeg.build),
                 ("WebP webp.cpp (g++)", webp.build))]
        for job in jobs:
            name, seconds = job.result()
            print(f"  built {name} in {seconds:.2f} s", flush=True)
    for stem in ("vq_encode", "vq_grouped", "thin_head", "flash_attention"):
        for line in buildLog(stem).splitlines():
            if "entry function" in line or "spill" in line or "Used" in line:
                print(f"  ptxas {stem}: {line.strip()}", flush=True)


def jpegCheck(np, photo, smi: str) -> dict:
    """The host decoders against the fixtures' hashes of PIL's decode: every
    JPEG of tests/golden/torch_jpeg/ (baseline, progressive, smoothed,
    arithmetic, lossless, CMYK, YCCK, 4:1:1; the full-size progressive, CMYK
    and arithmetic photos among them), every PNG and BMP form of
    tests/golden/torch_images/ and every WebP of tests/golden/torch_webp/
    (the full-size lossy and lossless photos among them); the photo's q95
    bytes and their decode against PIL's (`photo.json`); then the codec's
    rates on the photo at q95, and the progressive, arithmetic, CMYK and
    WebP decoders' on their photos, medians of JPEG_RATE_ITERS calls, in
    megapixels per second."""
    import hashlib
    from mcquic_tpu_torch.data.dataset import _decodeImage
    from mcquic_tpu_torch.data.jpeg import encodeJpeg, readJpeg
    from mcquic_tpu_torch.data.webp import readWebp
    for folder in (JPEG_FIXTURE, IMAGE_FIXTURE, WEBP_FIXTURE):
        manifest = json.loads((folder / "manifest.json").read_text())
        for name, entry in sorted(manifest.items()):
            got = _decodeImage((folder / name).read_bytes(), name)
            digest = hashlib.sha256(got.tobytes()).hexdigest() if got is not None else None
            if got is None or list(got.shape) != entry["shape"] or digest != entry["sha256"]:
                raise AssertionError(f"the decode of the fixture's {name} is not PIL's "
                                     f"({digest and digest[:16]} against {entry['sha256'][:16]})")
            print(f"  fixture {folder.name}/{name} {tuple(got.shape)}: decode equals PIL's "
                  f"(sha256 {digest[:16]})", flush=True)
    data = encodeJpeg(photo, 95)
    want = json.loads(PHOTO_DIGESTS.read_text())["photo_q95"]
    got = {"sha256": hashlib.sha256(data).hexdigest(),
           "decode_sha256": hashlib.sha256(readJpeg(data).tobytes()).hexdigest()}
    print(f"  the photo at q95: the port's bytes equal PIL's {got['sha256'] == want['sha256']}, "
          f"its decode of them equals PIL's {got['decode_sha256'] == want['decode_sha256']}",
          flush=True)
    if got != want:
        raise AssertionError(f"the photo's q95 bytes or their decode differ from PIL's: {got} "
                             f"against {want}")
    megapixels = photo.shape[0] * photo.shape[1] / 1e6

    def rate(fn):
        times = []
        for _ in range(JPEG_RATE_ITERS):
            start = time.perf_counter()
            fn()
            times.append(time.perf_counter() - start)
        return megapixels / statistics.median(times)
    progressive = PHOTO_PROGRESSIVE.read_bytes()
    arithmetic, cmyk = PHOTO_ARITHMETIC.read_bytes(), PHOTO_CMYK.read_bytes()
    lossy, lossless = PHOTO_WEBP.read_bytes(), PHOTO_WEBP_LOSSLESS.read_bytes()
    rates = {"decode_mp_s": rate(lambda: readJpeg(data)),
             "encode_mp_s": rate(lambda: encodeJpeg(photo, 95)),
             "progressive_decode_mp_s": rate(lambda: readJpeg(progressive)),
             "arithmetic_decode_mp_s": rate(lambda: readJpeg(arithmetic)),
             "cmyk_decode_mp_s": rate(lambda: readJpeg(cmyk)),
             "webp_lossy_decode_mp_s": rate(lambda: readWebp(lossy)),
             "webp_lossless_decode_mp_s": rate(lambda: readWebp(lossless)), "photo_jpeg": data}
    print(f"  JPEG codec on the host, the photo {photo.shape[1]}x{photo.shape[0]} at q95 "
          f"({len(data)} bytes): decode {rates['decode_mp_s']:.2f} MP/s, encode "
          f"{rates['encode_mp_s']:.2f} MP/s; the progressive photo (PIL, q90, "
          f"{len(progressive)} bytes): decode {rates['progressive_decode_mp_s']:.2f} MP/s; the "
          f"arithmetic photo ({len(arithmetic)} bytes): decode "
          f"{rates['arithmetic_decode_mp_s']:.2f} MP/s; the CMYK photo (PIL, q95, {len(cmyk)} "
          f"bytes): decode {rates['cmyk_decode_mp_s']:.2f} MP/s (medians of {JPEG_RATE_ITERS}; "
          f"{smi})", flush=True)
    print(f"  WebP decoder on the host, the photo: lossy (PIL's default q80, {len(lossy)} bytes) "
          f"{rates['webp_lossy_decode_mp_s']:.2f} MP/s, lossless ({len(lossless)} bytes) "
          f"{rates['webp_lossless_decode_mp_s']:.2f} MP/s (medians of {JPEG_RATE_ITERS}; {smi})",
          flush=True)
    return rates


def main() -> int:
    started = time.perf_counter()
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

    from mcquic_tpu_torch.container import File
    from mcquic_tpu_torch.data import jpeg
    from mcquic_tpu_torch.data.png import readPng, writePng
    from mcquic_tpu_torch.data.dataset import readImage
    from mcquic_tpu_torch.demo import loadModel, writeSeededExport, zooPath
    from mcquic_tpu_torch.models.compressor import Compressor, seededCompressor
    from mcquic_tpu_torch.models.engine import CompressorEngine
    from mcquic_tpu_torch.models.tiling import (TiledFile, compressTiled, decompressTiled,
                                                fromTiles, toTiles)
    import mcquic_tpu_torch.models.generator as generatorModule
    import mcquic_tpu_torch.models.quantizer as quantizerModule
    from mcquic_tpu_torch.data.transforms import imageToModelInput, modelOutputToImage
    from mcquic_tpu_torch.generate import GEN_STAGE2_NEON_A, loadGenerator, writeSeededGenerator
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention, blockCausalMask
    from mcquic_tpu_torch.ops.attention import flashAttentionPlain
    from mcquic_tpu_torch.ops.attention_cuda import attentionPlan, flashAttention
    from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelPlain, conv3x3SubpixelThin
    from mcquic_tpu_torch.ops.vq import groupLatent, latentTokens, vqEncodePlain
    from mcquic_tpu_torch.ops.vq_cuda import k1Plan, vqNearest
    from mcquic_tpu_torch.ops.vq_grouped_cuda import vqNearestGrouped
    from mcquic_tpu_torch.utils import exactFp32
    from mcquic_tpu_torch.utils.build import findNvcc
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
        buildAll()
        codec = jpegCheck(np, readPng(PHOTO), smi)

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

            def cli(*args):
                return subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch", *map(str, args)],
                                        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)

            def finish(proc):
                _, stderr = proc.communicate(timeout=CLI_TIMEOUT)
                if proc.returncode != 0:
                    raise RuntimeError(f"CLI {proc.args} exited {proc.returncode}:\n{stderr}")

            # four compressions at once: the photo; the photo as a q95 JPEG, and a
            # PNG holding the port's decode of it, which must give the JPEG's .mcq;
            # PIL's progressive JPEG of the photo
            photoJpg, decodedPng = out / "photo.jpg", out / "photo_decoded.png"
            progressiveJpg = out / "photo_progressive.jpg"
            photoJpg.write_bytes(codec["photo_jpeg"])
            progressiveJpg.write_bytes(PHOTO_PROGRESSIVE.read_bytes())
            decoded = jpeg.readJpeg(codec["photo_jpeg"])
            writePng(decodedPng, decoded)
            # the WebP and CMYK photos, each beside a PNG of the port's decode of it
            forms = {}
            for source in (PHOTO_WEBP, PHOTO_CMYK):
                copy = out / source.name
                copy.write_bytes(source.read_bytes())
                formDecoded = readImage(copy)
                writePng(out / f"{source.stem}_decoded.png", formDecoded)
                forms[source.name] = (copy, out / f"{source.stem}_decoded.png", formDecoded)
            procs = [cli("-qp", QP, PHOTO, out / "cli.mcq")] + [
                cli("-qp", QP, src, out / f"{src.stem}.mcq")
                for src in (photoJpg, decodedPng, progressiveJpg,
                            *[copy for copy, _, _ in forms.values()])]
            try:
                finish(procs[0])
                procs.append(cli(out / "cli.mcq", out / "cli.png"))
                for proc in procs[1:]:
                    finish(proc)
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            cliFile = File.deserialize((out / "cli.mcq").read_bytes())
            cliQuality = psnr(img, readPng(out / "cli.png"))
            print(f"  CLI: {cliFile.BPP:.4f} bpp, PSNR {cliQuality:.2f} dB, .mcq identical to "
                  f"the in-process one: {(out / 'cli.mcq').read_bytes() == file.serialize()}",
                  flush=True)
            if (abs(cliFile.BPP - REGISTERED_BPP) > BPP_RTOL * REGISTERED_BPP
                    or abs(cliQuality - REGISTERED_PSNR) > PSNR_ATOL):
                raise AssertionError("the CLI round trip misses the registered bpp / PSNR")

            jpgMcq = (out / "photo.mcq").read_bytes()
            sameAsPng = jpgMcq == (out / "photo_decoded.mcq").read_bytes()
            vqNearest.launches = conv3x3SubpixelThin.launches = 0
            inProcess = engine.compressImage(readImage(photoJpg)).serialize()
            jpgK1 = vqNearest.launches
            jpgRestored = engine.decompressImage(File.deserialize(jpgMcq))
            jpgK2 = conv3x3SubpixelThin.launches
            print(f"  CLI on photo.jpg (q95, {len(codec['photo_jpeg'])} bytes): "
                  f"{File.deserialize(jpgMcq).BPP:.4f} bpp, .mcq identical to the CLI's on a PNG "
                  f"of its decode: {sameAsPng}, to the in-process compress: "
                  f"{inProcess == jpgMcq}; K1 {jpgK1} launches in the compress, K2 {jpgK2} in the "
                  f"restore; PSNR against the JPEG's decode {psnr(decoded, jpgRestored):.2f} dB",
                  flush=True)
            if not (sameAsPng and inProcess == jpgMcq and jpgK1 == 3 and jpgK2 == 1):
                raise AssertionError("the JPEG input does not compress as the PNG of its decode")

            # the progressive JPEG's codes against those of a PNG of its pixels
            progressiveMcq = (out / "photo_progressive.mcq").read_bytes()
            progressiveDecoded = readImage(progressiveJpg)
            writePng(out / "photo_progressive_decoded.png", progressiveDecoded)
            vqNearest.launches = conv3x3SubpixelThin.launches = 0
            progressiveFile = engine.compressImage(progressiveDecoded)
            progressiveK1 = vqNearest.launches
            progressiveRestored = engine.decompressImage(File.deserialize(progressiveMcq))
            progressiveK2 = conv3x3SubpixelThin.launches
            pngCodes = engine.encode(readPng(out / "photo_progressive_decoded.png")[None])
            cliCodes = engine.coder.decompress([File.deserialize(progressiveMcq).Content],
                                               [File.deserialize(progressiveMcq).FileHeader.CodeSize])
            codesSame = all(np.array_equal(a, b) for a, b in zip(cliCodes, pngCodes))
            print(f"  CLI on photo_progressive.jpg (PIL progressive q90, "
                  f"{PHOTO_PROGRESSIVE.stat().st_size} bytes): "
                  f"{File.deserialize(progressiveMcq).BPP:.4f} bpp, .mcq identical to the "
                  f"in-process compress: {progressiveFile.serialize() == progressiveMcq}; its codes "
                  f"and those of a PNG of its pixels identical: {codesSame}; K1 {progressiveK1} "
                  f"launches in the compress, K2 {progressiveK2} in the restore; PSNR against its "
                  f"decode {psnr(progressiveDecoded, progressiveRestored):.2f} dB", flush=True)
            if not (codesSame and progressiveFile.serialize() == progressiveMcq
                    and progressiveK1 == 3 and progressiveK2 == 1):
                raise AssertionError("the progressive JPEG does not compress as the PNG of its "
                                     "decode")
            # the WebP and CMYK photos: the CLI's .mcq equals the one for a PNG of the
            # port's decode (compressed in process, as the CLI compresses: the photo.jpg
            # gate above holds the CLI to the in-process bytes); in process, K1 3 per
            # compress and K2 1 per restore
            for name, (copy, png, formDecoded) in forms.items():
                formMcq = (out / f"{copy.stem}.mcq").read_bytes()
                samePng = formMcq == engine.compressImage(readImage(png)).serialize()
                vqNearest.launches = conv3x3SubpixelThin.launches = 0
                formInProcess = engine.compressImage(readImage(copy)).serialize()
                formK1 = vqNearest.launches
                formRestored = engine.decompressImage(File.deserialize(formMcq))
                formK2 = conv3x3SubpixelThin.launches
                print(f"  CLI on {name} ({copy.stat().st_size} bytes): "
                      f"{File.deserialize(formMcq).BPP:.4f} bpp, .mcq identical to the one for a "
                      f"PNG of its decode: {samePng}, to the in-process compress: "
                      f"{formInProcess == formMcq}; K1 {formK1} launches in the compress, K2 "
                      f"{formK2} in the restore; PSNR against its decode "
                      f"{psnr(formDecoded, formRestored):.2f} dB", flush=True)
                if not (samePng and formInProcess == formMcq and formK1 == 3 and formK2 == 1):
                    raise AssertionError(f"{name} does not compress as the PNG of its decode")
            photoCliMcq, photoCliRestored = (out / "cli.mcq").read_bytes(), readPng(out / "cli.png")

    with Phase("6 generation"), tempfile.TemporaryDirectory() as tmp, ExitStack() as stopAtExit:
        start = time.perf_counter()
        ckpt = writeSeededGenerator(Path(tmp) / "gen_stage2_neonA.ckpt.npz", geometry, seed=0)
        model = loadGenerator(ckpt, device="cuda")
        levels, depth = len(lengths), geometry["depth"]
        print(f"  seeded gen_stage2_neonA checkpoint (configs/rd5/gen_stage2_neonA.yaml widths and "
              f"depth), {ckpt.stat().st_size / 1e6:.1f} MB, written and loaded in "
              f"{time.perf_counter() - start:.2f} s", flush=True)
        condition = torch.tensor(GEN_CLASSES, device=device)
        # the CLI, in a subprocess beside the in-process checks, joined at the end
        out = Path(tmp) / "samples"
        cliStart = time.perf_counter()
        generateCli = subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch", "generate", "-c",
                                        ",".join(map(str, GEN_CLASSES)), str(ckpt), str(out)],
                                       cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
        stopAtExit.callback(stopProcess, generateCli)   # should the phase fail before its join

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
        generatorVsCpu(torch, model.state_dict(), geometry, condition, levels)

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

        # the CLI started at the top of the phase
        try:
            _, stderr = generateCli.communicate(timeout=CLI_TIMEOUT)
        finally:
            stopProcess(generateCli)
        if generateCli.returncode != 0:
            raise RuntimeError(f"generate CLI exited {generateCli.returncode}:\n{stderr}")
        pngs = sorted(out.glob("*.png"))
        shapes = [readPng(p).shape for p in pngs]
        print(f"  CLI generate: {[p.name for p in pngs]}, {shapes} in "
              f"{time.perf_counter() - cliStart:.2f} s (process start and load included, beside "
              f"the phase's in-process work)", flush=True)
        if len(pngs) != batch or any(sh != (256, 256, 3) for sh in shapes):
            raise AssertionError("the generate CLI did not write 4 256x256 PNGs")

    with Phase("7 validation path"), tempfile.TemporaryDirectory() as tmp, ExitStack() as stopAtExit:
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

        # the tiled compress through the CLI in TILED_PROCESSES fresh processes, each choosing
        # its own cuDNN algorithms, beside the in-process work below (ROADMAP C8)
        tiledProcs = [(subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch", "-qp", str(QP),
                                         "--tile", str(TILE), str(PHOTO), str(tmp / f"tiled{i}.mcq")],
                                        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp / f"tiled{i}.mcq")
                      for i in range(TILED_PROCESSES)]
        for proc, _ in tiledProcs:
            stopAtExit.callback(stopProcess, proc)          # should the phase fail before its join

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
        for proc, _ in tiledProcs:
            _, err = proc.communicate(timeout=CLI_TIMEOUT)
            if proc.returncode != 0:
                raise RuntimeError(f"the tiled CLI compress exited {proc.returncode}:\n{err}")
        tiled, tiledPng = tiledProcs[0][1], tmp / "tiled.png"
        proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", str(tiled), str(tiledPng)],
                              cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"the tiled CLI restore exited {proc.returncode}:\n{proc.stderr}")
        datas = [path.read_bytes() for _, path in tiledProcs]
        data = datas[0]
        tf = TiledFile.deserialize(data)
        cliRestored = readPng(tiledPng)
        inProcess = compressTiled(engine, img, TILE)
        sameFiles = [d == inProcess.serialize() for d in datas]
        sameFile = all(sameFiles)
        sameRestore = np.array_equal(cliRestored, decompressTiled(engine, tf))
        tiles, rows, cols = toTiles(img, TILE)
        files = [engine.compressImage(t) for t in tiles]
        streamsEqual = [sum(f.Content == b for f, b in zip(files, TiledFile.deserialize(d).binaries))
                        for d in datas]
        sameStreams = min(streamsEqual)
        together = fromTiles(engine.decompress([f.Content for f in files],
                                               [f.FileHeader for f in files], toImage=True),
                             rows, cols, *img.shape[:2])
        oneByOne = fromTiles(np.stack([engine.decompressImage(f) for f in files]), rows, cols,
                             *img.shape[:2])
        diff = np.abs(oneByOne.astype(np.int16) - cliRestored.astype(np.int16))
        print(f"  --tile {TILE} CLI in {TILED_PROCESSES} fresh processes: {rows}x{cols} tiles, "
              f"{tf.BPP:.4f} bpp, PSNR {psnr(img, cliRestored):.2f} dB; each .mcq identical to "
              f"in-process: {sameFiles}; restore equal to in-process: {sameRestore}. The tiles "
              f"coded whole (batch 1): {streamsEqual} of {len(files)} streams identical in each "
              f"process's file; restored as one batch, pixels equal: "
              f"{np.array_equal(together, cliRestored)}; restored one by one, pixels equal on "
              f"{(diff == 0).mean():.6%}, max diff {int(diff.max())}"
              + ("" if sameFile else
                 f"; in-process against the CLI's: streams equal "
                 f"{[sum(a == b for a, b in zip(inProcess.binaries, TiledFile.deserialize(d).binaries)) for d in datas]} "
                 f"of {len(tf.binaries)}, fields equal "
                 f"{[k for k in ('rows', 'cols', 'tile', 'height', 'width', 'qp', 'codeSize') if getattr(inProcess, k) == getattr(tf, k)]}"),
              flush=True)
        if not (TiledFile.isTiled(data) and sameFile and sameRestore and sameStreams == len(files)
                and np.array_equal(together, cliRestored) and diff.max() <= TILE_BATCH_MAX_DIFF):
            raise AssertionError("the tiled round trip disagrees")

    with Phase("8 Neon codec"), tempfile.TemporaryDirectory() as tmp, ExitStack() as stopAtExit:
        tmp = Path(tmp)
        export = writeSeededExport(tmp / "neon_v2_60k.npz", "Neon", NEON_V2_60K, seed=0, qp="-1")
        crop = img[128:384, 128:384]
        writePng(tmp / "crop.png", crop)
        # the --local CLI, in a subprocess beside the in-process work, joined at the end
        neonCli = subprocess.Popen([sys.executable, "-m", "mcquic_tpu_torch", "--local",
                                    str(export), str(tmp / "crop.png"), str(tmp / "cli.mcq")],
                                   cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True)
        stopAtExit.callback(stopProcess, neonCli)
        start = time.perf_counter()
        neonEngine = loadModel(local=export, device="cuda")
        print(f"  seeded Neon export at configs/rd5/neon_v2_60k.yaml's geometry {NEON_V2_60K}, "
              f"{export.stat().st_size / 1e6:.1f} MB, loaded in {time.perf_counter() - start:.2f} s",
              flush=True)
        neonEngine.decompressImage(neonEngine.compressImage(crop))           # warm-up
        searches = []
        originalEncode = quantizerModule.vqEncode

        def captureNeon(x, codebook):
            searches.append((latentTokens(x), codebook.float().contiguous()))
            return originalEncode(x, codebook)

        quantizerModule.vqEncode = captureNeon
        try:
            neonEngine.encode(crop[None])
        finally:
            quantizerModule.vqEncode = originalEncode
        with exactFp32(), torch.inference_mode():
            for level, (tokens, codebook) in enumerate(searches):
                n, _ = checkCodes(torch, tokens, codebook, vqNearest(tokens, codebook),
                                  vqEncodePlain(tokens, codebook),
                                  f"K1 Neon codec level {level} {tuple(tokens.shape)}")
                if n:
                    raise AssertionError(f"K1 differs from the plain version at Neon level {level}")
        vqNearest.launches = 0
        start = time.perf_counter()
        neonFile = neonEngine.compressImage(crop)
        neonCompressS = time.perf_counter() - start
        neonMcq = tmp / "crop.mcq"
        neonMcq.write_bytes(neonFile.serialize())
        neonCodecLaunches = vqNearest.launches
        start = time.perf_counter()
        neonRestored = neonEngine.decompressImage(File.deserialize(neonMcq.read_bytes()))
        neonRestoreS = time.perf_counter() - start
        cardCodes = neonEngine.encode(crop[None])
        cpuEngine = loadModel(local=export, device="cpu")
        cpuCodes = cpuEngine.encode(crop[None])
        agreement = (sum(int((a == c).sum()) for a, c in zip(cardCodes, cpuCodes))
                     / sum(a.size for a in cardCodes))
        print(f"  Neon 256x256 crop: {neonFile.BPP:.4f} bpp, PSNR {psnr(crop, neonRestored):.2f} dB "
              f"(seeded weights), K1 launches per compress {neonCodecLaunches}, compress "
              f"{neonCompressS * 1e3:.1f} ms, restore {neonRestoreS * 1e3:.1f} ms (host clock); "
              f"card vs CPU codes agree on {agreement:.4%} "
              f"({'identical' if agreement == 1 else 'not identical'})", flush=True)
        if (neonCodecLaunches != len(NEON_V2_60K["size"]) or neonRestored.shape != crop.shape
                or agreement < CODES_MIN_AGREEMENT):
            raise AssertionError("the Neon codec did not run as it should")
        del cpuEngine
        _, err = neonCli.communicate(timeout=CLI_TIMEOUT)
        if neonCli.returncode != 0:
            raise RuntimeError(f"Neon CLI exited {neonCli.returncode}:\n{err}")
        sameNeonFile = (tmp / "cli.mcq").read_bytes() == neonMcq.read_bytes()
        print(f"  Neon CLI --local: .mcq identical to the in-process one: {sameNeonFile}", flush=True)
        if not sameNeonFile:
            raise AssertionError("the Neon CLI wrote another file")
        del neonEngine
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for sub in ("p9", "p10", "p12", "p13"):
            (tmp / sub).mkdir()
        with Phase("9 stage-1 training"):
            trainTrace = train9(torch, np, tmp / "p9", img, smi, codec)
        with Phase("10 Neon training"):
            neonTrace = train10(torch, np, tmp / "p10", img, smi)
        with Phase("11 generator training"), ExitStack() as stopAtExit:
            genTrace = train11(torch, np, tmp / "p10", img, smi, neonTrace["checkpoint"], lengths,
                               stopAtExit)
        with Phase("12 data parallel"):
            ddpTrace = ddp12(torch, np, tmp / "p12", smi, str(tmp / "p9" / "shards" / "*.tar.gz"),
                             tmp / "p9" / "val", tmp / "p10" / "classes", neonTrace["checkpoint"])
        with Phase("13 GeneratorVAR"):
            varTrace = var13(torch, np, tmp / "p13", smi, neonTrace["checkpoint"],
                             tmp / "p10" / "classes", k3)
        try:
            with Phase("14 reference checkpoint"):
                (tmp / "p14").mkdir()
                toolTrace = tooling14(torch, np, tmp / "p14", img, smi)
            with Phase("15 web demo, denseNorm, text conditioning"):
                (tmp / "p15").mkdir()
                webTrace = web15(torch, np, tmp / "p15", img, smi, engine, photoCliMcq,
                                 photoCliRestored, progressiveMcq)
            with Phase("16 serving over a device list"):
                servingTrace = devices16(torch, np, img, smi, engine)
            with Phase("17 captions"):
                (tmp / "p17").mkdir()
                captionTrace = captions17(torch, np, tmp / "p17", smi, webTrace["text"].pop("state"))
        finally:
            with Phase("13 GeneratorVAR, its generate CLI"):
                finishVarCli(varTrace["cli"])

    kernels = [
        {"name": "vq_nearest", "route": "cuda", "source": "mcquic_tpu_torch/csrc/vq_encode.cu",
         "replaces": "mcquic_tpu/ops/vq_pallas.py:162", "launches": launches["K1"],
         "max_abs_err": k1["err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "device_ms": k1["device_ms"], "library_device_ms": k1["library_device_ms"],
         "bound_fp32_ms": k1["bound_fp32_ms"], "host_us": k1["host_us"],
         "library_host_us": k1["library_host_us"], "photo_rescored": k1["photo_rescored"],
         "neon_codec_launches": neonCodecLaunches,
         "train_validation_launches_per_image": trainTrace["K1"],
         "neon_train_validation_launches_per_image": neonTrace["K1"],
         "gen_train_launches_per_step": genTrace["K1"],
         "ddp_gen_launches_per_rank_step": ddpTrace["gen"]["K1"],
         "ddp_validation_launches_per_image": ddpTrace["rd_qp2"]["val"]["K1"],
         "var_train_launches_per_step": varTrace["K1_per_step"],
         "converted_reference_launches_per_compress": toolTrace["K1"],
         "handler_launches_per_compress": webTrace["handler"]["K1"],
         "dense_neon_launches_per_compress": webTrace["dense_neon"]["K1"],
         "device_list_launches_per_replica": [c["K1"] for c in servingTrace["launches"]],
         "past_budget_device_list_launches_per_replica":
             [c["K1"] for c in servingTrace["past_budget"]],
         "neon_device_ms": neonK1["device_ms"], "neon_ms": neonK1["ms"],
         "neon_library_device_ms": neonK1["library_device_ms"],
         "qp12_device_ms": qp12K1["device_ms"],
         "qp12_library_device_ms": qp12K1["library_device_ms"]},
        {"name": "vq_grouped", "route": "cuda", "source": "mcquic_tpu_torch/csrc/vq_grouped.cu",
         "replaces": "mcquic_tpu/ops/vq_pallas.py:75", "launches": pastLaunches["K1b"],
         "max_abs_err": k1b["err"], "ms": k1b["ms"], "plain_ms": k1b["plain_ms"],
         "bound_ms": k1b["bound_ms"], "bound_by": k1b["bound_by"], "library_ms": k1b["library_ms"],
         "device_ms": k1b["device_ms"], "library_device_ms": k1b["library_device_ms"],
         "device_list_launches_per_replica": [c["K1b"] for c in servingTrace["past_budget"]]},
        {"name": "thin_head", "route": "cuda", "source": "mcquic_tpu_torch/csrc/thin_head.cu",
         "replaces": "mcquic_tpu/ops/subpixel_pallas.py:118", "launches": launches["K2"],
         "max_abs_err": k2["err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "device_ms": k2["device_ms"], "library_device_ms": k2["library_device_ms"],
         "bound_fp32_ms": k2["bound_fp32_ms"], "host_us": k2["host_us"],
         "library_host_us": k2["library_host_us"], "batch_device_ms": k2Batch["device_ms"],
         "train_validation_launches_per_image": trainTrace["K2"],
         "ddp_validation_launches_per_image": ddpTrace["rd_qp2"]["val"]["K2"],
         "converted_reference_launches_per_restore": toolTrace["K2"],
         "handler_launches_per_compress_and_preview": webTrace["handler"]["K2"],
         "device_list_launches_per_replica": [c["K2"] for c in servingTrace["launches"]],
         "batch_library_device_ms": k2Batch["library_device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "mcquic_tpu_torch/csrc/flash_attention.cu",
         "replaces": "mcquic_tpu/ops/attention_pallas.py:144", "launches": k3["launches"],
         "max_abs_err": k3["err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "device_ms": k3["device_ms"], "library_device_ms": k3["library_device_ms"],
         "bound_fp32_ms": k3["bound_fp32_ms"], "after_gen_train_launches": genTrace["K3_after"],
         "gen_train_launches_per_step": genTrace["K3_in_step"],
         "var_launches_per_generate": varTrace["K3_per_generate"],
         "text_conditioned_launches_per_generate": webTrace["text"]["K3"],
         "var_shape_b_h_tq_tk_d": varTrace["k3"]["shape"], "var_ms": varTrace["k3"]["ms"],
         "var_device_ms": varTrace["k3"]["device_ms"], "var_plain_ms": varTrace["k3"]["plain_ms"],
         "var_bound_ms": varTrace["k3"]["bound_ms"], "var_bound_by": varTrace["k3"]["bound_by"],
         "var_bound_fp32_ms": varTrace["k3"]["bound_fp32_ms"],
         "var_library_ms": varTrace["k3"]["library_ms"],
         "var_library_device_ms": varTrace["k3"]["library_device_ms"],
         "caption_encoder_launches_per_encode": captionTrace["encoder"]["K3"],
         "caption_generate_launches": captionTrace["generate"]["K3"],
         "caption_shape_b_h_tq_tk_d": captionTrace["k3"]["shape"],
         "caption_ms": captionTrace["k3"]["ms"],
         "caption_device_ms": captionTrace["k3"]["device_ms"],
         "caption_plain_ms": captionTrace["k3"]["plain_ms"],
         "caption_plain_device_ms": captionTrace["k3"]["plain_device_ms"],
         "caption_bound_ms": captionTrace["k3"]["bound_ms"],
         "caption_bound_by": captionTrace["k3"]["bound_by"],
         "caption_bound_fp32_ms": captionTrace["k3"]["bound_fp32_ms"],
         "caption_library_ms": captionTrace["k3"]["library_ms"],
         "caption_library_device_ms": captionTrace["k3"]["library_device_ms"]},
    ]
    print(f"chip_smoke: phases 1-17 in {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddpWorker(sys.argv[2:]))
    if sys.argv[1:2] == ["--multi-card"]:
        sys.exit(multiCard())
    sys.exit(main())
