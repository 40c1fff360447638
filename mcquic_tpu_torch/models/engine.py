"""CompressorEngine: the codec object tying the model, the rANS coder and the
`.mcq` container together (counterpart of `mcquic_tpu/models/engine.py`,
reference `mcquic/modules/compressor.py:67-117`). It takes the v1
`Compressor` (m groups and k per level) or the `Neon` tokenizer (m 1 and
its one k at each of its levels, codes small -> large), as the JAX engine
does (`engine.py:78-83`).

The engine leaves the module it is given as it was: its mode and its
parameters' `requires_grad` are the caller's (a trainer validates its live
model), since the codec's device work runs under `torch.inference_mode`,
where neither matters.

Device work runs under `utils.exactFp32` (fp32, TF32 off) and
`torch.inference_mode`. Host <-> device traffic is one array each way:
  * encode uploads the reflect-padded image, uint8 (normalized on the device,
    `engine.py:118-124`) or float in [-1, 1] (uploaded as it is,
    `engine.py:175-181`); the codes of all levels come back as one packed
    16-bit array (`engine.py:97`);
  * decode uploads the packed codes, widens them on the device, decodes,
    and, for an image, converts to uint8 on the device (`engine.py:232-234`).
On the card both directions go through pinned host memory with
non-blocking copies, and a download is waited for through its own event,
so `compressMany` / `decompressMany` can run the host rANS of one batch on
a worker thread (the rANS library is a ctypes `CDLL`, whose calls release
the GIL) while the card works on the next.

Given a list of `devices`, one process serves a batch data-parallel over
them, the counterpart of the JAX engine's `mesh=` (`engine.py:49-76`,
`_putBatch` at `:101-110`): one replica of the model per entry (an entry may
repeat, as in `["cuda:0", "cuda:0"]`), each on its own CUDA stream. A batch
whose rows divide the list is split along its rows: every part is uploaded,
encoded or decoded and downloaded on its replica, all of them launched
before any is waited for, and the codes or images are gathered in order.
Any other batch runs whole on the first replica, which gives the one-device
result, as the JAX engine's replicated placement does.

While `torch.profiler` records, each batch leaves spans (`utils/tracing.py`):
`engine.encodeDispatch` / `engine.decodeDispatch` around the host's part of
the device work (pad, upload, enqueue, start the download), and
`engine.ransEncode` / `engine.ransDecode` around the host rANS, each with
the batch's `images` and the `bytes` uploaded or of the streams. A batch's
rANS span is linked to its dispatch (the encode's cause, the decode's
effect) and shares its batch id, also from `compressMany`'s worker thread.
"""
import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

import mcquic_tpu_torch
from mcquic_tpu_torch.coding import RansCoder
from mcquic_tpu_torch.container import File, FileHeader, ImageSize
from mcquic_tpu_torch.data.transforms import alignedPadding, centerCropTo
from mcquic_tpu_torch.models.compressor import Compressor, Neon
from mcquic_tpu_torch.utils import exactFp32, resolveDevice, tracing


ALIGN = 128          # pad to multiples of 128, as the reference does (transforms.py:81-99)


def _toU16Bits(codes: torch.Tensor) -> torch.Tensor:
    """int codes in [0, 65536) -> int16 with the same 16 bits (host views them as uint16)."""
    codes = codes.to(torch.int32)
    return torch.where(codes >= 32768, codes - 65536, codes).to(torch.int16)


def _streamBytes(binaries: List[List[bytes]]) -> int:
    return sum(len(b) for image in binaries for b in image)


class _InFlight(NamedTuple):
    """Device results on their way to the host, one per replica that took a
    part of the batch: the host tensors they land in, the events recorded
    after their copies (None on the CPU), and the dispatch's span (None
    unless a profiler records). `wait` gathers them in order along the rows."""
    hosts: List[torch.Tensor]
    events: List[Optional[torch.cuda.Event]]
    span: Optional[tracing.Span] = None

    def wait(self) -> np.ndarray:
        for event in self.events:
            if event is not None:
                event.synchronize()
        if len(self.hosts) == 1:
            return self.hosts[0].numpy()
        return np.concatenate([h.numpy() for h in self.hosts])


class CompressorEngine:
    """Owns a v1 `Compressor` or a `Neon` on a device, or one replica of it
    on each of a list of devices; exposes encode/decode, compress/decompress,
    their pipelined multi-batch forms and the image-level
    compressImage/decompressImage."""

    def __init__(self, model, qp: str = "-1", device="cuda", devices: Optional[Sequence] = None):
        self._devices = [resolveDevice(d) for d in (devices or [device])]
        self._device = self._devices[0]
        self._replicas = [model.to(self._device)] + [copy.deepcopy(model).to(d)
                                                     for d in self._devices[1:]]
        self._model = self._replicas[0]
        # with several replicas, each launches on a stream of its own
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" and len(self._devices) > 1
                         else None for d in self._devices]
        self._qp = qp
        if isinstance(model, Neon):
            self._m, self._k = [1] * len(model.size), [model.k] * len(model.size)
        elif isinstance(model, Compressor):
            self._m, self._k = [model.m] * len(model.k), list(model.k)
        else:
            raise TypeError(f"Unknown compressor module {type(model)}")
        if max(self._k) > 1 << 16:
            raise ValueError("codes are carried in 16 bits; k must be <= 65536")
        self._coder = RansCoder(self._m, self._k)
        self.refreshFreq()

    @property
    def model(self):
        return self._model

    @property
    def replicas(self) -> List[torch.nn.Module]:
        """The model on each device of the list, the first being `model`."""
        return list(self._replicas)

    @property
    def coder(self) -> RansCoder:
        return self._coder

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    @property
    def QuantizationParameter(self) -> str:
        return self._qp

    def updateModel(self, stateDict: dict):
        """New weights into every replica, then the rANS tables from their
        frequencies (`updateVariables`, `engine.py:139-145`)."""
        for replica in self._replicas:
            replica.load_state_dict(stateDict, strict=True)
        self.refreshFreq()

    def refreshFreq(self):
        """Install a copy of the model's code frequencies as the rANS tables;
        the CDFs are rebuilt at the next use (`engine.py:147-151`)."""
        self._coder.updateFreq([f.detach().cpu().double().numpy().copy()
                                for f in self._model._quantizer.frequencies()])

    # ------------------------------------------------------------ transfers
    def _parts(self, n: int) -> List[Tuple[int, slice]]:
        """(replica, rows) of a batch of n: one part per replica where n
        divides among them, else the whole batch on the first."""
        count = len(self._replicas)
        if count == 1 or n % count:
            return [(0, slice(0, n))]
        size = n // count
        return [(i, slice(i * size, (i + 1) * size)) for i in range(count)]

    @contextlib.contextmanager
    def _on(self, i: int):
        """Run on replica i's device and stream, which first waits for the
        work already queued on its device (the weights' copies)."""
        stream = self._streams[i]
        if stream is None:
            yield
            return
        stream.wait_stream(torch.cuda.current_stream(self._devices[i]))
        with torch.cuda.device(self._devices[i]), torch.cuda.stream(stream):
            yield

    def _upload(self, array: np.ndarray, device: torch.device) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array))
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host

    @staticmethod
    def _download(tensor: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start the copy to the host on the current stream of the tensor's
        device, and record an event there after it."""
        if tensor.device.type != "cuda":
            return tensor, None
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        host.copy_(tensor, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(tensor.device))
        return host, event

    # ----------------------------------------------------------------- codec
    def _encodeDispatch(self, x: np.ndarray) -> Tuple[_InFlight, List[Tuple[int, ...]]]:
        """Upload, encode and start the download of the packed codes, on
        every replica that takes a part; returns without waiting for the
        card."""
        x = np.asarray(x)
        if x.ndim != 4:
            raise ValueError(f"encode takes [n, h, w, c] images, got {x.shape}")
        with tracing.span("engine.encodeDispatch", images=x.shape[0]) as record:
            x = alignedPadding(x if x.dtype == np.uint8 else x.astype(np.float32, copy=False),
                               ALIGN)
            if record is not None:
                record.counts["bytes"] = x.nbytes
            hosts, events = [], []
            for i, rows in self._parts(x.shape[0]):
                model, device = self._replicas[i], self._devices[i]
                dtype = next(model.parameters()).dtype
                with self._on(i), exactFp32(), torch.inference_mode():
                    xDev = self._upload(x[rows], device)
                    if xDev.dtype == torch.uint8:
                        xDev = (xDev.float() / 255.0 - 0.5) * 2.0
                    codes = model.encode(xDev.to(dtype).permute(0, 3, 1, 2))
                    packed = torch.cat([_toU16Bits(c.reshape(c.shape[0], -1)) for c in codes], 1)
                    host, event = self._download(packed)
                hosts.append(host)
                events.append(event)
        return _InFlight(hosts, events, record), [tuple(c.shape[1:]) for c in codes]

    @staticmethod
    def _splitCodes(packed: np.ndarray, shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
        """The packed codes [n, sum] -> per level [n, *shape]."""
        packed = packed.view(np.uint16)
        out, cur = [], 0
        for shape in shapes:
            size = int(np.prod(shape))
            out.append(packed[:, cur:cur + size].reshape(-1, *shape).astype(np.int32))
            cur += size
        return out

    def encode(self, x: np.ndarray) -> List[np.ndarray]:
        """NHWC images, uint8 or float in [-1, 1] -> codes per level
        [n, m, h, w] int32. The images are reflect-padded to multiples of
        ALIGN; uint8 is mapped to [-1, 1] on the device, float is uploaded as
        float32 and cast to the model's type."""
        inFlight, shapes = self._encodeDispatch(x)
        return self._splitCodes(inFlight.wait(), shapes)

    def _decodeDispatch(self, codes: Sequence[np.ndarray], toImage: bool,
                        parent: Optional[tracing.Span] = None) -> _InFlight:
        """Upload the packed codes, decode and start the download, on every
        replica that takes a part. `parent`: the span of the rANS decode
        that gave the codes."""
        n = codes[0].shape[0]
        with tracing.span("engine.decodeDispatch", parent, images=n) as record:
            packed = np.concatenate([np.asarray(c).reshape(n, -1) for c in codes], 1)
            packed = packed.astype(np.uint16).view(np.int16)
            if record is not None:
                record.counts["bytes"] = packed.nbytes
            hosts, events = [], []
            for i, rows in self._parts(n):
                with self._on(i), exactFp32(), torch.inference_mode():
                    flat = self._upload(packed[rows], self._devices[i]).to(torch.int64) & 0xFFFF
                    levels, cur = [], 0
                    for c in codes:
                        size = int(np.prod(c.shape[1:]))
                        levels.append(flat[:, cur:cur + size].reshape(-1, *c.shape[1:]))
                        cur += size
                    y = self._replicas[i].decode(levels)
                    if toImage:
                        y = torch.clamp(torch.round((y * 0.5 + 0.5) * 255.0), 0, 255).to(
                            torch.uint8)
                    host, event = self._download(y.permute(0, 2, 3, 1).contiguous())
                hosts.append(host)
                events.append(event)
        return _InFlight(hosts, events, record)

    def decode(self, codes: Sequence[np.ndarray], toImage: bool = False) -> np.ndarray:
        """codes per level [n, m, h, w] -> restored NHWC, still padded: float
        in [-1, 1], or uint8 when toImage."""
        return self._decodeDispatch(codes, toImage).wait()

    def _entropyCode(self, codes: List[np.ndarray], shape, parent: Optional[tracing.Span] = None
                     ) -> Tuple[List[List[bytes]], List[FileHeader]]:
        """rANS-encode a batch's codes; `parent`: the span of its dispatch."""
        n, h, w, c = shape
        with tracing.span("engine.ransEncode", parent, images=n) as record:
            binaries, codeSizes = self._coder.compress(codes)
            if record is not None:
                record.counts["bytes"] = _streamBytes(binaries)
            headers = [FileHeader(mcquic_tpu_torch.__version__, self._qp, cs, ImageSize(h, w, c))
                       for cs in codeSizes]
        return binaries, headers

    def _ransDecode(self, binaries: List[List[bytes]], headers: List[FileHeader]
                    ) -> Tuple[List[np.ndarray], Optional[tracing.Span]]:
        """rANS-decode a batch's streams -> (codes per level, the span)."""
        with tracing.span("engine.ransDecode", images=len(binaries)) as record:
            if record is not None:
                record.counts["bytes"] = _streamBytes(binaries)
            codes = self._coder.decompress(binaries, [h.CodeSize for h in headers])
        return codes, record

    def compress(self, x: np.ndarray) -> Tuple[List[np.ndarray], List[List[bytes]], List[FileHeader]]:
        """NHWC images (uint8, or float in [-1, 1]) -> (codes,
        binaries[n][level], headers[n])."""
        inFlight, shapes = self._encodeDispatch(x)
        codes = self._splitCodes(inFlight.wait(), shapes)
        return (codes, *self._entropyCode(codes, np.shape(x), inFlight.span))

    def decompress(self, binaries: List[List[bytes]], headers: List[FileHeader],
                   toImage: bool = False) -> np.ndarray:
        """Entropy-decode, decode, center-crop to the recorded size."""
        codes, record = self._ransDecode(binaries, headers)
        ims = headers[0].ImageSize
        return centerCropTo(self._decodeDispatch(codes, toImage, record).wait(),
                            ims.height, ims.width)

    # ------------------------------------------------------------- pipelined
    def compressMany(self, batches: Iterable[np.ndarray]
                     ) -> List[Tuple[List[List[bytes]], List[FileHeader]]]:
        """Pipelined multi-batch compression (`engine.py:262-316`): batch i's
        codes are entropy-coded on a worker thread while the card encodes
        batch i+1. Returns (binaries, headers) per batch, the same as
        `compress` once per batch."""
        jobs, pending = [], None
        with ThreadPoolExecutor(1) as worker:
            for x in batches:
                x = np.asarray(x)
                inFlight = self._encodeDispatch(x)
                if pending is not None:
                    jobs.append(self._submitRans(worker, *pending))
                pending = (inFlight, x.shape)
            if pending is not None:
                jobs.append(self._submitRans(worker, *pending))
            return [job.result() for job in jobs]

    def _submitRans(self, worker, encoded, shape):
        inFlight, levelShapes = encoded
        return worker.submit(self._entropyCode, self._splitCodes(inFlight.wait(), levelShapes),
                             shape, inFlight.span)

    def decompressMany(self, items: Iterable[Tuple[List[List[bytes]], List[FileHeader]]]
                       ) -> List[np.ndarray]:
        """Pipelined multi-batch decompression (`engine.py:318-340`): the host
        rANS decode of batch i+1 overlaps the card's decode of batch i.
        items: (binaries[n][level], headers[n]) per batch; returns the
        restored float NHWC batches, cropped to their recorded sizes."""
        results, pending = [], None
        for binaries, headers in items:
            codes, record = self._ransDecode(binaries, headers)
            inFlight = self._decodeDispatch(codes, False, record)
            if pending is not None:
                results.append(self._cropped(*pending))
            pending = (inFlight, headers)
        if pending is not None:
            results.append(self._cropped(*pending))
        return results

    @staticmethod
    def _cropped(inFlight: _InFlight, headers: List[FileHeader]) -> np.ndarray:
        ims = headers[0].ImageSize
        return centerCropTo(inFlight.wait(), ims.height, ims.width)

    # -------------------------------------------------------------- wrappers
    def compressImage(self, img: np.ndarray) -> File:
        """uint8 HWC image -> `.mcq` File."""
        _, binaries, headers = self.compress(np.asarray(img, np.uint8)[None])
        return File(headers[0], binaries[0])

    def decompressImage(self, file: File) -> np.ndarray:
        """`.mcq` File -> uint8 HWC image."""
        return self.decompress([file.Content], [file.FileHeader], toImage=True)[0]
