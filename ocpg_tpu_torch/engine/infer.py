"""Static-shape clip inference engine: counterpart of
``ocpg_tpu/engine/infer.py``.

Requests are padded to a small set of canvas buckets and a fixed clip
length and batched ``slots`` at a time into one forward.  Over a data mesh
(``mesh``, ``parallel/mesh.py``) a dispatch group has ``world x
per_device_batch`` slots: each rank runs its ``per_device_batch`` rows of
every group, idle slots get padding clips so every rank dispatches in
lockstep, and the outputs are gathered (``gather_rows``) before the
readback, so ``run()`` returns every request's masks on every rank, in
order, as JAX's ``run`` does.  Without a mesh ``slots`` and ``device`` say
the group size and the device.  uint8 frames are
normalised on the device, with the canvas padding zeroed again in
normalised space.  Up to ``pipeline_depth`` groups are in flight: each
group's outputs are copied back to pinned host memory behind its forward,
and the host waits for group i-1's copy only after it has dispatched
group i, so assembling and uploading a group overlaps the device's work.

Within one ``run()`` a group whose rows (this rank's, padding rows as
None) carry the very ``frames`` objects of the previous group's, on the
same canvas, reuses that group's device canvas, its mask and the model's
backbone results (``models/ocpg.py::VisualFeatures``): it assembles and
uploads only the text, sizes and query overrides, and the model skips its
backbone.  The expressions of one video, sent as requests on one frames
array, so run the backbone once.  Nothing is kept past ``run()``, so a
caller that refills one array between calls is never served stale
features, and the outputs are those of running every group in full.

Under a profiler, ``run()`` marks its spans (``utils/profiling.py``):
``ocpg.engine.run``, and per group ``ocpg.engine.dispatch`` (with
``ocpg.engine.assemble`` and ``ocpg.engine.upload`` inside) and
``ocpg.engine.drain`` (with ``ocpg.engine.wait`` inside).  Every dispatch
adds its requests' frames x rows x columns to ``pixels_real`` and its
canvas, slots x ``clip_len`` x the bucket, to ``pixels_dispatched``, and
one to ``backbone_runs`` or, where it reused the previous group's
backbone results, to ``backbone_reused``.

Usage:
    engine = ClipInferenceEngine(model, clip_len=36)
    results = engine.run(requests)     # list[InferRequest] -> list[np (t,h,w)]
"""

from __future__ import annotations

import collections
import dataclasses
import math
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.loader import normalize_frames
from ..models.build import resolve_device
from ..models.ocpg import VisualFeatures
from ..parallel.mesh import gather_rows
from ..utils.profiling import span

# /64-aligned canvases at the reference inference scale (Resize 360, max
# 640): landscape (384, 640), square-ish (512, 640), portrait (640, 512)
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = ((384, 640), (512, 640), (640, 512))

# pixels (frames x rows x columns) since the last reset (set them to 0 to
# reset): of the requests dispatched, and of the canvases they ran on
pixels_real = 0
pixels_dispatched = 0
# dispatches since the last reset that ran the backbone, and that reused
# the previous group's backbone results
backbone_runs = 0
backbone_reused = 0


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: through pinned memory, asynchronously, on the GPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def readback(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: into pinned memory, asynchronously, from the GPU
    (wait on an event recorded after it before reading it)."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)
    return t


@dataclasses.dataclass
class InferRequest:
    # (t, h, w, 3), t <= clip_len: un-normalised uint8 RGB (normalised on the
    # device) or already-normalised float32 (passed through)
    frames: np.ndarray
    text_ids: np.ndarray      # (Lt,) int32
    text_mask: np.ndarray     # (Lt,) int32
    # DAVIS/YTVOS branch only: >= 0 forces that decoder query; -1 = argmax
    query_override: int = -1


def pick_bucket(h: int, w: int,
                buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest-area bucket that holds (h, w); else a /64-aligned exact canvas."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    return (-(-h // 64) * 64, -(-w // 64) * 64)


@dataclasses.dataclass
class _Clips:
    """A dispatched group's visual side: its canvas, this rank's frames
    arrays (None for a padding row), their device canvas and mask, and the
    model's backbone results on them."""
    bucket: Tuple[int, int]
    frames: List[Optional[np.ndarray]]
    x: torch.Tensor
    m: torch.Tensor
    visual: VisualFeatures

    def holds(self, bucket, frames) -> bool:
        return self.bucket == bucket and all(a is b for a, b in zip(self.frames, frames))


class ClipInferenceEngine:
    """Batches clip requests over the mesh (or on one device) with bucketed
    static shapes."""

    def __init__(self, model, clip_len: int = 36,
                 buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
                 slots: int = 1,
                 out_dtype: torch.dtype = torch.float32,
                 pipeline_depth: int = 2,
                 want_ref_points: bool = False,
                 max_exact_shapes: int = 4,
                 want_query_scores: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None, per_device_batch: int = 1):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type:
            raise ValueError(f"model is on {model_dev}, engine on {self.device}")
        self.model = model
        self.clip_len = clip_len
        self.buckets = tuple(buckets)
        # requests per dispatch: this rank's rows (local) of the group (slots)
        self.local_slots = max(1, per_device_batch) if mesh is not None else max(1, slots)
        self.slots = self.local_slots * (mesh.size if mesh is not None else 1)
        # f32 by default, as the JAX engine; float16 halves the readback
        self.out_dtype = out_dtype
        self.pipeline_depth = max(1, pipeline_depth)
        self.want_ref_points = want_ref_points
        self.want_query_scores = want_query_scores
        self.last_ref_points: List[Optional[np.ndarray]] = []
        self.last_query_scores: List[Optional[np.ndarray]] = []
        self.last_canvas: List[Optional[Tuple[int, int]]] = []
        # exact mode (buckets=()) makes one canvas per distinct /64-aligned
        # request size; past max_exact_shapes distinct canvases, new shapes
        # use DEFAULT_BUCKETS, as in the JAX engine, so outputs match it
        self.max_exact_shapes = max_exact_shapes
        self._exact_fallback_warned = False
        self._canvases: set = set()
        self.n_batches = 0

    def _dispatch(self, requests, bucket, group, last: Optional[_Clips]):
        """Assemble, upload and enqueue this rank's rows of one group's
        forward, the gather of the group's outputs and their readback.
        ``last`` is the previous group's visual side, reused where this
        group's rows carry the same frames; returns this group's beside."""
        global pixels_real, pixels_dispatched, backbone_runs, backbone_reused
        bh, bw = bucket
        n = self.local_slots
        lo = (self.mesh.rank if self.mesh is not None else 0) * n
        rows = [requests[ridx] for ridx in group[lo:lo + n]]
        frames = [r.frames for r in rows] + [None] * (n - len(rows))
        reuse = last is not None and last.holds(bucket, frames)
        with span("ocpg.engine.assemble"):
            if not reuse:
                samples = np.zeros((n, self.clip_len, bh, bw, 3),
                                   requests[group[0]].frames.dtype)
                mask = np.ones((n, self.clip_len, bh, bw), bool)
                for j, r in enumerate(rows):
                    t, h, w = r.frames.shape[:3]
                    samples[j, :t, :h, :w] = r.frames
                    mask[j, :t, :h, :w] = False
            lt = requests[group[0]].text_ids.shape[-1]
            ids = np.full((n, lt), 1, np.int32)
            ids[:, 0] = 0
            attn = np.zeros((n, lt), np.int32)
            attn[:, 0] = 1
            sizes = np.ones((n, 2), np.int32)
            qov = np.full((n,), -1, np.int32)
            for j, r in enumerate(rows):
                ids[j] = r.text_ids
                attn[j] = r.text_mask
                sizes[j] = r.frames.shape[1:3]
                qov[j] = r.query_override
        pixels_real += sum(math.prod(requests[ridx].frames.shape[:3]) for ridx in group)
        pixels_dispatched += self.slots * self.clip_len * bh * bw
        dev = self.device
        with span("ocpg.engine.upload"):
            if reuse:
                clips = last
                backbone_reused += 1
            else:
                m = upload(mask, dev)
                clips = _Clips(bucket, frames, normalize_frames(upload(samples, dev), m), m,
                               VisualFeatures())
                backbone_runs += 1
            ids_d, attn_d, sizes_d, qov_d = (upload(a, dev) for a in (ids, attn, sizes, qov))
        out = self.model(clips.x, clips.m, ids_d, attn_d, sizes_d, query_override=qov_d,
                         visual=clips.visual)
        def gathered(t):
            return readback(t if self.mesh is None else gather_rows(self.mesh, t))

        ret = {"masks": gathered(out["pred_masks"].to(self.out_dtype))}
        if self.want_ref_points:
            ret["refs"] = gathered(out["reference_points"])
        if self.want_query_scores:
            ret["scores"] = gathered(out["query_scores"])
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.n_batches += 1
        return ret, event, clips

    def run(self, requests: Sequence[InferRequest],
            progress: Optional[Callable[[int], None]] = None) -> List[np.ndarray]:
        """Per request, the (t, h, w) best-query mask logits (float32),
        cropped to the request's frame count and size.  Consecutive groups
        on the same canvas whose rows carry the same ``frames`` objects run
        the backbone once (module docstring); the outputs are the same."""
        if not requests:
            return []
        with span("ocpg.engine.run"):
            return self._run(requests, progress)

    def _run(self, requests, progress):
        wire_dtype = requests[0].frames.dtype
        for i, r in enumerate(requests):
            if r.frames.dtype != wire_dtype:
                raise ValueError(
                    f"request {i} frames dtype {r.frames.dtype} != {wire_dtype}; "
                    "mix of compact-uint8 and normalized-f32 requests in one run()")

        exact_over_cap = False
        if not self.buckets:
            shapes = {pick_bucket(r.frames.shape[1], r.frames.shape[2], ())
                      for r in requests}
            if len(shapes | self._canvases) > self.max_exact_shapes:
                exact_over_cap = True
                if not self._exact_fallback_warned:
                    self._exact_fallback_warned = True
                    print(f"ClipInferenceEngine: >{self.max_exact_shapes} distinct "
                          "exact canvases observed; new shapes fall back to the "
                          "serving bucket trio (pass an explicit buckets list to "
                          "override)", file=sys.stderr)

        order: Dict[Tuple[int, int], List[int]] = {}
        for i, r in enumerate(requests):
            t = r.frames.shape[0]
            if t > self.clip_len:
                raise ValueError(f"request {i} has {t} frames > clip_len={self.clip_len}")
            h, w = r.frames.shape[1:3]
            bucket = pick_bucket(h, w, self.buckets)
            if exact_over_cap and bucket not in self._canvases:
                bucket = pick_bucket(h, w, DEFAULT_BUCKETS)
            order.setdefault(bucket, []).append(i)
        groups = [(bucket, idxs[base:base + self.slots])
                  for bucket, idxs in order.items()
                  for base in range(0, len(idxs), self.slots)]

        results: List[Optional[np.ndarray]] = [None] * len(requests)
        self.last_ref_points = [None] * len(requests)
        self.last_query_scores = [None] * len(requests)
        self.last_canvas = [None] * len(requests)

        def drain(group, ret, event):
            with span("ocpg.engine.drain"):
                with span("ocpg.engine.wait"):
                    if event is not None:
                        event.synchronize()
                masks = ret["masks"].numpy()
                refs = ret["refs"].numpy() if self.want_ref_points else None
                scores = ret["scores"].numpy() if self.want_query_scores else None
                for j, ridx in enumerate(group):
                    t, h, w = requests[ridx].frames.shape[:3]
                    results[ridx] = masks[j, :t, 0, :h, :w].astype(np.float32)
                    if refs is not None:
                        self.last_ref_points[ridx] = refs[j, :t, 0]
                    if scores is not None:
                        self.last_query_scores[ridx] = scores[j]
                if progress is not None:
                    progress(len(group))

        inflight = collections.deque()
        last = None
        for bucket, group in groups:
            self._canvases.add(bucket)
            for ridx in group:
                self.last_canvas[ridx] = bucket
            with span("ocpg.engine.dispatch"):
                ret, event, last = self._dispatch(requests, bucket, group, last)
                inflight.append((group, ret, event))
            if len(inflight) >= self.pipeline_depth:
                drain(*inflight.popleft())
        while inflight:
            drain(*inflight.popleft())
        return results  # type: ignore[return-value]

    @property
    def canvas_count(self) -> int:
        """Distinct canvases this engine has run (the JAX engine's compile count)."""
        return len(self._canvases)
