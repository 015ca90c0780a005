"""Host data loader: counterpart of ``ocpg_tpu/data/loader.py``.

``ClipLoader`` reads clips through a dataset reader, transforms them, pads
them to one fixed canvas and batches them, in a pool of threads (the
decode and the numpy transforms release the GIL).  An epoch is
deterministic: the order is shuffled from ``seed + epoch``, each worker
draws from ``random.Random(seed * 1000 + epoch * 17 + worker_id)`` and a
reorder buffer yields the batches in index order whatever the threads'
timing.  Train epochs drop the remainder; eval epochs pad the tail batch
by repeating its last sample and say ``real_count``.  The tokenizer is the
port's ``models/text_encoder.SimpleTokenizer``.

``decompress_batch`` is the compact wire's inverse, on the batch's device:
a compact batch carries un-normalised uint8 RGB frames, binary uint8 masks
and float16 heatmaps, about a third of the bytes of a float32 batch; the
train step moves it to the device as it is and expands it there.
"""

from __future__ import annotations

import os
import queue as queue_mod
import random
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.text_encoder import SimpleTokenizer
from .transforms import (IMAGENET_MEAN, IMAGENET_STD, _resize_clip, canvas_for,
                         pad_to_canvas, train_transform, val_transform)


class ClipLoader:
    """Iterates (epoch-seeded, optionally sharded) batches of fixed shape."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        tokenizer: Optional[SimpleTokenizer] = None,
        canvas: Optional[Tuple[int, int]] = None,
        train: bool = True,
        seed: int = 42,
        shard_index: int = 0,
        shard_count: int = 1,
        num_workers: Optional[int] = None,
        max_text_len: int = 32,
        text_vocab: Optional[int] = None,
        compact: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.canvas = canvas or canvas_for()
        self.train = train
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        if num_workers is None:
            # decode threads beyond the host's cores slow the loader down
            # (oversubscription); cap at the cores and at 4, the reference
            # DataLoader's worker count
            num_workers = max(1, min(4, os.cpu_count() or 1))
        self.num_workers = num_workers
        # compact wire: uint8 frames and masks, f16 heatmaps, ImageNet
        # normalisation on the device (decompress_batch)
        self.compact = compact
        if tokenizer is None:
            # A default-vocab (50265) hash tokenizer paired with a smaller
            # cfg.text_vocab would emit out-of-range ids -> NaN embeddings
            # with no error; force the caller to state the model's vocab.
            if text_vocab is None:
                raise ValueError(
                    "ClipLoader needs tokenizer= or text_vocab=cfg.text_vocab "
                    "(the hash-fallback tokenizer must match the model vocab)")
            tokenizer = SimpleTokenizer(max_len=max_text_len,
                                        vocab_size=text_vocab)
        self.tokenizer = tokenizer

    def _load_one(self, idx: int, rng: random.Random) -> Dict[str, np.ndarray]:
        # retry until a clip has a valid frame, as the reference's readers do
        for _ in range(20):
            rec = self.dataset.get_clip(idx, rng)
            clip = rec.clip
            orig_size = clip.size                      # dataset-native (h, w)
            orig_masks = None if self.train else clip.masks.astype(np.uint8)
            # the worker's seeded rng drives the transforms too — otherwise
            # they'd fall back to the global `random` module (thread-shared,
            # run-to-run nondeterministic)
            clip = (train_transform(clip, rng=rng,
                                    normalize_images=not self.compact)
                    if self.train else
                    val_transform(clip, normalize_images=not self.compact))
            # fit-to-canvas guard: the transform's shorter-side scales cap the
            # LONGER side at max_size, so a portrait-aspect crop can exceed
            # the canvas height (e.g. 563x448 vs 512x640).  The reference
            # pads to the batch's largest clip and never cares; a fixed
            # canvas must downscale such clips to fit.
            ch, cw = self.canvas
            h, w = clip.size
            if h > ch or w > cw:
                scale = min(ch / h, cw / w)
                clip = _resize_clip(
                    clip, (max(1, int(h * scale)), max(1, int(w * scale))))
            if clip.valid.any() or not self.train:
                entry = pad_to_canvas(clip, self.canvas, compact=self.compact)
                entry["targets"]["orig_size"] = np.asarray(orig_size, np.int32)
                if orig_masks is not None:
                    # native-resolution GT for eval (the reference scores
                    # predictions against the dataset's own annotations);
                    # ragged, so carried outside the stacked target arrays
                    entry["orig_masks"] = orig_masks
                if rec.valid_indices is not None:
                    entry["valid_indices"] = np.asarray(rec.valid_indices, np.int32)
                return entry
            idx = rng.randrange(len(self.dataset))
        raise RuntimeError("no valid sample found after 20 retries")

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Epoch-seeded shuffled shard iteration (the reference's
        DistributedSampler semantics)."""
        rng = random.Random(self.seed + epoch)
        order = list(range(len(self.dataset)))
        if self.train:
            rng.shuffle(order)
        order = order[self.shard_index::self.shard_count]
        # static batch shapes: train drops the remainder (one fewer step);
        # eval must cover every sample, so the tail batch is padded by
        # repeating the last sample and carries "real_count" for the eval
        # loops to slice on
        n_batches = len(order) // self.batch_size
        tail = len(order) - n_batches * self.batch_size
        if not self.train and tail:
            n_batches += 1
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that still honours `stop`: a worker blocked in a
            # plain q.put() would never observe stop when the consumer
            # abandons the generator mid-epoch, leaking threads + batch memory
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker(worker_id: int):
            wrng = random.Random(self.seed * 1000 + epoch * 17 + worker_id)
            try:
                for bi in range(worker_id, n_batches, self.num_workers):
                    if stop.is_set():
                        return
                    idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                    real = len(idxs)
                    idxs = idxs + [idxs[-1]] * (self.batch_size - real)
                    entries = [self._load_one(i, wrng) for i in idxs]
                    batch = self._collate(entries)
                    if real < self.batch_size:
                        batch["real_count"] = real
                    if not put((bi, batch)):
                        return
                put((None, None))
            except BaseException as e:  # propagate instead of deadlocking epoch()
                put((None, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for th in threads:
            th.start()
        # reorder buffer: yield batches in index order so an epoch is fully
        # deterministic regardless of worker scheduling (the consumer always
        # drains the queue, so `pending` — not the bounded queue — absorbs
        # out-of-order completions and workers never deadlock)
        pending: Dict[int, Dict] = {}
        next_bi = 0
        finished = 0
        try:
            while next_bi < n_batches:
                if next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
                    continue
                if finished == self.num_workers:
                    raise RuntimeError(
                        f"loader workers exited with batch {next_bi} missing")
                bi, batch = q.get()
                if bi is None:
                    if isinstance(batch, BaseException):
                        raise batch
                    finished += 1
                    continue
                pending[bi] = batch
        finally:
            stop.set()

    def _collate(self, entries) -> Dict[str, np.ndarray]:
        captions = [e["caption"] for e in entries]
        ids, attn = self.tokenizer(captions)
        batch = {
            "samples": np.stack([e["samples"] for e in entries]),
            "samples_mask": np.stack([e["samples_mask"] for e in entries]),
            "text_ids": ids,
            "text_mask": attn,
            "targets": {
                k: np.stack([e["targets"][k] for e in entries])
                for k in entries[0]["targets"]
            },
        }
        if "valid_indices" in entries[0]:
            batch["valid_indices"] = np.stack([e["valid_indices"] for e in entries])
        if "orig_masks" in entries[0]:
            batch["orig_masks"] = [e["orig_masks"] for e in entries]  # ragged
        return batch


def normalize_frames(samples: torch.Tensor, samples_mask: torch.Tensor) -> torch.Tensor:
    """uint8 RGB frames -> ImageNet-normalised float32 on their device, with
    the canvas padding (``samples_mask``) zeroed again in normalised space,
    as the reference pads zeros after normalising; other frames as they are."""
    if samples.dtype != torch.uint8:
        return samples
    mean = torch.from_numpy(IMAGENET_MEAN).to(samples.device)
    std = torch.from_numpy(IMAGENET_STD).to(samples.device)
    x = (samples.float() / 255.0 - mean) / std
    return torch.where(samples_mask[..., None], 0.0, x)


def decompress_batch(batch: Dict) -> Dict:
    """The compact wire's inverse, on the batch's own device: uint8 RGB
    becomes ImageNet-normalised float32 (``normalize_frames``); non-float32
    masks, weights and weak_masks become float32.  A float32 batch comes
    back unchanged."""
    b = dict(batch)
    t = dict(b["targets"])
    b["samples"] = normalize_frames(b["samples"], b["samples_mask"])
    for k in ("masks", "weights", "weak_masks"):
        if k in t and t[k].dtype != torch.float32:
            t[k] = t[k].float()
    b["targets"] = t
    return b
