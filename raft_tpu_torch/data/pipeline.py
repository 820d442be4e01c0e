"""Input pipeline: augmented, prefetched training batches on the device.

Ported from the JAX package's ``raft_tpu/data/pipeline.py`` for one
process and ``window_size=1``:

  * deterministic epoch shuffling from a seed: epoch ``e`` is
    ``np.random.default_rng((seed, e)).permutation(len(dataset))``, and a
    pipeline started at ``start_step`` resumes that stream where the
    uninterrupted run was (its state is just ``(seed, step)``);
  * per-sample augmentation with ``default_rng((seed, 1 << 20, step,
    slot))`` on a thread pool, so the same seed gives the JAX pipeline's
    samples;
  * the data fault policy (``utils.faults.DataFaultPolicy``): transient
    errors retried, bad samples quarantined and their slots refilled, a
    budget that raises;
  * host batches in the JAX package's NHWC layout (:func:`collate`,
    :func:`normalize_images`), copied to the device from pinned memory
    with ``non_blocking=True`` and permuted to the port's NCHW on a
    prefetch thread (``utils.prefetch``), ``prefetch_depth`` batches
    ahead.

Stacked batch windows (``window_size > 1``) are not ported yet (ROADMAP
queue 1 item 2d).
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from raft_tpu_torch.data.augment import FlowAugmentor
from raft_tpu_torch.data.datasets import FlowDataset
from raft_tpu_torch.device import resolve_device
from raft_tpu_torch.utils.faults import BadSampleBudgetError, DataFaultPolicy
from raft_tpu_torch.utils.prefetch import prefetch

__all__ = ["TrainPipeline", "collate", "normalize_images", "to_device"]


def normalize_images(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """uint8-range images -> [-1, 1] float32 (model input contract)."""
    out = dict(batch)
    for k in ("image1", "image2"):
        out[k] = batch[k].astype(np.float32) / 255.0 * 2.0 - 1.0
    return out


def collate(samples) -> Dict[str, np.ndarray]:
    # "sparse" is a per-sample augmentation marker, not batch data
    keys = [k for k in samples[0].keys() if k != "sparse"]
    return {
        k: np.stack([np.asarray(s[k], np.float32) for s in samples]) for k in keys
    }


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (NHWC numpy) -> the step's batch on ``device``:
    images ``(B, 3, H, W)``, flow ``(B, 2, H, W)``, valid ``(B, H, W)``;
    on the card each array goes through pinned memory with a
    ``non_blocking`` copy."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        if t.ndim == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[key] = t
    return out


class TrainPipeline:
    """Infinite iterator of training batches on the device.

    Args:
        dataset: index-able ``FlowDataset``.
        global_batch_size: samples a batch.
        augmentor: per-sample augmentation (None = raw samples; the
            dataset's resolutions must then be uniform).
        seed: shuffling/augmentation seed.
        device: where batches go (the card unless ``'cpu'`` is named).
        start_step: resume point: the stream continues as the
            uninterrupted run would at this step.
        fault_policy: what a failing ``dataset[idx]`` does (None =
            propagate); ``counters`` holds ``data/skipped`` and
            ``data/retries`` for the trainer's log boundary.
        window_size: 1 only (stacked windows are not ported yet).
    """

    def __init__(
        self,
        dataset: FlowDataset,
        global_batch_size: int,
        *,
        augmentor: Optional[FlowAugmentor] = None,
        seed: int = 0,
        num_workers: int = 4,
        prefetch_depth: int = 2,
        device=None,
        start_step: int = 0,
        fault_policy: Optional[DataFaultPolicy] = None,
        window_size: int = 1,
    ):
        if window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {window_size}")
        if window_size > 1:
            raise NotImplementedError(
                "stacked batch windows (window_size > 1) are not ported yet: ROADMAP queue 1 item 2d"
            )
        self.dataset = dataset
        self.augmentor = augmentor
        self.seed = seed
        self.device = resolve_device(device)
        self.prefetch_depth = prefetch_depth
        self.num_workers = num_workers
        self.step = start_step
        self.fault_policy = fault_policy
        self.window_size = window_size
        self.counters: Dict[str, int] = {"data/skipped": 0, "data/retries": 0}
        self.quarantined: set = set()
        self._fault_lock = threading.Lock()
        self.global_batch_size = global_batch_size

    def _index_stream(self) -> Iterator[int]:
        """Deterministic infinite shuffled index stream: epoch ``e`` is
        ``default_rng((seed, e)).permutation(n)``."""
        n = len(self.dataset)
        epoch = 0
        # fast-forward for resume
        consumed = self.step * self.global_batch_size
        while True:
            rng = np.random.default_rng((self.seed, epoch))
            perm = rng.permutation(n)
            if consumed >= len(perm):
                consumed -= len(perm)
                epoch += 1
                continue
            for i in perm[consumed:]:
                yield int(i)
            consumed = 0
            epoch += 1

    def _quarantine_sample(self, idx: int, exc: BaseException) -> None:
        """Record a permanently bad sample; raise once over budget."""
        policy = self.fault_policy
        with self._fault_lock:
            new = idx not in self.quarantined
            self.quarantined.add(idx)
            self.counters["data/skipped"] += 1
            n_bad = len(self.quarantined)
        if new:
            print(
                f"data: quarantined sample {idx} "
                f"({type(exc).__name__}: {exc}); {n_bad} bad so far"
            )
        if n_bad > policy.max_bad_samples:
            raise BadSampleBudgetError(
                f"{n_bad} distinct bad samples exceed the budget of "
                f"{policy.max_bad_samples} (last: index {idx}: "
                f"{type(exc).__name__}: {exc})"
            ) from exc

    def _load_sample(self, idx: int):
        """``dataset[idx]`` under the fault policy; None = skipped.

        Transient errors retry with capped exponential backoff; parse
        errors fail fast (the bytes on disk will not change). Quarantined
        indices skip without touching storage again.
        """
        policy = self.fault_policy
        if policy is None:
            return self.dataset[idx]
        if idx in self.quarantined:
            with self._fault_lock:
                self.counters["data/skipped"] += 1
            return None
        delay = policy.base_delay
        attempt = 0
        while True:
            try:
                return self.dataset[idx]
            except policy.deterministic as e:
                if policy.mode == "raise":
                    raise
                self._quarantine_sample(idx, e)
                return None
            except policy.transient as e:
                if attempt >= policy.max_retries:
                    if policy.mode == "raise":
                        raise
                    self._quarantine_sample(idx, e)
                    return None
                attempt += 1
                with self._fault_lock:
                    self.counters["data/retries"] += 1
                time.sleep(
                    min(delay, policy.max_delay) * (1.0 + 0.25 * random.random())
                )
                delay *= 2.0

    def _make_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        stream = self._index_stream()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def load_one(args):
            step, slot, idx = args
            sample = self._load_sample(idx)
            if sample is None:
                return None
            if self.augmentor is not None:
                rng = np.random.default_rng((self.seed, 1 << 20, step, slot))
                sample = self.augmentor(rng, sample)
            return sample

        step = self.step
        try:
            while True:
                work = [(step, j, next(stream)) for j in range(self.global_batch_size)]
                samples = list(pool.map(load_one, work))
                # Fault policy: refill skipped slots from the stream
                for j, s in enumerate(samples):
                    while s is None:
                        if len(self.quarantined) >= len(self.dataset):
                            raise BadSampleBudgetError(
                                "every sample in the dataset is quarantined"
                            )
                        s = load_one((step, j, next(stream)))
                    samples[j] = s
                batch = normalize_images(collate(samples))
                yield batch
                step += 1
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self):
        source = (to_device(b, self.device) for b in self._make_batches())
        for batch in prefetch(source, self.prefetch_depth):
            self.step += 1
            yield batch
