"""Batching, probabilistic dataset mixing, and background prefetch.

The port's own copy of `diffusion_e2e_ft_tpu/data/mixer.py` (numpy only), so
the PyTorch package imports nothing of the JAX package; the two give the same
batches from the same seed.

Capability parity: `MixedDataLoader` (the reference's `training/dataloaders/load.py:18-59`):
two loaders interleaved by a pre-shuffled boolean schedule whose fractions equalize to
a split1:split2 ratio (9:1 Hypersim:VKITTI in the reference scripts), truncating the
larger dataset.

Additions: `BatchLoader` assembles fixed-shape NHWC numpy batches, and
`Prefetcher` overlaps host-side decode with device compute.

Data parallelism: a `BatchLoader` given `rank` and `world` walks the global
batches (`batch_size` is the global one) in the single-process order and
reads only the rank's block of rows of each; a dataset with per-sample
randomness (`skip(n)`) is advanced past the rows the rank does not read, so
each sample gets the draw it would get in one process.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from diffusion_e2e_ft_tpu_torch.parallel.mesh import row_block

DOMAIN_ONE_HOT = {
    "indoor": np.asarray([1.0, 0.0, 0.0], np.float32),
    "outdoor": np.asarray([0.0, 1.0, 0.0], np.float32),
    "object": np.asarray([0.0, 0.0, 1.0], np.float32),
}


def collate(samples: Sequence[Dict[str, Any]], modality: str = "depth") -> Dict[str, np.ndarray]:
    """Stack dataset samples into the trainer's batch layout.

    depth:   target = clamped metric depth  (SSI is affine-invariant)
    normals: target = unit normal field
    joint:   depth_target + normal_target + domain one-hot (GeoWizard)
    """
    rgb = np.stack([s["rgb"] for s in samples])
    mask = np.stack([s["val_mask"] for s in samples]).astype(bool)
    batch: Dict[str, np.ndarray] = {"rgb": rgb, "val_mask": mask}
    if modality == "depth":
        batch["target"] = np.stack([s["metric"] for s in samples])
    elif modality == "normals":
        batch["target"] = np.stack([s["normals"] for s in samples])
    elif modality == "joint":
        batch["depth_target"] = np.stack([s["metric"] for s in samples])
        batch["normal_target"] = np.stack([s["normals"] for s in samples])
        batch["domain"] = DOMAIN_ONE_HOT[samples[0].get("domain", "indoor")]
    else:
        raise ValueError(f"Unknown modality: {modality}")
    return batch


class BatchLoader:
    """Shuffled epoch iterator over a dataset, yielding collated batches.

    Drops the trailing partial batch (fixed shapes keep one compiled graph)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        modality: str = "depth",
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"a global batch of {batch_size} does not split over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.modality = modality
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            block = row_block(len(idx), self.rank, self.world)
            skip = getattr(self.dataset, "skip", None)
            if skip is not None:
                skip(block.start)
            rows = [self.dataset[int(i)] for i in idx[block]]
            if skip is not None:
                skip(len(idx) - block.stop)
            yield collate(rows, self.modality)


class MixedLoader:
    """Probabilistic split1:split2 interleave of two batch loaders.

    Each epoch draws a fresh boolean schedule: int(len1*frac1) Trues and
    int(len2*frac2) Falses, shuffled; fractions cap the larger source so the
    effective ratio is split1:split2."""

    def __init__(self, loader1, loader2, split1: int = 9, split2: int = 1, seed: int = 0):
        self.loader1 = loader1
        self.loader2 = loader2
        self.split1 = split1
        self.split2 = split2
        self.rng = np.random.default_rng(seed)
        self.frac1, self.frac2 = self.split_fractions()

    def split_fractions(self):
        n1, n2 = len(self.loader1), len(self.loader2)
        f1 = min((n2 / n1) * (self.split1 / self.split2), 1.0)
        f2 = min((n1 / n2) * (self.split2 / self.split1), 1.0)
        return f1, f2

    def schedule(self) -> np.ndarray:
        take1 = int(len(self.loader1) * self.frac1)
        take2 = int(len(self.loader2) * self.frac2)
        choice = np.concatenate([np.ones(take1, bool), np.zeros(take2, bool)])
        self.rng.shuffle(choice)
        return choice

    def __len__(self) -> int:
        return int(len(self.loader1) * self.frac1) + int(len(self.loader2) * self.frac2)

    def __iter__(self):
        it1, it2 = iter(self.loader1), iter(self.loader2)
        for use1 in self.schedule():
            yield next(it1) if use1 else next(it2)


class Prefetcher:
    """Background-thread prefetch: decodes/collates the next batches while the
    device is busy with the current step."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error: List[BaseException] = []

        def worker():
            try:
                for item in self.loader:
                    q.put(item)
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
