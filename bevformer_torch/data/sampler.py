"""Data samplers (host-side index logic).

The port's own copy of `bevformer_tpu/data/sampler.py`. It replaces the
reference's distributed samplers:
  * `GroupShuffleSampler` — `datasets/samplers/group_sampler.py:62-103`:
    epoch-seeded shuffled per-process split (group/aspect-ratio flags are
    meaningless for fixed-size 6-camera nuScenes inputs, so this reduces to
    a seeded DistributedSampler with padding to equal shares).
  * `ContiguousVideoSampler` — `datasets/samplers/distributed_sampler.py:
    22-41`: NON-shuffled contiguous block per process so each worker
    evaluates continuous video (the temporal prev_bev state stays valid);
    see the note at `bevformer/apis/test.py:150-152`.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class GroupShuffleSampler:
    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 seed: int = 0):
        self.n = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-self.n // num_replicas)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> List[int]:
        rng = np.random.RandomState(self.seed + self.epoch)
        idx = rng.permutation(self.n)
        # pad to make divisible, like DistributedGroupSampler
        pad = self.num_samples * self.num_replicas - self.n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        return list(idx[self.rank :: self.num_replicas])

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples


class ContiguousVideoSampler:
    """Each process gets one contiguous block (video continuity preserved)."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0):
        self.n = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        per = -(-dataset_len // num_replicas)
        self.start = min(rank * per, dataset_len)
        self.stop = min(self.start + per, dataset_len)

    def indices(self) -> List[int]:
        return list(range(self.start, self.stop))

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self) -> int:
        return self.stop - self.start
