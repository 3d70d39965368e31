"""Epoch samplers with iteration-level resume — the port's copy of
``selfocc_tpu/data/sampler.py``.

Behavioral rewrite of ``dataset/sampler.py`` (``CustomDistributedSampler``):
deterministic per-epoch shuffling sharded across data-parallel workers, plus
``set_last_iter`` so a restart skips already-consumed indices (the reference's
``--iter-resume`` path, ``train.py:161-162, 273-287``). The port's
``train.py`` runs one replica (``num_replicas=1, rank=0``).
"""
from __future__ import annotations

import numpy as np


class DistributedSampler:
    """Deterministic shuffled epoch order, sharded over ranks."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        assert 0 <= rank < num_replicas
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.last_iter = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_last_iter(self, last_iter: int):
        """Skip the first ``last_iter`` batches of the current epoch on resume
        (reference ``sampler.py:112-118``)."""
        self.last_iter = last_iter

    def __len__(self):
        return self.num_samples - self.last_iter

    def __iter__(self):
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            indices = g.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        # pad to a multiple of num_replicas (wrap-around, as torch's sampler)
        pad = self.total_size - len(indices)
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        indices = indices[: self.total_size]
        shard = indices[self.rank::self.num_replicas]
        yield from shard[self.last_iter:].tolist()
        self.last_iter = 0
