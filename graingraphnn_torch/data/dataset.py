"""In-memory dataset of equally padded GraphSamples with epoch shuffling and
fixed-shape batching. The shuffle is the JAX package's
(`np.random.default_rng(seed).shuffle`), so both packages see the same
batches."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from ..graph import state


def common_capacities(raw_sizes, multiple: int = 8):
    """Shared padding capacities (ng, nj, ne) over samples of raw sizes
    (grains, joints, live jj edges), each rounded up to `multiple`."""
    ng = max(s[0] for s in raw_sizes)
    nj = max(s[1] for s in raw_sizes)
    ne = max(s[2] for s in raw_sizes)
    r = lambda n: state.round_up(max(n, 1), multiple)
    return r(ng), r(nj), r(ne)


class GraphDataset:
    def __init__(self, samples: Sequence[state.GraphSample]):
        self.samples: List[state.GraphSample] = list(samples)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def batches(
        self, batch_size: int, shuffle: bool = False, seed: int = 0,
        drop_last: bool = False,
    ) -> Iterator[state.GraphSample]:
        order = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            yield state.stack([self.samples[i] for i in idx])


def split(samples, train_ratio: float = 0.95):
    """Sequential train/valid split (no shuffle before the split)."""
    n_train = int(train_ratio * len(samples))
    return samples[:n_train], samples[n_train:]
