"""The port's copies of the JAX package's numpy data modules (`data/mixer.py`,
`data/train_datasets.py`) give the same batches as the originals from the
same seed, on a seeded in-memory dataset."""

import numpy as np
import pytest

from diffusion_e2e_ft_tpu.data import mixer as jmixer
from diffusion_e2e_ft_tpu_torch.data import mixer as tmixer


class _Samples:
    """An in-memory dataset of seeded samples (the readers' sample layout)."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.samples = [{
            "rgb": rng.uniform(-1, 1, (6, 8, 3)).astype(np.float32),
            "val_mask": rng.random((6, 8)) > 0.2,
            "metric": rng.uniform(-1, 1, (6, 8)).astype(np.float32),
            "normals": rng.normal(size=(6, 8, 3)).astype(np.float32),
            "domain": ("indoor", "outdoor")[i % 2],
        } for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _epoch(mod, modality: str, seed: int):
    a = mod.BatchLoader(_Samples(23, 0), 2, modality, seed=seed)
    b = mod.BatchLoader(_Samples(7, 1), 2, modality, seed=seed)
    return list(mod.Prefetcher(mod.MixedLoader(a, b, 9, 1, seed=seed)))


@pytest.mark.parametrize("modality", ["depth", "normals", "joint"])
def test_mixed_batches_match_the_jax_package(modality):
    want, got = _epoch(jmixer, modality, seed=3), _epoch(tmixer, modality, seed=3)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
