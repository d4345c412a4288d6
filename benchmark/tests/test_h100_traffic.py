"""The traffic repeats exactly for a seed, every seed sends the same mix, and
the training batches' rows all differ."""

import json

import numpy as np
import pytest

import tiny
from families import common as C
from kinds import serve

SEEDS = [0, 1, 2147483647, 2147483648 + 12345, 4294967296 + 77, 2**63 - 1]
MIX = json.loads((tiny.BENCH_DIR / "traffic" / "mix_7rps.json").read_text())["params"]
TRAIN = json.loads((tiny.BENCH_DIR / "traffic" / "train_bs8.json").read_text())["params"]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_sends_the_exact_3_to_1_mix_in_each_block(seed):
    sizes = serve.order(MIX, seed, 4000)
    for b in range(0, 4000, 4):
        block = sizes[b:b + 4]
        assert block.count((480, 640)) == 3 and block.count((768, 768)) == 1


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_the_traffic_repeats_for_a_seed_and_differs_between_seeds(seed):
    assert serve.order(MIX, seed, 64) == serve.order(MIX, seed, 64)
    a, b = serve.images(MIX, seed), serve.images(MIX, seed)
    assert all(np.array_equal(x, y) for s in a for x, y in zip(a[s], b[s]))
    other = serve.images(MIX, seed + 1)
    assert not np.array_equal(a[(480, 640)][0], other[(480, 640)][0])
    assert serve.order(MIX, seed, 64) != serve.order(MIX, seed + 1, 64)


def test_training_batches_repeat_and_their_rows_all_differ():
    params = dict(TRAIN, height=16, width=24)
    a, b = C.train_ring(params, 2147483649, False), C.train_ring(params, 2147483649, False)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    rows = np.concatenate([x["rgb"].reshape(params["micro_batch"], -1) for x in a])
    assert len(rows) == params["ring"] * params["micro_batch"] and len(np.unique(rows, axis=0)) == len(rows)
    invalid = 1.0 - np.mean([x["val_mask"].mean() for x in a])
    assert abs(invalid - params["invalid_share"]) < 0.02
    joint = C.train_ring(params, 5, True)[0]
    assert np.allclose(np.linalg.norm(joint["normal_target"], axis=-1), 1.0, atol=1e-5)
