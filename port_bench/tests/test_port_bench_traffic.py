"""The traffic generator is a function of the mix and the seed, and the
seed deals out one fixed set of sizes."""

import numpy as np

from port_bench.harness import traffic
from port_bench.tests.tiny import SERVE, TRAIN

SEED = 3_000_000_019  # beyond 32 signed bits


def test_serve_images_repeat_for_a_seed():
    a_warm, a_pool = traffic.serve_images(SERVE, SEED, "cpu")
    b_warm, b_pool = traffic.serve_images(SERVE, SEED, "cpu")
    _, c_pool = traffic.serve_images(SERVE, SEED + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a_pool + a_warm,
                                                    b_pool + b_warm))
    assert not np.array_equal(a_pool[0], c_pool[0])
    assert len(a_warm) == SERVE["batch"]
    assert len(a_pool) == SERVE["pool_images"]
    assert a_pool[0].dtype == np.uint8 and a_pool[0].shape == (80, 80, 3)
    batches = [traffic.serve_batch(SERVE, a_pool, i) for i in range(4)]
    assert all(len(b) == SERVE["batch"] for b in batches)


def test_train_batches_repeat_and_share_one_set_of_sizes():
    a = traffic.train_batches(TRAIN, SEED, 8, "cpu")
    b = traffic.train_batches(TRAIN, SEED, 8, "cpu")
    c = traffic.train_batches(TRAIN, SEED + 1, 8, "cpu")
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["gt_polys"], c[0]["gt_polys"])

    def sizes(bs):
        hw = np.concatenate([x["img_hw"][:, 0] for x in bs])
        gts = np.concatenate([x["gt_valid"].sum(1) for x in bs])
        return sorted(hw), sorted(gts)

    assert sizes(a) == sizes(c)
    for x in a:
        for i, (h, w) in enumerate(x["img_hw"]):
            assert not x["images"][i, h:].any() and not x["images"][i, :,
                                                                   w:].any()
        assert set(np.unique(x["gt_labels"][x["gt_valid"]])) <= set(
            range(1, TRAIN["classes"] + 1))
