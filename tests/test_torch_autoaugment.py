"""The port's copy of AutoAugment-for-detection
(``yoloret_tpu_torch/tools/autoaugment.py``) against the JAX package's
(``yoloret_tpu/tools/autoaugment.py``): for each policy and several
``RandomState`` seeds, on seeded 64x64 images with boxes, the distorted
image and boxes are equal bit for bit, and so is the state of the
generator after the call (the same draws in the same order)."""

import numpy as np
import pytest

from yoloret_tpu.tools import autoaugment as jax_aa
from yoloret_tpu_torch.tools import autoaugment

SEEDS = range(12)


def sample(seed):
    """A 64x64 image of noise with two bright boxes, and its boxes
    [N, 5] (x1, y1, x2, y2, class) in pixels, one of them at the edge."""
    rs = np.random.RandomState(100 + seed)
    img = rs.randint(0, 120, (64, 64, 3)).astype(np.uint8)
    boxes = []
    for c in range(int(rs.randint(1, 4))):
        x1, y1 = rs.uniform(0, 40, 2)
        x2, y2 = x1 + rs.uniform(6, 24), y1 + rs.uniform(6, 24)
        img[int(y1):int(y2), int(x1):int(x2), c % 3] = 240
        boxes.append([x1, y1, x2, y2, c])
    boxes.append([50.0, 44.0, 64.0, 64.0, 7])
    return img, np.asarray(boxes, np.float64)


@pytest.mark.parametrize("policy", ["v0", "v1", "v2", "v3", "test"])
def test_distort_matches_jax_bit_for_bit(policy):
    changed = 0
    for seed in SEEDS:
        img, boxes = sample(seed)
        rs_got, rs_want = np.random.RandomState(seed), np.random.RandomState(seed)
        got_img, got_boxes = autoaugment.distort_image_with_autoaugment(
            img.copy(), boxes.copy(), policy, rs_got)
        want_img, want_boxes = jax_aa.distort_image_with_autoaugment(
            img.copy(), boxes.copy(), policy, rs_want)
        np.testing.assert_array_equal(got_img, want_img, err_msg=f"{policy} seed {seed}")
        np.testing.assert_array_equal(got_boxes, want_boxes, err_msg=f"{policy} seed {seed}")
        assert got_img.dtype == np.uint8 and got_boxes.dtype == np.float64
        assert rs_got.randint(2**31 - 1) == rs_want.randint(2**31 - 1)
        changed += not np.array_equal(got_img, img)
    assert changed > 0  # the seeds reach ops that change pixels


def test_policies_and_errors_are_the_jax_packages():
    assert autoaugment.POLICIES == jax_aa.POLICIES
    assert autoaugment.ONLY_BBOX_OPS == jax_aa.ONLY_BBOX_OPS
    img, boxes = sample(0)
    with pytest.raises(ValueError, match="unknown policy"):
        autoaugment.distort_image_with_autoaugment(img, boxes, "v9")
