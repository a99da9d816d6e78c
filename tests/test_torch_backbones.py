"""The port's MobileNetV2 x1.4 / x1.0 and EfficientNet backbones vs the
JAX package: the heads of the whole detector (MobileNetV2 through the
fused path, whose kernels take their plain versions on the CPU), the
EfficientNet stage tables, and ``Predictor.detect_arrays`` at 80 classes
for the two COCO backbones (``configs/coco_*.yaml``).

Float32 on the CPU at 64x64, batch 2, inputs from a numpy seed; one set-up
per backbone, the port's seeded init in the Flax tree
(``tests/_torch_parity.py``), heads within atol = rtol = 2e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import ANCHORS, SIZE, assert_heads_close, make_pair, port_variables
from yoloret_tpu.infer import Predictor as JaxPredictor
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.nn import detector as jax_detector
from yoloret_tpu.nn import efficientnet as jax_efficientnet
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.nn import efficientnet
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.fused_infer import fused_detector_apply, fused_params

torch.set_num_threads(1)

COCO_CLASSES = 80  # the two COCO backbones are set up at the configs' class count
BACKBONES = {"mobilenetv2x14": COCO_CLASSES, "mobilenetv2x10": 3,
             "efficientnetb0": 3, "efficientnetb3": COCO_CLASSES}


@pytest.fixture(scope="module")
def pairs():
    """One set-up and JAX forward per backbone, made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            nc = BACKBONES[name]
            cache[name] = make_pair(jax_build_detector(name, num_classes=nc),
                                    YoloReT(name, num_classes=nc), port_variables) + (nc,)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_detector_heads_match_jax(pairs, name):
    x, _, want, port, _ = pairs(name)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_heads_close(got, want)


@pytest.mark.parametrize("name", ["mobilenetv2x14", "mobilenetv2x10"])
def test_fused_detector_heads_match_jax(pairs, name):
    x, _, want, port, _ = pairs(name)
    params = fused_params(port)
    assert len(params.blocks) == 16
    assert_heads_close(fused_detector_apply(port, torch.from_numpy(x), params), want)


def test_efficientnet_takes_the_stock_forward(pairs):
    x, _, want, port, _ = pairs("efficientnetb3")
    assert fused_params(port) is None
    assert_heads_close(fused_detector_apply(port, torch.from_numpy(x)), want)


def test_efficientnet_b3_stages():
    stages, dropout = efficientnet.decode_block_args("b3")
    got = [(s.num_repeat, s.kernel_size, s.output_filters) for s in stages[:6]]
    assert got == [(2, 3, 24), (3, 3, 32), (3, 5, 48), (5, 3, 96), (5, 5, 136), (6, 5, 232)]
    assert efficientnet.round_filters(32, 1.2) == 40 and dropout == 0.3
    assert efficientnet.tap_channels("b3") == {"c2": 32, "c3": 48, "c4": 136, "c5": 232}
    body = YoloReT("efficientnetb3").body
    assert [n for _, names in body.stage_blocks for n in names][-1] == "stage_5_block_5"
    assert not hasattr(body, "top") and hasattr(efficientnet.EfficientNet("b3", True), "top")


@pytest.mark.parametrize("variant", [f"b{i}" for i in range(8)])
def test_efficientnet_tables_equal_jax(variant):
    got, got_drop = efficientnet.decode_block_args(variant)
    want, want_drop = jax_efficientnet.decode_block_args(variant)
    assert [dataclasses.astuple(a) for a in got] == [dataclasses.astuple(a) for a in want]
    assert got_drop == want_drop
    width, depth, _, _ = efficientnet.EFFICIENTNET_PARAMS[variant]
    assert efficientnet.EFFICIENTNET_PARAMS[variant] == jax_efficientnet.EFFICIENTNET_PARAMS[variant]
    for f in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        assert efficientnet.round_filters(f, width) == jax_efficientnet.round_filters(f, width)
    for r in (1, 2, 3, 4):
        assert efficientnet.round_repeats(r, depth) == jax_efficientnet.round_repeats(r, depth)


@pytest.mark.parametrize("name", ["mobilenetv2x14", "efficientnetb3"])
def test_predictor_matches_jax_predictor_at_80_classes(pairs, name, monkeypatch):
    _, variables, _, _, nc = pairs(name)
    names = [f"class_{i}" for i in range(nc)]
    kw = dict(backbone=name, class_names=names, anchors=ANCHORS, input_hw=(SIZE, SIZE),
              score_threshold=0.3, bf16=False, num_candidates=64, batch_buckets=(4,))
    # the JAX Predictor's own (eager) init is replaced by the fixture's variables
    monkeypatch.setattr(jax_detector.YoloReT, "init", lambda self, *a, **k: variables)
    want_pred = JaxPredictor(**kw)
    got_pred = Predictor(weights=variables, device="cpu", **kw)
    rs = np.random.RandomState(7)
    images = [rs.randint(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((100, 140), (64, 64), (90, 50))]
    want = want_pred.detect_arrays(images)
    got = got_pred.detect_arrays(images)
    assert got_pred.forwards == 1 and got_pred.dispatched_batch_sizes == {4}
    assert sum(len(d) for d in want) > 0
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            assert (g.class_id, g.class_name) == (w.class_id, w.class_name)
            np.testing.assert_allclose(g.score, w.score, rtol=1e-4)
            np.testing.assert_allclose(g.box, w.box, atol=1e-2)
