"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so without a GPU these
tests skip. This file imports no JAX, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Float32 with TF32 off (tolerance 1e-4: summation order over at most
720 terms); bfloat16 atol = rtol = 2e-2, one bf16 step at values in
[2, 4) (the kernel rounds where the plain version rounds, so summation
order is the only difference); NMS must agree exactly (the kernel is built without FMA
contraction and copies the picked values).
"""

import numpy as np
import pytest
import torch

from yoloret_tpu_torch.ops.mbconv import fused_mbconv, reference_mbconv
from yoloret_tpu_torch.ops.nms_kernel import suppress, suppress_plain

MBCONV_CASES = [
    # (h, w, cin, ce, cout, stride, expand, residual)
    (16, 16, 8, 32, 16, 1, True, False),
    (20, 20, 16, 96, 16, 1, True, True),
    (16, 16, 24, 24, 16, 1, False, False),
    (12, 12, 16, 16, 16, 1, False, True),
    (16, 16, 8, 48, 24, 2, True, False),
    (10, 10, 72, 432, 120, 2, True, False),
    (10, 10, 120, 720, 120, 1, True, True),
]
# The 16 blocks of MobileNetV2 x0.75 @320 (11 distinct shapes), at batch
# 1 and 3; odd maps (416 gives 13x13 maps), a 7x7 map, a block without
# expand, and a batch of 128 whose items outnumber the persistent CTAs.
BLOCK_SHAPES = [
    (160, 160, 24, 24, 16, 1, False, False),
    (160, 160, 16, 96, 24, 2, True, False),
    (80, 80, 24, 144, 24, 1, True, True),
    (80, 80, 24, 144, 24, 2, True, False),
    (40, 40, 24, 144, 24, 1, True, True),
    (40, 40, 24, 144, 48, 2, True, False),
    (20, 20, 48, 288, 48, 1, True, True),
    (20, 20, 48, 288, 72, 1, True, False),
    (20, 20, 72, 432, 72, 1, True, True),
    (20, 20, 72, 432, 120, 2, True, False),
    (10, 10, 120, 720, 120, 1, True, True),
]
MBCONV_CASES += [s + (n,) for n in (1, 3) for s in BLOCK_SHAPES] + [
    (13, 13, 120, 720, 120, 1, True, True, 3),
    (26, 26, 72, 432, 120, 2, True, False, 3),
    (7, 7, 120, 720, 120, 1, True, True, 3),
    (14, 14, 72, 432, 120, 2, True, False, 3),
    (9, 11, 24, 24, 16, 1, False, False, 3),
    (10, 10, 120, 720, 120, 1, True, True, 128),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mbconv_inputs(seed, h, w, cin, ce, cout, expand, dev, batch=3):
    rs = np.random.RandomState(seed)

    def r(*shape):
        return torch.from_numpy((rs.randn(*shape) * 0.2).astype(np.float32)).to(dev)

    x = torch.from_numpy(rs.rand(batch, h, w, cin).astype(np.float32) - 0.5).to(dev)
    return (x, r(cin, ce) if expand else None, r(ce) if expand else None, r(3, 3, ce), r(ce),
            r(ce, cout), r(cout))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MBCONV_CASES)
def test_mbconv_kernel_matches_plain(cuda, case):
    h, w, cin, ce, cout, stride, expand, residual = case[:8]
    args = _mbconv_inputs(0, h, w, cin, ce, cout, expand, cuda, *case[8:])
    before = fused_mbconv.launches
    got = fused_mbconv(*args, stride=stride, residual=residual)
    assert fused_mbconv.launches == before + 1
    want = reference_mbconv(*args, stride=stride, residual=residual)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    bf = [None if a is None else a.to(torch.bfloat16) if i in (0, 1, 3, 5) else a
          for i, a in enumerate(args)]
    got = fused_mbconv(*bf, stride=stride, residual=residual)
    want = reference_mbconv(*bf, stride=stride, residual=residual)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,shared", [(64, True), (512, True), (100, False), (512, False)])
def test_nms_kernel_matches_plain(cuda, k, shared):
    rs = np.random.RandomState(k)
    b, c = 4, 20
    shape = (b, k) if shared else (b, c, k)
    boxes = rs.rand(*shape, 4).astype(np.float32) * 300
    boxes[..., 2:] = boxes[..., :2] + rs.rand(*shape, 2).astype(np.float32) * 60
    scores = (rs.permutation(b * c * k).reshape(b, c, k) / (b * c * k)).astype(np.float32)
    bt, st = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    before = suppress.launches
    got = suppress(bt, st, max_det=20, iou_threshold=0.5, score_threshold=0.3)
    assert suppress.launches == before + 1
    want = suppress_plain(bt, st, max_det=20, iou_threshold=0.5, score_threshold=0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
