"""Building blocks of the detector, NHWC in and out.

Port of ``yoloret_tpu/nn/layers.py``. Every module takes
and returns NHWC tensors, as the JAX package does; a kxk convolution
runs ``F.conv2d`` on the NCHW view of the same storage (channels-last
strides, so no copy is made), and a 1x1 convolution is ``F.linear`` over
the channel axis. Parameters stay float32 and are cast to the input's
dtype at use, as Flax does with ``dtype=bfloat16`` modules.

Every block's ``forward(x, train=False)`` has two branches, as the Flax
modules' ``train`` argument does. At inference (``train=False``) the
BatchNorm runs folded into the conv before it, with running statistics.
In training (``train=True``) the conv, the BatchNorm on batch statistics
and the activation run unfolded, and the BatchNorm updates its running
statistics as Flax's does (see ``BatchNorm``). Parameter names follow the Flax tree (``conv``,
``bn``, ``dwconv``, ``depthwise``, ``pointwise``, ``expand``, ``se``,
``project``), so that ``yoloret_tpu_torch.weights.from_flax`` maps one
onto the other.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yoloret_tpu_torch.parallel.mesh import in_group, mean_over_ranks, rank, world
from yoloret_tpu_torch.parallel.spatial import current as spatial_shard

Act = Optional[Callable[[torch.Tensor], torch.Tensor]]


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6). Under autograd the gradient at the kinks is
    JAX's, half on each side (``torch.clamp`` passes all of it); exact
    zeros are common there: a dead channel normalised by BatchNorm in
    training is exactly 0. Without autograd one ``torch.clamp``: the
    serving batch is host-bound, and the two kernels of the other form
    cost it 7.5% on an H100 (``tools/activation_ab.py``)."""
    if x.requires_grad:
        return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))
    return torch.clamp(x, 0.0, 6.0)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1), the darknet family's activation, with gradient 1
    at 0 as ``jax.nn.leaky_relu`` gives it."""
    return torch.where(x >= 0, x, 0.1 * x)


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """Channel rounding of the MobileNetV2 width multiplier."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of TF/Flax ``"SAME"`` along one axis.

    The total is what makes the output ``ceil(size / stride)`` long, and
    the odd pixel goes to the high side: a 3x3 stride-2 conv on an even
    input pads (0, 1), not PyTorch's symmetric 1."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor,  # [B, H, W, Cin]
    weight: torch.Tensor,  # [Cout, Cin / groups, kh, kw]
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """NHWC convolution with ``"SAME"`` padding; returns NHWC.

    On a row shard (``parallel/spatial.py``) it convolves the shard's
    output rows of the whole map: the rows they read (a halo from the
    neighbours, zeros outside the image, where the whole map's padding
    puts them) gathered into one slab, VALID in height, ``"SAME"`` in
    width."""
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    cout, _, kh, kw = weight.shape
    if kh == kw == 1 and stride == 1 and groups == 1:
        return F.linear(x, weight.reshape(cout, -1), bias)
    pw = same_padding(x.shape[2], kw, stride)
    shard = spatial_shard()
    if shard is not None:
        o, n, h = shard.level(x.shape[1], stride)
        a = o - same_padding(h, kh, stride)[0]
        slab = shard.rows(x, a, a + n - stride + kh)
        xc = F.pad(slab.permute(0, 3, 1, 2), (pw[0], pw[1], 0, 0))
        return F.conv2d(xc, weight, bias, stride, 0, 1, groups).permute(0, 2, 3, 1)
    ph = same_padding(x.shape[1], kh, stride)
    xc = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, weight, bias, stride, (ph[0], pw[0]), 1, groups)
    else:
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(xc, weight, bias, stride, 0, 1, groups)
    return y.permute(0, 2, 3, 1)


def conv_kernel_init(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Fan-out normal init, ``sqrt(2 / (kh * kw * out))`` (the JAX
    package's ``conv_kernel_init``), in place."""
    out_ch, _, kh, kw = weight.shape
    std = (2.0 / (kh * kw * out_ch)) ** 0.5
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator) * std)


class Conv2dSame(nn.Module):
    """Bias-optional NHWC conv with ``"SAME"`` padding (Flax ``nn.Conv``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, bias: bool = False):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, self.stride, self.groups)


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis (the last), eps 1e-3, Flax's
    ``nn.BatchNorm`` in both of its modes.

    At inference it is not called on activations: the conv before it
    takes it folded in (``fold_bn``). Called (``forward``), it is the
    training mode, ``use_running_average=False``: the statistics of the
    batch are computed in float32 at least (float64 stays float64), the
    variance as E[x^2] - E[x]^2 clipped at 0 (biased, as Flax computes
    it, not the unbiased one ``F.batch_norm`` and ``nn.SyncBatchNorm``
    keep), E[x] and E[x^2] over the global batch in a process group (the
    mean of the ranks' own, all-reduced differentiably by
    ``parallel.mesh.mean_over_ranks``; every rank holds as many rows, and
    without a group the same formula runs without the collective), the
    input is
    normalised with them in that dtype and cast back to its own, and the
    running statistics move to ``momentum * old + (1 - momentum) *
    batch`` (Flax's momentum m, PyTorch's 1 - m) unless
    ``update_stats`` is False (``keep_stats``)."""

    def __init__(self, ch: int, eps: float = 1e-3, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        mean, mean_sq = xf.mean(axes), (xf * xf).mean(axes)
        if in_group():  # one all-reduce of both; the same bits at world size 1
            mean, mean_sq = mean_over_ranks(torch.stack([mean, mean_sq]))
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


@contextlib.contextmanager
def keep_stats(model: nn.Module) -> Iterator[None]:
    """Inside, no BatchNorm of ``model`` updates its running statistics
    (a forward whose statistics are thrown away, as the JAX train step
    throws away all but the clean forward's)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, b in zip(bns, before):
            m.update_stats = b


def fold_bn(weight: torch.Tensor, bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into a conv: (weight * s, t) with
    s = gamma / sqrt(var + eps), t = beta - mean * s, per output channel
    (dim 0 of ``weight``), in ``weight``'s dtype, float32 at least."""
    dtype = torch.promote_types(weight.dtype, torch.float32)
    s = bn.weight.to(dtype) / torch.sqrt(bn.running_var.to(dtype) + bn.eps)
    return (weight.to(dtype) * s.reshape(-1, *([1] * (weight.dim() - 1))),
            bn.bias.to(dtype) - bn.running_mean.to(dtype) * s)


def conv_bn(x: torch.Tensor, conv: Conv2dSame, bn: BatchNorm, train: bool = False
            ) -> torch.Tensor:
    """bn(conv(x)). At inference one conv with the BN folded into kernel
    and bias: the activation is read and written once instead of three
    more times for the normalisation (equal up to float rounding). In
    training the conv, then the BatchNorm on batch statistics."""
    if train:
        return bn(conv(x))
    w, t = fold_bn(conv.weight.to(torch.promote_types(x.dtype, torch.float32)), bn)
    return conv2d_same(x, w, t, conv.stride, conv.groups)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + optional activation."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 1,
                 stride: int = 1, act: Act = relu6, momentum: float = 0.9):
        super().__init__()
        self.act = act
        self.conv = Conv2dSame(in_ch, features, kernel_size, stride)
        self.bn = BatchNorm(features, momentum=momentum)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv_bn(x, self.conv, self.bn, train)
        return x if self.act is None else self.act(x)


class DepthwiseConvBN(nn.Module):
    """Depthwise kxk conv (no bias) + BatchNorm + optional activation."""

    def __init__(self, ch: int, kernel_size: int, stride: int = 1, act: Act = relu6,
                 momentum: float = 0.9):
        super().__init__()
        self.act = act
        self.dwconv = Conv2dSame(ch, ch, kernel_size, stride, groups=ch)
        self.bn = BatchNorm(ch, momentum=momentum)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv_bn(x, self.dwconv, self.bn, train)
        return x if self.act is None else self.act(x)


class SeparableConvBN(nn.Module):
    """Depthwise kxk + BN + ReLU6, then pointwise 1x1 + BN + ReLU6
    (BN momentum 0.99, the Flax module's default)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5, stride: int = 1,
                 momentum: float = 0.99):
        super().__init__()
        self.depthwise = DepthwiseConvBN(in_ch, kernel_size, stride, act=relu6,
                                         momentum=momentum)
        self.pointwise = ConvBN(in_ch, features, 1, act=relu6, momentum=momentum)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.pointwise(self.depthwise(x, train), train)


class WeightedSum(nn.Module):
    """Learned scalar-weighted sum of N same-shape tensors (the RFCR
    fusion weights, initialised to ones)."""

    def __init__(self, num_inputs: int = 4):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(num_inputs))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(xs) != self.alpha.numel():
            raise ValueError(f"expected {self.alpha.numel()} inputs, got {len(xs)}")
        alpha = self.alpha.to(xs[0].dtype)
        out = alpha[0] * xs[0]
        for i in range(1, len(xs)):
            out = out + alpha[i] * xs[i]
        return out


def mean_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """[B, H, W, C] -> the mean over H and W, [B, C] ([B, 1, 1, C] with
    ``keepdim``); on a row shard the mean over the whole map (the group's
    sum, float32 at least, over the global pixel count), in x's dtype.
    Integer codes (the int8 backbone's) sum exactly as int32 and come out
    float32, the whole map's sum times the float32 reciprocal of its
    pixel count: the JAX package's ``jnp.mean`` of the codes bit for bit
    (XLA multiplies by the reciprocal), on a row shard too."""
    shard = spatial_shard()
    h = x.shape[-3] if shard is None else shard.level(x.shape[-3])[2]
    if not x.is_floating_point():
        total = x.sum(dim=(-3, -2), keepdim=keepdim, dtype=torch.int32)
        total = total if shard is None else shard.sum(total)
        return total.float() * torch.tensor(float(h * x.shape[-2])).reciprocal()
    if shard is None:
        return x.mean(dim=(-3, -2), keepdim=keepdim)
    total = shard.sum(x.to(torch.promote_types(x.dtype, torch.float32))
                      .sum(dim=(-3, -2), keepdim=keepdim))
    return (total / (h * x.shape[2])).to(x.dtype)


class SqueezeExcite(nn.Module):
    """Global mean -> reduce 1x1 (swish) -> excite 1x1 (sigmoid) ->
    scale. ``reduced`` comes from the block-args input filters."""

    def __init__(self, reduced: int, features: int):
        super().__init__()
        self.reduce = Conv2dSame(features, reduced, bias=True)
        self.excite = Conv2dSame(reduced, features, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = mean_hw(x, keepdim=True)
        s = torch.sigmoid(self.excite(swish(self.reduce(s))))
        return x * s


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, *out_hw, C), "bilinear")`` of NHWC ``x``:
    half-pixel centres, antialiased when it downsamples (the triangle
    widened by in/out, as JAX's scale-and-translate; ``F.interpolate``
    does not widen it), computed in x's dtype."""
    from yoloret_tpu_torch.data.augment import weight_matrix

    b, h, w, c = x.shape
    one = torch.ones(1, dtype=torch.float32, device=x.device)
    zero = torch.zeros(1, dtype=torch.float32, device=x.device)
    wy = weight_matrix(h, out_hw[0], one * (out_hw[0] / h), zero)[0].to(x.dtype)  # [H, out]
    wx = weight_matrix(w, out_hw[1], one * (out_hw[1] / w), zero)[0].to(x.dtype)
    return torch.einsum("bhwc,ho,wp->bopc", x, wy, wx)


class SpatialAttention(nn.Module):
    """Spatial-attention gate, the JAX package's ``SpatialAttention``
    (the reference's experimental ``SpatialBlock``): a 1x1 conv to one
    map (``squeeze``), a bilinear resize to at most ``pool_hw`` x
    ``pool_hw``, a dense layer to (nh * nh) // 4 (swish, ``reduce``) and
    back to nh * nw (sigmoid, ``expand``), a resize back, then a
    multiply. Its dense sizes follow the pooled map, so it is built for a
    map of ``map_hw`` (H, W) and takes any map that pools to the same
    size. Not sharded over rows: no registry backbone uses it."""

    def __init__(self, features: int, map_hw: Tuple[int, int], pool_hw: int = 20):
        super().__init__()
        self.pool_hw = pool_hw
        self.pool = (min(pool_hw, map_hw[0]), min(pool_hw, map_hw[1]))
        nh, nw = self.pool
        self.squeeze = Conv2dSame(features, 1, bias=True)
        self.reduce = nn.Linear(nh * nw, (nh * nh) // 4)
        self.expand = nn.Linear((nh * nh) // 4, nh * nw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial_shard() is not None:
            raise ValueError("SpatialAttention does not run on a row shard")
        b, h, w, _ = x.shape
        if (min(self.pool_hw, h), min(self.pool_hw, w)) != self.pool:
            raise ValueError(f"SpatialAttention built for maps pooled to {self.pool}, got "
                             f"{(h, w)}")
        s = resize_bilinear(self.squeeze(x), self.pool).reshape(b, -1)
        s = swish(F.linear(s, self.reduce.weight.to(x.dtype), self.reduce.bias.to(x.dtype)))
        s = torch.sigmoid(F.linear(s, self.expand.weight.to(x.dtype),
                                   self.expand.bias.to(x.dtype)))
        return x * resize_bilinear(s.reshape(b, *self.pool, 1), (h, w))


def drop_connect(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Per-sample stochastic depth (the JAX package's ``DropConnect`` in
    training): keep each sample with probability 1 - rate, scaled by
    1 / (1 - rate); the uniform draw comes from ``generator``, drawn for
    the global batch in a process group and sliced to this rank's rows,
    so a row's draw does not depend on the world size."""
    keep = 1.0 - rate
    b, n, r = x.shape[0], world(), rank()
    u = torch.rand((b * n,) + (1,) * (x.dim() - 1), generator=generator,
                   device=x.device, dtype=x.dtype)[r * b:(r + 1) * b]
    return (x / keep) * torch.floor(keep + u)


class MBConv(nn.Module):
    """EfficientNet mobile inverted bottleneck with SE: expand 1x1
    (skipped at expand_ratio 1) -> depthwise kxk (swish) -> SE -> project
    1x1; residual when stride 1 and in == out filters, in training behind
    drop-connect at ``drop_connect_rate``, drawn from the ``generator``
    passed to ``forward``. ``spatial_attention`` puts ``SpatialAttention``
    in the SE's place (the JAX ``MBConvBlockSpatial`` variant); it needs
    ``spatial_hw``, the (H, W) of the depthwise's output."""

    def __init__(self, input_filters: int, output_filters: int, kernel_size: int = 3,
                 stride: int = 1, expand_ratio: int = 6, se_ratio: Optional[float] = 0.25,
                 id_skip: bool = True, momentum: float = 0.99, drop_connect_rate: float = 0.0,
                 spatial_attention: bool = False,
                 spatial_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        filters = input_filters * expand_ratio
        self.residual = id_skip and stride == 1 and input_filters == output_filters
        self.drop_connect_rate = drop_connect_rate
        self.expand = (ConvBN(input_filters, filters, 1, act=swish, momentum=momentum)
                       if expand_ratio != 1 else None)
        self.depthwise = DepthwiseConvBN(filters, kernel_size, stride, act=swish,
                                         momentum=momentum)
        if spatial_attention and spatial_hw is None:
            raise ValueError("spatial_attention needs spatial_hw")
        self.spatial = SpatialAttention(filters, spatial_hw) if spatial_attention else None
        self.se = (SqueezeExcite(max(1, int(input_filters * se_ratio)), filters)
                   if se_ratio is not None and 0.0 < se_ratio <= 1.0 and not spatial_attention
                   else None)
        self.project = ConvBN(filters, output_filters, 1, act=None, momentum=momentum)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x, train)
        y = self.depthwise(y, train)
        if self.spatial is not None:
            y = self.spatial(y)
        elif self.se is not None:
            y = self.se(y)
        y = self.project(y, train)
        if not self.residual:
            return y
        if train and self.drop_connect_rate > 0:
            if generator is None:
                raise ValueError("drop-connect in training needs a generator")
            y = drop_connect(y, self.drop_connect_rate, generator)
        return y + x


def check_rows_aligned(x: torch.Tensor, stride: int) -> None:
    """On a row shard: its rows of ``x``'s map start and end at multiples
    of ``stride`` (the partition cuts at the deepest level), so an op
    that reads whole ``stride``-row groups is local."""
    shard = spatial_shard()
    if shard is not None:
        shard.level(x.shape[1], stride)


def maxpool_downsample(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Max pool with window = stride, VALID padding, NHWC; local to a row
    shard."""
    check_rows_aligned(x, stride)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride)
    return y.permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC; local to a row shard."""
    check_rows_aligned(x, 1)
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every conv kernel with ``conv_kernel_init`` and of
    every dense kernel with a fan-in normal; biases, BatchNorm and fusion
    weights keep their constructor values (zeros, identity statistics and
    ones), as the Flax initialisers give."""
    for m in module.modules():
        if isinstance(m, Conv2dSame):
            conv_kernel_init(m.weight, generator)
        elif isinstance(m, nn.Linear):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.in_features ** -0.5)


@torch.no_grad()
def calibrate_bn(model: nn.Module, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of its conv's
    output on ``images``, in one forward pass in layer order. Seeded
    fan-out weights with identity statistics shrink activations some 50x
    per MobileNetV2 block; calibrated, every layer carries unit-scale
    activations, as trained weights do (for checks on seeded weights)."""

    def hook(mod, inp):
        conv = mod.conv if isinstance(mod, ConvBN) else mod.dwconv
        y = conv(inp[0]).float()
        mod.bn.running_mean.copy_(y.mean(dim=(0, 1, 2)))
        mod.bn.running_var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (ConvBN, DepthwiseConvBN))]
    try:
        model(images)
    finally:
        for h in handles:
            h.remove()
