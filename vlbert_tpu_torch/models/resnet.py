"""ResNet C4 backbone and conv5 RoI head (port of vlbert_tpu/models/resnet.py).

Module and parameter names follow the reference torch ResNet
(``conv1``, ``bn1``, ``layer3.0.downsample.0``, ...), so
``vlbert_tpu.training.convert`` maps them onto the JAX tree.

Public functions keep the JAX layout: images and feature maps are NHWC.
Inside, convolutions run on ``torch.channels_last`` tensors, so the NCHW
view of an NHWC tensor is already in the layout cuDNN wants and the body4
map handed back (``x.permute(0, 2, 3, 1)``) is NHWC-contiguous with no copy.
"""

from __future__ import annotations

import torch
from torch import nn

from vlbert_tpu_torch.models.layers import Conv2d, cast

# torchvision layer counts
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}



class FrozenBatchNorm(nn.Module):
    """BatchNorm with constant statistics: a per-channel affine folded in
    fp32 and applied in the compute dtype. Channels are dim 1 (NCHW)."""

    def __init__(self, num_features, eps=1e-5, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x):
        w = self.weight / torch.sqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * w
        d = self.compute_dtype
        return x * cast(w, d)[:, None, None] + cast(b, d)[:, None, None]


class BasicBlock(nn.Module):
    """3x3 -> 3x3 with expansion 1 (ResNet-18 and 34). Both convs take the
    dilation, the first the stride; ``stride_in_1x1`` does not apply."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False, stride_in_1x1=False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(inplanes, planes, 3, stride, dilation, **kw)
        self.bn1 = FrozenBatchNorm(planes, **kw)
        self.conv2 = Conv2d(planes, planes, 3, 1, dilation, **kw)
        self.bn2 = FrozenBatchNorm(planes, **kw)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, **kw),
                FrozenBatchNorm(planes, **kw))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with expansion 4. ``stride_in_1x1`` puts the stride
    on the first 1x1 conv (caffe/msra style) instead of the 3x3."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False, stride_in_1x1=False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(inplanes, planes, 1, s1, **kw)
        self.bn1 = FrozenBatchNorm(planes, **kw)
        self.conv2 = Conv2d(planes, planes, 3, s3, dilation, **kw)
        self.bn2 = FrozenBatchNorm(planes, **kw)
        self.conv3 = Conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = FrozenBatchNorm(planes * 4, **kw)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride, **kw),
                FrozenBatchNorm(planes * 4, **kw))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class ResNetStage(nn.Sequential):
    """A stack of residual blocks (torch ``_make_layer``); NCHW in/out.
    ``block``: "basic" or "bottleneck"."""

    def __init__(self, block, inplanes, planes, blocks, stride=1, dilation=1,
                 stride_in_1x1=False, *, dtype=torch.float32, device=None):
        cls = BLOCKS[block]
        out_ch = planes * cls.expansion
        need_ds = stride != 1 or inplanes != out_ch
        super().__init__(*[
            cls(inplanes if i == 0 else out_ch, planes,
                stride if i == 0 else 1, dilation, need_ds and i == 0,
                stride_in_1x1, dtype=dtype, device=device)
            for i in range(blocks)])


def _to_nchw(x):
    """NHWC tensor -> NCHW view in channels_last memory (no copy when x is
    NHWC-contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def c4_channels(num_layers):
    """Channels of body4, the C4 map: 256 for ResNet-18 / 34, 1024 for the
    bottleneck depths; the RoI head's output has twice as many."""
    block, _ = RESNET_SPECS[num_layers]
    return 256 * BLOCKS[block].expansion


class ResNetC4Backbone(nn.Module):
    """Stem + stages 1-3 (torch ``layer1..3``): [B, H, W, 3] NHWC ->
    stride-16 body4 [B, H/16, W/16, c4_channels] NHWC-contiguous.

    Frozen stages are a training matter (``requires_grad``); serving runs
    the whole backbone as is.
    """

    def __init__(self, num_layers=101, stride_in_1x1=False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        block, layers = RESNET_SPECS[num_layers]
        e = BLOCKS[block].expansion
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(3, 64, 7, 2, **kw)
        self.bn1 = FrozenBatchNorm(64, **kw)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = ResNetStage(block, 64, 64, layers[0], 1, **kw)
        self.layer2 = ResNetStage(block, 64 * e, 128, layers[1], 2,
                                  stride_in_1x1=stride_in_1x1, **kw)
        self.layer3 = ResNetStage(block, 128 * e, 256, layers[2], 2,
                                  stride_in_1x1=stride_in_1x1, **kw)
        self.to(memory_format=torch.channels_last)

    def forward(self, images):
        x = self.conv1(_to_nchw(images))
        x = self.maxpool(torch.relu(self.bn1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return x.permute(0, 2, 3, 1)   # body4, NHWC


class ResNetRoIHead(ResNetStage):
    """conv5 stage applied to RoI features: 3 blocks of the depth's kind
    for every depth, as the reference builds it. ``c5_dilated`` gives
    stride 1 and dilation 2. [N, 14, 14, C4] NHWC -> the unpooled map
    [N, h, w, 2 C4] NHWC in the compute dtype (C4 = ``c4_channels``: 2048
    out for the bottleneck depths, 512 for ResNet-18 / 34; h = w = 14
    dilated, 7 otherwise); FastRCNN applies the instance masks and pools,
    as the JAX package's ``average_pool=False`` head leaves it to."""

    def __init__(self, num_layers=101, c5_dilated=False, stride_in_1x1=False,
                 *, dtype=torch.float32, device=None):
        block, _ = RESNET_SPECS[num_layers]
        stride, dilation = (1, 2) if c5_dilated else (2, 1)
        super().__init__(block, c4_channels(num_layers), 512, 3, stride,
                         dilation, stride_in_1x1, dtype=dtype, device=device)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        return super().forward(_to_nchw(x)).permute(0, 2, 3, 1)
