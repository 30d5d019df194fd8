"""Vision models (counterpart of ``paddle_tpu/vision/models.py``): LeNet,
ResNet and ResNeXt, VGG, AlexNet, MobileNet v1/v2/v3, DenseNet,
SqueezeNet, InceptionV3, ShuffleNetV2 and GoogLeNet, layer for layer and
name for name as the reference builds them (so a ``state_dict`` crosses
with ``convert.layer_state_from_numpy``). Their convs, pools and batch
norms are the surface's ``nn`` layers: plain PyTorch (cuDNN on the card),
as the reference leaves them to XLA.

``pretrained``: ``False`` builds the model from the current seed; a path
to a local file loads it through ``paddle.load``; any other truthy value
raises. No weights are registered (``model_urls`` is empty), and fetching
them (the reference's ``utils.download`` branch) is not ported: the port
runs without a network and raises ``NotImplementedError`` there.
"""
from __future__ import annotations

import os

from .. import nn
from ..ops.manipulation import concat, split

# arch -> (weights url, md5), as the reference's model_urls tables; empty
model_urls: dict = {}


def _load_pretrained(model, arch, pretrained):
    """``pretrained`` False: ``model`` as built; a local file: its
    ``state_dict`` loaded; anything else raises (no silent random
    init)."""
    if not pretrained:
        return model
    from ..framework_io import load

    if isinstance(pretrained, str):
        if "://" not in pretrained and os.path.exists(pretrained):
            model.set_state_dict(load(pretrained))
            return model
        raise NotImplementedError(
            f"pretrained={pretrained!r}: fetching weights (the reference's "
            "utils.download) is not ported; the port runs without a "
            "network, so pass the path of a local file")
    if arch in model_urls:
        raise NotImplementedError(
            f"pretrained=True for {arch!r} names {model_urls[arch][0]}: "
            "fetching weights is not ported; pass the path of a local file")
    raise RuntimeError(
        f"pretrained=True for {arch!r} but no weights are registered "
        f"in paddle.vision.models.model_urls and none were passed — "
        f"call with pretrained='<path>' to a local weights file. "
        f"Refusing to silently return random init.")


class LeNet(nn.Layer):
    """LeNet-5 for 1 x 28 x 28 inputs."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84), nn.Linear(84, num_classes)
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.fc(x)
        return x


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation, stride=stride, groups=groups, dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1, bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ResNet (and ResNeXt, wide ResNet) of ``depth`` 18 to 152."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True, groups=1):
        super().__init__()
        layer_cfg = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
        }
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3, bias_attr=False)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, 2, 1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride, bias_attr=False),
                norm_layer(planes * block.expansion),
            )
        layers = [
            block(self.inplanes, planes, stride, downsample, self.groups, self.base_width, norm_layer=norm_layer)
        ]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(
                block(self.inplanes, planes, groups=self.groups, base_width=self.base_width, norm_layer=norm_layer)
            )
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.fc(x)
        return x


def resnet18(pretrained=False, **kwargs):
    return _load_pretrained(ResNet(BasicBlock, 18, **kwargs), "resnet18", pretrained)


def resnet34(pretrained=False, **kwargs):
    return _load_pretrained(ResNet(BasicBlock, 34, **kwargs), "resnet34", pretrained)


def resnet50(pretrained=False, **kwargs):
    return _load_pretrained(ResNet(BottleneckBlock, 50, **kwargs), "resnet50", pretrained)


def resnet101(pretrained=False, **kwargs):
    return _load_pretrained(ResNet(BottleneckBlock, 101, **kwargs), "resnet101", pretrained)


def resnet152(pretrained=False, **kwargs):
    return _load_pretrained(ResNet(BottleneckBlock, 152, **kwargs), "resnet152", pretrained)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.classifier(x)
        return x


def _make_vgg_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


_VGG_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _load_pretrained(VGG(_make_vgg_layers(_VGG_CFGS[16], batch_norm), **kwargs), "vgg16", pretrained)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _load_pretrained(VGG(_make_vgg_layers(_VGG_CFGS[19], batch_norm), **kwargs), "vgg19", pretrained)


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2D(3, 2),
        )
        self.classifier = nn.Sequential(
            nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        x = nn.functional.flatten(x, 1)
        return self.classifier(x)


def alexnet(pretrained=False, **kwargs):
    return _load_pretrained(AlexNet(**kwargs), "alexnet", pretrained)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def conv_bn(inp, oup, k, s, p, groups=1):
            return nn.Sequential(
                nn.Conv2D(inp, oup, k, stride=s, padding=p, groups=groups, bias_attr=False),
                nn.BatchNorm2D(oup),
                nn.ReLU6(),
            )

        class InvertedResidual(nn.Layer):
            def __init__(self, inp, oup, stride, expand_ratio):
                super().__init__()
                hidden = int(round(inp * expand_ratio))
                self.use_res = stride == 1 and inp == oup
                layers = []
                if expand_ratio != 1:
                    layers.append(conv_bn(inp, hidden, 1, 1, 0))
                layers += [
                    conv_bn(hidden, hidden, 3, stride, 1, groups=hidden),
                    nn.Conv2D(hidden, oup, 1, bias_attr=False),
                    nn.BatchNorm2D(oup),
                ]
                self.conv = nn.Sequential(*layers)

            def forward(self, x):
                out = self.conv(x)
                return x + out if self.use_res else out

        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        input_channel = int(32 * scale)
        features = [conv_bn(3, input_channel, 3, 2, 1)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(
                    InvertedResidual(input_channel, out_c, s if i == 0 else 1, t)
                )
                input_channel = out_c
        self.last_channel = int(1280 * max(1.0, scale))
        features.append(conv_bn(input_channel, self.last_channel, 1, 1, 0))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes)
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return _load_pretrained(MobileNetV2(scale=scale, **kwargs), "mobilenet_v2", pretrained)


# -- resnext / wide resnet (ResNet parameterisations) ----------------------
def resnext50_32x4d(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 50, groups=32, width=4, **kw), "resnext50_32x4d", pretrained)


def resnext50_64x4d(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 50, groups=64, width=4, **kw), "resnext50_64x4d", pretrained)


def resnext101_32x4d(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 101, groups=32, width=4, **kw), "resnext101_32x4d", pretrained)


def resnext101_64x4d(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 101, groups=64, width=4, **kw), "resnext101_64x4d", pretrained)


def resnext152_32x4d(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 152, groups=32, width=4, **kw), "resnext152_32x4d", pretrained)


def resnext152_64x4d(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 152, groups=64, width=4, **kw), "resnext152_64x4d", pretrained)


def wide_resnet50_2(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 50, width=128, **kw), "wide_resnet50_2", pretrained)


def wide_resnet101_2(pretrained=False, **kw):
    return _load_pretrained(ResNet(BottleneckBlock, 101, width=128, **kw), "wide_resnet101_2", pretrained)


def vgg11(pretrained=False, batch_norm=False, **kw):
    cfg = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
    return _load_pretrained(VGG(_make_vgg_layers(cfg, batch_norm), **kw),
                            "vgg11", pretrained)


def vgg13(pretrained=False, batch_norm=False, **kw):
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
           512, 512, "M"]
    return _load_pretrained(VGG(_make_vgg_layers(cfg, batch_norm), **kw),
                            "vgg13", pretrained)


# -- MobileNetV1 ------------------------------------------------------------
class MobileNetV1(nn.Layer):
    """MobileNet v1: depthwise-separable stacks."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale))

        def dw_sep(inp, oup, stride):
            return nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride, 1, groups=inp,
                          bias_attr=False),
                nn.BatchNorm2D(inp), nn.ReLU(),
                nn.Conv2D(inp, oup, 1, 1, 0, bias_attr=False),
                nn.BatchNorm2D(oup), nn.ReLU(),
            )

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + [
               (512, 1024, 2), (1024, 1024, 1)]
        layers = [nn.Sequential(
            nn.Conv2D(3, c(32), 3, 2, 1, bias_attr=False),
            nn.BatchNorm2D(c(32)), nn.ReLU())]
        for inp, oup, st in cfg:
            layers.append(dw_sep(c(inp), c(oup), st))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return _load_pretrained(MobileNetV1(scale=scale, **kw), "mobilenet_v1", pretrained)


# -- MobileNetV3 ------------------------------------------------------------
class _SqueezeExcite(nn.Layer):
    def __init__(self, ch, squeeze=4):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, ch // squeeze, 1)
        self.fc2 = nn.Conv2D(ch // squeeze, ch, 1)

    def forward(self, x):
        s = self.pool(x)
        s = nn.functional.relu(self.fc1(s))
        s = nn.functional.hardsigmoid(self.fc2(s))
        return x * s


class _MBV3Block(nn.Layer):
    def __init__(self, inp, exp, out, k, stride, se, act):
        super().__init__()
        self.use_res = stride == 1 and inp == out
        act_layer = nn.Hardswish if act == "hs" else nn.ReLU
        layers = []
        if exp != inp:
            layers += [nn.Conv2D(inp, exp, 1, bias_attr=False),
                       nn.BatchNorm2D(exp), act_layer()]
        layers += [nn.Conv2D(exp, exp, k, stride, k // 2, groups=exp,
                             bias_attr=False),
                   nn.BatchNorm2D(exp), act_layer()]
        if se:
            layers.append(_SqueezeExcite(exp))
        layers += [nn.Conv2D(exp, out, 1, bias_attr=False),
                   nn.BatchNorm2D(out)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_ch, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale))

        layers = [nn.Sequential(
            nn.Conv2D(3, c(16), 3, 2, 1, bias_attr=False),
            nn.BatchNorm2D(c(16)), nn.Hardswish())]
        inp = c(16)
        for k, exp, out, se, act, st in cfg:
            layers.append(_MBV3Block(inp, c(exp), c(out), k, st, se, act))
            inp = c(out)
        last_conv = c(cfg[-1][1])
        layers.append(nn.Sequential(
            nn.Conv2D(inp, last_conv, 1, bias_attr=False),
            nn.BatchNorm2D(last_conv), nn.Hardswish()))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_ch), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.classifier(x)
        return x


_MBV3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hs", 2),
    (5, 240, 40, True, "hs", 1), (5, 240, 40, True, "hs", 1),
    (5, 120, 48, True, "hs", 1), (5, 144, 48, True, "hs", 1),
    (5, 288, 96, True, "hs", 2), (5, 576, 96, True, "hs", 1),
    (5, 576, 96, True, "hs", 1),
]
_MBV3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hs", 2), (3, 200, 80, False, "hs", 1),
    (3, 184, 80, False, "hs", 1), (3, 184, 80, False, "hs", 1),
    (3, 480, 112, True, "hs", 1), (3, 672, 112, True, "hs", 1),
    (5, 672, 160, True, "hs", 2), (5, 960, 160, True, "hs", 1),
    (5, 960, 160, True, "hs", 1),
]


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_SMALL, 1024, scale, num_classes, with_pool)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_LARGE, 1280, scale, num_classes, with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return _load_pretrained(MobileNetV3Small(scale=scale, **kw), "mobilenet_v3_small", pretrained)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return _load_pretrained(MobileNetV3Large(scale=scale, **kw), "mobilenet_v3_large", pretrained)


# -- DenseNet ---------------------------------------------------------------
class _DenseLayer(nn.Layer):
    def __init__(self, inp, growth, bn_size):
        super().__init__()
        self.block = nn.Sequential(
            nn.BatchNorm2D(inp), nn.ReLU(),
            nn.Conv2D(inp, bn_size * growth, 1, bias_attr=False),
            nn.BatchNorm2D(bn_size * growth), nn.ReLU(),
            nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                      bias_attr=False),
        )

    def forward(self, x):
        return concat([x, self.block(x)], axis=1)


class DenseNet(nn.Layer):
    """DenseNet 121 to 264."""

    _cfgs = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
             169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
             264: (6, 12, 64, 48)}

    def __init__(self, layers=121, growth_rate=32, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        block_cfg = self._cfgs[layers]
        ch = 2 * growth_rate
        feats = [nn.Sequential(
            nn.Conv2D(3, ch, 7, 2, 3, bias_attr=False),
            nn.BatchNorm2D(ch), nn.ReLU(), nn.MaxPool2D(3, 2, 1))]
        for bi, n_layers in enumerate(block_cfg):
            for _ in range(n_layers):
                feats.append(_DenseLayer(ch, growth_rate, bn_size))
                ch += growth_rate
            if bi != len(block_cfg) - 1:
                feats.append(nn.Sequential(
                    nn.BatchNorm2D(ch), nn.ReLU(),
                    nn.Conv2D(ch, ch // 2, 1, bias_attr=False),
                    nn.AvgPool2D(2, 2)))
                ch //= 2
        feats.append(nn.Sequential(nn.BatchNorm2D(ch), nn.ReLU()))
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.classifier(x)
        return x


def densenet121(pretrained=False, **kw):
    return _load_pretrained(DenseNet(121, **kw), "densenet121", pretrained)


def densenet161(pretrained=False, **kw):
    return _load_pretrained(DenseNet(161, growth_rate=48, **kw), "densenet161", pretrained)


def densenet169(pretrained=False, **kw):
    return _load_pretrained(DenseNet(169, **kw), "densenet169", pretrained)


def densenet201(pretrained=False, **kw):
    return _load_pretrained(DenseNet(201, **kw), "densenet201", pretrained)


def densenet264(pretrained=False, **kw):
    return _load_pretrained(DenseNet(264, **kw), "densenet264", pretrained)


# -- SqueezeNet -------------------------------------------------------------
class _Fire(nn.Layer):
    def __init__(self, inp, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(inp, squeeze, 1), nn.ReLU())
        self.e1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1), nn.ReLU())
        self.e3 = nn.Sequential(nn.Conv2D(squeeze, e3, 3, padding=1),
                                nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return concat([self.e1(s), self.e3(s)], axis=1)


class SqueezeNet(nn.Layer):
    """SqueezeNet 1.0 and 1.1."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, 2), nn.ReLU(), nn.MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), nn.MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2), _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, 2), nn.ReLU(), nn.MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2), _Fire(128, 32, 128, 128),
                _Fire(256, 32, 128, 128), nn.MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.classifier_conv = nn.Conv2D(512, num_classes, 1)
        self.pool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        x = nn.functional.relu(self.classifier_conv(x))
        x = self.pool(x)
        return nn.functional.flatten(x, 1)


def squeezenet1_0(pretrained=False, **kw):
    return _load_pretrained(SqueezeNet("1.0", **kw), "squeezenet1_0", pretrained)


def squeezenet1_1(pretrained=False, **kw):
    return _load_pretrained(SqueezeNet("1.1", **kw), "squeezenet1_1", pretrained)


# -- InceptionV3 (compact faithful variant) ---------------------------------
class _ConvBN(nn.Layer):
    def __init__(self, inp, out, k, **kw):
        super().__init__()
        self.conv = nn.Conv2D(inp, out, k, bias_attr=False, **kw)
        self.bn = nn.BatchNorm2D(out)

    def forward(self, x):
        return nn.functional.relu(self.bn(self.conv(x)))


class InceptionV3(nn.Layer):
    """The reference's compact InceptionV3: the stem and three mixed blocks
    with two reductions (its branch-concat topology at fewer blocks),
    and the 2048 -> ``num_classes`` head."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, stride=2), _ConvBN(32, 32, 3),
            _ConvBN(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _ConvBN(64, 80, 1), _ConvBN(80, 192, 3), nn.MaxPool2D(3, 2))

        def mixed(inp, b1, b5r, b5, b3r, b3, pool_p):
            class _Mixed(nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.b1 = _ConvBN(inp, b1, 1)
                    self.b5 = nn.Sequential(_ConvBN(inp, b5r, 1),
                                            _ConvBN(b5r, b5, 5, padding=2))
                    self.b3 = nn.Sequential(
                        _ConvBN(inp, b3r, 1),
                        _ConvBN(b3r, b3, 3, padding=1),
                        _ConvBN(b3, b3, 3, padding=1))
                    self.pool = nn.Sequential(nn.AvgPool2D(3, 1, 1),
                                              _ConvBN(inp, pool_p, 1))

                def forward(self, x):
                    return concat(
                        [self.b1(x), self.b5(x), self.b3(x), self.pool(x)],
                        axis=1)

            return _Mixed()

        self.mixed1 = mixed(192, 64, 48, 64, 64, 96, 32)   # -> 256
        self.mixed2 = mixed(256, 64, 48, 64, 64, 96, 64)   # -> 288
        self.reduce1 = nn.Sequential(_ConvBN(288, 768, 3, stride=2))
        self.mixed3 = mixed(768, 192, 128, 192, 128, 192, 192)  # -> 768
        self.reduce2 = nn.Sequential(_ConvBN(768, 2048, 3, stride=2))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.mixed2(self.mixed1(x))
        x = self.mixed3(self.reduce1(x))
        x = self.reduce2(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.fc(x)
        return x


def inception_v3(pretrained=False, **kw):
    return _load_pretrained(InceptionV3(**kw), "inception_v3", pretrained)


# -- ShuffleNetV2 -----------------------------------------------------------
class _ShuffleUnit(nn.Layer):
    def __init__(self, inp, out, stride):
        super().__init__()
        self.stride = stride
        branch = out // 2
        if stride == 2:
            self.branch1 = nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride, 1, groups=inp,
                          bias_attr=False),
                nn.BatchNorm2D(inp),
                nn.Conv2D(inp, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU())
            in2 = inp
        else:
            self.branch1 = None
            in2 = inp // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(in2, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), nn.ReLU(),
            nn.Conv2D(branch, branch, 3, stride, 1, groups=branch,
                      bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), nn.ReLU())

    def forward(self, x):
        if self.stride == 2:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        else:
            x1, x2 = split(x, 2, axis=1)
            out = concat([x1, self.branch2(x2)], axis=1)
        # channel shuffle (groups=2)
        n, c, h, w = out.shape
        out = out.reshape([n, 2, c // 2, h, w]).transpose(
            [0, 2, 1, 3, 4]).reshape([n, c, h, w])
        return out


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        chs = {0.25: (24, 48, 96, 512), 0.33: (32, 64, 128, 512),
               0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
               1.5: (176, 352, 704, 1024), 2.0: (244, 488, 976, 2048)}[scale]
        self.stem = nn.Sequential(
            nn.Conv2D(3, 24, 3, 2, 1, bias_attr=False), nn.BatchNorm2D(24),
            nn.ReLU(), nn.MaxPool2D(3, 2, 1))
        stages = []
        inp = 24
        for ci, reps in zip(chs[:3], (4, 8, 4)):
            stages.append(_ShuffleUnit(inp, ci, 2))
            for _ in range(reps - 1):
                stages.append(_ShuffleUnit(ci, ci, 1))
            inp = ci
        self.stages = nn.Sequential(*stages)
        self.final = nn.Sequential(
            nn.Conv2D(inp, chs[3], 1, bias_attr=False),
            nn.BatchNorm2D(chs[3]), nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(chs[3], num_classes)

    def forward(self, x):
        x = self.final(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.fc(x)
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _load_pretrained(ShuffleNetV2(scale=0.25, **kw), "shufflenet_v2_x0_25", pretrained)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _load_pretrained(ShuffleNetV2(scale=0.33, **kw), "shufflenet_v2_x0_33", pretrained)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _load_pretrained(ShuffleNetV2(scale=0.5, **kw), "shufflenet_v2_x0_5", pretrained)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _load_pretrained(ShuffleNetV2(scale=1.0, **kw), "shufflenet_v2_x1_0", pretrained)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _load_pretrained(ShuffleNetV2(scale=1.5, **kw), "shufflenet_v2_x1_5", pretrained)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _load_pretrained(ShuffleNetV2(scale=2.0, **kw), "shufflenet_v2_x2_0", pretrained)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _load_pretrained(ShuffleNetV2(scale=1.0, act="swish", **kw), "shufflenet_v2_swish", pretrained)


# -- GoogLeNet --------------------------------------------------------------
class GoogLeNet(nn.Layer):
    """The reference's compact Inception-v1 (main head only)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, 2, 3), nn.ReLU(), nn.MaxPool2D(3, 2, 1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2, 1))

        def inc(inp, c1, c3r, c3, c5r, c5, pp):
            class _Inc(nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.b1 = nn.Sequential(nn.Conv2D(inp, c1, 1), nn.ReLU())
                    self.b3 = nn.Sequential(nn.Conv2D(inp, c3r, 1), nn.ReLU(),
                                            nn.Conv2D(c3r, c3, 3, padding=1),
                                            nn.ReLU())
                    self.b5 = nn.Sequential(nn.Conv2D(inp, c5r, 1), nn.ReLU(),
                                            nn.Conv2D(c5r, c5, 5, padding=2),
                                            nn.ReLU())
                    self.bp = nn.Sequential(nn.MaxPool2D(3, 1, 1),
                                            nn.Conv2D(inp, pp, 1), nn.ReLU())

                def forward(self, x):
                    return concat(
                        [self.b1(x), self.b3(x), self.b5(x), self.bp(x)],
                        axis=1)

            return _Inc()

        self.i3a = inc(192, 64, 96, 128, 16, 32, 32)    # 256
        self.i3b = inc(256, 128, 128, 192, 32, 96, 64)  # 480
        self.pool3 = nn.MaxPool2D(3, 2, 1)
        self.i4a = inc(480, 192, 96, 208, 16, 48, 64)   # 512
        self.i4e = inc(512, 256, 160, 320, 32, 128, 128)  # 832
        self.pool4 = nn.MaxPool2D(3, 2, 1)
        self.i5b = inc(832, 384, 192, 384, 48, 128, 128)  # 1024
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.pool4(self.i4e(self.i4a(x)))
        x = self.i5b(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.functional.flatten(x, 1)
            x = self.fc(x)
        return x, None, None  # (main, aux1, aux2), as the reference


def googlenet(pretrained=False, **kw):
    return _load_pretrained(GoogLeNet(**kw), "googlenet", pretrained)
