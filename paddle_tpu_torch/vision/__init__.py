"""``paddle.vision``: datasets, transforms, models and detection ops
(counterpart of ``paddle_tpu/vision/__init__.py``)."""
from . import datasets  # noqa: F401
from . import transforms  # noqa: F401
from . import models  # noqa: F401
from .models import (  # noqa: F401
    AlexNet, DenseNet, GoogLeNet, InceptionV3, LeNet, MobileNetV1,
    MobileNetV2, MobileNetV3Large, MobileNetV3Small, ResNet, ShuffleNetV2,
    SqueezeNet, VGG, alexnet, densenet121, densenet161, densenet169,
    densenet201, densenet264, googlenet, inception_v3, mobilenet_v1,
    mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small, resnet18,
    resnet34, resnet50, resnet101, resnet152, resnext50_32x4d,
    resnext50_64x4d, resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
    resnext152_64x4d, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish, squeezenet1_0, squeezenet1_1,
    vgg11, vgg13, vgg16, vgg19, wide_resnet50_2, wide_resnet101_2)


_image_backend = "pil"


def set_image_backend(backend):
    """``'pil'``, ``'cv2'`` or ``'tensor'``."""
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unknown image backend {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image: a PIL image (``'pil'``), or its CHW array as a
    Tensor on the current place (``'tensor'``). PIL is imported here;
    cv2 is not a dependency."""
    backend = backend or _image_backend
    if backend == "cv2":
        raise ImportError("cv2 is not a dependency of the port; use the "
                          "'pil' or 'tensor' backend")
    from PIL import Image

    img = Image.open(path)
    if backend == "pil":
        return img
    import numpy as np

    from ..ops.creation import to_tensor

    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr.transpose(2, 0, 1)  # CHW, the reference tensor layout
    return to_tensor(arr)


from . import ops  # noqa: F401,E402
