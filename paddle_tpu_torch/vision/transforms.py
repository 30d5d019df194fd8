"""Vision transforms over numpy arrays (counterpart of
``paddle_tpu/vision/transforms.py``): numpy, with ``scipy.ndimage``
imported where a warp needs it. Neither PIL nor cv2 is imported."""
from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, dtype=np.float32)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = [-1] + [1] * (arr.ndim - 1)
        else:
            shape = [1] * (arr.ndim - 1) + [-1]
        return (arr - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        if chw:
            arr = arr.transpose(1, 2, 0)
        h, w = arr.shape[:2]
        th, tw = self.size
        ys = (np.arange(th) * (h / th)).astype(np.int64).clip(0, h - 1)
        xs = (np.arange(tw) * (w / tw)).astype(np.int64).clip(0, w - 1)
        out = arr[ys][:, xs]
        if chw:
            out = out.transpose(2, 0, 1)
        return out


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(img[..., ::-1])
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            if img.ndim == 3:
                return np.ascontiguousarray(img[:, ::-1])
            return np.ascontiguousarray(img[::-1])
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0, keys=None):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)
        self.padding = padding

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        arr = img.transpose(1, 2, 0) if chw else img
        if self.padding:
            p = self.padding
            pads = [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pads)
        h, w = arr.shape[:2]
        th, tw = self.size
        y = np.random.randint(0, h - th + 1)
        x = np.random.randint(0, w - tw + 1)
        out = arr[y : y + th, x : x + tw]
        return out.transpose(2, 0, 1) if chw else out


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        arr = img.transpose(1, 2, 0) if chw else img
        h, w = arr.shape[:2]
        th, tw = self.size
        y = (h - th) // 2
        x = (w - tw) // 2
        out = arr[y : y + th, x : x + tw]
        return out.transpose(2, 0, 1) if chw else out


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return np.asarray(img).transpose(self.order)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.ascontiguousarray(np.asarray(img)[..., ::-1])


# -- functional long tail (parity: vision/transforms/functional.py) ---------
def vflip(img):
    return np.ascontiguousarray(np.asarray(img)[::-1])


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = np.asarray(img)
    if isinstance(padding, int):
        p = [(padding, padding), (padding, padding)]
    elif len(padding) == 2:
        p = [(padding[1], padding[1]), (padding[0], padding[0])]
    else:
        p = [(padding[1], padding[3]), (padding[0], padding[2])]
    if arr.ndim == 3:
        p = p + [(0, 0)]
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if padding_mode == "constant" else {}
    return np.pad(arr, p, mode=mode, **kw)


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    arr = np.asarray(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = arr.shape[:2]
    th, tw = output_size
    return crop(arr, (h - th) // 2, (w - tw) // 2, th, tw)


def adjust_brightness(img, brightness_factor):
    arr = np.asarray(img).astype(np.float32)
    hi = 255.0 if np.asarray(img).dtype == np.uint8 else 1.0
    out = np.clip(arr * brightness_factor, 0, hi)
    return out.astype(np.asarray(img).dtype)


def adjust_contrast(img, contrast_factor):
    arr = np.asarray(img).astype(np.float32)
    hi = 255.0 if np.asarray(img).dtype == np.uint8 else 1.0
    mean = arr.mean()
    out = np.clip((arr - mean) * contrast_factor + mean, 0, hi)
    return out.astype(np.asarray(img).dtype)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, -1)
    minc = np.min(rgb, -1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-10), 0)
    rc = (maxc - r) / np.maximum(d, 1e-10)
    gc = (maxc - g) / np.maximum(d, 1e-10)
    bc = (maxc - b) / np.maximum(d, 1e-10)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(d == 0, 0.0, h)
    return np.stack([h, s, v], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    out = np.choose(
        i[..., None] * 0 + i[..., None],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out


def adjust_hue(img, hue_factor):
    arr = np.asarray(img)
    dt = arr.dtype
    f = arr.astype(np.float32) / (255.0 if dt == np.uint8 else 1.0)
    hsv = _rgb_to_hsv(f)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv)
    return (out * (255.0 if dt == np.uint8 else 1.0)).astype(dt)


def adjust_saturation(img, saturation_factor):
    arr = np.asarray(img).astype(np.float32)
    gray = arr @ np.array([0.299, 0.587, 0.114], np.float32)
    out = arr * saturation_factor + gray[..., None] * (1 - saturation_factor)
    hi = 255.0 if np.asarray(img).dtype == np.uint8 else 1.0
    return np.clip(out, 0, hi).astype(np.asarray(img).dtype)


def to_grayscale(img, num_output_channels=1):
    arr = np.asarray(img).astype(np.float32)
    gray = arr @ np.array([0.299, 0.587, 0.114], np.float32)
    out = np.repeat(gray[..., None], num_output_channels, -1)
    return out.astype(np.asarray(img).dtype)


def erase(img, i, j, h, w, v, inplace=False):
    arr = np.asarray(img).copy()
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[2] not in (1, 3):
        arr[:, i:i + h, j:j + w] = v
    else:
        arr[i:i + h, j:j + w] = v
    return arr


def _affine_grid_sample(arr, matrix, fill=0.0, interpolation="bilinear",
                        out_hw=None, offset=(0.0, 0.0)):
    """Inverse-warp HWC image by a 2x3 matrix.

    interpolation: "nearest" (order 0, exact for label/mask images) or
    "bilinear". out_hw/offset support an expanded output canvas."""
    from scipy import ndimage as _nd

    h, w = arr.shape[:2]
    oh, ow = out_hw or (h, w)
    inv = np.linalg.inv(np.vstack([matrix, [0, 0, 1]]))[:2]
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    xs = xs + offset[0]
    ys = ys + offset[1]
    coords = np.stack([xs, ys, np.ones_like(xs)], 0).reshape(3, -1)
    src = inv @ coords
    sx, sy = src[0].reshape(oh, ow), src[1].reshape(oh, ow)
    order = 0 if interpolation == "nearest" else 1
    chans = []
    a3 = arr[..., None] if arr.ndim == 2 else arr
    for c in range(a3.shape[-1]):
        chans.append(_nd.map_coordinates(
            a3[..., c].astype(np.float32), [sy, sx], order=order, cval=fill))
    out = np.stack(chans, -1)
    return out[..., 0] if arr.ndim == 2 else out


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    arr = np.asarray(img)
    h, w = arr.shape[:2]
    cx, cy = center or ((w - 1) / 2.0, (h - 1) / 2.0)
    rad = -np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    m = np.array([[cos, -sin, cx - cos * cx + sin * cy],
                  [sin, cos, cy - sin * cx - cos * cy]], np.float32)
    out_hw, offset = None, (0.0, 0.0)
    if expand:
        # bounding box of the rotated corners
        corners = np.array([[0, 0, 1], [w - 1, 0, 1],
                            [w - 1, h - 1, 1], [0, h - 1, 1]], np.float32)
        warped = corners @ m.T
        xmin, ymin = warped.min(0)
        xmax, ymax = warped.max(0)
        out_hw = (int(np.ceil(ymax - ymin)) + 1, int(np.ceil(xmax - xmin)) + 1)
        offset = (float(xmin), float(ymin))
    return _affine_grid_sample(arr, m, fill, interpolation, out_hw,
                               offset).astype(arr.dtype)


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", center=None, fill=0):
    arr = np.asarray(img)
    h, w = arr.shape[:2]
    cx, cy = center or ((w - 1) / 2.0, (h - 1) / 2.0)
    rad = -np.deg2rad(angle)
    sx = np.deg2rad(shear[0] if isinstance(shear, (list, tuple)) else shear)
    sy = np.deg2rad(shear[1] if isinstance(shear, (list, tuple)) and len(shear) > 1 else 0.0)
    a = scale * np.cos(rad + sy) / np.cos(sy)
    b = scale * (np.cos(rad + sy) * np.tan(sx) / np.cos(sy) - np.sin(rad))
    c = scale * np.sin(rad + sy) / np.cos(sy)
    d = scale * (np.sin(rad + sy) * np.tan(sx) / np.cos(sy) + np.cos(rad))
    m = np.array([
        [a, b, cx + translate[0] - a * cx - b * cy],
        [c, d, cy + translate[1] - c * cx - d * cy],
    ], np.float32)
    return _affine_grid_sample(arr, m, fill, interpolation).astype(arr.dtype)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    arr = np.asarray(img)
    # solve homography from 4 correspondences
    A, bvec = [], []
    for (x, y), (u, v) in zip(startpoints, endpoints):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        bvec.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        bvec.append(v)
    hvec = np.linalg.solve(np.asarray(A, np.float64),
                           np.asarray(bvec, np.float64))
    H = np.append(hvec, 1.0).reshape(3, 3).astype(np.float32)
    from scipy import ndimage as _nd

    h, w = arr.shape[:2]
    inv = np.linalg.inv(H)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    coords = np.stack([xs, ys, np.ones_like(xs)], 0).reshape(3, -1)
    src = inv @ coords
    sx = (src[0] / src[2]).reshape(h, w)
    sy = (src[1] / src[2]).reshape(h, w)
    a3 = arr[..., None] if arr.ndim == 2 else arr
    chans = [_nd.map_coordinates(a3[..., ch].astype(np.float32), [sy, sx],
                                 order=1, cval=fill)
             for ch in range(a3.shape[-1])]
    out = np.stack(chans, -1)
    return (out[..., 0] if arr.ndim == 2 else out).astype(arr.dtype)


# -- transform classes -------------------------------------------------------
class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                top = np.random.randint(0, h - ch + 1)
                left = np.random.randint(0, w - cw + 1)
                patch = crop(arr, top, left, ch, cw)
                return resize(patch, self.size)
        return resize(center_crop(arr, min(h, w)), self.size)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        f = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        f = np.random.uniform(-self.value, self.value)
        return adjust_hue(img, f)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.ts = []
        if brightness:
            self.ts.append(BrightnessTransform(brightness))
        if contrast:
            self.ts.append(ContrastTransform(contrast))
        if saturation:
            self.ts.append(SaturationTransform(saturation))
        if hue:
            self.ts.append(HueTransform(hue))

    def _apply_image(self, img):
        order = np.random.permutation(len(self.ts))
        for i in order:
            img = self.ts[i](img)
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.args = (padding, fill, padding_mode)

    def _apply_image(self, img):
        return pad(img, *self.args)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        self.degrees = ((-degrees, degrees) if np.isscalar(degrees)
                        else tuple(degrees))
        self.kw = dict(interpolation=interpolation, expand=expand,
                       center=center, fill=fill)

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, **self.kw)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        self.degrees = ((-degrees, degrees) if np.isscalar(degrees)
                        else tuple(degrees))
        self.translate = translate
        self.scale_rng = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0
        if self.translate:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        sc = np.random.uniform(*self.scale_rng) if self.scale_rng else 1.0
        sh = (np.random.uniform(-self.shear, self.shear)
              if self.shear and np.isscalar(self.shear) else 0.0)
        return affine(arr, angle=angle, translate=(tx, ty), scale=sc,
                      shear=(sh, 0.0), fill=self.fill, center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() > self.prob:
            return np.asarray(img)
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(np.random.randint(0, dx + 1), np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1), np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1), h - 1 - np.random.randint(0, dy + 1)),
               (np.random.randint(0, dx + 1), h - 1 - np.random.randint(0, dy + 1))]
        return perspective(arr, start, end, fill=self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob, self.scale, self.ratio, self.value = prob, scale, ratio, value

    def _apply_image(self, img):
        if np.random.rand() > self.prob:
            return np.asarray(img)
        arr = np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[2] not in (1, 3)
        h, w = (arr.shape[1], arr.shape[2]) if chw else arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.random.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh)
                j = np.random.randint(0, w - ew)
                return erase(arr, i, j, eh, ew, self.value)
        return arr
