"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets.py``).

Nothing is downloaded. ``MNIST`` reads the idx files at the paths given
and, as the reference does, falls back to a synthetic set when they are
absent; ``Cifar10/100``, ``Flowers`` and ``VOC2012`` are the reference's
synthetic stand-ins; ``DatasetFolder`` reads class subdirectories of
``.npy`` files (a missing root raises ``FileNotFoundError``). ``FakeData``
makes image ``idx`` from ``RandomState(idx)``, the same arrays in both
packages. Samples are numpy: a transform may turn them into Tensors.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset


class FakeData(Dataset):
    """Synthetic image classification dataset (deterministic per index)."""

    def __init__(self, size=1000, image_shape=(1, 28, 28), num_classes=10, transform=None, dtype="float32"):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(*self.image_shape).astype(self.dtype)
        label = np.array(rng.randint(0, self.num_classes), dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class MNIST(Dataset):
    """MNIST from local idx files (paddle layout) or synthetic fallback."""

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            self.images = self._read_images(image_path)
            self.labels = self._read_labels(label_path)
        else:
            n = 60000 if mode == "train" else 10000
            fake = FakeData(size=min(n, 2048), image_shape=(28, 28))
            self.images = np.stack([fake[i][0] for i in range(len(fake))])
            self.labels = np.asarray([int(fake[i][1]) for i in range(len(fake))], np.int64)

    @staticmethod
    def _read_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return (data.reshape(n, rows, cols).astype(np.float32) / 255.0)

    @staticmethod
    def _read_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype(np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if img.ndim == 2:
            img = img[None]
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), np.array(self.labels[idx], np.int64)


FashionMNIST = MNIST


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        n = 1024
        fake = FakeData(size=n, image_shape=(3, 32, 32))
        self.data = [fake[i] for i in range(n)]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img, label = self.data[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class Cifar100(Cifar10):
    pass


class DatasetFolder(Dataset):
    """ImageFolder-style loader over class subdirectories of numpy files."""

    def __init__(self, root, loader=None, extensions=(".npy",), transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or (lambda p: np.load(p))
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for fname in sorted(os.listdir(d)):
                if fname.endswith(tuple(extensions)):
                    self.samples.append((os.path.join(d, fname), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array(label, np.int64)


ImageFolder = DatasetFolder


class Flowers(Dataset):
    """Synthetic-fallback Flowers102 (zero-egress stand-in)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, backend=None):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.n = 128
        self.transform = transform
        self.images = [
            (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            for _ in range(self.n)
        ]
        self.labels = rng.randint(0, 102, (self.n,))

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, int(self.labels[idx])

    def __len__(self):
        return self.n


class VOC2012(Dataset):
    """Synthetic-fallback VOC segmentation pairs."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 backend=None):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.n = 64
        self.transform = transform
        self.images = [
            (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            for _ in range(self.n)
        ]
        self.masks = [rng.randint(0, 21, (64, 64)).astype(np.uint8)
                      for _ in range(self.n)]

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return self.n
