"""Image datasets: CIFAR parsers, filelist/folder datasets, synthetic data
(counterpart of dynamic_tuning_tpu/data/datasets.py).

Replaces the reference's torchvision-backed builders
(datasets/image_datasets.py:8-105, vendored dataset classes datasets/*.py)
without torchvision: datasets yield fixed-size uint8 HWC canvases + labels;
all augmentation happens on the device (data/transforms.py).  Decoding
imports PIL inside the call, so a machine without PIL runs every dataset
that decodes nothing (synthetic, CIFAR, SVHN).

Dataset protocol: ``len(ds)``, ``ds[i] -> (np.uint8 [H,W,3], int label)``,
``ds.num_classes``, ``ds.metric`` ("accuracy" | "mean_per_class_acc",
reference image_datasets.py:36-105 picks per dataset).
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from dynamic_tuning_tpu_torch.data.vtab import parse_filelist, vtab_num_classes

# datasets evaluated with mean per-class accuracy in the reference
# (image_datasets.py: flowers102 / aircraft / pets use mean_per_class_acc)
MEAN_PER_CLASS = {"flowers102", "fgvc_aircraft", "oxford_iiit_pet"}


def _pil_canvas(im, canvas: int, square: bool = False) -> np.ndarray:
    """Decode-time canvas: PIL BICUBIC, matching the reference transforms.

    The reference feeds PIL-bicubic pixels (torchvision ``interpolation=3``:
    image_datasets.py:17,22, image_datasets_noaug.py:16-23), so the canvas
    resample uses PIL itself.

    square=False: torchvision Resize(short=canvas) + CenterCrop(canvas)
    (truncating long-side math, round-half-even crop offsets — the eval
    transform scaled to the canvas).  square=True: the VTAB no-aug
    Resize((canvas, canvas))."""
    from PIL import Image

    if square:
        im = im.resize((canvas, canvas), Image.BICUBIC)
    else:
        w, h = im.size
        if w <= h:
            nw, nh = canvas, int(canvas * h / w)
        else:
            nw, nh = int(canvas * w / h), canvas
        im = im.resize((nw, nh), Image.BICUBIC)
        left, top = round((nw - canvas) / 2.0), round((nh - canvas) / 2.0)
        im = im.crop((left, top, left + canvas, top + canvas))
    return np.asarray(im, np.uint8)


def decode_canvas(path: str, canvas: int, square: bool = False) -> np.ndarray:
    """PIL decode + the shared canvas resize."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    if im.size[0] < 2 or im.size[1] < 2:
        return np.zeros((canvas, canvas, 3), np.uint8)
    return _pil_canvas(im, canvas, square)


class ArrayDataset:
    """In-memory uint8 image array + labels (CIFAR & synthetic)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 num_classes: int, metric: str = "accuracy"):
        assert images.dtype == np.uint8 and images.ndim == 4
        self.images, self.labels = images, np.asarray(labels, np.int32)
        self.num_classes = num_classes
        self.metric = metric

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


class SyntheticDataset:
    """Deterministic fake data (the reference's DummyDataset analogue,
    video_datasets/k400.py:323-339) for pipeline and perf isolation."""

    def __init__(self, n: int = 1024, size: int = 224, num_classes: int = 100,
                 metric: str = "accuracy", seed: int = 0):
        self.n, self.size = n, size
        self.num_classes, self.metric = num_classes, metric
        self._rs = np.random.RandomState(seed)
        self._img = self._rs.randint(0, 256, (64, size, size, 3), np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self._img[i % 64], int(i % self.num_classes)


class ImageFilelist:
    """`path label` list file + image root, PIL-decoded to a fixed canvas
    (reference datasets/vtab.py:54-74)."""

    def __init__(self, root: str, listfile: str, num_classes: int,
                 canvas: int = 224, metric: str = "accuracy",
                 square: bool = True):
        self.root = root
        self.items = parse_filelist(listfile)
        self.num_classes = num_classes
        self.canvas = canvas
        self.metric = metric
        self.square = square

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        rel, label = self.items[i]
        return decode_canvas(os.path.join(self.root, rel), self.canvas,
                             self.square), label


class ImageFolder:
    """class-per-subdirectory layout (ImageNet-style), fixed-canvas decode."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str, canvas: int = 256, metric: str = "accuracy"):
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.num_classes = len(classes)
        self.canvas = canvas
        self.metric = metric
        self.square = False

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, label = self.samples[i]
        return decode_canvas(path, self.canvas), label


# ---------------------------------------------------------------------------
# CIFAR (python-pickle layout, parsed directly — no torchvision)
# ---------------------------------------------------------------------------

def _load_cifar_pickles(files, label_key) -> Tuple[np.ndarray, np.ndarray]:
    imgs, labels = [], []
    for f in files:
        with open(f, "rb") as fh:
            d = pickle.load(fh, encoding="latin1")
        imgs.append(np.asarray(d["data"], np.uint8))
        labels.extend(d[label_key])
    x = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(labels, np.int32)


def load_cifar100(root: str, train: bool) -> ArrayDataset:
    base = os.path.join(root, "cifar-100-python")
    f = os.path.join(base, "train" if train else "test")
    x, y = _load_cifar_pickles([f], "fine_labels")
    return ArrayDataset(x, y, 100)


def load_cifar10(root: str, train: bool) -> ArrayDataset:
    base = os.path.join(root, "cifar-10-batches-py")
    files = ([os.path.join(base, f"data_batch_{i}") for i in range(1, 6)]
             if train else [os.path.join(base, "test_batch")])
    x, y = _load_cifar_pickles(files, "labels")
    return ArrayDataset(x, y, 10)


# ---------------------------------------------------------------------------
# builder (reference build_image_dataset, datasets/image_datasets.py:8-105)
# ---------------------------------------------------------------------------

def build_image_dataset(dataset: str, data_path: str, *, no_aug: bool = False,
                        canvas: int = 0):
    """-> (train_ds, val_ds, num_classes, metric).

    ``no_aug`` selects the VTAB 224x224 canvas (both splits resized, no
    augmentation — reference image_datasets_noaug.py); otherwise the train
    canvas keeps enough pixels for on-device RandomResizedCrop.  ``canvas``
    overrides the short side (0 = default): larger keeps more source detail
    for the train crop at proportional loader cost.
    """
    canvas = canvas or (224 if no_aug else 256)
    if dataset.startswith("synthetic"):
        nc = 100
        train = SyntheticDataset(1024, canvas, nc)
        val = SyntheticDataset(256, canvas, nc, seed=1)
        return train, val, nc, "accuracy"
    # VTAB task via filelists — matched on the UNSTRIPPED name and tried
    # BEFORE the full-dataset parsers, exactly like the reference's
    # dispatch (image_datasets.py:45-48 checks _DATASET_NAME before the
    # *_full branches): a bare overlapping name ("svhn", "dtd", "cifar",
    # "oxford_iiit_pet") means the VTAB-1K task, while the "_full" suffix
    # selects the full dataset ("svhn_full" is not a VTAB name, so it
    # falls through to the parsers below)
    try:
        nc = vtab_num_classes(dataset)
    except KeyError:
        nc = None  # not a VTAB task name; fall through to the parsers
    if nc is not None:
        root = os.path.join(data_path, dataset)
        # square stretch only for the VTAB no-aug protocol; aug mode keeps
        # aspect ratio (short-side + center crop) like the reference's
        # Resize(256)+CenterCrop path
        train = ImageFilelist(root, os.path.join(root, "train800val200.txt"),
                              nc, canvas=canvas, square=no_aug)
        val = ImageFilelist(root, os.path.join(root, "test.txt"), nc,
                            canvas=canvas, square=no_aug)
        return train, val, nc, "accuracy"
    # the reference's full-dataset names carry a "_full" suffix
    # (image_datasets.py:32-96: cifar100_full, svhn_full, ...); strip it
    # AFTER the VTAB match so reference invocations work unchanged
    if dataset.endswith("_full"):
        dataset = dataset[: -len("_full")]
    if dataset == "cifar100":
        return (*_pair(load_cifar100, data_path), 100, "accuracy")
    if dataset == "cifar10":
        return (*_pair(load_cifar10, data_path), 10, "accuracy")
    # fine-grained full datasets with dedicated parsers
    from dynamic_tuning_tpu_torch.data.fine_grained import BUILDERS, FileListDataset
    if dataset in BUILDERS:
        b = BUILDERS[dataset]
        train, val = b(data_path, "train"), b(data_path, "test")
        # honor --canvas / no_aug for the filelist-backed builders (svhn
        # returns an in-memory 32x32 ArrayDataset with no decode canvas)
        for ds in (train, val):
            if isinstance(ds, FileListDataset):
                ds.canvas = canvas
                ds.square = no_aug
        return train, val, train.num_classes, train.metric
    # folder dataset (imagenet & the full fine-grained sets)
    metric = "mean_per_class_acc" if dataset in MEAN_PER_CLASS else "accuracy"
    train = ImageFolder(os.path.join(data_path, dataset, "train"),
                        canvas=canvas, metric=metric)
    val = ImageFolder(os.path.join(data_path, dataset, "val"),
                      canvas=canvas, metric=metric)
    return train, val, train.num_classes, metric


def _pair(loader, root):
    return loader(root, True), loader(root, False)
