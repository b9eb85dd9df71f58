"""Fine-grained dataset parsers (full-dataset image recipes).

The reference vendors torchvision-style dataset classes for these
(datasets/dtd.py, fgvc_aircraft.py, flowers102.py, food101.py,
oxford_iiit_pet.py, stanford_cars.py — 672 LoC total) and dispatches on
``args.dataset`` in build_image_dataset (datasets/image_datasets.py:36-105).
Here each becomes a thin parser producing (path, label) sample lists consumed
by the loader; the eval metric follows the reference (mean per-class
accuracy for flowers/aircraft/pets).  A copy of
dynamic_tuning_tpu/data/fine_grained.py.

All parsers expect the standard extracted layouts of the upstream archives.
"""

from __future__ import annotations

import os
from typing import List, Tuple

Samples = List[Tuple[str, int]]


class FileListDataset:
    """(path, label) samples decoded to a fixed canvas (short-side resize +
    center crop, the shared PIL-bicubic canvas of datasets.decode_canvas) —
    the same protocol as datasets.ImageFolder."""

    def __init__(self, samples: Samples, num_classes: int, canvas: int = 256,
                 metric: str = "accuracy"):
        self.samples = samples
        self.num_classes = num_classes
        self.canvas = canvas
        self.metric = metric
        self.square = False

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from dynamic_tuning_tpu_torch.data.datasets import decode_canvas

        path, label = self.samples[i]
        # the no-aug protocol's square resize reaches the decode
        return decode_canvas(path, self.canvas, self.square), label


def flowers102(root: str, split: str) -> FileListDataset:
    """Oxford Flowers-102: imagelabels.mat + setid.mat (reference
    datasets/flowers102.py)."""
    from scipy.io import loadmat

    base = os.path.join(root, "flowers-102")
    labels = loadmat(os.path.join(base, "imagelabels.mat"))["labels"][0] - 1
    setid = loadmat(os.path.join(base, "setid.mat"))
    ids = {"train": setid["trnid"][0], "val": setid["valid"][0],
           "test": setid["tstid"][0]}[split]
    samples = [(os.path.join(base, "jpg", f"image_{i:05d}.jpg"),
                int(labels[i - 1])) for i in ids]
    return FileListDataset(samples, 102, metric="mean_per_class_acc")


def food101(root: str, split: str) -> FileListDataset:
    """Food-101: meta/{train,test}.txt of class/image ids (reference
    datasets/food101.py)."""
    base = os.path.join(root, "food-101")
    listfile = os.path.join(base, "meta",
                            "train.txt" if split == "train" else "test.txt")
    classes = sorted({line.split("/")[0]
                      for line in open(listfile).read().split()})
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for line in open(listfile).read().split():
        cls = line.split("/")[0]
        samples.append((os.path.join(base, "images", line + ".jpg"),
                        cls_idx[cls]))
    return FileListDataset(samples, len(classes))


def dtd(root: str, split: str, partition: int = 1) -> FileListDataset:
    """Describable Textures: labels/{split}{partition}.txt (reference
    datasets/dtd.py)."""
    base = os.path.join(root, "dtd")
    listfile = os.path.join(base, "labels", f"{split}{partition}.txt")
    lines = [ln.strip() for ln in open(listfile) if ln.strip()]
    classes = sorted({ln.split("/")[0] for ln in lines})
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = [(os.path.join(base, "images", ln), cls_idx[ln.split("/")[0]])
               for ln in lines]
    return FileListDataset(samples, len(classes))


def oxford_pets(root: str, split: str) -> FileListDataset:
    """Oxford-IIIT Pets: annotations/{trainval,test}.txt 'name class ...'
    (reference datasets/oxford_iiit_pet.py)."""
    base = os.path.join(root, "oxford-iiit-pet")
    listfile = os.path.join(base, "annotations",
                            "trainval.txt" if split == "train" else "test.txt")
    samples = []
    for ln in open(listfile):
        parts = ln.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        name, cls = parts[0], int(parts[1]) - 1
        samples.append((os.path.join(base, "images", name + ".jpg"), cls))
    return FileListDataset(samples, 37, metric="mean_per_class_acc")


def fgvc_aircraft(root: str, split: str) -> FileListDataset:
    """FGVC-Aircraft variant level: images_variant_{trainval,test}.txt
    (reference datasets/fgvc_aircraft.py)."""
    base = os.path.join(root, "fgvc-aircraft-2013b", "data")
    tag = "trainval" if split == "train" else "test"
    listfile = os.path.join(base, f"images_variant_{tag}.txt")
    rows = []
    for ln in open(listfile):
        ln = ln.strip()
        if not ln:
            continue
        img_id, variant = ln.split(" ", 1)
        rows.append((img_id, variant))
    classes = sorted({v for _, v in rows})
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = [(os.path.join(base, "images", img_id + ".jpg"), cls_idx[v])
               for img_id, v in rows]
    return FileListDataset(samples, len(classes), metric="mean_per_class_acc")


def stanford_cars(root: str, split: str) -> FileListDataset:
    """Stanford Cars via devkit .mat annotations (reference
    datasets/stanford_cars.py)."""
    from scipy.io import loadmat

    base = os.path.join(root, "stanford_cars")
    if split == "train":
        ann = loadmat(os.path.join(base, "devkit", "cars_train_annos.mat"))
        img_dir = os.path.join(base, "cars_train")
    else:
        ann = loadmat(os.path.join(base, "cars_test_annos_withlabels.mat"))
        img_dir = os.path.join(base, "cars_test")
    samples = []
    for a in ann["annotations"][0]:
        fname = str(a["fname"][0])
        cls = int(a["class"][0][0]) - 1
        samples.append((os.path.join(img_dir, fname), cls))
    return FileListDataset(samples, 196)


def svhn(root: str, split: str):
    """SVHN cropped-digits .mat -> in-memory ArrayDataset (reference uses
    torchvision SVHN)."""
    import numpy as np
    from scipy.io import loadmat

    from dynamic_tuning_tpu_torch.data.datasets import ArrayDataset

    mat = loadmat(os.path.join(root, "svhn",
                               f"{'train' if split == 'train' else 'test'}_32x32.mat"))
    x = np.ascontiguousarray(mat["X"].transpose(3, 0, 1, 2))  # HWCN -> NHWC
    y = mat["y"].astype(np.int32)[:, 0]
    y[y == 10] = 0
    return ArrayDataset(x.astype(np.uint8), y, 10)


BUILDERS = {
    "flowers102": flowers102,
    "food101": food101,
    "dtd": dtd,
    "oxford_iiit_pet": oxford_pets,
    "fgvc_aircraft": fgvc_aircraft,
    "stanford_cars": stanford_cars,
    "svhn": svhn,
}
