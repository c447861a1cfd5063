"""Dataset registry (a copy of ``distdiff_tpu/data/registry.py``) — the
reference's ``StandardDataLoader`` re-designed.

Same on-disk conventions, same dispatch-by-name set (``dataloader.py:
106-130``): ``cifar100_subset``, ``stanford_cars``, ``pathmnist``/
``bloodmnist``/``breastmnist``, ``caltech-101``, ``imagenette2-320``,
``oxford_flowers``, ``dtd``, ``oxford_pets``, ``fgvc_aircraft``. Root
convention ``./data/{dataset}`` (``dataloader.py:64``), medmnist under
``./data/medmnist/{name}``.

Returns a ``LoadedDataset`` (train/test ``ImageListDataset`` + classnames
with underscores space-normalized, matching ``dataloader.py:128-129``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from distdiff_tpu_torch.data.datasets import ArrayDataset, ImageListDataset

DATASET_PATH = "./data/{}"

MEDMNIST_NAMES = ("pathmnist", "bloodmnist", "breastmnist")

DATASETS = (
    "cifar100_subset",
    "stanford_cars",
    "caltech-101",
    "imagenette2-320",
    "oxford_flowers",
    "dtd",
    "oxford_pets",
    "fgvc_aircraft",
) + MEDMNIST_NAMES


@dataclasses.dataclass
class LoadedDataset:
    train: object
    test: object
    classnames: List[str]

    @property
    def num_classes(self) -> int:
        return len(self.classnames)


def _listdir_images(path: str) -> List[str]:
    return sorted(
        f for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp"))
    )


def _class_dir_split(root: str, categories: Sequence[str]) -> Tuple[List[str], List[int]]:
    paths, labels = [], []
    for i, cat in enumerate(categories):
        cdir = os.path.join(root, cat)
        for f in _listdir_images(cdir):
            paths.append(os.path.join(cdir, f))
            labels.append(i)
    return paths, labels


def _load_class_dir_dataset(
    root: str, train_dir: str, test_dir: str,
    train_tf, test_tf,
    drop: Sequence[str] = (),
    expect_classes: Optional[int] = None,
) -> LoadedDataset:
    train_path = os.path.join(root, train_dir)
    test_path = os.path.join(root, test_dir)
    categories = sorted(os.listdir(train_path))
    categories = [c for c in categories if c not in drop]
    if expect_classes is not None:
        assert len(categories) == expect_classes, (
            f"{root}: expected {expect_classes} classes, found {len(categories)}"
        )
    tr_paths, tr_labels = _class_dir_split(train_path, categories)
    te_paths, te_labels = _class_dir_split(test_path, categories)
    return LoadedDataset(
        train=ImageListDataset(tr_paths, tr_labels, train_tf),
        test=ImageListDataset(te_paths, te_labels, test_tf),
        classnames=list(categories),
    )


# ------------------------------------------------------------ per-dataset

def _load_caltech101(root, train_tf, test_tf):
    # drops BACKGROUND_Google / Faces_easy, asserts 100 (dataloader.py:272-315)
    return _load_class_dir_dataset(
        root, "train", "test", train_tf, test_tf,
        drop=("BACKGROUND_Google", "Faces_easy"), expect_classes=100,
    )


def _load_imagenette(root, train_tf, test_tf):
    return _load_class_dir_dataset(root, "train", "val", train_tf, test_tf)


def _load_medmnist(root, train_tf, test_tf):
    # class-per-directory train/test tree (dataloader.py:230-270)
    return _load_class_dir_dataset(root, "train", "test", train_tf, test_tf)


def _load_cifar100_subset(root, train_tf, test_tf):
    """Train images from class dirs under ./data/cifar100_subset; test split
    from the standard CIFAR-100 python pickle at ./data/cifar-100-python
    (the torchvision download location, dataloader.py:132-165)."""
    pickle_dir = os.path.join(os.path.dirname(root.rstrip("/")), "cifar-100-python")
    meta_path = os.path.join(pickle_dir, "meta")
    test_path = os.path.join(pickle_dir, "test")
    if os.path.exists(meta_path) and os.path.exists(test_path):
        with open(meta_path, "rb") as f:
            classnames = pickle.load(f, encoding="latin1")["fine_label_names"]
        with open(test_path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
        images = (
            np.asarray(d["data"], np.uint8)
            .reshape(-1, 3, 32, 32)
            .transpose(0, 2, 3, 1)
        )
        test = ArrayDataset(images, np.asarray(d["fine_labels"]), test_tf)
    else:
        # fallback: class-dir test tree next to the train tree
        classnames = sorted(os.listdir(root))
        te_paths, te_labels = _class_dir_split(
            os.path.join(os.path.dirname(root.rstrip("/")), "cifar100_subset_test"),
            classnames,
        ) if os.path.isdir(
            os.path.join(os.path.dirname(root.rstrip("/")), "cifar100_subset_test")
        ) else ([], [])
        test = ImageListDataset(te_paths, te_labels, test_tf)
    tr_paths, tr_labels = _class_dir_split(root, classnames)
    return LoadedDataset(
        train=ImageListDataset(tr_paths, tr_labels, train_tf),
        test=test,
        classnames=list(classnames),
    )


def _load_stanford_cars(root, train_tf, test_tf):
    from scipy import io as sio

    def read(anno_file, image_dir, meta):
        anno = sio.loadmat(anno_file)["annotations"][0]
        paths, labels = [], []
        cname_to_label = {}
        for a in anno:
            label = int(a["class"][0, 0]) - 1
            name = str(meta[label][0])
            parts = name.split(" ")
            year = parts.pop(-1)
            parts.insert(0, year)  # "2012 Tesla Model S" ordering
            cname_to_label.setdefault(" ".join(parts), label)
            paths.append(os.path.join(root, image_dir, str(a["fname"][0])))
            labels.append(label)
        names = [k for k, _ in sorted(cname_to_label.items(), key=lambda x: x[1])]
        return paths, labels, names

    meta = sio.loadmat(os.path.join(root, "devkit", "cars_meta.mat"))["class_names"][0]
    tr_paths, tr_labels, names = read(
        os.path.join(root, "devkit", "cars_train_annos.mat"), "cars_train", meta
    )
    te_paths, te_labels, _ = read(
        os.path.join(root, "cars_test_annos_withlabels.mat"), "cars_test", meta
    )
    assert len(names) == 196, len(names)
    return LoadedDataset(
        train=ImageListDataset(tr_paths, tr_labels, train_tf),
        test=ImageListDataset(te_paths, te_labels, test_tf),
        classnames=names,
    )


def _load_oxford_flowers(root, train_tf, test_tf):
    labels_dirs = sorted(os.listdir(os.path.join(root, "train")))
    tr_paths, tr_labels, te_paths, te_labels = [], [], [], []
    for label in labels_dirs:
        for f in _listdir_images(os.path.join(root, "train", label)):
            tr_paths.append(os.path.join(root, "train", label, f))
            tr_labels.append(int(label) - 1)
        for f in _listdir_images(os.path.join(root, "valid", label)):
            te_paths.append(os.path.join(root, "valid", label, f))
            te_labels.append(int(label) - 1)
    with open(os.path.join(root, "cat_to_name.json")) as f:
        lab2cname = json.load(f)
    names = [v for _, v in sorted(lab2cname.items(), key=lambda x: int(x[0]))]
    assert len(names) == 102, len(names)
    return LoadedDataset(
        train=ImageListDataset(tr_paths, tr_labels, train_tf),
        test=ImageListDataset(te_paths, te_labels, test_tf),
        classnames=names,
    )


def _load_dtd(root, train_tf, test_tf):
    image_dir = os.path.join(root, "images")
    categories = sorted(os.listdir(image_dir))
    c2l = {c: i for i, c in enumerate(categories)}

    def read(split_file):
        paths, labels = [], []
        with open(os.path.join(root, "labels", split_file)) as f:
            for line in f:
                rel = line.strip()
                if not rel:
                    continue
                paths.append(os.path.join(image_dir, rel))
                labels.append(c2l[rel.split("/")[0]])
        return paths, labels

    # train = train1 + val1 merged (dataloader.py:411-475)
    tr_p, tr_l = read("train1.txt")
    v_p, v_l = read("val1.txt")
    te_p, te_l = read("test1.txt")
    return LoadedDataset(
        train=ImageListDataset(tr_p + v_p, tr_l + v_l, train_tf),
        test=ImageListDataset(te_p, te_l, test_tf),
        classnames=categories,
    )


def _load_oxford_pets(root, train_tf, test_tf):
    image_dir = os.path.join(root, "images")

    def read(split_file, collect_names=False):
        paths, labels = [], []
        c2l = {}
        with open(os.path.join(root, "annotations", split_file)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                imname, label, _species, _ = line.split(" ")
                breed = "_".join(imname.split("_")[:-1]).lower()
                label = int(label) - 1
                c2l.setdefault(breed, label)
                paths.append(os.path.join(image_dir, imname + ".jpg"))
                labels.append(label)
        return paths, labels, c2l

    tr_p, tr_l, c2l = read("trainval.txt", collect_names=True)
    te_p, te_l, _ = read("test.txt")
    names = [k for k, _ in sorted(c2l.items(), key=lambda x: x[1])]
    assert len(names) == 37, len(names)
    return LoadedDataset(
        train=ImageListDataset(tr_p, tr_l, train_tf),
        test=ImageListDataset(te_p, te_l, test_tf),
        classnames=names,
    )


def _load_fgvc_aircraft(root, train_tf, test_tf):
    images_dir = os.path.join(root, "images")
    with open(os.path.join(root, "variants.txt")) as f:
        names = [l.strip() for l in f if l.strip()]
    c2l = {n: i for i, n in enumerate(names)}

    def read(split):
        paths, labels = [], []
        with open(os.path.join(root, f"images_variant_{split}.txt")) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                paths.append(os.path.join(images_dir, parts[0] + ".jpg"))
                labels.append(c2l[" ".join(parts[1:])])
        return paths, labels

    tr_p, tr_l = read("train")
    te_p, te_l = read("test")
    return LoadedDataset(
        train=ImageListDataset(tr_p, tr_l, train_tf),
        test=ImageListDataset(te_p, te_l, test_tf),
        classnames=names,
    )


_LOADERS = {
    "caltech-101": _load_caltech101,
    "imagenette2-320": _load_imagenette,
    "cifar100_subset": _load_cifar100_subset,
    "stanford_cars": _load_stanford_cars,
    "oxford_flowers": _load_oxford_flowers,
    "dtd": _load_dtd,
    "oxford_pets": _load_oxford_pets,
    "fgvc_aircraft": _load_fgvc_aircraft,
    **{name: _load_medmnist for name in MEDMNIST_NAMES},
}


def load_dataset(
    dataset: str,
    train_transform=None,
    test_transform=None,
    data_root: Optional[str] = None,
) -> LoadedDataset:
    """Load by name. Classnames come back space-normalized (underscores
    replaced), matching ``dataloader.py:128-129``."""
    if dataset not in _LOADERS:
        raise ValueError(f"Dataset not supported: {dataset!r} (known: {DATASETS})")
    if data_root is not None:
        root = os.path.join(data_root, "medmnist", dataset) \
            if dataset in MEDMNIST_NAMES else os.path.join(data_root, dataset)
    else:
        root = DATASET_PATH.format(
            f"medmnist/{dataset}" if dataset in MEDMNIST_NAMES else dataset
        )
    loaded = _LOADERS[dataset](root, train_transform, test_transform)
    loaded.classnames = [c.replace("_", " ") for c in loaded.classnames]
    return loaded
