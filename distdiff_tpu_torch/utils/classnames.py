"""Classname tables (port of ``distdiff_tpu/utils/classnames.py``; reference
``utils/classnames.py``): CIFAR lists used as fallbacks when dataset
metadata files are absent (e.g. cifar100_subset without the torchvision
pickle), plus the ImageNet/ImageNet-R/Country211 tables and synset lookups
(reference ``utils/classnames.py:169-232``, ``class_to_synset.py``,
``synset_to_class.py``), stored once as a pair table in
``utils/imagenet_tables.py``, the port's own copy of the data."""

from distdiff_tpu_torch.utils.imagenet_tables import (  # noqa: F401  (re-exports)
    CLASS_TO_SYNSET,
    COUNTRY211_CLASSES,
    IMAGENET_CLASSES,
    IMAGENET_R_CLASSES,
    SYNSET_TO_CLASS,
)


def imagenet_class_to_synset(label: str) -> str:
    """Classname -> WordNet id (reference ``classnames.py:46-47``)."""
    return CLASS_TO_SYNSET[label]


def imagenet_synset_to_class(synset: str) -> str:
    """WordNet id -> classname (reference ``classnames.py:49-50``)."""
    return SYNSET_TO_CLASS[synset]

CIFAR10_CLASSES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]

CIFAR100_CLASSES = [
    "apple", "aquarium_fish", "baby", "bear", "beaver", "bed", "bee",
    "beetle", "bicycle", "bottle", "bowl", "boy", "bridge", "bus",
    "butterfly", "camel", "can", "castle", "caterpillar", "cattle", "chair",
    "chimpanzee", "clock", "cloud", "cockroach", "couch", "crab",
    "crocodile", "cup", "dinosaur", "dolphin", "elephant", "flatfish",
    "forest", "fox", "girl", "hamster", "house", "kangaroo", "keyboard",
    "lamp", "lawn_mower", "leopard", "lion", "lizard", "lobster", "man",
    "maple_tree", "motorcycle", "mountain", "mouse", "mushroom", "oak_tree",
    "orange", "orchid", "otter", "palm_tree", "pear", "pickup_truck",
    "pine_tree", "plain", "plate", "poppy", "porcupine", "possum", "rabbit",
    "raccoon", "ray", "road", "rocket", "rose", "sea", "seal", "shark",
    "shrew", "skunk", "skyscraper", "snail", "snake", "spider", "squirrel",
    "streetcar", "sunflower", "sweet_pepper", "table", "tank", "telephone",
    "television", "tiger", "tractor", "train", "trout", "tulip", "turtle",
    "wardrobe", "whale", "willow_tree", "wolf", "woman", "worm",
]


def get_num_classes(dataset: str) -> int:
    """Expected class counts (used by asserts, mirroring the reference's
    per-dataset assertions at e.g. ``dataloader.py:295,389,455,525``)."""
    table = {
        "cifar100_subset": 100,
        "caltech-101": 100,
        "stanford_cars": 196,
        "oxford_flowers": 102,
        "oxford_pets": 37,
        "fgvc_aircraft": 100,
        "dtd": 47,
        "imagenette2-320": 10,
        "pathmnist": 9,
        "bloodmnist": 8,
        "breastmnist": 2,
        # zero-shot-bench tables (reference classnames.py:224-232)
        "imagenet": 1000,
        "imagenet-r": 200,
        "country211": 211,
    }
    return table.get(dataset, -1)
