from distdiff_tpu_torch.data import transforms
from distdiff_tpu_torch.data.datasets import (
    ArrayDataset,
    BatchLoader,
    ConcatDataset,
    DatasetByClassNames,
    ImageListDataset,
    RepeatDataset,
    SubsetDataset,
    load_image,
    read_png,
)
from distdiff_tpu_torch.data.registry import DATASETS, LoadedDataset, load_dataset
from distdiff_tpu_torch.data.sd_dataset import SDDataset, SDItem, collate_sd
from distdiff_tpu_torch.data.templates import CUSTOM_TEMPLATES, template_for

__all__ = [
    "ArrayDataset",
    "BatchLoader",
    "ConcatDataset",
    "DatasetByClassNames",
    "ImageListDataset",
    "RepeatDataset",
    "SubsetDataset",
    "load_image",
    "read_png",
    "DATASETS",
    "LoadedDataset",
    "load_dataset",
    "SDDataset",
    "SDItem",
    "collate_sd",
    "CUSTOM_TEMPLATES",
    "template_for",
    "transforms",
]
