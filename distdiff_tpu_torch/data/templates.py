"""Per-dataset caption templates (a copy of ``distdiff_tpu/data/templates.py``;
reference ``dataloader.py:52-62``)."""

CUSTOM_TEMPLATES = {
    "oxford_pets": "a photo of a {}, a type of pet.",
    "oxford_flowers": "a photo of a {}, a type of flower.",
    "fgvc_aircraft": "a photo of a {}, a type of aircraft.",
    "dtd": "{} texture.",
    "stanford_cars": "a photo of a {}.",
    "cifar100_subset": "a photo of a {}.",
    "caltech-101": "a photo of a {}.",
    "imagenette2-320": "a photo of a {}.",
    "pathmnist": "a colon pathology histology slide of {}.",
    "bloodmnist": "a microscope blood cell image of {}.",
    "breastmnist": "a breast ultrasound image of {}.",
}


def template_for(dataset: str) -> str:
    return CUSTOM_TEMPLATES.get(dataset, "a photo of a {}.")
