"""Prompt template banks (port of ``distdiff_tpu/utils/prompts.py``;
reference ``utils/prompts_helper.py``): the standard CLIP ensemble "photo"
templates plus hooks for per-dataset CuPL sentence banks (loaded from
``data/{dataset}_le.pkl`` by SDDataset when ``--language_enhance`` is
on)."""

from __future__ import annotations

from typing import Dict, List, Sequence

# The 7-template "photo" ensemble commonly used for zero-shot heads.
PHOTO_TEMPLATES: List[str] = [
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
]

SIMPLE_TEMPLATE = "a photo of a {}."


def expand_templates(
    classnames: Sequence[str], templates: Sequence[str] = PHOTO_TEMPLATES
) -> Dict[str, List[str]]:
    """class -> list of filled prompt sentences."""
    return {c: [t.format(c) for t in templates] for c in classnames}


def zero_shot_prompts(classnames: Sequence[str]) -> List[str]:
    """One simple prompt per class (the reference's zero-shot head uses the
    per-dataset CUSTOM_TEMPLATES; this is the generic fallback)."""
    return [SIMPLE_TEMPLATE.format(c) for c in classnames]


# ---------------------------------------------------------------------------
# Published CuPL question banks + per-dataset photo prompts (reference
# ``utils/prompts_helper.py:1-150``; the strings are the published CuPL
# paper's prompt data, reproduced as data parity — not on the live DistDiff
# path, used when generating ``{dataset}_le.pkl`` sentence banks offline).

CUPL_PROMPTS: Dict[str, List[str]] = {
    "birdsnap": [
        "Describe what {} {}, a species of bird, looks like",
        "What does {} {} look like",
        "Visually describe {} {}, a type of bird",
        "A caption of an image of {} {}, a type of bird",
        "Describe the appearance of {} {}",
        "What are the prominent features to identify {} {} bird",
    ],
    "caltech101": [
        "Describe what {} {} looks like",
        "What does {} {} look like",
        "Describe a photo of {} {}",
    ],
    "caltech256": [
        "Describe what {} {} looks like",
        "What does {} {} look like",
        "Describe a photo of {} {}",
    ],
    "cifar10": [
        "Describe what {} {} looks like",
        "How can you identify {} {}?",
        "What does {} {} look like?",
        "Describe an image from the internet of {} {}",
        "A caption of an image of {} {}: ",
    ],
    "cifar100": [
        "Describe what {} {} looks like",
        "How can you identify {} {}?",
        "What does {} {} look like?",
        "Describe an image from the internet of {} {}",
        "A caption of an image of {} {}: ",
    ],
    "country211": [
        "Visually describe what {} looks like",
        "What does the landscape of {} look like",
        "Describe a photo taken in {}",
        "How does a typical photo taken in {} look like",
    ],
    "cub": [
        "Describe what {} {}, a species of bird, looks like",
        "What does {} {} look like",
        "Visually describe {} {}, a type of bird",
        "A caption of an image of {} {}, a type of bird",
        "Describe the appearance of {} {}",
        "What are the prominent features to identify {} {} bird",
    ],
    "dtd": [
        "What does {} {} material look like?",
        "What does {} {} surface look like?",
        "What does {} {} texture look like?",
        "What does {} {} object look like?",
        "What does {} {} thing look like?",
        "What does {} {} pattern look like?",
    ],
    "eurosat": [
        "Describe an aerial satellite view of {} {}",
        "How does a satellite photo of {} {} look like",
        "Visually describe a centered satellite view of {} {}",
    ],
    "fgvc_aircraft": [
        "Describe {} {} aircraft",
        "Describe {} {} aircraft",
    ],
    "flowers102": [
        "What does {} {} flower look like",
        "Describe the appearance of {} {}",
        "A caption of an image of {} {}",
        "Visually describe {} {}, a type of flower",
    ],
    "food101": [
        "Describe what {} {} looks like",
        "Visually describe {} {}",
        "How can you tell that the food in this photo is {} {}?",
    ],
    "imagenet": [
        "Describe what {} {} looks like",
        "How can you identify {} {}?",
        "What does {} {} look like?",
        "Describe an image from the internet of {} {}",
        "A caption of an image of {} {}: ",
    ],
    "imagenet-r": [
        "An art drawing of {} {}",
        "Artwork showing {} {}",
        "A cartoon {} {}",
        "An origami of {} {}",
        "A deviant art photo depicting {} {}",
        "An embroidery of {} {}",
        "A graffiti art showing {} {}",
        "A painting of {} {}",
        "A sculpture of {} {}",
        "A black and white sketch of {} {}",
        "A toy {} {}",
        "A videogame of {} {}",
    ],
    "imagenet-sketch": [
        "Describe how a black and white sketch of {} {} looks like",
        "A black and white sketch of {} {}",
        "Describe a black and white sketch from the internet of {} {}",
    ],
    "oxfordpets": [
        "Describe what {} {} pet looks like",
        "Visually describe {} {}, a type of pet",
    ],
    "stanfordcars": [
        "How can you identify {} {}",
        "Description of {} {}, a type of car",
        "A caption of a photo of {} {}:",
        "What are the primary characteristics of {} {}?",
        "Description of the exterior of {} {}",
        "What are the identifying characteristics of {} {}, a type of car?",
        "Describe an image from the internet of {} {}",
        "Describe what {} {}, a type of car, looks like",
    ],
    "sun397": [
        "Describe what {} {} looks like",
        "How can you identify {} {}?",
        "Describe a photo of {} {}",
    ],
    "ucf101": [
        "What does a person doing {} look like",
        "Describe the process of {}",
        "How does a person {}",
    ],
}

PHOTO_PROMPTS: Dict[str, str] = {
    "birdsnap": "A photo of a {}, a type of bird.",
    "caltech101": "A photo of a {}.",
    "caltech256": "A photo of a {}.",
    "cifar10": "A photo of a {}.",
    "cifar100": "A photo of a {}.",
    "country211": "A photo I took in {}",
    "cub": "A photo of a {}, a type of bird.",
    "dtd": "{} texture.",
    "eurosat": "A centered satellite photo of {}.",
    "fgvc_aircraft": "A photo of a {}, a type of aircraft",
    "flowers102": "A photo of a {}, a type of flower.",
    "food101": "A photo of a {}, a type of food.",
    "imagenet": "A photo of a {}.",
    "imagenet-sketch": "A black and white pencil sketch of a {}.",
    "oxfordpets": "A photo of a pet {}.",
    "stanfordcars": "A photo of a {} car.",
    "sun397": "A photo of a {}.",
    "ucf101": "A photo of a person doing {}.",
}


def return_photo_prompts(dataset: str) -> str:
    """Reference API (``prompts_helper.py:149-150``)."""
    return PHOTO_PROMPTS[dataset]


def cupl_prompts(dataset: str) -> List[str]:
    return CUPL_PROMPTS[dataset]
