"""Semantic-mask label catalogs; counterpart of ``nerf_tpu/utils/mask_utils.py``.

The ADE20K 150-class scene-parsing vocabulary and a binary person/non-person
map, each as an ordered name tuple with both mapping directions derived, and
the two lookups ``get_label_id_mapping`` and ``get_class_ids_from_labels``.
"""
from __future__ import annotations

# ADE20K scene-parsing classes, index = class id. Note: a few entries keep
# the vocabulary's published quirks (e.g. the trailing space in "bed ").
ADE20K_LABELS = (
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed ",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper", "fireplace",
    "refrigerator", "grandstand", "path", "stairs", "runway", "case",
    "pool table", "pillow", "screen door", "stairway", "river", "bridge",
    "bookcase", "blind", "coffee table", "toilet", "flower", "book", "hill",
    "bench", "countertop", "stove", "palm", "kitchen island", "computer",
    "swivel chair", "boat", "bar", "arcade machine", "hovel", "bus", "towel",
    "light", "truck", "tower", "chandelier", "awning", "streetlight",
    "booth", "television receiver", "airplane", "dirt track", "apparel",
    "pole", "land", "bannister", "escalator", "ottoman", "bottle", "buffet",
    "poster", "stage", "van", "ship", "fountain", "conveyer belt", "canopy",
    "washer", "plaything", "swimming pool", "stool", "barrel", "basket",
    "waterfall", "tent", "bag", "minibike", "cradle", "oven", "ball",
    "food", "step", "tank", "trade name", "microwave", "pot", "animal",
    "bicycle", "lake", "dishwasher", "screen", "blanket", "sculpture",
    "hood", "sconce", "vase", "traffic light", "tray", "ashcan", "fan",
    "pier", "crt screen", "plate", "monitor", "bulletin board", "shower",
    "radiator", "glass", "clock", "flag",
)

HUMAN_LABELS = ("non_person", "person")


def _build(labels):
    id_to_label = dict(enumerate(labels))
    label_to_id = {name: i for i, name in id_to_label.items()}
    return id_to_label, label_to_id


id_label_mapping_ade20k, label_id_mapping_ade20k = _build(ADE20K_LABELS)
id_label_mapping_human, label_id_mapping_human = _build(HUMAN_LABELS)


def get_label_id_mapping(use_human_mask: bool = False) -> dict:
    """The label->id catalog: the person map or ADE20K's."""
    return label_id_mapping_human if use_human_mask else label_id_mapping_ade20k


def get_class_ids_from_labels(labels, use_human_mask: bool = False) -> list:
    """Label names -> class ids in the chosen catalog."""
    mapping = get_label_id_mapping(use_human_mask)
    return [mapping[l] for l in labels]
