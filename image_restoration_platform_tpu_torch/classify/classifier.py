"""Degradation types and their canonical order (the conditioning layout).

Copied from image_restoration_platform_tpu/classify/classifier.py; the host
ClassifierService is not ported (the restore path classifies on the device,
classify/fused.py).
"""

DEGRADATION_TYPES = {
    "blur": "Motion blur or out-of-focus areas",
    "noise": "Grain and digital noise",
    "lowLight": "Underexposed or shadow detail loss",
    "compression": "JPEG artifacts and quality loss",
    "scratch": "Physical damage and blemishes",
    "fade": "Color loss and contrast reduction",
    "colorShift": "White balance and color cast issues",
}

# canonical ordering: this is also the layout of the model conditioning vector
DEGRADATION_ORDER = tuple(DEGRADATION_TYPES.keys())
