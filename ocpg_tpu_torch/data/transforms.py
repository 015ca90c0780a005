"""ImageNet normalisation constants (copied from ``ocpg_tpu/data/transforms.py``)."""

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
