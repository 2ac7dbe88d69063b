"""Per-flavor normalization statistics (the port of
``mfvit_tpu/data/constants.py``, same values).

The values are the reference's CheXpert augmentation constants
(aihc_utils/image_transform.py:4-19), in the cv2/BGR channel order the
reference feeds through PIL without conversion (loader.py:124-127); decode
keeps BGR so these stats line up.
"""
from __future__ import annotations

import math

# CheXpert original scans ('CheXpert-v1.0-small')
CXR_MEAN = (0.5020, 0.5020, 0.5020)
_cxr_std = round(math.sqrt(0.085585), 4)
CXR_STD = (_cxr_std, _cxr_std, _cxr_std)

# CheXpert enhanced ('CheXpert_Enh')
ENH_MEAN = (0.6086, 0.5204, 0.3384)
ENH_STD = (0.134909, 0.088268, 0.035044)

# COVID original CXR folder ('data')
DATA_MEAN = (0.5045, 0.5045, 0.5045)
DATA_STD = (0.2462, 0.2462, 0.2462)

# COVID enhanced folder ('Train_Mix')
TRAIN_MIX_MEAN = (0.2243, 0.5507, 0.6865)
TRAIN_MIX_STD = (0.1026, 0.2995, 0.3300)

# 4-channel stacked CXR+Enh (gray + 3 Enh channels; builder_4ch path)
MEAN_4CH = (0.5045, 0.2243, 0.5507, 0.6865)
STD_4CH = (0.2462, 0.1026, 0.2995, 0.3300)

# img_type -> (mean, std); keys are the reference's folder names
# (image_transform.py:69-78).
NORM_STATS = {
    "CheXpert-v1.0-small": (CXR_MEAN, CXR_STD),
    "CheXpert_Enh": (ENH_MEAN, ENH_STD),
    "data": (DATA_MEAN, DATA_STD),
    "Train_Mix": (TRAIN_MIX_MEAN, TRAIN_MIX_STD),
    "4ch": (MEAN_4CH, STD_4CH),
}


def norm_stats(img_type: str):
    try:
        return NORM_STATS[img_type]
    except KeyError:
        raise KeyError(
            f"unknown image flavor {img_type!r}; known: {sorted(NORM_STATS)}"
        ) from None
