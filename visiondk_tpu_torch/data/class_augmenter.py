"""Per-class augmentation dispatch (counterpart of ``visiondk_tpu/data/class_augmenter.py``).

Config maps class index → indices into the base transform list; samples of
that class run only the selected subset. Single-label (int) and multi-label
(vector) labels both dispatch; multi-label rows with a configured class use
the intersection rule of the reference (first matching class wins).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from visiondk_tpu_torch.data.transforms import Compose


class ClassWiseAugmenter:
    def __init__(
        self,
        base_transforms: Compose,
        class_transforms_config: Optional[Dict[int, Sequence[int]]] = None,
        common_indices: Optional[Sequence[int]] = None,
    ):
        self.base_transforms = base_transforms
        self.class_transforms = None
        if class_transforms_config:
            self.class_transforms = {
                int(c): Compose([base_transforms.transforms[i] for i in idxs])
                for c, idxs in class_transforms_config.items()
            }
        self.common = (
            Compose([base_transforms.transforms[i] for i in common_indices])
            if common_indices
            else None
        )

    def __call__(self, img, label=None):
        if self.class_transforms is None or label is None:
            return self.base_transforms(img)
        if isinstance(label, (int, np.integer)):
            t = self.class_transforms.get(int(label))
            return t(img) if t is not None else self.base_transforms(img)
        # multi-label: first configured class present in the label vector
        idxs = np.nonzero(np.asarray(label))[0]
        for i in idxs:
            if int(i) in self.class_transforms:
                return self.class_transforms[int(i)](img)
        return self.base_transforms(img)
