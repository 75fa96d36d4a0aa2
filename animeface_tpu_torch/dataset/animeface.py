'''The AnimeFace dataset (counterpart of `AnimeFace` in
`animeface_tpu/dataset/animeface.py`): the face crops under
`<data root>/animefacedataset/images/`, filtered by the year at the end of
each file name (`..._<year>.png`) when `min_year` is set.
'''

from __future__ import annotations

import glob
import os
from collections.abc import Callable

from animeface_tpu_torch.dataset._base import Image, make_default_transform, data_path


def _year_from_path(path: str) -> int:
    try:
        return int(os.path.splitext(os.path.basename(path))[0].split('_')[-1])
    except ValueError:
        return 0


def _animeface_images() -> list[str]:
    return sorted(glob.glob(data_path('animefacedataset', 'images', '*')))


class AnimeFace(Image):
    '''63.6k anime face crops, filterable by posted year.'''

    def __init__(self, image_size: int, min_year: int | None = 2005,
                 transform: Callable | None = None) -> None:
        self.min_year = min_year
        if transform is None:
            transform = make_default_transform(image_size)
        super().__init__(transform)

    def _load(self) -> list[str]:
        images = _animeface_images()
        if self.min_year is not None:
            images = [p for p in images if _year_from_path(p) >= self.min_year]
        return images
