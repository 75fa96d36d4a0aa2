'''The AnimeFace dataset family (counterpart of
`animeface_tpu/dataset/animeface.py`): the face crops under
`<data root>/animefacedataset/images/`, filtered by the year at the end of
each file name (`..._<year>.png`) when `min_year` is set, for every task:
images, AnimeFace + CelebA, SR, gray, XDoG line art (under `xdog/` beside
`images/`), and the labels of `labels.csv`.
'''

from __future__ import annotations

import csv
import glob
import os
import warnings
from collections.abc import Callable

from animeface_tpu_torch.dataset._base import (
    LRHR, Image, ImageGray, ImageImage, ImageLabel, ImageOnehot, ImageXDoG, data_path,
    make_default_transform,
)


def _year_from_path(path: str) -> int:
    try:
        return int(os.path.splitext(os.path.basename(path))[0].split('_')[-1])
    except ValueError:
        return 0


def _animeface_images(min_year: int | None = None) -> list[str]:
    images = sorted(glob.glob(data_path('animefacedataset', 'images', '*')))
    if min_year is not None:
        images = [p for p in images if _year_from_path(p) >= min_year]
    return images


def _celeba_images() -> list[str]:
    return sorted(glob.glob(data_path('celeba', 'img_align_celeba', '*')))


class AnimeFace(Image):
    '''63.6k anime face crops, filterable by posted year.'''

    def __init__(self, image_size: int, min_year: int | None = 2005,
                 transform: Callable | None = None) -> None:
        self.min_year = min_year
        if transform is None:
            transform = make_default_transform(image_size)
        super().__init__(transform)

    def _load(self) -> list[str]:
        return _animeface_images(self.min_year)


class AnimeFaceCelebA(ImageImage):
    '''AnimeFace + CelebA for unpaired I2I.'''

    def __init__(self, image_size: int, min_year: int | None = 2005,
                 transform: Callable | None = None) -> None:
        self.min_year = min_year
        if transform is None:
            transform = make_default_transform(image_size)
        super().__init__(transform)

    def _load(self):
        images = _animeface_images(self.min_year)
        celeba = _celeba_images()
        length = min(len(images), len(celeba))
        return images[:length], celeba[:length]


class AnimeFaceSR(LRHR):
    def __init__(self, image_size: int, scale: float = 2,
                 transform: Callable | None = None) -> None:
        if image_size > 128:
            warnings.warn('animeface images are small; use danbooru for SR')
        super().__init__(image_size, scale)
        if callable(transform):
            self.transform = transform

    def _load(self) -> list[str]:
        return _animeface_images()


class AnimeFaceGray(ImageGray):
    '''rgb + on-the-fly gray.'''

    def __init__(self, image_size: int, transform: Callable | None = None) -> None:
        if transform is None:
            transform = make_default_transform(image_size, hflip=False)
        super().__init__(transform)

    def _load(self):
        return _animeface_images()


class AnimeFaceXDoG(ImageXDoG):
    def __init__(self, image_size: int, min_year: int | None = 2005,
                 transform: Callable | None = None) -> None:
        self.min_year = min_year
        if transform is None:
            transform = make_default_transform(image_size, hflip=False)
        super().__init__(transform)

    def _load(self):
        images = _animeface_images(self.min_year)
        return images, [p.replace('images', 'xdog') for p in images]


def _read_labels_csv() -> tuple[list[str], list[str]]:
    with open(data_path('animefacedataset', 'labels.csv'), encoding='utf-8') as fin:
        rows = list(csv.reader(fin))
    return [r[0] for r in rows], [r[1] for r in rows]


class AnimeFaceLabel(ImageLabel):
    '''Images + illustration2vec tag labels (`labels.csv`).'''

    def __init__(self, image_size: int, transform: Callable | None = None) -> None:
        if transform is None:
            transform = make_default_transform(image_size)
        super().__init__(transform)

    def _load(self):
        return _read_labels_csv()


class AnimeFaceOneHot(ImageOnehot):
    def __init__(self, image_size: int, transform: Callable | None = None) -> None:
        if transform is None:
            transform = make_default_transform(image_size)
        super().__init__(transform)

    def _load(self):
        return _read_labels_csv()
