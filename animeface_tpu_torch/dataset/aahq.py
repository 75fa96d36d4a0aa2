'''The AAHQ dataset family (counterpart of `animeface_tpu/dataset/aahq.py`):
`<data root>/aahq/*`; with `num_images` below the count the list is
shuffled by the `random` module and cut.
'''

from __future__ import annotations

import glob
import random
from collections.abc import Callable

from animeface_tpu_torch.dataset._base import (
    LRHR, Image, ImageImage, data_path, make_default_transform,
)


def _aahq_images(num_images: int | None = None) -> list[str]:
    paths = sorted(glob.glob(data_path('aahq', '*')))
    if num_images is not None and 0 < num_images < len(paths):
        random.shuffle(paths)
        paths = paths[:num_images]
    return paths


class AAHQ(Image):
    def __init__(self, image_size: int, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        if transform is None:
            transform = make_default_transform(image_size)
        super().__init__(transform)

    def _load(self):
        return _aahq_images(self.num_images)


class AAHQSR(LRHR):
    def __init__(self, image_size: int, scale: float = 2, resize_scale: float = 1.,
                 num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        super().__init__(image_size, scale, resize_scale)
        if callable(transform):
            self.transform = transform

    def _load(self) -> list[str]:
        return _aahq_images(self.num_images)


class AAHQCelebA(ImageImage):
    def __init__(self, image_size: int, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        if transform is None:
            transform = make_default_transform(image_size)
        super().__init__(transform)

    def _load(self):
        images = _aahq_images()
        celeba = sorted(glob.glob(data_path('celeba', 'img_align_celeba', '*')))
        length = min(len(images), len(celeba))
        images, celeba = images[:length], celeba[:length]
        if self.num_images is not None and 0 < self.num_images < length:
            random.shuffle(images)
            random.shuffle(celeba)
            images, celeba = images[:self.num_images], celeba[:self.num_images]
        return images, celeba
