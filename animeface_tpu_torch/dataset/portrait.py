'''The Danbooru Portrait dataset family (counterpart of
`animeface_tpu/dataset/portrait.py`): `<data root>/danbooru/portraits/
portraits/*`, with line art under `portraits/xdog/`. With `num_images` the
list is shuffled by the `random` module and cut to that many, as in JAX.
'''

from __future__ import annotations

import glob
import random
from collections.abc import Callable

from animeface_tpu_torch.dataset._base import (
    LRHR, Image, ImageGray, ImageImage, ImageXDoG, data_path, make_default_transform,
)


def _portrait_images(num_images: int | None = None) -> list[str]:
    paths = sorted(glob.glob(data_path('danbooru', 'portraits', 'portraits', '*')))
    if num_images is not None:
        random.shuffle(paths)
        paths = paths[:num_images]
    return paths


class DanbooruPortrait(Image):
    def __init__(self, image_size: int, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        if transform is None:
            transform = make_default_transform(image_size, 1.2)
        super().__init__(transform)

    def _load(self) -> list[str]:
        return _portrait_images(self.num_images)


class DanbooruPortraitCelebA(ImageImage):
    def __init__(self, image_size: int, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        if transform is None:
            transform = make_default_transform(image_size, 1.2)
        super().__init__(transform)

    def _load(self):
        images = _portrait_images()
        celeba = sorted(glob.glob(data_path('celeba', 'img_align_celeba', '*')))
        length = min(len(images), len(celeba))
        images, celeba = images[:length], celeba[:length]
        if self.num_images is not None and self.num_images < length:
            random.shuffle(images)
            random.shuffle(celeba)
            images, celeba = images[:self.num_images], celeba[:self.num_images]
        return images, celeba


class DanbooruPortraitSR(LRHR):
    def __init__(self, image_size: int, scale: float = 2,
                 resize_ratio: float = 1.1, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        super().__init__(image_size, scale, resize_ratio)
        if callable(transform):
            self.transform = transform

    def _load(self) -> list[str]:
        return _portrait_images(self.num_images)


class DanbooruPortraitGray(ImageGray):
    '''rgb + on-the-fly gray (resize ratio 1.125).'''

    def __init__(self, image_size: int, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        if transform is None:
            transform = make_default_transform(image_size, 1.125, hflip=False)
        super().__init__(transform)

    def _load(self):
        return _portrait_images(self.num_images)


class DanbooruPortraitXDoG(ImageXDoG):
    def __init__(self, image_size: int, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        if transform is None:
            transform = make_default_transform(image_size, 1.2, hflip=False)
        super().__init__(transform)

    def _load(self):
        paths = _portrait_images(self.num_images)
        return paths, [p.replace('portraits/portraits', 'portraits/xdog') for p in paths]
