'''The Danbooru 2020 dataset family (counterpart of
`animeface_tpu/dataset/danbooru.py`): `<data root>/danbooru/2020/*/*.jpg`;
with `num_images` the list is shuffled by the `random` module and cut.
'''

from __future__ import annotations

import glob
import random
from collections.abc import Callable

from animeface_tpu_torch.dataset._base import (
    LRHR, Image, data_path, make_default_transform, pil_image,
)


def _danbooru_images(num_images: int | None = None) -> list[str]:
    paths = sorted(glob.glob(data_path('danbooru', '2020', '*', '*.jpg')))
    if num_images is not None:
        random.shuffle(paths)
        paths = paths[:num_images]
    return paths


class Danbooru(Image):
    def __init__(self, image_size: int, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        if transform is None:
            transform = make_default_transform(image_size, 1.2)
        super().__init__(transform)

    def _load(self) -> list[str]:
        return _danbooru_images(self.num_images)


class DanbooruSR(LRHR):
    def __init__(self, image_size: int, scale: float = 2,
                 resize_ratio: float = 1.1, num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        self.num_images = num_images
        super().__init__(image_size, scale, resize_ratio)
        if callable(transform):
            self.transform = transform

    def _load(self) -> list[str]:
        return _danbooru_images(self.num_images)


class DanbooruAutoPair(Danbooru):
    '''On-the-fly pairs: (transform(img), transform(pair_transform(img))).
    Every sample goes through `__getitem__`: the native pipeline decodes
    single images, not pairs (the JAX class inherits it from `Image`).'''

    def __init__(self, image_size: int, pair_transform: Callable,
                 num_images: int | None = None,
                 transform: Callable | None = None) -> None:
        super().__init__(image_size, num_images, transform)
        self.pair_transform = pair_transform

    def __getitem__(self, index):
        return self._transform(pil_image().open(self.images[index]).convert('RGB'))

    def _transform(self, image):
        pair_image = self.transform(self.pair_transform(image))
        return self.transform(image), pair_image

    def native_ok(self) -> bool:
        return False
