'''Data layer (counterpart of `animeface_tpu/dataset/__init__.py`).

`build_dataset(args, task)` maps `--dataset` to its class for the task
(`image`, `celeba`, `sr`, `xdog`, `gray`, `label`, `onehot`), or to the
task's synthetic stand-in when `--synthetic-data` is set or the data root
is missing (with a warning). `build_loader` wraps it in a `DataLoader` and
refuses, at once, a file dataset that PIL would have to decode when PIL
does not import. `dataset/device.py` (`--device-data`) is ROADMAP Queue 1
item 6.
'''

from __future__ import annotations

import os
import warnings

from animeface_tpu_torch.dataset._base import (
    LRHR, DataLoader, Image, ImageGray, ImageImage, ImageLabel, ImageOnehot, ImageXDoG,
    WrappedDataset, data_path, make_default_transform, pil_available, set_data_root,
)
from animeface_tpu_torch.dataset.aahq import AAHQ, AAHQCelebA, AAHQSR
from animeface_tpu_torch.dataset.animeface import (
    AnimeFace, AnimeFaceCelebA, AnimeFaceGray, AnimeFaceLabel, AnimeFaceOneHot, AnimeFaceSR,
    AnimeFaceXDoG,
)
from animeface_tpu_torch.dataset.danbooru import Danbooru, DanbooruAutoPair, DanbooruSR
from animeface_tpu_torch.dataset.portrait import (
    DanbooruPortrait, DanbooruPortraitCelebA, DanbooruPortraitGray, DanbooruPortraitSR,
    DanbooruPortraitXDoG,
)
from animeface_tpu_torch.dataset.synthetic import (
    SyntheticImage, SyntheticImageGray, SyntheticImageImage, SyntheticImageLabel,
    SyntheticImageOnehot, SyntheticImageXDoG, SyntheticLRHR,
)

__all__ = ['AAHQ', 'AAHQCelebA', 'AAHQSR', 'AnimeFace', 'AnimeFaceCelebA', 'AnimeFaceGray',
           'AnimeFaceLabel', 'AnimeFaceOneHot', 'AnimeFaceSR', 'AnimeFaceXDoG', 'DataLoader',
           'Danbooru', 'DanbooruAutoPair', 'DanbooruPortrait', 'DanbooruPortraitCelebA',
           'DanbooruPortraitGray', 'DanbooruPortraitSR', 'DanbooruPortraitXDoG', 'DanbooruSR',
           'Image', 'ImageGray', 'ImageImage', 'ImageLabel', 'ImageOnehot', 'ImageXDoG', 'LRHR',
           'SyntheticImage', 'SyntheticImageGray', 'SyntheticImageImage', 'SyntheticImageLabel',
           'SyntheticImageOnehot', 'SyntheticImageXDoG', 'SyntheticLRHR', 'WrappedDataset',
           'build_dataset', 'build_loader', 'make_default_transform']

_REGISTRY = {
    # task -> dataset-name -> (cls, kwargs builder)
    'image': {
        'animeface': lambda a: (AnimeFace, dict(image_size=a.image_size,
                                                min_year=a.min_year)),
        'danbooru': lambda a: (DanbooruPortrait, dict(image_size=a.image_size,
                                                      num_images=a.num_images)),
        'danbooru2020': lambda a: (Danbooru, dict(image_size=a.image_size,
                                                  num_images=a.num_images)),
        'aahq': lambda a: (AAHQ, dict(image_size=a.image_size,
                                      num_images=a.num_images)),
    },
    'celeba': {
        'animeface': lambda a: (AnimeFaceCelebA, dict(image_size=a.image_size,
                                                      min_year=a.min_year)),
        'danbooru': lambda a: (DanbooruPortraitCelebA,
                               dict(image_size=a.image_size,
                                    num_images=a.num_images)),
        'aahq': lambda a: (AAHQCelebA, dict(image_size=a.image_size,
                                            num_images=a.num_images)),
    },
    'sr': {
        'animeface': lambda a: (AnimeFaceSR, dict(image_size=a.image_size,
                                                  scale=getattr(a, 'scale', 2))),
        'danbooru': lambda a: (DanbooruPortraitSR,
                               dict(image_size=a.image_size,
                                    scale=getattr(a, 'scale', 2),
                                    num_images=a.num_images)),
        'danbooru2020': lambda a: (DanbooruSR,
                                   dict(image_size=a.image_size,
                                        scale=getattr(a, 'scale', 2),
                                        num_images=a.num_images)),
    },
    'xdog': {
        'animeface': lambda a: (AnimeFaceXDoG, dict(image_size=a.image_size,
                                                    min_year=a.min_year)),
        'danbooru': lambda a: (DanbooruPortraitXDoG,
                               dict(image_size=a.image_size,
                                    num_images=a.num_images)),
    },
    'gray': {
        'animeface': lambda a: (AnimeFaceGray, dict(image_size=a.image_size)),
        'danbooru': lambda a: (DanbooruPortraitGray,
                               dict(image_size=a.image_size,
                                    num_images=a.num_images)),
    },
    'label': {
        'animeface': lambda a: (AnimeFaceLabel, dict(image_size=a.image_size)),
    },
    'onehot': {
        'animeface': lambda a: (AnimeFaceOneHot, dict(image_size=a.image_size)),
    },
}

_SYNTHETIC = {
    'image': lambda a: SyntheticImage(a.image_size, _syn_count(a), a.seed),
    'celeba': lambda a: SyntheticImageImage(a.image_size, _syn_count(a), a.seed),
    'sr': lambda a: SyntheticLRHR(a.image_size, getattr(a, 'scale', 2),
                                  _syn_count(a), a.seed),
    'xdog': lambda a: SyntheticImageXDoG(a.image_size, _syn_count(a), a.seed),
    'gray': lambda a: SyntheticImageGray(a.image_size, _syn_count(a), a.seed),
    'label': lambda a: SyntheticImageLabel(a.image_size, _syn_count(a), seed=a.seed),
    'onehot': lambda a: SyntheticImageOnehot(a.image_size, _syn_count(a), seed=a.seed),
}

#: the task bases of the datasets that read image files
_FILE_DATASETS = (Image, ImageImage, LRHR, ImageXDoG, ImageGray, ImageLabel)


def _syn_count(args) -> int:
    n = getattr(args, 'num_images', None) or 2048
    return min(int(n), 10_000)


def build_dataset(args, task: str = 'image'):
    '''Dataset instance for `--dataset <name>` under the given task.

    Falls back to the synthetic stand-in when `--synthetic-data` is set, or
    when the data root does not exist (with a warning).
    '''
    if getattr(args, 'data_root', None):
        set_data_root(args.data_root)
    use_synthetic = getattr(args, 'synthetic_data', False)
    if not use_synthetic and not os.path.isdir(
            getattr(args, 'data_root', None) or data_path()):
        warnings.warn(f'data root not found; using synthetic {task} data')
        use_synthetic = True
    if use_synthetic:
        return _SYNTHETIC[task](args)

    task_map = _REGISTRY[task]
    name = args.dataset
    if name not in task_map:
        raise KeyError(f'dataset {name!r} unsupported for task {task!r}; '
                       f'have {sorted(task_map)}')
    cls, kwargs = task_map[name](args)
    return cls(**kwargs)


def build_loader(args, task: str = 'image', batch_size: int | None = None,
                 **loader_kwargs) -> DataLoader:
    dataset = build_dataset(args, task)
    if isinstance(dataset, _FILE_DATASETS) and not pil_available():
        name = type(dataset).__name__
        if not hasattr(dataset, 'load_native_batch'):
            raise RuntimeError(f'{name} reads image files that only PIL decodes (its task has '
                               'no native path), and PIL does not import')
        if not dataset.native_ok():
            raise RuntimeError(
                f'{name} reads image files, and neither decoder loads: the native pipeline '
                '(native/libanimeface_io.so, which links libjpeg.so.62 and libpng16.so.16) '
                'nor PIL')
    return DataLoader(dataset, batch_size or args.batch_size,
                      seed=getattr(args, 'seed', 0), **loader_kwargs)
