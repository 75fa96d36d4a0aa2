'''Data layer (counterpart of `animeface_tpu/dataset/__init__.py` for the
`image` task).

`build_dataset(args)` maps `--dataset` to its class, or to the synthetic
stand-in when `--synthetic-data` is set or the data root is missing (with
a warning). `build_loader` wraps it in a `DataLoader` and refuses, at once,
a file dataset that neither the native pipeline nor PIL can decode. The
other dataset families and tasks are ROADMAP Queue 1 item 6.
'''

from __future__ import annotations

import os
import warnings

from animeface_tpu_torch.dataset._base import (
    DataLoader, Image, WrappedDataset, data_path, make_default_transform, pil_available,
    set_data_root,
)
from animeface_tpu_torch.dataset import native
from animeface_tpu_torch.dataset.animeface import AnimeFace
from animeface_tpu_torch.dataset.synthetic import SyntheticImage

__all__ = ['AnimeFace', 'DataLoader', 'Image', 'SyntheticImage', 'WrappedDataset',
           'build_dataset', 'build_loader', 'make_default_transform']

_REGISTRY = {
    # task -> dataset-name -> (cls, kwargs builder)
    'image': {
        'animeface': lambda a: (AnimeFace, dict(image_size=a.image_size,
                                                min_year=a.min_year)),
    },
}

_SYNTHETIC = {
    'image': lambda a: SyntheticImage(a.image_size, _syn_count(a), a.seed),
}


def _syn_count(args) -> int:
    n = getattr(args, 'num_images', None) or 2048
    return min(int(n), 10_000)


def build_dataset(args, task: str = 'image'):
    '''Dataset instance for `--dataset <name>` under the given task.

    Falls back to the synthetic stand-in when `--synthetic-data` is set, or
    when the data root does not exist (with a warning).
    '''
    if task not in _REGISTRY:
        raise NotImplementedError(f'task {task!r} is not ported (ROADMAP Queue 1 item 6)')
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
    if isinstance(dataset, Image) and not pil_available() and not (
            native.available() and getattr(dataset.transform, 'native_cfg', None) is not None):
        raise RuntimeError(
            f'{type(dataset).__name__} reads image files, and neither decoder loads: the '
            'native pipeline (native/libanimeface_io.so, which links libjpeg.so.62 and '
            'libpng16.so.16) nor PIL')
    return DataLoader(dataset, batch_size or args.batch_size,
                      seed=getattr(args, 'seed', 0), **loader_kwargs)
