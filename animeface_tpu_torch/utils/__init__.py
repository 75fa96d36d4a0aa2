'''Cross-cutting utilities (counterpart of `animeface_tpu/utils/__init__.py`).'''

from animeface_tpu_torch.utils.misc import EasyDict, make_image_grid, save_image
from animeface_tpu_torch.utils.status import Status
from animeface_tpu_torch.utils.argument import (
    get_default_parser, add_args, save_args, result_dir,
)

__all__ = ['EasyDict', 'make_image_grid', 'save_image', 'Status', 'get_default_parser',
           'add_args', 'save_args', 'result_dir', 'debug_mode']


def debug_mode():
    '''Rich tracebacks when `rich` imports (`--debug`).'''
    try:
        from rich.traceback import install
    except ImportError:
        return
    install(show_locals=False)
