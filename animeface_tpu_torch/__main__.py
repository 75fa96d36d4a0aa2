'''CLI: `python -m animeface_tpu_torch <Model> [flags]`.

Counterpart of `main.py`: imports `animeface_tpu_torch.implementations.<Model>`
and calls its `main(parser)`. Training runs on `cuda`; `ANIMEFACE_PLATFORM=cpu`
runs it on the CPU, and without either a card or that variable the command
fails. `main(argv)` runs the same in-process.
'''

from __future__ import annotations

import os
import sys
from importlib import import_module

from animeface_tpu_torch.nnutils.accelerate import default_device
from animeface_tpu_torch.utils import argument, debug_mode


def _recipe(name):
    '''The package of recipe `name`, or None if the port has none or it has
    no `main` yet.'''
    if name.startswith('_'):
        return None
    try:
        module = import_module(f'animeface_tpu_torch.implementations.{name}')
    except ModuleNotFoundError as e:
        if name not in str(e):
            raise
        return None
    return module if hasattr(module, 'main') else None


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        default_device()
    except RuntimeError as e:
        print(f'error: {e}', file=sys.stderr)
        sys.exit(1)
    parser = argument.get_default_parser()
    args = parser.parse_known_args(argv)[0]
    if args.debug:
        debug_mode()
    argument.refuse_deferred(args)
    module = _recipe(args.name)
    if module is None:
        impl_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'implementations')
        have = sorted(d for d in os.listdir(impl_dir) if _recipe(d) is not None)
        print(f'error: unknown implementation {args.name!r}.\n'
              f'available: {", ".join(have)}', file=sys.stderr)
        sys.exit(2)
    # the recipe's main parses sys.argv, as the JAX recipes do
    saved = sys.argv
    sys.argv = [saved[0] if saved else 'animeface_tpu_torch', *argv]
    try:
        module.main(parser)
    finally:
        sys.argv = saved


if __name__ == '__main__':
    main()
