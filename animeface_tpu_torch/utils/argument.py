'''Layered argparse system.

Counterpart of `animeface_tpu/utils/argument.py`: `get_default_parser` (the
global flags, every one with the JAX name and default), `add_args` (the
declarative {name: [default, help]} builder), `result_dir` and
`save_args`. Flags whose feature a later slice brings are parsed as in JAX
and refused with `NotImplementedError` when set (`refuse_deferred`).
'''

from __future__ import annotations

import datetime
import json
import os
from argparse import ArgumentParser

from animeface_tpu_torch.utils.misc import EasyDict

#: where `result_dir` puts each recipe's `result/` (the JAX package uses
#: its own implementations directory, overridable by the same variable)
IMPLEMENTATIONS_DIR = os.environ.get(
    'ANIMEFACE_IMPLEMENTATIONS_DIR',
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 'implementations'))


def get_default_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument('name')

    default_args = EasyDict()
    default_args.image_size     = [128, 'Size of image.']
    default_args.batch_size     = [32, 'Global batch size (split across data-parallel devices)']
    default_args.dataset        = ['animeface', 'Dataset name']
    default_args.min_year       = [2005, 'Minimum of generated year. Ignored when dataset==danbooru']
    default_args.num_images     = [60000, 'Number of images in training set. Ignored when dataset==animeface']
    default_args.save           = [1000, 'Interval for saving the model / sample grids']
    default_args.max_iters      = [-1, 'Max training iterations. If < 0, derived from --default-epochs']
    default_args.default_epochs = [100, 'Used to calculate max iterations when --max-iters < 0']
    default_args.log_file       = [str, 'Filename for saving log output']
    default_args.log_interval   = [1, 'Interval for logging to log file']
    default_args.debug          = [False, 'Debug mode (rich console, verbose)']
    default_args.seed           = [0, 'PRNG seed']
    default_args.data_root      = ['/usr/src/data', 'Root directory holding the datasets']
    default_args.synthetic_data = [False, 'Use procedurally generated data (no dataset required)']
    default_args.device_data    = [False, 'Keep the whole dataset resident in device memory '
                                          '(not ported yet)']
    default_args.mesh           = [[-1], 'Device mesh shape; only one device (-1 or 1) is ported']
    default_args.multihost      = [False, 'Multi-host execution (not ported yet)']
    default_args.no_bf16        = [False, 'Disable bfloat16 compute (use float32)']
    default_args.resume         = [str, 'Checkpoint directory to resume training from']
    default_args.profile        = [False, 'Capture a profiler trace of a few steps (not ported yet)']

    return add_args(parser, default_args)


def refuse_deferred(args) -> None:
    '''Raise `NotImplementedError` for a flag whose feature is not ported,
    naming the ROADMAP item that brings it.'''
    if list(args.mesh) not in ([-1], [1]):
        raise NotImplementedError(f'--mesh {args.mesh}: the port runs on one device; '
                                  'multi-GPU is ROADMAP Queue 1 item 9')
    if args.multihost:
        raise NotImplementedError('--multihost: multi-GPU is ROADMAP Queue 1 item 9')
    if args.device_data:
        raise NotImplementedError('--device-data: dataset/device.py is not ported '
                                  '(ROADMAP Queue 1 item 6)')
    if args.profile:
        raise NotImplementedError('--profile is not ported (ROADMAP Queue 1 item 6)')


def add_args(parser: ArgumentParser, arg_defaults: dict,
             prefix: str = '--', under_score: bool = False) -> ArgumentParser:
    '''{name: [default] | [default, help]} -> argparse options.

    Type is inferred from the default: int/float/str pass through; bool becomes
    store_true (default must be falsy); list/tuple becomes nargs='*' typed by the
    first element; a bare type object becomes a typed optional defaulting to None.
    '''
    for k, v in arg_defaults.items():
        option = prefix + (k if under_score else k.replace('_', '-'))

        if len(v) == 1:
            default, help = v[0], ''
        elif len(v) == 2:
            default, help = v
        else:
            raise ValueError('arg_defaults value must be [default] or [default, help]')

        value_type = type(default)
        if value_type in (float, int, str):
            parser.add_argument(option, default=default, type=value_type, help=help)
        elif value_type is bool:
            if default:
                raise ValueError('Only supports store_true action')
            parser.add_argument(option, default=default, action='store_true', help=help)
        elif value_type in (list, tuple):
            ele_type = type(default[0])
            parser.add_argument(option, default=list(default), type=ele_type, nargs='*', help=help)
        elif isinstance(default, type):
            parser.add_argument(option, default=None, type=default, help=help)

    return parser


def recipe_defaults(name: str, arg_defaults: dict, overrides: dict):
    '''The parsed defaults of recipe `name` (the global flags and
    `arg_defaults`), with `overrides` set; an unknown override raises
    `TypeError`.'''
    args = add_args(get_default_parser(), arg_defaults).parse_args([name])
    unknown = set(overrides) - set(vars(args))
    if unknown:
        raise TypeError(f'unknown {name} arguments: {sorted(unknown)}')
    vars(args).update(overrides)
    return args


def result_dir(name: str) -> str:
    '''Per-implementation output directory: <IMPLEMENTATIONS_DIR>/<name>/result.'''
    d = os.path.join(IMPLEMENTATIONS_DIR, name, 'result')
    os.makedirs(d, exist_ok=True)
    return d


def save_args(args, identify: bool = True, id: str | None = None) -> str:
    args_dict = {k: v for k, v in vars(args).items()}
    if identify:
        if id is None:
            id = datetime.datetime.now().strftime('%Y%m%d%H%M%S')
        args_file = f'args-{id}.json'
    else:
        args_file = 'args.json'
    filename = os.path.join(result_dir(args.name), args_file)
    with open(filename, 'w', encoding='utf-8') as fout:
        json.dump(args_dict, fout, indent=2, default=str)
    return filename
