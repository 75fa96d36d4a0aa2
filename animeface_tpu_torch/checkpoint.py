'''Full-train-state checkpoints with resume.

Counterpart of `animeface_tpu/checkpoint.py`: a directory of
`ckpt-<step>/{state.pt, meta.json}`, each published by an atomic
`os.replace` of a staging directory, the oldest past `max_to_keep`
removed, staging directories orphaned by a kill swept at start, and
`all_steps` / `latest_step` to find them; `save_model` / `load_model` for
the standalone weights artifact.

The training state is a dict whose values are modules (their
`state_dict()`: parameters and buffers), optimizers (their `state_dict()`),
tensors, numbers, `torch.Generator`s (their `get_state()`) and dicts of
these. `snapshot` turns it into nested dicts of tensors, numbers, strings
and lists, which `torch.load(weights_only=True)` reads back. A key that
starts with '_' is configuration (as `ada['_interval']`): it is not saved
and a restore keeps the value the run was built with from its arguments.
`restore` fills a freshly built state in place: a shape that differs is an
error, a missing key keeps its built value and an extra key is dropped,
each printed.
'''

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import torch
from torch import nn

_STEP_RE = re.compile(r'^ckpt-(\d+)$')


def snapshot(obj):
    '''The saved form of a training state (see the module docstring).'''
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        return obj.state_dict()
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, dict):
        return {k: snapshot(v) for k, v in obj.items()
                if not (isinstance(k, str) and k.startswith('_'))}
    if isinstance(obj, (list, tuple)):
        return [snapshot(v) for v in obj]
    return obj


def tensors(tree):
    '''The tensors of a snapshot, depth first.'''
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


class Checkpointer:
    '''Directory of `ckpt-<step>/{state.pt, meta.json}` checkpoints.'''

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        # sweep staging dirs orphaned by a hard kill mid-save
        for name in os.listdir(self.directory):
            if name.startswith('.tmp-ckpt-'):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    # ---- write ----

    def save(self, step: int, state, meta: dict | None = None) -> str:
        final = os.path.join(self.directory, f'ckpt-{int(step)}')
        tmp = tempfile.mkdtemp(prefix='.tmp-ckpt-', dir=self.directory)
        try:
            torch.save(snapshot(state), os.path.join(tmp, 'state.pt'))
            with open(os.path.join(tmp, 'meta.json'), 'w', encoding='utf-8') as f:
                json.dump(meta or {}, f, default=str)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)   # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, f'ckpt-{s}'), ignore_errors=True)

    # ---- read ----

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target, step: int | None = None, map_location='cpu'):
        '''Fill the training state `target` in place from checkpoint `step`
        (default the latest). Returns (target, meta). Raises
        FileNotFoundError when there is no checkpoint.'''
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoints in {self.directory}')
        path = os.path.join(self.directory, f'ckpt-{int(step)}')
        loaded = torch.load(os.path.join(path, 'state.pt'), map_location=map_location,
                            weights_only=True)
        filled, dropped = [], []
        _fill(target, loaded, path, '', filled, dropped)
        if filled or dropped:
            print(f'[checkpoint] MIGRATED restore from {path}:')
            for p in filled:
                print(f'[checkpoint]   missing leaf kept from the built state: {p}')
            for p in dropped:
                print(f'[checkpoint]   obsolete leaf in file dropped: {p}')
        with open(os.path.join(path, 'meta.json'), encoding='utf-8') as f:
            meta = json.load(f)
        return target, meta


def _check_shape(path, key, want, got):
    if tuple(want.shape) != tuple(got.shape):
        raise ValueError(
            f'checkpoint {path}: leaf {key} has shape {tuple(got.shape)} but the built '
            f'state expects {tuple(want.shape)}: wrong model size/config for this snapshot')


def _merge_keys(built: dict, got, prefix, filled, dropped, config_keys=False):
    '''The keys of `built` that `got` has; the others recorded as filled,
    `got`'s extra keys as dropped. With `config_keys`, keys that start with
    '_' are left out.'''
    got = got if isinstance(got, dict) else {}
    keys = []
    for k in built:
        if config_keys and isinstance(k, str) and k.startswith('_'):
            continue
        if k in got:
            keys.append(k)
        else:
            filled.append(f'{prefix}/{k}')
    dropped.extend(f'{prefix}/{k}' for k in got if k not in built)
    return keys


def _fill(target, loaded, path, prefix, filled, dropped):
    '''Load `loaded` into `target` (see `Checkpointer.restore`); returns
    the value `target`'s slot takes.'''
    if isinstance(target, nn.Module):
        built = target.state_dict()
        merged = dict(built)
        for k in _merge_keys(built, loaded, prefix, filled, dropped):
            _check_shape(path, f'{prefix}/{k}', built[k], loaded[k])
            merged[k] = loaded[k]
        target.load_state_dict(merged)
        return target
    if isinstance(target, torch.optim.Optimizer):
        target.load_state_dict(loaded)
        return target
    if isinstance(target, torch.Generator):
        target.set_state(loaded.cpu())
        return target
    if isinstance(target, torch.Tensor):
        _check_shape(path, prefix, target, loaded)
        with torch.no_grad():
            target.copy_(loaded)
        return target
    if isinstance(target, dict):
        for k in _merge_keys(target, loaded, prefix, filled, dropped, config_keys=True):
            target[k] = _fill(target[k], loaded[k], path, f'{prefix}/{k}', filled, dropped)
        return target
    return loaded


def save_model(path: str, state_dict) -> None:
    '''Standalone weights artifact: one `torch.save` of a state dict.'''
    torch.save(state_dict, path)


def load_model(path: str, module: nn.Module, map_location='cpu') -> nn.Module:
    '''Load a `save_model` file into `module`; returns it.'''
    module.load_state_dict(torch.load(path, map_location=map_location, weights_only=True))
    return module
