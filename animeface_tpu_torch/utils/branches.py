'''The sign-dependent branches of a run, recorded on one device and
replayed on another.

A training step in float32 on the card and the same step in float64 on the
CPU take a kink the other way wherever an input lies within float32
rounding of it: a ReLU's or leaky ReLU's input near 0, a hinge near its
margin, the mask of a `torch.where`. Their values agree there; their
gradients do not. `Branches` is a `torch.overrides.TorchFunctionMode`:
entered around a run, it records, in call order, the branch that each such
call takes (a boolean mask, a sign, or max pooling's argmax); entered
around a later run with that record, it replays it, so that each call
returns the recorded branch's value, written so that autograd
differentiates that branch. The calls it sees are those the run makes
itself, on floating-point tensors:

- `relu`, `leaky_relu` (torch's, and the port's `ops.activations.leaky_relu`,
  whose gradient at 0 is 1), `prelu`;
- `clamp` and `clip` (`clamp_min`, `clamp_max`);
- `abs`;
- the comparisons `>`, `>=`, `<`, `<=` (the masks behind `torch.where`);
- `max_pool2d`: which input each window picks.

What a call does inside is not seen, nor a backward's own operations
(`torch.autograd.grad` and `Tensor.backward` are calls of their own, run
with the mode set aside). A replayed call whose operation or shape differs
from the next recorded one raises `BranchMismatch`, and so does `done()`
when recorded calls are left over.
'''

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from animeface_tpu_torch.ops import activations


class BranchMismatch(RuntimeError):
    '''A replayed run's calls are not the recorded run's.'''


class Branch(NamedTuple):
    op: str                  # the operation's name in the record
    shape: tuple             # its input's shape
    taken: torch.Tensor      # the branch: a mask, a sign, or pooling's argmax


def _bind(names, defaults, args, kwargs):
    '''The call's arguments by their names in `func`'s signature, the
    first (the input) as 'x'.'''
    bound = dict(zip(names, args))
    bound.update(kwargs)
    a = {n: bound.get(n, defaults.get(n)) for n in names}
    a['x'] = a.pop(names[0])
    return a


def _no_inplace(op, a):
    if a.get('inplace'):
        raise BranchMismatch(f'an in-place {op} cannot be recorded or replayed')


def _relu(a, taken=None):
    x = a['x']
    if taken is None:
        return x > 0
    return x * taken.to(x.dtype)


def _leaky(a, taken=None):
    x = a['x']
    if taken is None:
        return x > 0
    return torch.where(taken, x, x * a['negative_slope'])


def _port_leaky(a, taken=None):
    x = a['x']
    if taken is None:
        return x >= 0           # the port's gradient at 0 is 1
    return torch.where(taken, x, x * a['alpha'])


def _prelu(a, taken=None):
    x, w = a['x'], a['weight']
    if taken is None:
        return x > 0
    if w.numel() > 1:
        w = w.reshape([1, -1] + [1] * (x.dim() - 2))
    return torch.where(taken, x, w.to(x.dtype) * x)


def _clamp(a, taken=None):
    '''-1 below min, 1 above max, 0 between (the gradient's 1).'''
    x, lo, hi = a['x'], a.get('min'), a.get('max')
    if taken is None:
        code = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
        if lo is not None:
            code = torch.where(x < lo, -1, code).to(torch.int8)
        if hi is not None:
            code = torch.where(x > hi, 1, code).to(torch.int8)
        return code
    out = x
    if lo is not None:
        out = torch.where(taken < 0, torch.as_tensor(lo, dtype=x.dtype, device=x.device), out)
    if hi is not None:
        out = torch.where(taken > 0, torch.as_tensor(hi, dtype=x.dtype, device=x.device), out)
    return out


def _abs(a, taken=None):
    x = a['x']
    if taken is None:
        return torch.sign(x).to(torch.int8)
    return x * taken.to(x.dtype)


def _comparison(compare):
    def branch(a, taken=None):
        return compare(a['x'], a['other']) if taken is None else taken
    return branch


def _max_pool2d(a, taken=None):
    x = a['x']
    if taken is None:
        return F.max_pool2d(x, a['kernel_size'], a['stride'], a['padding'], a['dilation'],
                            a['ceil_mode'], return_indices=True)[1]
    out = x.flatten(-2).gather(-1, taken.flatten(-2)).reshape(taken.shape)
    return (out, taken) if a['return_indices'] else out


def _ops():
    '''func -> (op name, argument names, defaults, branch function).'''
    T = torch.Tensor
    table = {}

    def add(funcs, op, names, defaults, fn):
        for f in funcs:
            table[f] = (op, names, defaults, fn)
    add((torch.relu, F.relu, T.relu), 'relu', ('input', 'inplace'), {}, _relu)
    add((F.leaky_relu,), 'leaky_relu', ('input', 'negative_slope', 'inplace'),
        {'negative_slope': 0.01}, _leaky)
    add((activations.leaky_relu,), 'port leaky_relu', ('x', 'alpha'), {'alpha': 0.2},
        _port_leaky)
    add((F.prelu, torch.prelu, T.prelu), 'prelu', ('input', 'weight'), {}, _prelu)
    add((torch.clamp, torch.clip, T.clamp, T.clip), 'clamp', ('input', 'min', 'max'), {},
        _clamp)
    add((torch.clamp_min, T.clamp_min), 'clamp', ('input', 'min'), {}, _clamp)
    add((torch.clamp_max, T.clamp_max), 'clamp', ('input', 'max'), {}, _clamp)
    add((torch.abs, T.abs, T.__abs__), 'abs', ('input',), {}, _abs)
    for name, funcs in (('gt', (torch.gt, torch.greater, T.gt, T.greater, T.__gt__)),
                        ('ge', (torch.ge, torch.greater_equal, T.ge, T.greater_equal, T.__ge__)),
                        ('lt', (torch.lt, torch.less, T.lt, T.less, T.__lt__)),
                        ('le', (torch.le, torch.less_equal, T.le, T.less_equal, T.__le__))):
        add(funcs, name, ('input', 'other'), {}, _comparison(getattr(torch, name)))
    add((F.max_pool2d,), 'max_pool2d',
        ('input', 'kernel_size', 'stride', 'padding', 'dilation', 'ceil_mode', 'return_indices'),
        dict(padding=0, dilation=1, ceil_mode=False, return_indices=False), _max_pool2d)
    return table


_OPS = _ops()


class Branches(TorchFunctionMode):
    '''Records the branches of the calls above (`Branches()`), or replays a
    record (`Branches(replay=record.taken)`), inside `with`. In a replay,
    `flips` counts the elements whose own branch differs from the record's
    (the kinks the recorded run took the other way).'''

    def __init__(self, replay: list[Branch] | None = None):
        super().__init__()
        self.replay = replay
        self.taken: list[Branch] = []
        self.next = 0
        self.flips = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        entry = _OPS.get(func)
        if entry is None or not (args and isinstance(args[0], torch.Tensor)
                                 and args[0].is_floating_point()):
            return func(*args, **kwargs)
        op, names, defaults, fn = entry
        a = _bind(names, defaults, args, kwargs)
        _no_inplace(op, a)
        if op == 'max_pool2d' and a['stride'] is None:
            a['stride'] = a['kernel_size']
        x = a['x']
        if self.replay is None:
            self.taken.append(Branch(op, tuple(x.shape), fn(a)))
            return func(*args, **kwargs)
        if self.next >= len(self.replay):
            raise BranchMismatch(f'call {self.next} ({op} of {tuple(x.shape)}) has no recorded '
                                 f'branch: the record ends at {len(self.replay)} calls')
        want = self.replay[self.next]
        if (want.op, want.shape) != (op, tuple(x.shape)):
            raise BranchMismatch(f'call {self.next}: {op} of {tuple(x.shape)}, where the record '
                                 f'has {want.op} of {want.shape}')
        self.next += 1
        taken = want.taken.to(x.device)
        self.flips += int((fn(a) != taken).sum())
        return fn(a, taken)

    def done(self):
        '''Raise unless a replay used the whole record.'''
        if self.replay is not None and self.next != len(self.replay):
            raise BranchMismatch(f'the replay made {self.next} of the record\'s '
                                 f'{len(self.replay)} calls')

    def on(self, device) -> list[Branch]:
        '''The record with its branches on `device`.'''
        return [b._replace(taken=b.taken.to(device)) for b in self.taken]
