'''The branch recorder of the card's step gate
(`animeface_tpu_torch/utils/branches.py`), on the CPU.

A two-layer net's step with one hidden input within float32 rounding of
0, on the far side of 0 in float64: the float64 step misses the float32
step's gradients by far more than 1e-3 of their norm, and the float64 step
that replays the float32 step's branches holds them within 1e-5. Each call
the recorder knows, replayed in float64 with branches that agree, gives
the plain call's value and gradient, and recording leaves the values as
they are. A replay whose calls are not the record's raises. A mode is the
entering thread's own, as the gate's CPU workers need.
'''

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from animeface_tpu_torch.ops.activations import leaky_relu
from animeface_tpu_torch.utils.branches import Branches, BranchMismatch

KINKS = {'relu': F.relu, 'leaky_relu': lambda h: F.leaky_relu(h, 0.2),
         'port leaky_relu': leaky_relu}


def kinked(seed):
    '''x [1, 8] and W1 [4, 8], W2 [2, 4] in float32 with h[0, 0] = x . W1[0]
    within rounding of 0: its last weight solves h = 0 in float64.'''
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 8)).astype(np.float32)
    W1 = rng.standard_normal((4, 8)).astype(np.float32)
    W1[0, -1] = np.float32(-(x[0, :-1].astype(np.float64) @ W1[0, :-1]) / x[0, -1])
    W2 = rng.standard_normal((2, 4)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, W1, W2)]


def step(act, x, W1, W2, dtype, branches=None):
    '''The loss's gradients with respect to W1 and W2, in `dtype`.'''
    W1, W2 = (w.to(dtype).requires_grad_() for w in (W1, W2))
    with branches if branches is not None else torch.enable_grad():
        h = x.to(dtype) @ W1.T
        loss = (act(h) @ W2.T).square().mean()
        grads = torch.autograd.grad(loss, (W1, W2))
    return h, torch.cat([g.flatten() for g in grads]).double()


def flipped(act):
    '''The first seed whose h[0, 0] has another sign in float32 than in
    float64.'''
    for seed in range(200):
        x, W1, W2 = kinked(seed)
        h32 = step(act, x, W1, W2, torch.float32)[0][0, 0]
        h64 = step(act, x, W1, W2, torch.float64)[0][0, 0]
        if (h32 > 0) != (h64 > 0) and (h32 >= 0) != (h64 >= 0):
            return x, W1, W2
    raise AssertionError('no seed puts h[0, 0] on both sides of 0')


@pytest.mark.parametrize('name', list(KINKS))
def test_replayed_branches_hold_the_float32_step(name):
    act = KINKS[name]
    x, W1, W2 = flipped(act)
    record = Branches()
    _, g32 = step(act, x, W1, W2, torch.float32, record)
    assert [b.op for b in record.taken] == [name]
    _, g64 = step(act, x, W1, W2, torch.float64)
    replay = Branches(replay=record.on('cpu'))
    _, replayed = step(act, x, W1, W2, torch.float64, replay)
    replay.done()
    assert replay.flips == 1
    norm = float(g32.norm())
    assert float((g64 - g32).norm()) > 1e-3 * norm
    assert float((replayed - g32).norm()) <= 1e-5 * norm


def _pool(x):
    return F.max_pool2d(x, 2) + F.max_pool2d(x, kernel_size=2, stride=2)


#: name -> (a call on x and w that the recorder replays, the ops it records)
CALLS = {
    'relu': (lambda x, w: F.relu(x) + torch.relu(x) + x.relu(), ['relu'] * 3),
    'leaky_relu': (lambda x, w: F.leaky_relu(x, 0.1) + F.leaky_relu(x, negative_slope=0.3),
                   ['leaky_relu'] * 2),
    'port leaky_relu': (lambda x, w: leaky_relu(x) + leaky_relu(x, 0.1),
                        ['port leaky_relu'] * 2),
    'prelu': (lambda x, w: F.prelu(x, w) + F.prelu(x, w[:1]), ['prelu'] * 2),
    'clamp': (lambda x, w: x.clamp(-0.5, 0.5) + torch.clip(x, min=-0.3) + x.clamp_min(0.1)
              + torch.clamp(x, max=w.view(1, 3, 1, 1)), ['clamp'] * 4),
    'abs': (lambda x, w: x.abs() + abs(x) + torch.abs(x), ['abs'] * 3),
    'comparisons': (lambda x, w: torch.where(x > 0.2, x, 2 * x) + torch.where(0.1 < x, x, -x)
                    + torch.where(x.le(0), x, 3 * x) + torch.where(torch.ge(x, w[0]), x, 0 * x),
                    ['gt', 'gt', 'le', 'ge']),
    'max_pool2d': (lambda x, w: _pool(x * w.view(1, 3, 1, 1)), ['max_pool2d'] * 2),
}


@pytest.mark.parametrize('name', list(CALLS))
def test_replay_gives_the_plain_value_and_gradient(name):
    call, ops = CALLS[name]
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 3, 4, 4, generator=g), torch.rand(3, generator=g)

    def run(dtype, branches=None):
        xs, ws = x.to(dtype).requires_grad_(), w.to(dtype).requires_grad_()
        with branches if branches is not None else torch.enable_grad():
            y = call(xs, ws)
            grads = torch.autograd.grad(y.square().sum(), (xs, ws), allow_unused=True)
        return y, grads

    plain32, _ = run(torch.float32)
    record = Branches()
    y32, _ = run(torch.float32, record)
    assert torch.equal(y32, plain32)                      # recording changes nothing
    assert [b.op for b in record.taken] == ops
    y64, grads64 = run(torch.float64)
    replay = Branches(replay=record.on('cpu'))
    y, grads = run(torch.float64, replay)
    replay.done()
    assert replay.flips == 0
    assert torch.allclose(y, y64, rtol=0, atol=1e-12)
    for got, want in zip(grads, grads64):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.allclose(got, want, rtol=0, atol=1e-12)


def _record(x):
    record = Branches()
    with record:
        F.relu(x)
        x.abs()
    return record.on('cpu')


@pytest.mark.parametrize('case', ['another op', 'another shape', 'a call more', 'a call fewer'])
def test_replay_of_other_calls_raises(case):
    x = torch.randn(2, 5)
    taken = _record(x)
    replay = Branches(replay=taken)
    with pytest.raises(BranchMismatch):
        with replay:
            F.relu(x.double())
            if case == 'another op':
                torch.clamp(x.double(), 0, 1)
            elif case == 'another shape':
                x[:1].double().abs()
            elif case == 'a call more':
                x.double().abs()
                F.relu(x.double())
        replay.done()
    # integer tensors and untracked calls pass by
    replay = Branches(replay=taken)
    with replay:
        F.relu(x.double())
        (torch.arange(3) > 1).sum()
        torch.tanh(x.double())
        x.double().abs()
    replay.done()


def test_a_mode_is_its_threads_own():
    x = torch.randn(3, 3)
    record = Branches()
    seen = []
    with record:
        t = threading.Thread(target=lambda: seen.append(F.relu(x)))
        t.start()
        t.join(timeout=30)
        F.relu(x)
    assert not t.is_alive() and len(seen) == 1
    assert [b.op for b in record.taken] == ['relu']
