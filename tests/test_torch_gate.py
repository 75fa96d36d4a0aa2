'''The card-vs-CPU gate's tolerances (`chip_smoke.nudged_tolerances` and
`gate_ratios`), on the CPU with made-up card results.

A loss that is the mean of two logits of size about 1 that nearly cancel
(mean about 1e-3, as WGAN-gp's g loss over 2 samples was when a card run
failed at an error of 1.594e-3 of its value) passes at that error, because
f32 rounding-size nudges of the logits move the mean by as much; a 1%
error of the same loss, or of a loss that does not cancel, fails. A
gradient keeps the rule it had: L2 within rtol + 2 S of its own norm (a
small gradient beside a large one too), S the largest relative L2 move any
nudge makes to any gradient. Sensitivities above the caps raise. The
option: structurally zero gradients (`zero_grad`) leave S and are held
to their bound. (The kinks that made a step's gradients multimodal under
nudges are replayed from the card run now: `tests/test_torch_branches.py`.)
'''

import numpy as np
import pytest
import torch

import chip_smoke

RTOL = 1e-3


def logits_run(seed=None, nudge=1e-6):
    '''Two logits of a fixed linear D, about +1 and -0.998, in float32,
    on inputs moved by `nudge` * N(0, 1) from a generator of `seed`.'''
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256)).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32)
    w /= np.float32(np.linalg.norm(w))
    x -= np.outer(x @ w, w).astype(np.float32)                      # x . w = 0
    x += np.outer([1.0, -0.998], w).astype(np.float32)
    if seed is not None:
        x = x + (nudge * np.random.default_rng(seed).standard_normal(x.shape)).astype(np.float32)
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    return logits


def loss_entries(seed=None):
    logits = logits_run(seed)
    return {'loss g': (-logits.mean()).double(), 'loss d': (1 - logits).abs().mean().double()}


def near_cancelling():
    want = loss_entries()
    moved = [loss_entries(7 + k) for k in range(3)]
    return want, moved, chip_smoke.nudged_tolerances(
        want, moved, RTOL, loss_scales={k: 1.0 for k in want})


def test_near_cancelling_mean_passes_at_rounding_size():
    want, moved, tols = near_cancelling()
    g = float(want['loss g'])
    assert 5e-4 < abs(g) < 2e-3                            # two ~1 logits, mean ~1e-3
    card = dict(want, **{'loss g': want['loss g'] + 1.594e-3 * abs(want['loss g'])})
    # the old rule (the loss within RTOL of itself) refuses it
    assert abs(float(card['loss g'] - want['loss g'])) > RTOL * abs(g)
    ratios = chip_smoke.gate_ratios(card, want, tols)
    assert ratios['loss g'] <= 1, (ratios, tols)
    assert tols['loss_sens']['loss g'] > 0
    assert tols['loss_tol']['loss g'] == pytest.approx(RTOL * abs(g)
                                                       + 2 * tols['loss_sens']['loss g'])


@pytest.mark.parametrize('key', ['loss g', 'loss d'])
def test_one_percent_error_fails(key):
    want, moved, tols = near_cancelling()
    card = dict(want, **{key: want[key] * 1.01})
    assert chip_smoke.gate_ratios(card, want, tols)[key] > 1


def _grads(seed=None, scale=1e-6):
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, generator=g).double(), torch.randn(8, 8, generator=g).double()
    c = 1e-6 * torch.randn(16, generator=g).double()          # small beside G.a
    if seed is not None:
        gn = torch.Generator().manual_seed(seed)
        a = a + scale * (1 + seed) * torch.randn(a.shape, generator=gn).double()
        b = b + scale * torch.randn(b.shape, generator=gn).double()
        c = c + scale * 1e-6 * torch.randn(c.shape, generator=gn).double()
    return {'grad G.a': a, 'grad D.b': b, 'grad G.c': c}


def _card_with_error(want, key, size):
    """`want` with `key` moved by `size` of its norm in L2."""
    err = torch.randn(want[key].shape, generator=torch.Generator().manual_seed(3)).double()
    err *= size * want[key].norm() / err.norm()
    return dict(want, **{key: want[key] + err})


@pytest.mark.parametrize('key', ['grad G.a', 'grad G.c'])
def test_gradient_rule_is_unchanged(key):
    """Each gradient within rtol + 2 S of its own norm, the small G.c (1e-6
    of G.a's norm) as much as G.a: no floor from its model's largest."""
    want = _grads()
    moved = [_grads(7 + k, 1e-4) for k in range(3)]
    tols = chip_smoke.nudged_tolerances(want, moved, RTOL)
    S = max(float((m[k] - want[k]).norm() / want[k].norm()) for m in moved for k in want)
    assert tols['S'] == pytest.approx(S) and tols['grad_tol'] == pytest.approx(RTOL + 2 * S)
    assert [v for v, _ in tols['per_nudge']] == pytest.approx(
        [max(float((m[k] - want[k]).norm() / want[k].norm()) for k in want) for m in moved])
    assert tols['zero_grads'] == {}
    for factor, ok in ((0.9, True), (1.1, False)):
        card = _card_with_error(want, key, factor * tols['grad_tol'])
        assert (chip_smoke.gate_ratios(card, want, tols)[key] <= 1) == ok


def _with_zero(seed=None):
    """`_grads` without G.c, plus a structurally zero G.bias: rounding of
    about 1e-9 of G.a's norm that each nudge moves by its whole size."""
    grads = _grads(seed, 1e-4)
    del grads['grad G.c']
    g = torch.Generator().manual_seed(100 + (seed or 0))
    grads['grad G.bias'] = 1e-9 * torch.randn(8, generator=g).double()
    return grads


def test_structurally_zero_gradients_leave_s():
    want = _with_zero()
    moved = [_with_zero(7 + k) for k in range(3)]
    with pytest.raises(AssertionError, match='G.bias'):        # relative to itself: all noise
        chip_smoke.nudged_tolerances(want, moved, RTOL)
    tols = chip_smoke.nudged_tolerances(want, moved, RTOL, zero_grad=1e-5)
    bound = 1e-5 * float(want['grad G.a'].norm())
    assert tols['zero_grads'] == {'grad G.bias': pytest.approx(bound)}
    plain = chip_smoke.nudged_tolerances({k: v for k, v in want.items() if k != 'grad G.bias'},
                                         [{k: v for k, v in m.items() if k != 'grad G.bias'}
                                          for m in moved], RTOL)
    assert tols['S'] == plain['S'] and tols['grad_tol'] == plain['grad_tol']
    # rounding on the card passes; a bias gradient at 1e-3 of G.a's norm fails
    for size, ok in ((2e-9, True), (0.5 * bound, True), (1e-3 * bound / 1e-5, False)):
        card = dict(want, **{'grad G.bias': want['grad G.bias'] + size / 8 ** 0.5})
        assert (chip_smoke.gate_ratios(card, want, tols)['grad G.bias'] <= 1) == ok
    card = _card_with_error(want, 'grad G.a', 1.1 * tols['grad_tol'])
    assert chip_smoke.gate_ratios(card, want, tols)['grad G.a'] > 1


def test_caps_refuse_an_empty_check():
    want, moved = _grads(), [_grads(7, 0.2)]
    with pytest.raises(AssertionError, match='too sensitive'):
        chip_smoke.nudged_tolerances(want, moved, RTOL)
    want = {'loss g': torch.tensor(1e-3, dtype=torch.float64)}
    moved = [{'loss g': torch.tensor(0.2, dtype=torch.float64)}]
    with pytest.raises(AssertionError, match='too sensitive'):
        chip_smoke.nudged_tolerances(want, moved, RTOL, loss_scales={'loss g': 1.0})
    assert chip_smoke.nudged_tolerances(want, [dict(want)], RTOL)['loss_sens']['loss g'] == 0
