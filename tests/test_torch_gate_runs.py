'''The card-vs-CPU step gate's runs (`chip_smoke.check_step_against_cpu`)
with the CPU as its own card, DCGAN at 32px: the card's float32 run
records its branches, the float64 nudges and the float64 CPU reference
replay them, one build of the models for the float32 run and one for the
float64 ones (the reference runs on the nudges' models), and the gate
holds (the card run and the CPU reference take the same inputs and
branches, so their difference is f32 rounding: every ratio within its
tolerance). The intra-op thread count is left as it was. Inside
`deferred_gates` the reference's step is made by the caller and run in a
thread of its own, and the gate returns None; leaving the block waits for
it, and a gate that fails there raises with the phase that submitted it.'''

import threading
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from animeface_tpu_torch.implementations.DCGAN import utils as du
from animeface_tpu_torch.nnutils.loss import GANLoss

Z = 16


def _gate(nudges, builds, make_step=None, ran=None):
    args = du.default_args(image_size=32, latent_dim=Z)
    G, D = du.build_models(args, device='cpu')

    def build(a, d):
        builds.append(threading.get_ident())
        return du.build_models(a, d) + (None,)

    def dcgan_step(G, D, G_ema, g_opt, d_opt):
        step = du.build_train_step(G, D, g_opt, d_opt, GANLoss())

        def run(state, real, draws):
            if ran is not None:
                ran.append(threading.get_ident())
            return step(state, real, draws)
        return run

    def draw(G, real, a):
        return du.draw_step_inputs(G, real, torch.Generator().manual_seed(6))

    return chip_smoke.check_step_against_cpu(
        'DCGAN 32px', build, make_step or dcgan_step, draw, args, SimpleNamespace(G=G, D=D),
        torch.device('cpu'), nudges=nudges)


@pytest.mark.parametrize('nudges', [3, 9])
def test_overlapping_runs_hold_and_restore_threads(nudges):
    threads = torch.get_num_threads()
    builds = []
    ratios = _gate(nudges, builds)
    assert torch.get_num_threads() == threads
    assert max(ratios.values()) <= 1, ratios
    # the float32 run's build and the float64 runs'
    assert builds == [threading.get_ident()] * 2


def test_deferred_reference_runs_beside_and_fails_with_its_phase(capsys):
    builds, ran = [], []
    with chip_smoke.deferred_gates() as gates:
        with chip_smoke.phase('DCGAN gate'):
            assert _gate(3, builds, ran=ran) is None
        assert len(gates.pending) == 1 and gates.pending[0][:2] == ('DCGAN gate', 'DCGAN 32px')
    assert gates.pending[0][2].result()['grad'] <= 1
    main = threading.get_ident()
    assert builds == [main] * 2
    assert ran[:4] == [main] * 4 and len(ran) == 5 and ran[4] != main   # the reference beside

    def broken(G, D, G_ema, g_opt, d_opt):
        '''A step whose float64 runs move D's gradients by 1%.'''
        step = du.build_train_step(G, D, g_opt, d_opt, GANLoss())

        def run(state, real, draws):
            out = step(state, real, draws)
            if next(D.parameters()).dtype == torch.float64:
                for p in D.parameters():
                    p.grad.mul_(1.01)
            return out
        return run
    with pytest.raises(AssertionError, match='disagree'):
        with chip_smoke.deferred_gates():
            with chip_smoke.phase('broken gate'):
                _gate(3, [], broken)
    assert 'chip_smoke: phase broken gate failed: DCGAN 32px gate' in capsys.readouterr().err
