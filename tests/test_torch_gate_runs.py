'''The card-vs-CPU step gate's runs (`chip_smoke.check_step_against_cpu`)
with the CPU as its own card, DCGAN at 32px: the card run and the nudged
CPU runs overlap in threads, each worker with its own build of the models,
and the gate holds (the card run and the unmoved CPU run take the same
inputs, so their difference is f32 rounding from the threads' split of
the intra-op pool: every ratio within its tolerance). The intra-op thread
count is restored afterwards.'''

import threading
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from animeface_tpu_torch.implementations.DCGAN import utils as du
from animeface_tpu_torch.nnutils.loss import GANLoss

Z = 16


@pytest.mark.parametrize('nudges', [3, 9])
def test_overlapping_runs_hold_and_restore_threads(nudges):
    args = du.default_args(image_size=32, latent_dim=Z)
    G, D = du.build_models(args, device='cpu')
    builds = []

    def build(a, d):
        builds.append(threading.get_ident())
        return du.build_models(a, d) + (None,)

    def make_step(G, D, G_ema, g_opt, d_opt):
        return du.build_train_step(G, D, g_opt, d_opt, GANLoss())

    def draw(G, real, a):
        return du.draw_step_inputs(G, real, torch.Generator().manual_seed(6))

    threads = torch.get_num_threads()
    ratios = chip_smoke.check_step_against_cpu(
        'DCGAN 32px', build, make_step, draw, args, SimpleNamespace(G=G, D=D),
        torch.device('cpu'), nudges=nudges)
    assert torch.get_num_threads() == threads
    assert max(ratios.values()) <= 1, ratios
    workers = min(chip_smoke.GATE_WORKERS, 1 + nudges)
    # the card's thread and at most `workers` CPU threads, one build each
    assert 2 <= len(builds) == len(set(builds)) <= 1 + workers
