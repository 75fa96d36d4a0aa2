'''One CIPS training step of the port against JAX's
`CIPS/utils.py:build_train_step`, plain and R1, and the mapping's lr group
against the JAX `g_label_fn`.

Both sides start from one bridged state (16px, 2 style layers 8..16 wide,
latent/style 32, D 8..16 wide, batch 8, f32 on the CPU) and get the same
draws: z from the step's key split (`CIPS/utils.py:23-25`) and
DiffAugment's draws replayed from ar (the reals) and af (the fakes, in
both phases) by `test_torch_diffaugment.jax_draws`, with policy
'color,translation,cutout'. The step runs plain SGD on both sides and each
keeps the raw gradients, compared at 1e-4 of each tensor's scale (f32
through G, the augmentation and D, forward and backward, in two
frameworks); the updated parameters, G_ema and w_avg to 1e-6.
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.CIPS import model as jm
from animeface_tpu.implementations.CIPS import utils as ju
from animeface_tpu.nnutils.loss import NonSaturatingLoss as JLoss
from animeface_tpu_torch.convert import (
    convert_cips_generator, convert_stylegan3_discriminator)
from animeface_tpu_torch.implementations.CIPS import utils as tu
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from test_torch_diffaugment import jax_draws
from test_torch_diffaugment_steps import POLICY, RTOL, _check_module
from test_torch_step import _sgd_keeping_grads, _close, _nchw, LR

B, S, L = 8, 16, 32
ARGS = tu.default_args(image_size=S, batch_size=B, latent_dim=L, style_dim=L, num_layers=2,
                       g_channels=8, g_max_channels=16, d_channels=8, d_max_channels=16,
                       no_bf16=True, policy=POLICY)


def _jax_models():
    G = jm.Generator(image_size=S, latent_dim=L, style_dim=L, num_layers=2, channels=8,
                     max_channels=16, image_channels=3, map_num_layers=ARGS.map_num_layers,
                     pixel_norm=True)
    D = jm.Discriminator(image_size=S, in_channels=3, channels=8, max_channels=16,
                         mbsd_group_size=4, mbsd_channels=1, bottom=4, filter_size=4)
    return G, D


@pytest.fixture(scope='module')
def setup():
    jG, jD = _jax_models()
    gv = jax.device_get(jax.jit(jG.init)(jax.random.PRNGKey(0), jnp.zeros((1, L))))
    dp = jax.device_get(jax.jit(jD.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((2, S, S, 3)))['params'])
    rng = np.random.default_rng(0)
    moments = {'w_avg': rng.standard_normal(L).astype(np.float32)}
    real = np.clip(rng.standard_normal((B, S, S, 3)), -1, 1).astype(np.float32)
    return jG, jD, gv['params'], moments, dp, real


@pytest.mark.parametrize('do_r1', [False, True], ids=['plain', 'r1'])
def test_step_matches_jax(setup, do_r1):
    jG, jD, gp, gm, dp, real = setup
    sgd = _sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(42), G=gp, D=dp, G_moments=gm,
                 G_ema=copy.deepcopy(gp), g_opt=sgd.init(gp), d_opt=sgd.init(dp),
                 step=jnp.int32(0))
    step = ju.build_train_step(jG, jD, sgd, sgd, JLoss(), POLICY, ARGS.gp_lambda, do_r1)
    jnew, jmetrics = jax.device_get(jax.jit(step)(state, jnp.asarray(real)))
    _, zkey, ar, af = jax.random.split(state['rng'], 4)
    draws = dict(z=torch.from_numpy(np.array(jax.random.normal(zkey, (B, L)))),
                 aug_r=jax_draws(ar, real.shape, POLICY), aug_f=jax_draws(af, real.shape, POLICY))

    G, D, G_ema = tu.build_models(ARGS, device='cpu')
    G.load_state_dict(convert_cips_generator(gp, gm))
    G_ema.load_state_dict(convert_cips_generator(gp, gm))
    D.load_state_dict(convert_stylegan3_discriminator(dp))
    tstate = tu.init_state('cpu')
    tstep = tu.build_train_step(
        G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
        torch.optim.SGD(D.parameters(), lr=LR), NonSaturatingLoss(), ARGS.gp_lambda, do_r1,
        policy=POLICY)
    metrics = tstep(tstate, _nchw(real), draws)

    assert sorted(metrics) == sorted(jmetrics) == ['d', 'g']
    _close(metrics['g'], jmetrics['g'], what='G loss')
    _close(metrics['d'], jmetrics['d'], what='D loss')
    new_moments = jnew['G_moments']
    _check_module(G, jnew['g_opt'], jnew['G'],
                  lambda t: convert_cips_generator(t, new_moments), RTOL)
    _check_module(D, jnew['d_opt'], jnew['D'], convert_stylegan3_discriminator, RTOL)
    want = convert_cips_generator(jnew['G_ema'], new_moments)
    for name, v in G_ema.state_dict().items():       # EMA params, the kept w_avg
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(G.map.w_avg.numpy(), np.asarray(new_moments['w_avg']),
                               rtol=1e-6, atol=1e-7)
    assert not np.allclose(G.map.w_avg.numpy(), gm['w_avg'])
    assert tstate['step'] == 1


def _jax_g_label_fn(params):
    '''`g_label_fn` of `animeface_tpu/implementations/CIPS/utils.py:train`.'''
    return jax.tree_util.tree_map_with_path(
        lambda path, _: 'map' if str(path[0].key).startswith('Linear_') else 'syn', params)


def test_mapping_group_matches_jax_labels(setup):
    '''The parameters the port trains at lr * map_lr_scale are exactly those
    the JAX `g_label_fn` labels 'map'; Adam (0, 0.99), eps 1e-8.'''
    jG, jD, gp, gm, dp, real = setup
    labels = convert_cips_generator(
        jax.tree_util.tree_map(lambda lab: np.float32(lab == 'map'), _jax_g_label_fn(gp)),
        {'w_avg': np.zeros(L, np.float32)})
    want_map = {name for name, v in labels.items() if name != 'map.w_avg' and float(v.min()) == 1}
    assert want_map and all(float(labels[n].max()) == 0 for n in labels
                            if n not in want_map and n != 'map.w_avg')
    G, D, _ = tu.build_models(ARGS, device='cpu')
    g_opt, d_opt = tu.make_optimizers(ARGS, G, D)
    names = {id(p): n for n, p in G.named_parameters()}
    by_lr = {}
    for group in g_opt.param_groups:
        assert group['betas'] == (0., 0.99) and group['eps'] == 1e-8
        by_lr.setdefault(group['lr'], set()).update(names[id(p)] for p in group['params'])
    assert by_lr == {ARGS.lr: set(names.values()) - want_map,
                     ARGS.lr * ARGS.map_lr_scale: want_map}
    assert [g['lr'] for g in d_opt.param_groups] == [ARGS.lr]


def test_recipe_training_and_sampler_on_cpu():
    '''`build_training` on the CPU: step 0 is the R1 variant (gp_every 16),
    two steps give finite losses and advance w_avg, and `sample_fn` runs
    G_ema under impl 'cuda' (the kernels' plain versions on the CPU).'''
    run = tu.build_training(tu.default_args(**dict(vars(ARGS), num_test=4)), device='cpu')
    assert [run.uses_r1(i) for i in (0, 1, 16)] == [True, False, True]
    real = torch.rand((B, 3, S, S), generator=torch.Generator().manual_seed(1)) * 2 - 1
    before = run.G.map.w_avg.clone()
    for _ in range(2):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 2 and not torch.equal(run.G.map.w_avg, before)
    assert torch.equal(run.G_ema.map.w_avg, run.G.map.w_avg)
    images = run.sample_fn()
    assert images.shape == (4, 3, S, S) and bool(torch.isfinite(images).all())
