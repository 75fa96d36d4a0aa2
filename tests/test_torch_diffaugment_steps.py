'''The StyleGAN2 training step with its DEFAULT augmentation, DiffAugment
with the recipe's policy (here 'color,translation,cutout'), against the JAX
step, which defaults to it too (`StyleGAN2/utils.py:79-81`); the StyleGAN3
step's twin is `tests/test_torch_diffaugment_sg3_step.py`.

Both sides start from one bridged state (the small models, batch 8 and f32
on the CPU of `tests/test_torch_step.py`, whose helpers this file uses) and
get the same draws: z and the noise maps as there, and DiffAugment's draws
replayed from the step's augment keys by `test_torch_diffaugment.jax_draws`.
The stacked D batch takes akey_r's draws in its first B rows and akey_f's
in the next B (the JAX vmap over the two keys), the G phase akey_g's. The
steps run plain SGD on both sides and keep the raw gradients, compared at
1e-4 of each tensor's scale, except D's in an adversarial D phase, 1e-2,
for the reason `tests/test_torch_step.py` gives (D's gradient is piecewise
continuous in its input, and the two frameworks' fakes differ by about
2e-6). Translation and cutout put exact zeros through D's zero-initialised
biases, where the port's leaky ReLU must take JAX's gradient (1 at 0).
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.StyleGAN2 import utils as ju2
from animeface_tpu.nnutils.loss import NonSaturatingLoss as JLoss
from animeface_tpu_torch.convert import convert_discriminator, convert_generator
from animeface_tpu_torch.implementations.StyleGAN2 import utils as tu2
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
import test_torch_step as sg2t
from test_torch_diffaugment import jax_draws

POLICY = 'color,translation,cutout'
RTOL = 1e-4
LR = sg2t.LR


def _cat(a, b):
    return [tuple(torch.cat(p) for p in zip(x, y)) if isinstance(x, tuple)
            else torch.cat([x, y]) for x, y in zip(a, b)]


def _check_module(port, grads, params, convert, grad_rtol):
    want_grad, want_new = convert(grads), convert(params)
    for name, p in port.named_parameters():
        sg2t._close(p.grad, want_grad[name], rtol=grad_rtol, what=f'grad {name}')
        np.testing.assert_allclose(p.detach().numpy(), want_new[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# ------------------------------------------------------------------ StyleGAN2

@pytest.fixture(scope='module')
def sg2():
    jG, jD = ju2.build_models(sg2t.ARGS, jnp.float32)
    k = jax.random.PRNGKey(0)
    gp = jax.device_get(jax.jit(jG.init)({'params': k, 'noise': k, 'mixing': k},
                                         jnp.zeros((1, sg2t.S)))['params'])
    dp = jax.device_get(jax.jit(jD.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((1, sg2t.N, sg2t.N, 3)))['params'])
    real = np.clip(np.random.default_rng(0).standard_normal((sg2t.B, sg2t.N, sg2t.N, 3)),
                   -1, 1).astype(np.float32)
    return jG, jD, gp, dp, real


@pytest.mark.parametrize('do_r1', [False, True], ids=['adversarial', 'r1'])
def test_stylegan2_default_diffaugment_step_matches_jax(sg2, do_r1):
    jG, jD, gp, dp, real = sg2
    B = sg2t.B
    sgd = sg2t._sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(42), G=gp, D=dp, G_ema=copy.deepcopy(gp),
                 g_opt=sgd.init(gp), d_opt=sgd.init(dp), pl_mean=jnp.float32(0.0),
                 step=jnp.int32(0))
    step = ju2.build_train_step(jG, jD, sgd, sgd, JLoss(), POLICY, sg2t.ARGS.r1_lambda,
                                sg2t.ARGS.pl_lambda, sg2t.ARGS.d_k, sg2t.ARGS.g_k, 0.999,
                                do_r1, False)
    jnew, jmetrics = jax.device_get(jax.jit(step)(state, jnp.asarray(real)))

    _, zkey_d, zkey_g, akey_r, akey_f, akey_g, nkey_d, nkey_g, _ = \
        jax.random.split(state['rng'], 9)
    z_d = jax.random.normal(zkey_d, (B, sg2t.S))
    z_g = jax.random.normal(zkey_g, (B, sg2t.S))
    draws = dict(z_d=torch.from_numpy(np.array(z_d)), z_g=torch.from_numpy(np.array(z_g)),
                 noise_d=sg2t._noise_maps(jG, gp, z_d, nkey_d),
                 noise_g=sg2t._noise_maps(jG, gp, z_g, nkey_g),
                 aug_d=_cat(jax_draws(akey_r, real.shape, POLICY),
                            jax_draws(akey_f, real.shape, POLICY)),
                 aug_g=jax_draws(akey_g, real.shape, POLICY))

    G, D, G_ema = tu2.build_models(sg2t.ARGS, torch.float32, device='cpu')
    G.load_state_dict(convert_generator(gp))
    D.load_state_dict(convert_discriminator(dp))
    G_ema.load_state_dict(convert_generator(gp))
    tstate = dict(pl_mean=torch.tensor(0.0), step=0, generator=None)
    tstep = tu2.build_train_step(
        G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
        torch.optim.SGD(D.parameters(), lr=LR), NonSaturatingLoss(), sg2t.ARGS.r1_lambda,
        sg2t.ARGS.pl_lambda, sg2t.ARGS.d_k, sg2t.ARGS.g_k, 0.999, do_r1, False, policy=POLICY)
    metrics = tstep(tstate, sg2t._nchw(real), draws)

    sg2t._close(metrics['G'], jmetrics['G'], what='G loss')
    sg2t._close(metrics['D'], jmetrics['D'], what='D loss')
    _check_module(G, jnew['g_opt'], jnew['G'], convert_generator, RTOL)
    _check_module(D, jnew['d_opt'], jnew['D'], convert_discriminator,
                  RTOL if do_r1 else 1e-2)
    ema = convert_generator(jnew['G_ema'])
    for name, p in G_ema.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ema[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    assert tstate['step'] == 1


def test_stylegan2_recipe_cadence_and_default_draws():
    '''`build_training` on the CPU at a tiny size: R1 at i % d_k == 0 and
    path length at i % g_k == 0, never at step 0, only with their lambda;
    the default draws cover the stacked D batch and the G phase.'''
    args = tu2.default_args(image_size=8, batch_size=4, style_dim=16, channels=8,
                            max_channels=16, map_num_layers=2, no_bf16=True)
    run = tu2.build_training(args, device='cpu', seed=0)
    assert [run.variant(i) for i in (0, 8, 16, 32)] == [
        (False, False), (False, False), (True, False), (True, False)]
    run_pl = tu2.build_training(tu2.default_args(**dict(vars(args), pl_lambda=2.0)),
                                device='cpu', seed=0)
    assert [run_pl.variant(i) for i in (0, 1, 8, 16)] == [
        (False, False), (False, False), (False, True), (True, True)]
    real = torch.rand((4, 3, 8, 8), generator=torch.Generator().manual_seed(1)) * 2 - 1
    draws = tu2.draw_step_inputs(run.G, real, run.state['generator'], args.policy)
    assert len(draws['aug_d']) == 4 and draws['aug_d'][0].shape == (8, 1, 1, 1)
    assert draws['aug_d'][3][0].shape == (8,) and draws['aug_g'][3][0].shape == (4,)
    for _ in range(2):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 2


def test_leaky_relu_gradient_at_zero_matches_jax():
    '''The port's leaky ReLU has F.leaky_relu's values and
    jax.nn.leaky_relu's gradient (1 at exactly 0, where F.leaky_relu's is
    the slope), also under a double backward (R1).'''
    from animeface_tpu_torch.ops.activations import leaky_relu
    x0 = np.array([-1.5, -0.0, 0.0, 0.25, 2.0], np.float32)
    c = np.arange(1, 6, dtype=np.float32)
    w0 = np.float32(0.7)

    def jinner(w, x):
        return jnp.sum(jax.nn.leaky_relu(x * w, 0.2) * c)

    want_dx = jax.grad(jinner, argnums=1)(w0, jnp.asarray(x0))
    want_dw_of_dx = jax.grad(lambda w: jnp.sum(jax.grad(jinner, argnums=1)(w, jnp.asarray(x0))
                                               ** 2))(w0)
    x = torch.from_numpy(x0).requires_grad_(True)
    w = torch.tensor(w0, requires_grad=True)
    y = leaky_relu(x * w, 0.2)
    assert torch.equal(y, torch.nn.functional.leaky_relu(x * w, 0.2))
    (dx,) = torch.autograd.grad((y * torch.from_numpy(c)).sum(), x, create_graph=True)
    np.testing.assert_allclose(dx.detach().numpy(), np.asarray(want_dx), rtol=1e-6)
    (dw,) = torch.autograd.grad((dx ** 2).sum(), w)
    np.testing.assert_allclose(float(dw), float(want_dw_of_dx), rtol=1e-6)
