'''One StyleGAN2-ADA training step of the port against JAX's build_train_step.

Both sides start from one bridged state (32px, style 16, batch 8, f32 on
the CPU) and get the same draws: z from the step's key splits
(`StyleGAN2/utils.py:84-89`), the G noise maps captured with
`flax.linen.intercept_methods`, the path-length noise from the
`fold_in(..., 1)` key, and one deterministic augment function (a fixed
G_inv through the two-pass geometry, then a fixed color matrix).

The step runs with plain SGD on both sides, and each side keeps the raw
gradients (JAX in the optimizer state, the port in `.grad`) to compare them
at full precision; Adam (with the lazy-regularization rescale) is held against
optax separately on given gradients, since with beta1 = 0 an Adam step is
close to lr * sign(g) and would amplify last-bit differences of near-zero
gradients. Tolerance 1e-4 relative to each tensor's scale (f32 through G,
the augment and D, forward and backward, in two frameworks), except D's
gradients in an adversarial D phase: 1e-2. There D sees G's fakes, which
the two frameworks produce 2e-6 apart, and D's gradient is only piecewise
continuous in its input (a leaky-ReLU unit whose pre-activation lies that
close to 0 changes slope); fed the same fakes, the two agree to 1e-6.
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from animeface_tpu.implementations.StyleGAN2 import model as jm
from animeface_tpu.implementations.StyleGAN2 import utils as ju
from animeface_tpu.nnutils import ada as jada
from animeface_tpu.nnutils.loss import NonSaturatingLoss as JLoss
from animeface_tpu.utils import EasyDict
from animeface_tpu_torch.convert import convert_generator, convert_discriminator
from animeface_tpu_torch.implementations.StyleGAN2 import utils as tu
from animeface_tpu_torch.nnutils import ada as tada
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss

B, S, N = 8, 16, 32
ARGS = EasyDict(image_size=N, image_channels=3, style_dim=S, channels=8,
                max_channels=32, block_num_conv=2, map_num_layers=2, map_lr=0.01,
                disable_map_norm=False, mbsd_groups=4, lr=1e-3, beta1=0.0,
                beta2=0.99, g_k=8, d_k=16, r1_lambda=10.0, pl_lambda=2.0)
RTOL = 1e-4


def _close(got, want, rtol=RTOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f'{what}: max abs err {err} vs scale {scale}'


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def _noise_maps(jG, gp, inputs, key, method=None):
    maps = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jm.InjectNoise) and context.method_name == '__call__':
            x = args[0]
            noise = jax.random.normal(context.module.make_rng('noise'),
                                      x.shape[:3] + (1,), x.dtype)
            maps.append(np.asarray(noise))
            return x + noise
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jG.apply({'params': gp}, inputs, rngs={'noise': key},
                 **({} if method is None else {'method': method}))
    return [_nchw(m) for m in maps]


LR = 1e-3


def _sgd_keeping_grads():
    '''SGD whose state is the last gradient tree.'''
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -LR * g, grads), grads

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope='module')
def setup():
    jG, jD = ju.build_models(ARGS, jnp.float32)
    k = jax.random.PRNGKey(0)
    gp = jax.device_get(jax.jit(jG.init)({'params': k, 'noise': k, 'mixing': k},
                                         jnp.zeros((1, S)))['params'])
    dp = jax.device_get(jax.jit(jD.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((1, N, N, 3)))['params'])
    rng = np.random.default_rng(0)
    real = np.clip(rng.standard_normal((B, N, N, 3)), -1, 1).astype(np.float32)
    G_inv = np.asarray(jada.rotate2d_inv(jnp.asarray(rng.uniform(-0.5, 0.5, B), jnp.float32))
                       @ jada.translate2d_inv(jnp.asarray(rng.uniform(-3, 3, B), jnp.float32),
                                              jnp.asarray(rng.uniform(-3, 3, B), jnp.float32)))
    Cm = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    Cm[:, :3, :] += rng.uniform(-0.2, 0.2, (B, 3, 4)).astype(np.float32)
    return jG, jD, gp, dp, real, G_inv, Cm


def _jax_step(setup, do_r1, do_pl):
    jG, jD, gp, dp, real, G_inv, Cm = setup
    pipe = jada.AugmentPipe(xint=1, geom_impl='twopass')

    def augment_fn(key, x, state):
        return pipe._execute_color(pipe._execute_geometry(x, jnp.asarray(G_inv)),
                                   jnp.asarray(Cm))

    sgd = _sgd_keeping_grads()
    ada = jada.ada_init_state(B, interval=4, target_kimg=1)
    ada['p'] = jnp.float32(0.2)
    ada['num_iter'] = jnp.int32(3)           # this step adjusts p
    state = dict(rng=jax.random.PRNGKey(42), G=gp, D=dp, G_ema=copy.deepcopy(gp),
                 g_opt=sgd.init(gp), d_opt=sgd.init(dp), pl_mean=jnp.float32(0.3),
                 step=jnp.int32(0), ada=ada)
    step = ju.build_train_step(jG, jD, sgd, sgd, JLoss(), '', ARGS.r1_lambda,
                               ARGS.pl_lambda, ARGS.d_k, ARGS.g_k, 0.999, do_r1, do_pl,
                               augment_fn=augment_fn, ada_enabled=True)
    new, metrics = jax.jit(step)(state, jnp.asarray(real))

    # the step's draws, reproduced from its key splits
    _, zkey_d, zkey_g, _, _, _, nkey_d, nkey_g, _ = jax.random.split(state['rng'], 9)
    z_d = jax.random.normal(zkey_d, (B, S))
    z_g = jax.random.normal(zkey_g, (B, S))
    draws = dict(z_d=torch.from_numpy(np.array(z_d)), z_g=torch.from_numpy(np.array(z_g)),
                 noise_d=_noise_maps(jG, gp, z_d, nkey_d))
    if do_pl:
        w = jG.apply({'params': gp}, z_g, method=jm.Generator.map_w)
        draws['noise_g'] = _noise_maps(jG, gp, w, nkey_g, jm.Generator.synthesize_from_w)
        draws['pl_noise'] = _nchw(jax.random.normal(jax.random.fold_in(nkey_g, 1),
                                                     (B, N, N, 3)) / np.sqrt(N * N))
    else:
        draws['noise_g'] = _noise_maps(jG, gp, z_g, nkey_g)
    return jax.device_get((new, metrics)), draws


@pytest.mark.parametrize('do_r1,do_pl', [(False, False), (False, True), (True, True)],
                         ids=['adversarial', 'pl', 'r1+pl'])
def test_step_matches_jax(setup, do_r1, do_pl):
    jG, jD, gp, dp, real, G_inv, Cm = setup
    (jnew, jmetrics), draws = _jax_step(setup, do_r1, do_pl)

    G, D, G_ema = tu.build_models(ARGS, torch.float32, device='cpu')
    G.load_state_dict(convert_generator(gp))
    D.load_state_dict(convert_discriminator(dp))
    G_ema.load_state_dict(convert_generator(gp))
    pipe = tada.AugmentPipe(xint=1, geom_impl='twopass')
    tG_inv, tCm = torch.tensor(G_inv), torch.tensor(Cm)

    def augment_fn(x, state):
        reps = x.shape[0] // B          # the D phase stacks [real; fake]
        x = pipe._execute_geometry(x, tG_inv.repeat(reps, 1, 1))
        return pipe._execute_color(x, tCm.repeat(reps, 1, 1))

    ada = tada.ada_init_state(B, interval=4, target_kimg=1, device='cpu')
    ada['p'] = torch.tensor(0.2)
    ada['num_iter'] = torch.tensor(3, dtype=torch.int32)
    state = dict(pl_mean=torch.tensor(0.3), step=0, ada=ada, generator=None)
    step = tu.build_train_step(
        G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
        torch.optim.SGD(D.parameters(), lr=LR), NonSaturatingLoss(), ARGS.r1_lambda,
        ARGS.pl_lambda, ARGS.d_k, ARGS.g_k, 0.999, do_r1, do_pl,
        augment_fn=augment_fn, ada_enabled=True)
    metrics = step(state, _nchw(real), draws)

    _close(metrics['G'], jmetrics['G'], what='G loss')
    _close(metrics['D'], jmetrics['D'], what='D loss')
    for port, grads, params, convert, rtol in (
            (G, jnew['g_opt'], jnew['G'], convert_generator, RTOL),
            (D, jnew['d_opt'], jnew['D'], convert_discriminator, RTOL if do_r1 else 1e-2)):
        want_grad, want_new = convert(grads), convert(params)
        for name, p in port.named_parameters():
            _close(p.grad, want_grad[name], rtol=rtol, what=f'grad {name}')
            np.testing.assert_allclose(p.detach().numpy(), want_new[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    ema = convert_generator(jnew['G_ema'])
    for name, p in G_ema.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ema[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    _close(state['pl_mean'], jnew['pl_mean'], what='pl_mean')
    assert state['step'] == 1
    for k in ('p', 'signsum', 'count', 'num_iter'):
        assert float(state['ada'][k]) == pytest.approx(float(jnew['ada'][k]), abs=1e-6), k


def test_adam_with_lazy_reg_rescale_matches_optax():
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** -rng.integers(0, 6)
              for s in shapes] for _ in range(4)]
    jG, jD = ju.make_optimizers(ARGS)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    module = torch.nn.Module()
    module.ps = torch.nn.ParameterList(tparams)
    tG, tD = tu.make_optimizers(ARGS, module, module)
    for jopt, topt in ((jG, tG), (jD, tD)):
        jp = [jnp.asarray(p) for p in params]
        opt_state = jopt.init(jp)
        with torch.no_grad():
            for t, p in zip(tparams, params):
                t.copy_(torch.from_numpy(p))
        topt.state.clear()
        for g in grads:
            up, opt_state = jopt.update([jnp.asarray(x) for x in g], opt_state, jp)
            jp = optax.apply_updates(jp, up)
            for t, x in zip(tparams, g):
                t.grad = torch.from_numpy(x.astype(np.float32))
            topt.step()
        for t, want in zip(tparams, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
