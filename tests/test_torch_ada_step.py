'''One training step of the ADA recipe (StyleGAN3 + augmentation) in the
port against JAX's `StyleGAN3/utils.py:build_train_step`, plain and R1.

Both sides start from one bridged state (32px, 4 layers, channels 8..32,
style 32 as `_sg3_args` in tests/test_implementations.py, batch 8, f32 on
the CPU) and get the same draws: z from the step's key split
(`StyleGAN3/utils.py:44-46`), and one deterministic augment function (a
fixed G_inv through the two-pass geometry, then a fixed color matrix). On
the port's side the geometry takes the kernel branch, which at 32px is the
line-pass wrapper (its plain version on the CPU).

The step runs with plain SGD on both sides, and each side keeps the raw
gradients (JAX in the optimizer state, the port in `.grad`) to compare them
at full precision; Adam with the mapping's lr scale is held against optax
separately on given gradients (with beta1 = 0 an Adam step is close to
lr * sign(g), which would amplify last-bit differences of near-zero
gradients). Tolerance 1e-4 relative to each tensor's scale (f32 through G,
the augment and D, forward and backward, in two frameworks, each summing
in its own order); the updated parameters to 1e-6 (one SGD step from equal
parameters with gradients that agree to 1e-4 relative).
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from animeface_tpu.implementations.StyleGAN3 import utils as ju
from animeface_tpu.nnutils import ada as jada
from animeface_tpu.nnutils.loss import NonSaturatingLoss as JLoss
from animeface_tpu.utils import EasyDict
from animeface_tpu_torch.convert import (
    convert_stylegan3_generator, convert_stylegan3_discriminator)
from animeface_tpu_torch.implementations.ADA.utils import build_training, default_args
from animeface_tpu_torch.implementations.StyleGAN3 import utils as tu
from animeface_tpu_torch.nnutils import ada as tada
from animeface_tpu_torch.nnutils.ada_geometry import twopass_warp
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss

B, N, L = 8, 32, 32
ARGS = default_args(image_size=N, batch_size=B, num_layers=4, channels=8, max_channels=32,
                    style_dim=L, latent_dim=L, d_channels=8, d_max_channels=32,
                    no_bf16=True, ada_target_kimg=1)
RTOL = 1e-4
LR = 1e-3


def _close(got, want, rtol=RTOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f'{what}: max abs err {err} vs scale {scale}'


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def _sgd_keeping_grads():
    '''SGD whose state is the last gradient tree.'''
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -LR * g, grads), grads

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope='module')
def setup():
    jG, jD = ju.build_models(EasyDict(vars(ARGS)), jnp.float32)
    gv = jax.device_get(jax.jit(jG.init)({'params': jax.random.PRNGKey(0)},
                                         jnp.zeros((1, L))))
    dp = jax.device_get(jax.jit(jD.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((2, N, N, 3)))['params'])
    rng = np.random.default_rng(0)
    real = np.clip(rng.standard_normal((B, N, N, 3)), -1, 1).astype(np.float32)
    G_inv = np.asarray(jada.rotate2d_inv(jnp.asarray(rng.uniform(-0.5, 0.5, B), jnp.float32))
                       @ jada.translate2d_inv(jnp.asarray(rng.uniform(-3, 3, B), jnp.float32),
                                              jnp.asarray(rng.uniform(-3, 3, B), jnp.float32)))
    Cm = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    Cm[:, :3, :] += rng.uniform(-0.2, 0.2, (B, 3, 4)).astype(np.float32)
    return jG, jD, gv['params'], gv['moments'], dp, real, G_inv, Cm


def _jax_step(setup, do_r1):
    jG, jD, gp, gm, dp, real, G_inv, Cm = setup
    pipe = jada.AugmentPipe(xint=1, geom_impl='twopass')

    def augment_fn(key, x, state):
        return pipe._execute_color(pipe._execute_geometry(x, jnp.asarray(G_inv)),
                                   jnp.asarray(Cm))

    sgd = _sgd_keeping_grads()
    ada = jada.ada_init_state(B, interval=4, target_kimg=1)
    ada['p'] = jnp.float32(0.2)
    ada['num_iter'] = jnp.int32(3)           # this step adjusts p
    state = dict(rng=jax.random.PRNGKey(42), G=gp, D=dp, G_moments=gm,
                 G_ema=copy.deepcopy(gp), g_opt=sgd.init(gp), d_opt=sgd.init(dp),
                 step=jnp.int32(0), ada=ada)
    step = ju.build_train_step(jG, jD, sgd, sgd, JLoss(), '', ARGS.gp_lambda, do_r1,
                               augment_fn=augment_fn, ada_enabled=True)
    new, metrics = jax.jit(step)(state, jnp.asarray(real))
    _, zkey, _, _, _ = jax.random.split(state['rng'], 5)
    z = jax.random.normal(zkey, (B, L))
    return jax.device_get((new, metrics)), torch.from_numpy(np.array(z))


def _port(setup):
    jG, jD, gp, gm, dp, real, G_inv, Cm = setup
    G, D, G_ema = tu.build_models(ARGS, torch.float32, device='cpu')
    G.load_state_dict(convert_stylegan3_generator(gp, gm))
    G_ema.load_state_dict(convert_stylegan3_generator(gp, gm))
    D.load_state_dict(convert_stylegan3_discriminator(dp))
    return G, D, G_ema


@pytest.mark.parametrize('do_r1', [False, True], ids=['plain', 'r1'])
def test_step_matches_jax(setup, monkeypatch, do_r1):
    monkeypatch.setenv('ANIMEFACE_ADA_FUSED', '0')      # JAX: the dense line pass
    jG, jD, gp, gm, dp, real, G_inv, Cm = setup
    (jnew, jmetrics), z = _jax_step(setup, do_r1)

    G, D, G_ema = _port(setup)
    pipe = tada.AugmentPipe(xint=1, geom_impl='twopass')
    tG_inv, tCm = torch.tensor(G_inv), torch.tensor(Cm)

    def augment_fn(key, x, state):
        return pipe._execute_color(twopass_warp(x, tG_inv, fused=True), tCm)

    ada = tada.ada_init_state(B, interval=4, target_kimg=1, device='cpu')
    ada['p'] = torch.tensor(0.2)
    ada['num_iter'] = torch.tensor(3, dtype=torch.int32)
    state = dict(step=0, generator=None, ada=ada)
    step = tu.build_train_step(
        G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
        torch.optim.SGD(D.parameters(), lr=LR), NonSaturatingLoss(), ARGS.gp_lambda, do_r1,
        augment_fn, ada_enabled=True)
    metrics = step(state, _nchw(real), dict(z=z, aug=None))

    assert sorted(metrics) == sorted(jmetrics)
    _close(metrics['g'], jmetrics['g'], what='G loss')
    _close(metrics['d'], jmetrics['d'], what='D loss')
    new_moments = jax.device_get(jnew['G_moments'])
    for port, grads, params, convert in (
            (G, jnew['g_opt'], jnew['G'], lambda t: convert_stylegan3_generator(t, new_moments)),
            (D, jnew['d_opt'], jnew['D'], convert_stylegan3_discriminator)):
        want_grad, want_new = convert(grads), convert(params)
        for name, p in port.named_parameters():
            _close(p.grad, want_grad[name], what=f'grad {name}')
            np.testing.assert_allclose(p.detach().numpy(), want_new[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    want = convert_stylegan3_generator(jnew['G_ema'], new_moments)
    for name, v in G_ema.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, v in G.state_dict().items():                 # the D-phase moments
        if 'magnitude_ema' in name or 'w_avg' in name:
            _close(v.numpy(), want[name].numpy(), rtol=1e-5, what=name)
    assert state['step'] == 1
    for k in ('p', 'signsum', 'count', 'num_iter'):
        assert float(state['ada'][k]) == pytest.approx(float(jnew['ada'][k]), abs=1e-6), k
    _close(metrics['p'], jmetrics['p'], what='p')


def test_g_phase_sees_the_pre_step_moments(setup):
    '''Every layer's magnitude_ema is the same at the G-phase forward as at
    the D-phase forward (the pre-step value), and the step keeps one update.'''
    G, D, G_ema = _port(setup)
    seen = []
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append(float(mod.magnitude_ema)), with_kwargs=True)
        for layer in G.synthesis.net]
    before = [float(m) for m in G.moment_buffers()[1:]]     # magnitude_ema per layer
    step = tu.build_train_step(
        G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
        torch.optim.SGD(D.parameters(), lr=LR), NonSaturatingLoss(), ARGS.gp_lambda, False,
        lambda key, x, state: x)
    step(dict(step=0), _nchw(setup[5]), dict(z=torch.randn(B, L), aug=None))
    for h in hooks:
        h.remove()
    n = len(G.synthesis.net)
    assert seen[:n] == seen[n:] == before
    G.load_state_dict(G_ema.state_dict())           # the EMA model got the moments
    after = [float(m) for m in G.moment_buffers()[1:]]
    assert all(a != b for a, b in zip(after, before))


def test_recipe_step_replays_fake_draws_and_picks_r1():
    '''The assembled recipe on the CPU at a tiny size: step 0 is the R1
    variant and step 1 the plain one (gp_every 16); the G phase replays the
    D-phase fakes' augment draws, the reals get their own.'''
    run = build_training(ARGS, device='cpu', seed=0)
    run.state['ada']['p'] = torch.tensor(0.5)
    entry_states = []

    class SpyPipe(type(run.pipe)):
        def __call__(self, images, p, generator=None, **kw):
            entry_states.append(generator.get_state())
            return super().__call__(images, p, generator=generator, **kw)

    run.pipe.__class__ = SpyPipe
    real = torch.rand((B, 3, N, N), generator=torch.Generator().manual_seed(1)) * 2 - 1
    assert [run.uses_r1(i) for i in (0, 1, 15, 16)] == [True, False, False, True]
    for _ in range(2):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 2 and len(entry_states) == 6
    for real_s, fake_s, fake2_s in (entry_states[:3], entry_states[3:]):
        assert torch.equal(fake_s, fake2_s) and not torch.equal(real_s, fake_s)


def test_adam_with_mapping_lr_matches_optax():
    rng = np.random.default_rng(3)
    shapes = {'map': (4, 3), 'synthesis': (5,)}
    params = {k: {'w': rng.standard_normal(s).astype(np.float32)} for k, s in shapes.items()}
    grads = [{k: {'w': (rng.standard_normal(s) * 10.0 ** -rng.integers(0, 6)).astype(np.float32)}
              for k, s in shapes.items()} for _ in range(4)]
    g_tx, _ = ju.make_optimizers(EasyDict(vars(ARGS)))
    module = torch.nn.Module()
    for k in shapes:
        sub = torch.nn.Module()
        sub.w = torch.nn.Parameter(torch.from_numpy(params[k]['w'].copy()))
        setattr(module, k, sub)
    t_opt, _ = tu.make_optimizers(ARGS, module, module)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = g_tx.init(jp)
    for g in grads:
        up, opt_state = g_tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, up)
        for k in shapes:
            getattr(module, k).w.grad = torch.from_numpy(g[k]['w'])
        t_opt.step()
    for k in shapes:
        np.testing.assert_allclose(getattr(module, k).w.detach().numpy(),
                                   np.asarray(jp[k]['w']), rtol=1e-6, atol=1e-7)
