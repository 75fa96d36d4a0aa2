'''One training step of PGGAN and StyleGAN (v1) of the port against the
JAX steps, at depth 1 (8px) in each mode pair the phase machine produces
(G_transition ('t', 's'), a stable phase ('s', 's'), D_transition ('s',
't')), and `gradient_penalty` alone against JAX's.

Both sides start from one bridged state (depth-2 models at narrow widths,
32 and 16 channels, patched into both frameworks' width tables; latent
16, biases and StyleGAN's noise scales moved off their init; batch 4, f32
on the CPU), alpha 0.5 and alpha_delta 0.25, and
get the same draws: z and the penalty's alpha from the JAX step's keys,
StyleGAN's noise maps made with numpy and returned by the JAX model
module's noise draws (`NoiseJax`; both G calls of the step see the same
maps, as both JAX calls get one key). The step runs plain SGD on both
sides and each keeps the raw gradients (JAX in the optimizer state, the
port in `.grad`). Losses, alpha and every parameter after the step agree
at 1e-4 of their scale, the tolerance of
`tests/test_torch_dcgan_steps.py` (f32 through G and D, forward, backward
and the penalty's double backward, in two frameworks). The gradients are
held twice. The port's step run in float64 (every module's compute dtype
and parameter; the casts the recipe makes to float32 stay) agrees with the
JAX step at 1e-4 of each gradient's scale, floored at 1e-2 of its model's
largest gradient (D's last bias has no adversarial gradient, -1 + 1, so
rounding is all there is), as in the DCGAN steps test. The port's float32
step agrees with JAX within that tolerance plus its own distance from its
float64 step: a leaky-ReLU input within float32 rounding of 0 takes the
other slope in one framework, and with the penalty's weight of 10 one such
input (at 7.8e-7, in D's from_rgb of the fakes in PGGAN's stable case)
moves whole gradients by up to 6e-3 of their scale, in the port's float32
against its own float64 run as much as against JAX.
'''

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.PGGAN import model as jpm
from animeface_tpu.implementations.PGGAN import utils as jpu
from animeface_tpu.implementations.StyleGAN import model as jsm
from animeface_tpu.implementations.StyleGAN import utils as jsu
from animeface_tpu.nnutils.loss import NonSaturatingLoss as JNSLoss, WGANLoss as JWGANLoss
from animeface_tpu.nnutils.loss.penalty import gradient_penalty as jgradient_penalty
from animeface_tpu_torch.convert import (
    convert_pggan_discriminator, convert_pggan_generator, convert_stylegan1_generator)
from animeface_tpu_torch.implementations.PGGAN import model as tpm
from animeface_tpu_torch.implementations.PGGAN import utils as tpu
from animeface_tpu_torch.implementations.StyleGAN import model as tsm
from animeface_tpu_torch.implementations.StyleGAN import utils as tsu
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss, WGANLoss, gradient_penalty
from test_torch_pggan import NoiseJax, bridged, close, nchw, one_thread  # noqa: F401
from test_torch_step import LR, _sgd_keeping_grads
from test_torch_stylegan1 import noise_maps

RTOL = 1e-4
Z, B, DEPTH = 16, 4, 1
MODES = [('t', 's'), ('s', 's'), ('s', 't')]
#: narrow width tables for both frameworks' models (the forward tests in
#: test_torch_pggan.py and test_torch_stylegan1.py run the modules' own)
G_NARROW = [(None, 32), (32, 32), (32, 16)]
D_NARROW = [(32, 32), (32, 32), (16, 32)]


@pytest.fixture(scope='module', autouse=True)
def narrow_widths():
    '''The steps at narrow widths: every model module reads its width table
    when it builds or runs a block, so both sides patch theirs.'''
    with pytest.MonkeyPatch.context() as mp:
        for module, g_name, d_name in ((jpm, 'G_PARAMS', 'D_PARAMS'), (jsm, 'G_CH', 'D_CH'),
                                       (tpm, 'G_PARAMS', 'D_PARAMS')):
            mp.setattr(module, g_name, G_NARROW)
            mp.setattr(module, d_name, D_NARROW)
        mp.setattr(tsm, 'G_CH', [(32, 32), (32, 32), (32, 16)])
        yield


def _recipe(name):
    if name == 'PGGAN':
        jG, jD = jpm.Generator(latent_dim=Z, max_depth=2), jpm.Discriminator(max_depth=2)
        args = tpu.default_args(image_size=16, latent_dim=Z, no_bf16=True)
        G, D = tpu.build_models(args, 'cpu')
        gp, dp = bridged(jG, jD, G, D, convert_pggan_generator, convert_pggan_discriminator)
        return SimpleNamespace(jG=jG, jD=jD, G=G, D=D, gp=gp, dp=dp, jutils=jpu, jloss=JWGANLoss(),
                               loss=WGANLoss(), drift=1e-3, build=tpu.build_train_step,
                               convert_g=convert_pggan_generator, nkeys=3)
    jG = jsm.Generator(latent_dim=Z, style_dim=Z, max_depth=2)
    jD = jsm.Discriminator(max_depth=2)
    args = tsu.default_args(image_size=16, latent_dim=Z, no_bf16=True)
    G, D = tsu.build_models(args, 'cpu')
    gp, dp = bridged(jG, jD, G, D, convert_stylegan1_generator, convert_pggan_discriminator)
    return SimpleNamespace(jG=jG, jD=jD, G=G, D=D, gp=gp, dp=dp, jutils=jsu, jloss=JNSLoss(),
                           loss=NonSaturatingLoss(), drift=1e-4, build=tsu.build_train_step,
                           convert_g=convert_stylegan1_generator, nkeys=4)


@pytest.fixture(scope='module', params=['PGGAN', 'StyleGAN'])
def recipe(request):
    return request.param, _recipe(request.param)


def _f64(module):
    '''`module` in float64, compute dtypes included.'''
    module = copy.deepcopy(module).double()
    for m in module.modules():
        if getattr(m, 'dtype', None) == torch.float32:
            m.dtype = torch.float64
    return module


def _check(got, got64, want_grads, want_params, convert, what):
    '''`got` (the float32 step's module) and `got64` (the float64 step's)
    against the JAX step's gradients and parameters.'''
    want_grad = convert(want_grads)
    floor = 1e-2 * max(float(v.abs().max()) for v in want_grad.values())
    grad64 = dict((n, p.grad) for n, p in got64.named_parameters())
    for name, p in got.named_parameters():
        assert p.grad is not None, f'{what}: no gradient for {name}'
        want = want_grad[name].double()
        tol = RTOL * max(float(want.abs().max()), floor)
        err64 = float((grad64[name] - want).abs().max())
        assert err64 <= tol, f'{what} float64 grad {name}: max abs err {err64} vs tol {tol}'
        own = float((p.grad.double() - grad64[name]).abs().max())
        err = float((p.grad.double() - want).abs().max())
        assert err <= tol + own, f'{what} grad {name}: max abs err {err} vs {tol} + {own}'
    want = convert(want_params)
    state = got.state_dict()
    assert set(state) == set(want)
    for name, v in state.items():
        close(v.numpy(), want[name].numpy(), rtol=RTOL, what=f'{what} {name}')


@pytest.mark.parametrize('modes', MODES, ids=['G_transition', 'stable', 'D_transition'])
def test_step_matches_jax(recipe, monkeypatch, modes):
    name, r = recipe
    g_mode, d_mode = modes
    real = np.clip(np.random.default_rng(6).standard_normal((B, 8, 8, 3)), -1,
                   1).astype(np.float32)
    maps = noise_maps(B, DEPTH, seed=50)
    if name == 'StyleGAN':
        monkeypatch.setattr(jsm, 'jax', NoiseJax([m.transpose(0, 2, 3, 1) for m in maps]))
    sgd = _sgd_keeping_grads()
    jstep = r.jutils.build_train_step(r.jG, r.jD, sgd, sgd, r.jloss, 10.0, r.drift, DEPTH,
                                      g_mode, d_mode)
    rng = jax.random.PRNGKey(11)
    state = dict(rng=rng, G=r.gp, D=r.dp, g_opt=sgd.init(r.gp), d_opt=sgd.init(r.dp),
                 alpha=jnp.float32(0.5), alpha_delta=jnp.float32(0.25), step=jnp.int32(0))
    new, jmetrics = jax.device_get(jax.jit(jstep)(state, jnp.asarray(real)))
    keys = jax.random.split(rng, r.nkeys)
    draws = dict(z=torch.from_numpy(np.array(jax.random.normal(keys[1], (B, Z)))),
                 gp_alpha=torch.from_numpy(np.array(jax.random.uniform(keys[2], (1, 1, 1, 1)))))
    if name == 'StyleGAN':
        draws['noise'] = [torch.from_numpy(m) for m in maps]

    ports = {}
    for dtype in (torch.float32, torch.float64):
        G, D = ((copy.deepcopy(m) for m in (r.G, r.D)) if dtype == torch.float32
                else (_f64(m) for m in (r.G, r.D)))
        pstate = dict(step=0, generator=None, alpha=torch.tensor(0.5, dtype=dtype),
                      alpha_delta=torch.tensor(0.25, dtype=dtype))
        step = r.build(G, D, torch.optim.SGD(G.parameters(), lr=LR),
                       torch.optim.SGD(D.parameters(), lr=LR), r.loss, 10.0, r.drift, DEPTH,
                       g_mode, d_mode)
        cast = {k: ([m.to(dtype) for m in v] if k == 'noise' else v.to(dtype))
                for k, v in draws.items()}
        ports[dtype] = (G, D, pstate, step(pstate, nchw(real).to(dtype), cast))
    G, D, pstate, metrics = ports[torch.float32]
    G64, D64 = ports[torch.float64][:2]
    for k in ('d', 'g', 'alpha'):
        close(metrics[k], jmetrics[k], rtol=RTOL, what=f'{k}')
    close(pstate['alpha'], new['alpha'], rtol=0, what='new alpha')
    assert float(pstate['alpha']) == 0.75 and pstate['step'] == 1
    _check(G, G64, new['g_opt'], new['G'], r.convert_g, 'G')
    _check(D, D64, new['d_opt'], new['D'], convert_pggan_discriminator, 'D')


@pytest.mark.parametrize('center', [1.0, 0.0])
def test_gradient_penalty_matches_jax(center):
    '''The penalty's value and its gradient with respect to D's parameters
    (through the input gradient's double backward), one alpha for the
    batch, against JAX's with the alpha its key draws (narrow widths).'''
    jD = jpm.Discriminator(max_depth=1)
    G, D = tpu.build_models(tpu.default_args(image_size=8, latent_dim=Z, no_bf16=True), 'cpu')
    dp = bridged(jpm.Generator(latent_dim=Z, max_depth=1), jD, G, D, convert_pggan_generator,
                 convert_pggan_discriminator)[1]
    rng = np.random.default_rng(7)
    real, fake = (rng.standard_normal((B, 8, 8, 3)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(5)

    def jloss(params):
        return jgradient_penalty(key, jnp.asarray(real), jnp.asarray(fake),
                                 lambda x: jD.apply({'params': params}, x, depth=1, mode='t',
                                                    alpha=0.5), center=center)
    want, want_grads = jax.device_get(jax.value_and_grad(jloss)(dp))
    alpha = torch.from_numpy(np.array(jax.random.uniform(key, (1, 1, 1, 1))))
    got = gradient_penalty(nchw(real), nchw(fake), lambda x: D(x, 1, 't', 0.5), alpha, center)
    got.backward()
    close(got.detach().numpy(), want, rtol=RTOL, what='penalty')
    grads = convert_pggan_discriminator(want_grads)
    # a bias right before a linear stage (D's last one, the one before the
    # average pool) has no penalty gradient in exact arithmetic: the floor
    # of the step test, 1e-2 of the largest gradient, scales those
    floor = 1e-2 * max(float(v.abs().max()) for v in grads.values())
    for name, p in D.named_parameters():
        # D's last bias does not reach the input gradient: no graph, JAX's 0
        got_grad = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((got_grad - grads[name]).abs().max())
        tol = RTOL * max(float(grads[name].abs().max()), floor)
        assert err <= tol, f'penalty grad {name}: max abs err {err} vs tol {tol}'
    with pytest.raises(ValueError):
        gradient_penalty(nchw(real), nchw(fake), D, alpha, center=0.5)
