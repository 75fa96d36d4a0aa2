'''One step of the simple-GAN trunk (`nnutils/simple_gan.py:build_adv_step`)
of the port against JAX's, for TransGAN and HiT (ConvNeXt and VAN in
`tests/test_torch_simple_gan_steps_conv.py`), the plain and the R1
variant, and each recipe's `build_training` on the CPU.

Both sides start from one bridged state (narrow models of a block or
two at 16px, ConvNeXt at 32px, VAN at 8px; variables from
`test_torch_simple_gan_models.draw_vars`, every parameter off its init
value; batch 4, f32 on the CPU, dropout 0) and get
the same draws: z and DiffAugment's for the reals, the D-phase fakes and
the G-phase fakes from the JAX step's key splits (`simple_gan.py:29-31`;
`test_torch_diffaugment.jax_draws`), with each recipe's policy
('color,translation' for TransGAN and HiT, none for ConvNeXt and VAN).
gp_lambda 10, the EMA on. Both run plain SGD and keep the raw gradients
(JAX in the optimizer state, the port in `.grad`).

Losses agree at 1e-4 of their magnitude; parameters after the step and
G_ema at 1e-4 of their scale. Gradients are held as in
`tests/test_torch_progressive_steps.py`: the port's step in float64 (every
compute dtype and parameter) agrees with JAX at 1e-4 of each gradient's
scale, floored at 1e-2 of its model's largest; the port's float32 step
agrees within that plus its own distance from its float64 step (a
leaky-ReLU or ReLU input within f32 rounding of 0 takes the other slope
in one framework).
'''

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.ConvNeXt import model as jcm
from animeface_tpu.implementations.HiT import model as jhm
from animeface_tpu.implementations.TransGAN import model as jtm
from animeface_tpu.implementations.VAN import model as jvm
from animeface_tpu.nnutils import simple_gan as jsg
from animeface_tpu.nnutils.loss import NonSaturatingLoss as JNSLoss
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.ConvNeXt import model as tcm
from animeface_tpu_torch.implementations.ConvNeXt import utils as tcu
from animeface_tpu_torch.implementations.HiT import model as thm
from animeface_tpu_torch.implementations.HiT import utils as thu
from animeface_tpu_torch.implementations.TransGAN import model as ttm
from animeface_tpu_torch.implementations.TransGAN import utils as ttu
from animeface_tpu_torch.implementations.VAN import model as tvm
from animeface_tpu_torch.implementations.VAN import utils as tvu
from animeface_tpu_torch.nnutils import simple_gan
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from test_torch_diffaugment import jax_draws
from test_torch_pggan import close, nchw, one_thread  # noqa: F401  (autouse fixture)
from test_torch_simple_gan_models import draw_vars
from test_torch_step import LR, _sgd_keeping_grads

RTOL = 1e-4
B, Z, GP = 4, 8, 10.0
COLOR = 'color,translation'


def _recipes():
    tg = dict(depths=(1, 1), latent_dim=Z, bottom_width=8, embed_dim=32, num_heads=4)
    td = dict(depth=1, image_size=16, patch_size=4, embed_dim=16, num_heads=4)
    hg = dict(latent_dim=Z, dims=(32, 16), bottom=8, low_stages=1, num_heads=(4, 2),
              num_blocks=(1, 1), patch_sizes=(4,))
    hd = dict(image_size=16, channels=8, bottom=8)
    cg = dict(latent_dim=Z, image_size=32, bottom=16, channels=4, blocks_per_scale=1)
    cd = dict(depths=(1, 0, 0, 0), dims=(8, 8, 16, 16))
    vg = dict(latent_dim=Z, image_size=8, channels=8, blocks_per_scale=1)
    vd = dict(layers=(1, 0), channels=8)
    return {
        'TransGAN': (16, COLOR, jtm.Generator(**tg), jtm.Discriminator(**td), ttm.Generator(**tg),
                     ttm.Discriminator(**td),
                     lambda p: convert.convert_transgan_generator(p, tg['depths']),
                     convert.convert_transgan_discriminator),
        'HiT': (16, COLOR, jhm.Generator(**hg), jhm.Discriminator(**hd), thm.Generator(**hg),
                thm.Discriminator(**hd), convert.convert_hit_generator,
                lambda p: convert.convert_hit_discriminator(p, 8)),
        'ConvNeXt': (32, '', jcm.Generator(**cg), jcm.Discriminator(**cd), tcm.Generator(**cg),
                     tcm.Discriminator(**cd), lambda p: convert.convert_convnext_generator(p, 1),
                     lambda p: convert.convert_convnext_discriminator(p, cd['depths'])),
        'VAN': (8, '', jvm.Generator(**vg), jvm.Discriminator(**vd), tvm.Generator(**vg),
                tvm.Discriminator(**vd), lambda p: convert.convert_van_generator(p, 1),
                lambda p: convert.convert_van_discriminator(p, vd['layers'])),
    }


#: XLA's CPU backend without its LLVM optimizations: the steps are tiny and
#: their compile, not their run, is what costs
FAST_COMPILE = {'xla_backend_optimization_level': 0, 'xla_llvm_disable_expensive_passes': True}


def make_recipe(name):
    '''The bridged models, the reals, the draws and JAX's plain and R1 steps
    from one state (one compile for both).'''
    size, policy, jG, jD, G, D, convert_g, convert_d = _recipes()[name]
    gp = draw_vars(jG, jnp.zeros((1, Z)))
    dp = draw_vars(jD, jnp.zeros((2, size, size, 3)), seed=1)
    G.load_state_dict(convert_g(gp))
    D.load_state_dict(convert_d(dp))
    real = np.clip(np.random.default_rng(6).standard_normal((B, size, size, 3)), -1,
                   1).astype(np.float32)
    sgd = _sgd_keeping_grads()
    steps = [jsg.build_adv_step(jG, jD, sgd, sgd, JNSLoss(), policy, GP, do_r1, Z)
             for do_r1 in (False, True)]
    rng = jax.random.PRNGKey(11)
    state = dict(rng=rng, G=gp, D=dp, G_ema=copy.deepcopy(gp), g_opt=sgd.init(gp),
                 d_opt=sgd.init(dp), step=jnp.int32(0))
    both = jax.jit(lambda st, x: tuple(step(st, x) for step in steps))
    jout = jax.device_get(both.lower(state, jnp.asarray(real)).compile(FAST_COMPILE)(
        state, jnp.asarray(real)))
    _, zkey, ar, af, ag = jax.random.split(rng, 5)
    draws = dict(z=torch.from_numpy(np.array(jax.random.normal(zkey, (B, Z)))),
                 **{k: jax_draws(key, real.shape, policy)
                    for k, key in (('aug_r', ar), ('aug_f', af), ('aug_g', ag))})
    return SimpleNamespace(size=size, policy=policy, G=G, D=D, real=real, draws=draws,
                           jout=dict(zip((False, True), jout)), convert_g=convert_g,
                           convert_d=convert_d)


@pytest.fixture(scope='module', params=['TransGAN', 'HiT'])
def recipe(request):
    '''TransGAN and HiT here; ConvNeXt and VAN in
    `tests/test_torch_simple_gan_steps_conv.py`.'''
    return make_recipe(request.param)


def _f64(module):
    '''`module` in float64, compute dtypes included.'''
    module = copy.deepcopy(module).double()
    for m in module.modules():
        if getattr(m, 'dtype', None) == torch.float32:
            m.dtype = torch.float64
    return module


def _check_grads(got, got64, want_grads, convert, what):
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


def _check_state(module, want, what):
    state = module.state_dict()
    assert set(state) == set(want), what
    for name, v in state.items():
        close(v.numpy(), want[name].numpy(), rtol=RTOL, what=f'{what} {name}')


def check_step(r, do_r1):
    '''The port's step (float32 and float64) against JAX's from `make_recipe`.'''
    new, jmetrics = r.jout[do_r1]
    real, draws = r.real, r.draws

    ports = {}
    for dtype in (torch.float32, torch.float64):
        G, D = ((copy.deepcopy(m) for m in (r.G, r.D)) if dtype == torch.float32
                else (_f64(m) for m in (r.G, r.D)))
        G_ema = copy.deepcopy(G).requires_grad_(False)
        pstate = dict(step=0, generator=None)
        step = simple_gan.build_adv_step(G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
                                         torch.optim.SGD(D.parameters(), lr=LR),
                                         NonSaturatingLoss(), r.policy, GP, do_r1)
        cast = {k: v.to(dtype) if k == 'z' else
                [d.to(dtype) if d.is_floating_point() else d for d in v]
                if all(isinstance(d, torch.Tensor) for d in v) else v
                for k, v in draws.items()}
        ports[dtype] = (G, D, G_ema, pstate, step(pstate, nchw(real).to(dtype), cast))
    G, D, G_ema, pstate, metrics = ports[torch.float32]
    G64, D64 = ports[torch.float64][:2]
    assert sorted(metrics) == sorted(jmetrics) == ['d', 'g'] and pstate['step'] == 1
    for k in ('g', 'd'):
        close(metrics[k], jmetrics[k], rtol=RTOL, what=f'{k} loss')
    _check_grads(G, G64, new['g_opt'], r.convert_g, 'G')
    _check_grads(D, D64, new['d_opt'], r.convert_d, 'D')
    _check_state(G, r.convert_g(new['G']), 'new G')
    _check_state(D, r.convert_d(new['D']), 'new D')
    _check_state(G_ema, r.convert_g(new['G_ema']), 'G_ema')


@pytest.mark.parametrize('do_r1', [False, True], ids=['plain', 'r1'])
def test_step_matches_jax(recipe, do_r1):
    check_step(recipe, do_r1)


RECIPE_ARGS = {
    'TransGAN': (ttu, dict(image_size=16, latent_dim=Z, g_embed_dim=32, d_embed_dim=16,
                           g_depths=[1], d_depth=1, patch_size=4, ema=True, gp_every=2)),
    'HiT': (thu, dict(image_size=16, latent_dim=Z, dims=[32, 16], low_stages=1,
                      num_heads=[4, 2], num_blocks=[1, 1], patch_sizes=[4], channels=8,
                      gp_lambda=10., gp_every=2)),
    'ConvNeXt': (tcu, dict(image_size=32, latent_dim=Z, channels=4, blocks_per_scale=1,
                           d_depths=[1, 1, 1, 1], d_dims=[8, 8, 16, 16], ttur=True)),
    'VAN': (tvu, dict(image_size=16, latent_dim=Z, channels=8, blocks_per_scale=1,
                      layers=[1, 1], norm_name='in')),
}


@pytest.mark.parametrize('name', sorted(RECIPE_ARGS))
def test_recipe_training_and_sampler_on_cpu(name):
    '''`build_training` on the CPU at the recipe's knobs: three steps with the
    default draws give finite losses and take the R1 variant where the
    cadence says; `sample_fn` gives finite images from G_ema (from G without
    an EMA) and, for TransGAN, without dropout (two calls equal).'''
    module, kw = RECIPE_ARGS[name]
    args = module.default_args(batch_size=B, no_bf16=True, **kw)
    run = module.build_training(args, device='cpu')
    real = torch.rand((B, 3, args.image_size, args.image_size),
                      generator=torch.Generator().manual_seed(1)) * 2 - 1
    every = 1 if name in ('ConvNeXt', 'VAN') else args.gp_every
    assert [run.variant(i) for i in range(3)] == [
        'r1' if args.gp_lambda > 0 and i % every == 0 else 'plain' for i in range(3)]
    for _ in range(3):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 3
    images = run.sample_fn()
    assert images.shape == (16, 3, args.image_size, args.image_size)
    assert bool(torch.isfinite(images).all())
    assert torch.equal(images, run.sample_fn())
    has_ema = name in ('ConvNeXt', 'VAN', 'TransGAN')
    assert (run.G_ema is not None) == has_ema
    if has_ema:
        assert not all(torch.equal(a, b) for a, b in zip(run.G.parameters(),
                                                          run.G_ema.parameters()))


def test_transgan_step_draws_dropout_and_sampler_does_not():
    '''TransGAN at its default dropout 0.1: the step draws one seed for G
    (both G calls of the step see the same masks) and three for D; with
    the masks the D phase's fakes differ from the sampler's dropout-free G;
    G's two calls from one seed give equal outputs.'''
    args = ttu.default_args(batch_size=B, no_bf16=True, **RECIPE_ARGS['TransGAN'][1])
    run = ttu.build_training(args, device='cpu')
    assert run.G.has_dropout and run.D.has_dropout
    real = torch.zeros((B, 3, 16, 16))
    draws = simple_gan.draw_step_inputs(Z, real, run.state['generator'], args.policy, True, True,
                                        run.state['dropout_generator'])
    assert isinstance(draws['g_dropout'], int) and len(draws['d_dropout']) == 3
    assert len(set(draws['d_dropout'])) == 3
    with torch.no_grad():
        a = run.G(draws['z'], **simple_gan._dropout(draws, 'g_dropout', None, 'cpu'))
        b = run.G(draws['z'], **simple_gan._dropout(draws, 'g_dropout', None, 'cpu'))
        plain = run.G(draws['z'])
    assert torch.equal(a, b) and not torch.allclose(a, plain)
    metrics = run.train_step(run.state, real, draws)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
