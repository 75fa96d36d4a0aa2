'''One training step of NAFNet, Restormer (their shared restoration step),
pix2pixHD (the global step, the local pre-step and the fine step) and
CycleGAN (spectral norm on) of the port against the JAX package's jitted
steps, and each recipe's `build_training` on the CPU.

Both sides start from one bridged state (`test_torch_restoration_models.
line_art_vars`: every parameter, u and running statistic off its init
value) and take the same batch (image, line art) at batch 4, f32:
pix2pixHD at 32px (its global step at 16px), the others at 16px, narrow
widths and few blocks. Plain SGD on both sides; each keeps the
raw gradients (JAX in the optimizer state, the port in `.grad`). Losses
agree at 1e-4 of their magnitude; the state after the step (parameters,
BatchNorm's running statistics, every spectral norm's u as JAX threads
them) at 1e-4 of its scale. Gradients are held as in
`tests/test_torch_paired_steps.py`: the port's step in float64 agrees with
JAX at 1e-4 of each gradient's scale, floored at 1e-2 of its model's
largest, and the float32 step within that plus its own distance from the
float64 step; a gradient the float64 step gives below 1e-9 of the model's
largest (a conv bias before an instance norm or a train-mode BatchNorm) is
held to 1e-5 of the largest on both sides. What a step freezes or never
reads (pix2pixHD's global G in the pre-step, its local G and its D's
coarser scale in the global step, the global G's image head in the local
steps)
gets exactly zero gradients on both sides and keeps its parameters
exactly.
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.CycleGAN import model as jc
from animeface_tpu.implementations.CycleGAN import utils as jcu
from animeface_tpu.implementations.NAFNet import model as jn
from animeface_tpu.implementations.NAFNet import utils as jnu
from animeface_tpu.implementations.Restormer import model as jr
from animeface_tpu.implementations.pix2pixHD import model as jh
from animeface_tpu.implementations.pix2pixHD import utils as jhu
from animeface_tpu.nnutils.loss import LSGANLoss as JLSGAN
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.CycleGAN import utils as tcu
from animeface_tpu_torch.implementations.NAFNet import utils as tnu
from animeface_tpu_torch.implementations.Restormer import utils as tru
from animeface_tpu_torch.implementations.pix2pixHD import utils as thu
from animeface_tpu_torch.nnutils.loss import LSGANLoss
from test_torch_paired_steps import STRUCTURAL, ZERO_GRAD, _batch, _run_port
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_restoration_models import PIX2PIXHD_G, line_art_vars
from test_torch_simple_gan_models import nchw
from test_torch_simple_gan_steps import FAST_COMPILE, RTOL
from test_torch_step import _sgd_keeping_grads

B = 4
PIXEL, FEAT, CYCLE = 1.0, 1.0, 1.0


def _jax_steps(steps, state, batch, batches=None):
    '''The JAX `steps` on one state and `batch` (or each on its own of
    `batches`) in ONE jit (one compile).'''
    batches = tuple(tuple(jnp.asarray(b) for b in bt) for bt in (batches or [batch] * len(steps)))

    def run(s, bs):
        return [step(s, b) for step, b in zip(steps, bs)]
    return jax.device_get(jax.jit(run).lower(state, batches).compile(FAST_COMPILE)(state,
                                                                                 batches))


def check_grads(got, got64, want_grad, what, frozen=()):
    '''The module docstring's rule; `want_grad` JAX's gradients as the
    port's state dict, `frozen` the prefixes of the names held at zero.'''
    top = max(float(v.abs().max()) for v in want_grad.values())
    grad64 = dict((n, p.grad) for n, p in got64.named_parameters())
    zero = []
    for name, p in got.named_parameters():
        assert p.grad is not None, f'{what}: no gradient for {name}'
        want = want_grad[name].double()
        if frozen and name.startswith(frozen):
            assert not bool(p.grad.any()) and not bool(want.any()), f'{what} frozen {name}'
            continue
        if float(grad64[name].abs().max()) < STRUCTURAL * top:
            zero.append(name)
            err = max(float(want.abs().max()), float(p.grad.abs().max()))
            assert err <= ZERO_GRAD * top, f'{what} zero grad {name}: {err} vs {top}'
            continue
        tol = RTOL * max(float(want.abs().max()), 1e-2 * top)
        err64 = float((grad64[name] - want).abs().max())
        assert err64 <= tol, f'{what} float64 grad {name}: max abs err {err64} vs tol {tol}'
        own = float((p.grad.double() - grad64[name]).abs().max())
        err = float((p.grad.double() - want).abs().max())
        assert err <= tol + own, f'{what} grad {name}: max abs err {err} vs {tol} + {own}'
    assert all(n.endswith('bias') for n in zero), f'{what}: zero gradients {zero}'


def check_state(module, before, want, what, frozen=()):
    state = module.state_dict()
    assert set(state) == set(want), what
    for name, v in state.items():
        if frozen and name.startswith(frozen):
            assert torch.equal(v, before[name]), f'{what} frozen {name} moved'
        close(v.numpy(), want[name].numpy(), rtol=RTOL, what=f'{what} {name}')


def check(G, D, make_step, batch, jmetrics, want, frozen=((), ())):
    '''The port's step on copies of G and D (f32 and f64) against JAX's:
    `want` holds JAX's gradients and new state as the port's state dicts
    (g_grad, d_grad, G, D); `frozen` the prefixes each model holds.'''
    G32, D32, metrics = _run_port(G, D, make_step, batch, torch.float32)
    G64, D64, _ = _run_port(G, D, make_step, batch, torch.float64)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], rtol=RTOL, what=f'{k} loss')
    check_grads(G32, G64, want['g_grad'], 'G', frozen[0])
    check_grads(D32, D64, want['d_grad'], 'D', frozen[1])
    check_state(G32, G.state_dict(), want['G'], 'new G', frozen[0])
    check_state(D32, D.state_dict(), want['D'], 'new D', frozen[1])


def _restoration(name):
    '''(JAX G, JAX D, port recipe module, its overrides), at 16px'''
    d = dict(num_layers=3, channels=8)
    if name == 'NAFNet':
        g = dict(image_size=16, bottom=8, channels=8, blocks_per_scale=1, mid_blocks=1)
        return (jn.NAFNet(**g), jn.Discriminator(**d), tnu,
                dict(image_size=16, bottom=8, g_channels=8, blocks_per_scale=1, mid_blocks=1,
                     d_channels=8))
    g = dict(num_blocks=(1, 1), num_heads=(1, 2), num_refinement_blocks=1, channels=8)
    return (jr.Generator(**g), jn.Discriminator(**d), tru,
            dict(image_size=16, num_blocks=[1, 1], num_heads=[1, 2], num_refinement_blocks=1,
                 g_channels=8, d_channels=8))


@pytest.mark.parametrize('name', ['NAFNet', 'Restormer'])
def test_restoration_step_matches_jax(name):
    '''The shared step: D's BatchNorm statistics through the real and the
    fake pair (kept), the G phase's dropped; the pixel L1.'''
    jG, jD, module, kw = _restoration(name)
    size = 16
    gp = line_art_vars(jG, jnp.zeros((1, size, size, 1)))['params']
    dv = line_art_vars(jD, jnp.zeros((2, size, size, 4)), seed=1, train=True)
    batch = _batch([(B, size, size, 3), (B, size, size, 1)], 2)
    sgd = _sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(1), G=gp, D=dv, g_opt=sgd.init(gp),
                 d_opt=sgd.init(dv['params']), step=jnp.int32(0))
    [(jnew, jmetrics)] = _jax_steps(
        [jnu.build_restoration_step(jG, jD, sgd, sgd, JLSGAN(), PIXEL)], state, batch)
    G, D, _ = module.build_models(module.default_args(no_bf16=True, **kw), 'cpu')
    convert_g = (convert.convert_nafnet_generator if name == 'NAFNet'
                 else convert.convert_restormer_generator)
    G.load_state_dict(convert_g(gp))
    D.load_state_dict(convert.convert_nafnet_discriminator(dv))

    def make_step(G, D, g_opt, d_opt, dtype):
        return tnu.build_restoration_step(G, D, g_opt, d_opt, LSGANLoss(), PIXEL)
    check(G, D, make_step, batch, jmetrics, dict(
        g_grad=convert_g(jnew['g_opt']), d_grad=convert.convert_nafnet_discriminator(
            jnew['d_opt']), G=convert_g(jnew['G']), D=convert.convert_nafnet_discriminator(
            jnew['D'])))


PIX2PIXHD_ARGS = dict(channels=4, local_num_blocks=1, global_num_blocks=1, global_num_downs=1,
                      d_num_scale=2, feat_lambda=FEAT)


@pytest.fixture(scope='module')
def pix2pixhd():
    '''The bridged G and D and JAX's global step at 16px, its pre and fine
    steps at 32px (one compile for the three).'''
    jG, jD = jh.Generator(**PIX2PIXHD_G), jh.Discriminator(channels=4, num_scales=2)
    gp = line_art_vars(jG, jnp.zeros((1, 32, 32, 1)))['params']
    dp = line_art_vars(jD, jnp.zeros((1, 32, 32, 4)), seed=1)['params']
    sgd = _sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(1), G=gp, D=dp, g_opt=sgd.init(gp), d_opt=sgd.init(dp),
                 step=jnp.int32(0))

    def step(d_scale, g_keep, d_keep, global_phase):
        return jhu.build_train_step(jG, jD, sgd, sgd, JLSGAN(), FEAT, d_scale, g_keep, d_keep,
                                    global_phase)
    batches = {size: _batch([(B, size, size, 3), (B, size, size, 1)], 3) for size in (16, 32)}
    glob, pre, fine = _jax_steps(
        [step(1, ('global_g',), ('scale_0',), True), step(2, ('local_g',), None, False),
         step(2, None, None, False)], state, None, [batches[16], batches[32], batches[32]])
    G, D, _ = thu.build_models(thu.default_args(no_bf16=True, **PIX2PIXHD_ARGS), 'cpu')
    G.load_state_dict(convert.convert_pix2pixhd_generator(gp))
    D.load_state_dict(convert.convert_pix2pixhd_discriminator(dp))
    return G, D, batches, dict(global_=glob, pre=pre, fine=fine)


@pytest.mark.parametrize('variant', ['global_', 'pre', 'fine'])
def test_pix2pixhd_step_matches_jax(pix2pixhd, variant):
    '''The global step (global G through `global_forward`, D's finest of
    two scales), the local pre-step (the local G alone, both scales) and the
    fine step (everything), feature matching on.'''
    G, D, batches, jax_out = pix2pixhd
    jnew, jmetrics = jax_out[variant]
    d_scale, g_frozen, frozen = {
        'global_': (1, ('local_g',), (('local_g.',), ('scales.1.',))),
        'pre': (2, ('global_g',), (('global_g.',), ())),
        'fine': (2, (), (('global_g.convs.2.',), ())),
    }[variant]

    def make_step(G, D, g_opt, d_opt, dtype):
        return thu.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), FEAT, d_scale, g_frozen,
                                    variant == 'global_')
    cg, cd = convert.convert_pix2pixhd_generator, convert.convert_pix2pixhd_discriminator
    check(G, D, make_step, batches[16 if variant == 'global_' else 32], jmetrics, dict(
        g_grad=cg(jnew['g_opt']), d_grad=cd(jnew['d_opt']), G=cg(jnew['G']), D=cd(jnew['D'])),
        tuple(tuple(f) for f in frozen))


def _cyclegan(variables_ab, variables_ba):
    return {**convert.convert_cyclegan_generator(variables_ab, 'G_ab.'),
            **convert.convert_cyclegan_generator(variables_ba, 'G_ba.')}


def _cyclegan_d(variables_a, variables_b):
    return {**convert.convert_cyclegan_discriminator(variables_a, 'D_a.'),
            **convert.convert_cyclegan_discriminator(variables_b, 'D_b.')}


def test_cyclegan_step_matches_jax():
    '''Spectral norm in both Gs and Ds: the D phase's G updates of u
    dropped, the G phase's first forwards' kept, each D's through its real
    and fake forwards kept.'''
    kw = dict(image_size=16, target_resl=8, channels=4, num_blocks=1, use_sn=True)
    jG_ab, jG_ba = jc.Generator(in_channels=3, out_channels=1, **kw), jc.Generator(
        in_channels=1, out_channels=3, **kw)
    jD_a, jD_b = (jc.Discriminator(channels=4, num_layers=2, use_sn=True) for _ in range(2))
    gab = line_art_vars(jG_ab, jnp.zeros((2, 16, 16, 3)), train=True)
    gba = line_art_vars(jG_ba, jnp.zeros((2, 16, 16, 1)), seed=1, train=True)
    da = line_art_vars(jD_a, jnp.zeros((2, 16, 16, 3)), seed=2, train=True)
    db = line_art_vars(jD_b, jnp.zeros((2, 16, 16, 1)), seed=3, train=True)
    batch = _batch([(B, 16, 16, 3), (B, 16, 16, 1)], 4)
    sgd = _sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(1), G_ab=gab, G_ba=gba, D_a=da, D_b=db,
                 g_opt=sgd.init((gab['params'], gba['params'])),
                 d_opt=sgd.init((da['params'], db['params'])), step=jnp.int32(0))
    [(jnew, jmetrics)] = _jax_steps(
        [jcu.build_train_step(jG_ab, jG_ba, jD_a, jD_b, sgd, sgd, JLSGAN(), CYCLE)], state, batch)
    args = tcu.default_args(image_size=16, downsample_to=8, channels=4, num_blocks=1,
                            num_layers=2, no_bf16=True)
    G, D, _ = tcu.build_models(args, 'cpu')
    G.load_state_dict(_cyclegan(gab, gba))
    D.load_state_dict(_cyclegan_d(da, db))

    def make_step(G, D, g_opt, d_opt, dtype):
        return tcu.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), CYCLE)

    def grads(pair):
        return tuple({'params': p} for p in pair)
    check(G, D, make_step, batch, jmetrics, dict(
        g_grad=_cyclegan(*grads(jnew['g_opt'])), d_grad=_cyclegan_d(*grads(jnew['d_opt'])),
        G=_cyclegan(jnew['G_ab'], jnew['G_ba']), D=_cyclegan_d(jnew['D_a'], jnew['D_b'])))


RECIPES = {
    'NAFNet': (tnu, dict(g_channels=8, blocks_per_scale=1, mid_blocks=1, d_channels=8), {}),
    'Restormer': (tru, dict(g_channels=8, num_blocks=[1, 1], num_heads=[1, 2],
                            num_refinement_blocks=1, d_channels=8), {}),
    'pix2pixHD': (thu, PIX2PIXHD_ARGS, dict(steps_per_epoch=2, global_phase=False)),
    'CycleGAN': (tcu, dict(channels=4, num_blocks=1, downsample_to=16), {}),
}


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_recipe_training_and_sampler_on_cpu(name):
    '''`build_training` on the CPU from the xdog task's synthetic test
    batch: three steps give finite losses; the sampler's grid holds G's
    output for each test sample among the columns the JAX grid has
    ((image, line art, G) for NAFNet and Restormer, (line art, G, image)
    for pix2pixHD, (image, G) for CycleGAN), in order. pix2pixHD's local
    phase crosses `fine_from` (one epoch of two steps): its global G moves
    only then.'''
    from animeface_tpu_torch.dataset import DataLoader, build_dataset

    module, kw, extra = RECIPES[name]
    args = module.default_args(image_size=32, batch_size=B, no_bf16=True, synthetic_data=True,
                               num_images=8, **kw)
    if name == 'pix2pixHD':
        args.fine_from = 1
    dataset = build_dataset(args, 'xdog')
    num_test = args.test_images if name == 'CycleGAN' else args.num_test
    test = next(iter(DataLoader(dataset, num_test, shuffle=False, num_workers=1)))
    run = module.build_training(args, device='cpu', test_batch=test, **extra)
    batch = tuple(nchw(b) for b in next(iter(DataLoader(dataset, B, num_workers=1))))
    global_g = (copy.deepcopy(run.G.global_g.state_dict()) if name == 'pix2pixHD' else None)
    for i in range(3):
        metrics = run.train_step(run.state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        if global_g is not None:
            moved = any(not torch.equal(v, global_g[k])
                        for k, v in run.G.global_g.state_dict().items())
            assert moved == (i >= 2), f'pix2pixHD global G after step {i}: moved {moved}'
    assert run.state['step'] == 3
    grid = run.sample_fn()
    columns = {'CycleGAN': 2}.get(name, 3)
    assert grid.shape == (columns * num_test, 3, 32, 32) and bool(torch.isfinite(grid).all())
    image, line = (nchw(t) for t in test)
    shown = {'NAFNet': (0, image), 'Restormer': (0, image), 'pix2pixHD': (2, image),
             'CycleGAN': (0, image)}[name]
    assert torch.equal(grid[shown[0]::columns], shown[1])
    if name != 'CycleGAN':
        col = 1 if name in ('NAFNet', 'Restormer') else 0
        assert torch.equal(grid[col::columns], line.expand(-1, 3, -1, -1))
    assert torch.equal(grid, run.sample_fn())
