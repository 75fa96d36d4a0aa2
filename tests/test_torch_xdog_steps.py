'''One training step of normalizations ('in' and 'bn'), SPADE (its encoder
on, BatchNorm and spectral norm in G, E and D) and SCFT (the TPS warp and
the triplet loss) of the port against the JAX package's jitted steps, and
each recipe's `build_training` on the CPU.

Both sides start from one bridged state (`test_torch_xdog_models.
xdog_vars`: every parameter, u and running statistic off its init value)
and take the same batch (image, line art) at batch 4, f32, 32px, narrow
widths: SPADE's D at two scales of two layers, SCFT's D at one layer (its
default three need 128px). The port takes the draws JAX makes from its
key: DiffAugment's uniforms (`test_torch_diffaugment.jax_draws`), E's
noise, the TPS offsets. The VGG16 losses run on the same He-normal trunk
on both sides (`test_torch_paired_steps.vgg_path`). Plain SGD on both
sides; each keeps the raw gradients. Losses agree at 1e-4 of their
magnitude, the state after the step (parameters, BatchNorm's running
statistics, every spectral norm's u as JAX threads them) at 1e-4 of its
scale, and the gradients as `tests/test_torch_restoration_steps.py` holds
them: the port's step in float64 is the kink-aware reference (JAX's
float32 step and the port's float32 step take the same leaky-ReLU,
hinge and triplet kinks as it does only up to rounding), agreeing with
JAX at 1e-4 of each gradient's scale, floored at 1e-2 of its model's
largest; the float32 step within that plus its own distance from the
float64 step; structurally zero gradients (a conv bias before a norm)
within 1e-5 of the model's largest on both sides.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.SCFT import model as jc
from animeface_tpu.implementations.SCFT import utils as jcu
from animeface_tpu.implementations.SPADE import model as js
from animeface_tpu.implementations.SPADE import utils as jsu
from animeface_tpu.implementations.SRGAN import model as jsr
from animeface_tpu.implementations.normalizations import model as jn
from animeface_tpu.implementations.normalizations import utils as jnu
from animeface_tpu.nnutils.loss import HingeLoss as JHinge, LSGANLoss as JLSGAN
from animeface_tpu.nnutils.loss import vgg as jvgg
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.SCFT import utils as tcu
from animeface_tpu_torch.implementations.SPADE import utils as tsu
from animeface_tpu_torch.implementations.normalizations import utils as tnu
from animeface_tpu_torch.nnutils.loss import HingeLoss, LSGANLoss
from animeface_tpu_torch.nnutils.loss import vgg as tvgg
from test_torch_diffaugment import jax_draws
from test_torch_paired_steps import _batch, _vgg64, vgg_path  # noqa: F401  (fixture)
from test_torch_pggan import one_thread  # noqa: F401  (autouse fixture)
from test_torch_restoration_steps import _jax_steps, check
from test_torch_simple_gan_models import nchw
from test_torch_step import _sgd_keeping_grads
from test_torch_xdog_models import xdog_vars

B, SIZE = 4, 32
RECON, STYLE, CONTENT = 1.0, 1.0, 1.0
FEAT, KLD = 1.0, 0.05


def _draws_as(draws, dtype):
    '''`draws` with their floating tensors in `dtype`.'''
    if isinstance(draws, torch.Tensor):
        return draws.to(dtype) if draws.is_floating_point() else draws
    if isinstance(draws, dict):
        return {k: _draws_as(v, dtype) for k, v in draws.items()}
    return type(draws)(_draws_as(v, dtype) for v in draws)


def _vgg(path, dtype):
    vgg = tvgg.VGGLoss(device='cpu', vgg=16, weights_path=path)
    return vgg if dtype == torch.float32 else _vgg64(vgg)


@pytest.mark.parametrize('norm', ['in', 'bn'])
def test_normalizations_step_matches_jax(norm, vgg_path):
    '''DiffAugment 'color' on the image; G's BatchNorm statistics from the
    D phase's forward (kept), the G phase's dropped; the L1, the style and
    the content losses on.'''
    g_kw = dict(image_size=SIZE, channels=4, style_dim=8, norm_name=norm)
    jG, jD = jn.Generator(**g_kw), jsr.Discriminator(num_scale=1, channels=4, sn=False)
    gv = xdog_vars(jG, jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2, SIZE, SIZE, 3)), train=True)
    dv = xdog_vars(jD, jnp.zeros((2, SIZE, SIZE, 3)), seed=1, train=True)
    gv = dict(gv) if 'batch_stats' in gv else {'params': gv['params'], 'batch_stats': {}}
    dv = {'params': dv['params'], 'batch_stats': dv.get('batch_stats', {})}
    batch = _batch([(B, SIZE, SIZE, 3), (B, SIZE, SIZE, 1)], 2)
    sgd = _sgd_keeping_grads()
    key = jax.random.PRNGKey(1)
    state = dict(rng=key, G=gv, D=dv, g_opt=sgd.init(gv['params']),
                 d_opt=sgd.init(dv['params']), step=jnp.int32(0))
    [(jnew, jmetrics)] = _jax_steps([jnu.build_train_step(
        jG, jD, sgd, sgd, JLSGAN(), jvgg.VGGLoss(vgg=16, weights_path=vgg_path), RECON, STYLE,
        CONTENT)], state, batch)
    draws = dict(aug=jax_draws(jax.random.split(key)[1], batch[0].shape, 'color'))
    args = tnu.default_args(image_size=SIZE, channels=4, style_dim=8, d_channels=4,
                            norm_name=norm, no_bf16=True)
    G, D, _ = tnu.build_models(args, 'cpu')
    G.load_state_dict(convert.convert_normalizations_generator(gv))
    D.load_state_dict(convert.convert_srgan_discriminator(dv))

    def make_step(G, D, g_opt, d_opt, dtype):
        step = tnu.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), _vgg(vgg_path, dtype),
                                    RECON, STYLE, CONTENT)
        return lambda state, batch: step(state, batch, _draws_as(draws, dtype))
    cg, cd = convert.convert_normalizations_generator, convert.convert_srgan_discriminator
    check(G, D, make_step, batch, jmetrics, dict(
        g_grad=cg({'params': jnew['g_opt']}), d_grad=cd({'params': jnew['d_opt']}),
        G=cg(jnew['G']), D=cd(jnew['D'])))


def _spade(jnew_g, jnew_e):
    return {**convert.convert_spade_generator(jnew_g, 'G.'),
            **convert.convert_spade_encoder(jnew_e, 'E.')}


def test_spade_step_matches_jax():
    '''E's reparameterization with the noise of JAX's key in both phases;
    the D phase's G and E updates dropped, the G phase's kept; D's u
    through the real and the fake pair kept, and each of the G phase's D
    forwards from it; the hinge loss, feature matching and the KL term.'''
    g_kw = dict(image_size=SIZE, z_dim=8, channels=2, max_channels=16, spade_hidden_channels=4)
    jG, jE = js.Generator(**g_kw), js.Encoder(image_size=SIZE, z_dim=8, channels=2, use_sn=True)
    jD = jsr.Discriminator(num_scale=2, num_layers=2, channels=2)
    key = jax.random.PRNGKey(1)
    gv = xdog_vars(jG, jnp.zeros((2, 8)), jnp.zeros((2, SIZE, SIZE, 1)))
    ev = xdog_vars(jE, jnp.zeros((2, SIZE, SIZE, 3)), key, seed=1)
    dv = xdog_vars(jD, jnp.zeros((2, SIZE, SIZE, 4)), seed=2, train=True)
    batch = _batch([(B, SIZE, SIZE, 3), (B, SIZE, SIZE, 1)], 3)
    sgd = _sgd_keeping_grads()
    state = dict(rng=key, G=dict(gv), D=dv, E=dict(ev),
                 g_opt=sgd.init((gv['params'], ev['params'])), d_opt=sgd.init(dv['params']),
                 step=jnp.int32(0))
    [(jnew, jmetrics)] = _jax_steps(
        [jsu.build_train_step(jG, jD, jE, sgd, sgd, JHinge(), FEAT, KLD, 8)], state, batch)
    eps = torch.from_numpy(np.asarray(jax.random.normal(jax.random.split(key, 3)[2], (B, 8))))
    args = tsu.default_args(no_bf16=True, num_layers=2, feat_lambda=FEAT, kld_lambda=KLD,
                            **g_kw)
    G, D, _ = tsu.build_models(args, 'cpu')
    G.load_state_dict(_spade(gv, ev))
    D.load_state_dict(convert.convert_srgan_discriminator(dv))

    def make_step(G, D, g_opt, d_opt, dtype):
        step = tsu.build_train_step(G, D, g_opt, d_opt, HingeLoss(), FEAT, KLD)
        return lambda state, batch: step(state, batch, dict(z=eps.to(dtype)))
    g_grads, e_grads = jnew['g_opt']
    cd = convert.convert_srgan_discriminator
    check(G, D, make_step, batch, jmetrics, dict(
        g_grad=_spade({'params': g_grads}, {'params': e_grads}), d_grad=cd({'params':
                                                                            jnew['d_opt']}),
        G=_spade(jnew['G'], jnew['E']), D=cd(jnew['D'])))


def test_scft_step_matches_jax(vgg_path):
    '''DiffAugment 'color' and the TPS warp of the image from JAX's keys;
    the D phase's G update of u dropped, the G phase's two forwards'
    chained and kept; the L1, VGG16's style and perceptual losses and the
    triplet loss at the recipe's weights and margin 12. The recipe's VGG
    losses are L1s (p=1, held against JAX in `tests/test_torch_vgg.py`);
    here they are the squared ones (p=2) on both sides: the L1s of gram
    entries and features take |.| kinks in JAX's float32 step that no
    float64 run of the port can take with it (G's gradients 1.9x the
    tolerance with p=1, 0.45x with p=2).'''
    jG = jc.Generator(image_size=SIZE, enc_channels=2, num_res_blocks=1)
    jD = jc.Discriminator(num_layers=1, channels=4)
    gv = xdog_vars(jG, jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2, SIZE, SIZE, 3)))
    dv = xdog_vars(jD, jnp.zeros((2, SIZE, SIZE, 4)), seed=1)
    batch = _batch([(B, SIZE, SIZE, 3), (B, SIZE, SIZE, 1)], 4)
    args = tcu.default_args(image_size=SIZE, enc_channels=2, num_res_blocks=1, num_layers=1,
                            d_channels=4, no_bf16=True)
    lambdas = (args.recon_lambda, args.style_lambda, args.perc_lambda, args.triplet_lambda,
               args.margin)
    sgd = _sgd_keeping_grads()
    key = jax.random.PRNGKey(1)
    state = dict(rng=key, G=gv['params'], D=dv['params'], G_bs=gv['batch_stats'],
                 D_bs=dv['batch_stats'], g_opt=sgd.init(gv['params']),
                 d_opt=sgd.init(dv['params']), step=jnp.int32(0))
    [(jnew, jmetrics)] = _jax_steps([jcu.build_train_step(
        jG, jD, sgd, sgd, JLSGAN(), jvgg.VGGLoss(vgg=16, p=2, weights_path=vgg_path),
        *lambdas)], state, batch)
    _, ck, tk = jax.random.split(key, 3)
    draws = dict(aug=jax_draws(ck, batch[0].shape, 'color'),
                 tps=torch.from_numpy(np.asarray(jax.random.normal(tk, (B, 16, 2)) * 0.05)))
    G, D, _ = tcu.build_models(args, 'cpu')
    G.load_state_dict(convert.convert_scft_generator(gv))
    D.load_state_dict(convert.convert_scft_discriminator(dv))

    def make_step(G, D, g_opt, d_opt, dtype):
        step = tcu.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), _vgg(vgg_path, dtype),
                                    *lambdas)
        return lambda state, batch: step(state, batch, _draws_as(draws, dtype))
    cg, cd = convert.convert_scft_generator, convert.convert_scft_discriminator
    check(G, D, make_step, batch, jmetrics, dict(
        g_grad=cg({'params': jnew['g_opt']}), d_grad=cd({'params': jnew['d_opt']}),
        G=cg({'params': jnew['G'], 'batch_stats': jnew['G_bs']}),
        D=cd({'params': jnew['D'], 'batch_stats': jnew['D_bs']})))


RECIPES = {
    'normalizations': (tnu, dict(channels=4, style_dim=8, d_channels=4), 32, 'num_test'),
    'SPADE': (tsu, dict(z_dim=8, channels=2, max_channels=16, spade_hidden_channels=4), 64,
              'test_images'),
    'SCFT': (tcu, dict(enc_channels=2, num_res_blocks=1, d_channels=4), 128, 'num_test'),
}


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_recipe_training_and_sampler_on_cpu(name, vgg_path, monkeypatch):
    '''`build_training` on the CPU from the xdog task's synthetic test
    batch at the smallest size each D takes: two steps give finite losses,
    the sampler's grid is (line art as RGB, image, G's image) for each test
    sample, in order.'''
    from animeface_tpu_torch.dataset import DataLoader, build_dataset

    monkeypatch.setenv('ANIMEFACE_VGG_WEIGHTS', vgg_path)
    module, kw, size, num_test = RECIPES[name]
    args = module.default_args(image_size=size, batch_size=2, no_bf16=True, synthetic_data=True,
                               num_images=16, **kw)
    dataset = build_dataset(args, 'xdog')
    n = getattr(args, num_test)
    test = next(iter(DataLoader(dataset, n, shuffle=False, num_workers=1)))
    made = []
    monkeypatch.setattr(module, 'VGGLoss', lambda *a, **kw: made.append(kw) or tvgg.VGGLoss(
        *a, **kw), raising=False)
    run = module.build_training(args, device='cpu', test_batch=test)
    if name != 'SPADE':                 # SCFT's VGG losses are L1s
        assert made == [dict(vgg=16, p=1 if name == 'SCFT' else 2)]
    batch = tuple(nchw(b) for b in next(iter(DataLoader(dataset, 2, num_workers=1))))
    for _ in range(2):
        metrics = run.train_step(run.state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 2
    grid = run.sample_fn()
    assert grid.shape == (3 * n, 3, size, size) and bool(torch.isfinite(grid).all())
    image, line = (nchw(t) for t in test)
    assert torch.equal(grid[0::3], line.expand(-1, 3, -1, -1))
    assert torch.equal(grid[1::3], image)
    assert torch.equal(grid, run.sample_fn())
