'''One training step of pix2pix, SRGAN (instance norm and BatchNorm) and
ESRGAN of the port against the JAX package's `build_train_step`, and each
recipe's `build_training` on the CPU.

Both sides start from one bridged state (variables from
`test_torch_paired_models.paired_vars`: every parameter, u and running
statistic off its init value) and take the same batch: pix2pix at 32px
(line art -> RGB, its UNet at full width, pixelwise_gamma 1 so that the
adversarial term weighs), SRGAN and ESRGAN 16px -> 32px at narrow widths
with two D scales of two layers (adv_lambda 0.5), batch 4, f32. The VGG16
content loss runs on the same He-normal trunk on both sides (an .npz
both loaders read). Plain SGD on both sides; each keeps the raw gradients
(JAX in the optimizer state, the port in `.grad`). Losses agree at 1e-4
of their magnitude; the state after the step (parameters, every spectral
norm's u in the order JAX threads them, the running statistics) at 1e-4
of its scale. Gradients are held as in
`tests/test_torch_simple_gan_steps.py`: the port's step in float64 (every
compute dtype, parameter and the VGG trunk) agrees with JAX at 1e-4 of
each gradient's scale, floored at 1e-2 of its model's largest, and the
float32 step within that plus its own distance from the float64 step.
A conv bias that an instance norm or BatchNorm follows has a structurally
zero gradient: the float64 step gives it below 1e-9 of the model's
largest, and JAX's float32 rounding up to 1.7e-6 of it (a pix2pix Up
bias, an SRGAN D bias), past that floor's 1e-6. Such a gradient is held
to ZERO_GRAD of the model's largest on both sides, the bound the card's
step gate gives those (`chip_smoke.ZERO_GRAD`).
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.ESRGAN import model as je
from animeface_tpu.implementations.ESRGAN import utils as jeu
from animeface_tpu.implementations.SRGAN import model as js
from animeface_tpu.implementations.SRGAN import utils as jsu
from animeface_tpu.implementations.pix2pix import model as jp
from animeface_tpu.implementations.pix2pix import utils as jpu
from animeface_tpu.nnutils.loss import LSGANLoss as JLSGAN, NonSaturatingLoss as JNSLoss
from animeface_tpu.nnutils.loss import vgg as jvgg
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.ESRGAN import utils as teu
from animeface_tpu_torch.implementations.SRGAN import utils as tsu
from animeface_tpu_torch.implementations.pix2pix import utils as tpu
from animeface_tpu_torch.nnutils.loss import LSGANLoss, NonSaturatingLoss
from animeface_tpu_torch.nnutils.loss import vgg as tvgg
from test_torch_paired_models import paired_vars
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_simple_gan_models import nchw
from test_torch_simple_gan_steps import FAST_COMPILE, RTOL, _check_state, _f64
from test_torch_step import LR, _sgd_keeping_grads
from test_torch_vgg import _npz_of

B = 4
GAMMA, ADV, CONTENT = 1.0, 0.5, 1.0
SR = dict(channels=8, num_layers=2)


@pytest.fixture(scope='module')
def vgg_path(tmp_path_factory):
    '''VGG16 kernels He-normal (activations keep their scale through the
    relus), biases N(0, 0.01), as an .npz both packages load.'''
    rng = np.random.default_rng(7)
    params, c = {}, 3
    for block, (n, ch) in enumerate(zip((2, 2, 3, 3, 3), (64, 128, 256, 512, 512))):
        for i in range(n):
            params[f'conv{block}_{i}'] = {
                'kernel': (rng.standard_normal((3, 3, c, ch)) * np.sqrt(2 / (9 * c))
                           ).astype(np.float32),
                'bias': (rng.standard_normal(ch) * 0.01).astype(np.float32)}
            c = ch
    return _npz_of(params, tmp_path_factory.mktemp('vgg') / 'vgg16.npz')


def _vgg64(vgg):
    '''`vgg` with its trunk in float64 (the port's float64 step).'''
    v = copy.copy(vgg)
    v.model = copy.deepcopy(vgg.model).double()
    v._features = lambda x: v.model(tvgg.normalize_imagenet(x * 0.5 + 0.5, x.device))
    return v


def _jax_step(step, state, batch):
    args = (state, tuple(jnp.asarray(b) for b in batch))
    return jax.device_get(jax.jit(step).lower(*args).compile(FAST_COMPILE)(*args))


def _batch(shapes, seed):
    rng = np.random.default_rng(seed)
    return tuple(np.clip(rng.standard_normal(s), -1, 1).astype(np.float32) for s in shapes)


#: a gradient below this share of its model's largest in the float64 step
#: is structurally zero; JAX's and the float32 step's are held to ZERO_GRAD
STRUCTURAL = 1e-9
ZERO_GRAD = 1e-5


def check_grads(got, got64, want_grads, convert, what):
    '''The module docstring's rule; `want_grads` JAX's gradient tree.'''
    want_grad = convert(want_grads)
    top = max(float(v.abs().max()) for v in want_grad.values())
    grad64 = dict((n, p.grad) for n, p in got64.named_parameters())
    zero = []
    for name, p in got.named_parameters():
        assert p.grad is not None, f'{what}: no gradient for {name}'
        want = want_grad[name].double()
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


def _run_port(G, D, make_step, batch, dtype):
    '''The port's step on copies of G and D in `dtype`; returns the
    copies and the metrics.'''
    if dtype == torch.float64:
        G, D = _f64(G), _f64(D)
    else:
        G, D = copy.deepcopy(G), copy.deepcopy(D)
    step = make_step(G, D, torch.optim.SGD(G.parameters(), lr=LR),
                     torch.optim.SGD(D.parameters(), lr=LR), dtype)
    state = dict(step=0)
    metrics = step(state, tuple(nchw(b).to(dtype) for b in batch))
    assert state['step'] == 1
    return G, D, metrics


def _check(G, D, make_step, batch, jnew, jmetrics, convert_g, convert_d, grads_of):
    G32, D32, metrics = _run_port(G, D, make_step, batch, torch.float32)
    G64, D64, _ = _run_port(G, D, make_step, batch, torch.float64)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], rtol=RTOL, what=f'{k} loss')
    check_grads(G32, G64, grads_of(jnew, 'g_opt'), convert_g, 'G')
    check_grads(D32, D64, grads_of(jnew, 'd_opt'), convert_d, 'D')
    _check_state(G32, convert_g(jnew['G']), 'new G')
    _check_state(D32, convert_d(jnew['D']), 'new D')


def test_pix2pix_step_matches_jax():
    jG, jD = jp.Generator(image_size=32, image_channels=3), jp.Discriminator()
    gp = paired_vars(jG, jnp.zeros((1, 32, 32, 1)), train=False)['params']
    dp = paired_vars(jD, jnp.zeros((1, 32, 32, 4)), seed=1)['params']
    batch = _batch([(B, 32, 32, 3), (B, 32, 32, 1)], 2)
    sgd = _sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(1), G=gp, D=dp, g_opt=sgd.init(gp),
                 d_opt=sgd.init(dp), step=jnp.int32(0))
    jnew, jmetrics = _jax_step(jpu.build_train_step(jG, jD, sgd, sgd, JLSGAN(), GAMMA),
                               state, batch)
    G, D, _ = tpu.build_models(tpu.default_args(image_size=32, no_bf16=True), 'cpu')
    G.load_state_dict(convert.convert_pix2pix_generator(gp))
    D.load_state_dict(convert.convert_pix2pix_discriminator(dp))

    def make_step(G, D, g_opt, d_opt, dtype):
        return tpu.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), GAMMA)
    _check(G, D, make_step, batch, jnew, jmetrics, convert.convert_pix2pix_generator,
           convert.convert_pix2pix_discriminator, lambda new, k: new[k])


#: label -> (the JAX G, the JAX recipe module, the port's recipe module, its overrides)
SR_RECIPES = {
    'SRGAN-in': (lambda: js.Generator(channels=8, num_blocks=2), jsu, tsu,
                 dict(g_channels=8, num_blocks=2, d_channels=8, num_layers=2)),
    'SRGAN-bn': (lambda: js.Generator(channels=8, num_blocks=1, norm_name='bn'), jsu, tsu,
                 dict(g_channels=8, num_blocks=1, g_norm_name='bn', d_channels=8,
                      num_layers=2, d_norm_name='bn')),
    'ESRGAN': (lambda: je.Generator(channels=8, hid_channels=4, num_rrdb=2, num_rd=2,
                                    num_conv=3), jeu, teu,
               dict(g_channels=8, hidden_channels=4, num_blocks=2, num_rd=2, num_conv=3,
                    d_channels=8, num_layers=2, d_act_name='lrelu')),
}


@pytest.mark.parametrize('label', sorted(SR_RECIPES))
def test_sr_step_matches_jax(label, vgg_path):
    '''SRGAN's step (PReLU in G and D, instance norm; and BatchNorm in both,
    whose running statistics thread like u) and ESRGAN's relativistic one.'''
    make_jG, jmod, tmod, kw = SR_RECIPES[label]
    args = tmod.default_args(image_size=32, no_bf16=True, **kw)
    jG = make_jG()
    jD = js.Discriminator(channels=8, num_layers=2, act_name=args.d_act_name,
                          norm_name=args.d_norm_name)
    gv = paired_vars(jG, jnp.zeros((2, 16, 16, 3)), train=True)
    dv = paired_vars(jD, jnp.zeros((2, 32, 32, 3)), seed=1, train=True)
    batch = _batch([(B, 16, 16, 3), (B, 32, 32, 3)], 3)
    sgd = _sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(1), G=gv, D=dv, g_opt=sgd.init(gv['params']),
                 d_opt=sgd.init(dv['params']), step=jnp.int32(0))
    jstep = jmod.build_train_step(jG, jD, sgd, sgd, JNSLoss(),
                                  jvgg.VGGLoss(vgg=16, weights_path=vgg_path), ADV, CONTENT)
    jnew, jmetrics = _jax_step(jstep, state, batch)
    G, D, _ = tmod.build_models(args, 'cpu')
    G.load_state_dict(convert.convert_srgan_generator(gv))
    D.load_state_dict(convert.convert_srgan_discriminator(dv))
    vgg = tvgg.VGGLoss(device='cpu', vgg=16, weights_path=vgg_path)

    def make_step(G, D, g_opt, d_opt, dtype):
        return tsu.build_train_step(G, D, g_opt, d_opt, NonSaturatingLoss(),
                                    vgg if dtype == torch.float32 else _vgg64(vgg), ADV,
                                    CONTENT, relativistic=label == 'ESRGAN')
    _check(G, D, make_step, batch, jnew, jmetrics, convert.convert_srgan_generator,
           convert.convert_srgan_discriminator, lambda new, k: {'params': new[k]})


@pytest.mark.parametrize('name', ['pix2pix', 'SRGAN', 'ESRGAN'])
def test_recipe_training_and_sampler_on_cpu(name, vgg_path, monkeypatch):
    '''`build_training` on the CPU from the task's synthetic test batch:
    three steps give finite losses, the sampler's grid is (condition,
    target, G(condition)) for each test sample, in order.'''
    from animeface_tpu_torch.dataset import DataLoader, build_dataset

    monkeypatch.setenv('ANIMEFACE_VGG_WEIGHTS', vgg_path)
    module, task, kw = {
        'pix2pix': (tpu, 'xdog', dict(drop_out=0.5)),
        'SRGAN': (tsu, 'sr', dict(g_channels=8, num_blocks=1, d_channels=4, num_layers=2)),
        'ESRGAN': (teu, 'sr', dict(g_channels=8, hidden_channels=4, num_blocks=1, num_rd=1,
                                   num_conv=3, d_channels=4, num_layers=2)),
    }[name]
    args = module.default_args(image_size=32, batch_size=B, no_bf16=True, synthetic_data=True,
                               num_images=8, **kw)
    dataset = build_dataset(args, task)
    test = next(iter(DataLoader(dataset, args.num_test, shuffle=False, num_workers=1)))
    run = module.build_training(args, device='cpu', test_batch=test)
    batch = tuple(nchw(b) for b in next(iter(DataLoader(dataset, B, num_workers=1))))
    for _ in range(3):
        metrics = run.train_step(run.state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 3
    grid = run.sample_fn()
    n = args.num_test
    assert grid.shape == (3 * n, 3, 32, 32) and bool(torch.isfinite(grid).all())
    target = nchw(test[0] if name == 'pix2pix' else test[1])
    assert torch.equal(grid[1::3], target)
    assert torch.equal(grid, run.sample_fn())
