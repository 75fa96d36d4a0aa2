'''One SEBigGAN ICR step of the port against JAX's
`SEBigGAN/utils.py:build_train_step`, at the recipe's defaults (policy
'color,translation', lambdas 10/10/5/0.5, noise_sigma 0.03) and with
`--policy ''` (no augmentation), and the assembled recipe (orthogonal
init, EMA over the buffers) on the CPU.

Both sides start from one bridged state ('se' attention, 32px, channels 4,
z 16, batch 4, f32 on the CPU, variables from `test_torch_biggan.init_vars`)
and get the same draws: z, n and DiffAugment's for a1 and a2
(`SEBigGAN/utils.py:83-86`). Plain SGD keeping the raw gradients on both
sides; the losses, gradients, parameters, every u, the running statistics
and G_ema (an average of G's parameters and buffers) are held at 1e-4 of
their scale (`test_torch_biggan_steps.compare_step`).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.SEBigGAN import model as jm
from animeface_tpu.implementations.SEBigGAN import utils as ju
from animeface_tpu.nnutils.loss import HingeLoss as JHinge
from animeface_tpu_torch.convert import convert_biggan_discriminator, convert_biggan_generator
from animeface_tpu_torch.implementations.SEBigGAN import utils as tu
from animeface_tpu_torch.nnutils.loss import HingeLoss
from test_torch_biggan import B, CH, S, Z, _nchw, init_vars
from test_torch_biggan_steps import compare_step, load
from test_torch_diffaugment import jax_draws
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_step import LR, _sgd_keeping_grads

ARGS = tu.default_args(image_size=S, batch_size=B, z_dim=Z, channels=CH, no_bf16=True)
LAMBDAS = (ARGS.real_lambda, ARGS.fake_lambda, ARGS.latent_d_lambda, ARGS.latent_g_lambda)


@pytest.fixture(scope='module')
def setup():
    jG = jm.Generator(image_size=S, z_dim=Z, channels=CH)
    jD = jm.Discriminator(image_size=S, channels=CH)
    gv, dv = init_vars(jG, jnp.zeros((2, Z)), seed=3), init_vars(jD, jnp.zeros((2, S, S, 3)),
                                                                  seed=4)
    return jG, jD, gv, dv


@pytest.mark.parametrize('policy', ['color,translation', ''], ids=['defaults', 'no-policy'])
def test_icr_step_matches_jax(setup, policy):
    jG, jD, gv, dv = setup
    sgd = _sgd_keeping_grads()
    real = np.clip(np.random.default_rng(7).standard_normal((B, S, S, 3)), -1,
                   1).astype(np.float32)
    ema0 = jax.tree_util.tree_map(lambda a: a * np.float32(0.9), gv)     # G_ema != G
    state = dict(rng=jax.random.PRNGKey(12), G=gv, D=dv, G_ema=ema0,
                 g_opt=sgd.init(gv['params']), d_opt=sgd.init(dv['params']),
                 step=jnp.int32(0))
    step = ju.build_train_step(jG, jD, sgd, sgd, JHinge(), policy, LAMBDAS, ARGS.noise_sigma, Z)
    jnew, jmetrics = jax.device_get(jax.jit(step)(state, jnp.asarray(real)))
    _, zkey, nkey, a1, a2 = jax.random.split(state['rng'], 5)
    draws = dict(z=torch.from_numpy(np.array(jax.random.normal(zkey, (B, Z)))),
                 n=torch.from_numpy(np.array(jax.random.normal(nkey, (B, Z)) * ARGS.noise_sigma)),
                 a1=jax_draws(a1, real.shape, policy), a2=jax_draws(a2, real.shape, policy))

    G, D, G_ema = tu.build_models(ARGS, device='cpu')
    load(G, D, G_ema, gv, dv)
    G_ema.load_state_dict(convert_biggan_generator(ema0))
    tstate = dict(step=0, generator=None)
    tstep = tu.build_train_step(G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
                                torch.optim.SGD(D.parameters(), lr=LR), HingeLoss(), policy,
                                LAMBDAS, ARGS.noise_sigma)
    metrics = tstep(tstate, _nchw(real), draws)
    compare_step((G, D), jnew, metrics, jmetrics, convert_biggan_generator,
                 convert_biggan_discriminator, G_ema)
    assert tstate['step'] == 1


def test_recipe_orthogonal_init_and_training_on_cpu():
    '''`build_training` on the CPU: every G and D kernel starts orthogonal in
    flax's [fan_in, out] reading, biases at 0, norm scales at 1; two steps
    with the default draws give finite losses and move G_ema's buffers
    towards G's; `sample_fn` runs G_ema in eval mode on 16 latents.'''
    run = tu.build_training(ARGS, device='cpu')
    for name, p in list(run.G.named_parameters()) + list(run.D.named_parameters()):
        if name.endswith('weight') and p.ndim >= 2:
            m = p.detach().double().reshape(p.shape[0], -1).T          # [fan_in, out]
            gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
            close(gram, np.eye(gram.shape[0]), rtol=1e-5, what=name)
        elif name.endswith('bias'):
            assert not p.any(), name
    assert float(run.G.bn.weight.min()) == float(run.G.bn.weight.max()) == 1
    real = torch.rand((B, 3, S, S), generator=torch.Generator().manual_seed(1)) * 2 - 1
    before = [b.clone() for b in run.G_ema.buffers()]
    for _ in range(2):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    moved = [not torch.equal(a, b) for a, b in zip(before, run.G_ema.buffers())]
    assert all(moved)
    images = run.sample_fn()
    assert images.shape == (16, 3, S, S) and bool(torch.isfinite(images).all())
