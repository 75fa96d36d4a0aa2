'''StyleGAN3's G at 256px, the BASELINE config's size, against the JAX
package: all 14 layers (15 StyleLayers) at narrow widths (channels 4, max
16, style 16), batch 1, f32 on the CPU, in each of the three
`flrelu_memory` modes.

The layer geometry (sizes, sampling rates, cutoffs, the 4x up layers, the
critically sampled last layers) comes from `image_size`, so 256px builds
other layers than the 128px the other tests hold. Each mode's image, the
updated moments (train=True) and the gradient of sum(G(z) * g) in z are
held against the JAX G with its default 'pack' at 1e-4 of their scale, the
tolerance of `tests/test_torch_stylegan3.py`; the three modes compute the
same function, so their images agree to 1e-6 of scale.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.StyleGAN3 import model as jm
from animeface_tpu_torch.convert import convert_stylegan3_generator
from animeface_tpu_torch.implementations.StyleGAN3 import model as tm
from test_torch_stylegan3 import _close, _nhwc, _randomize_biases

RTOL = 1e-4
CFG = dict(image_size=256, latent_dim=16, num_layers=14, channels=4, max_channels=16,
           style_dim=16)


@pytest.fixture(scope='module')
def jax_run():
    '''The JAX G's variables, z, the output cotangent g, and its image,
    moments and dz.'''
    jG = jm.Generator(**CFG)
    gv = jax.device_get(jax.jit(jG.init)({'params': jax.random.PRNGKey(0)},
                                         jnp.zeros((1, 16))))
    gp = _randomize_biases(gv['params'], np.random.default_rng(0))
    moments = jax.tree_util.tree_map(np.asarray, gv['moments'])
    moments['map']['w_avg'] = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    z = np.random.default_rng(2).standard_normal((1, 16)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal((1, 256, 256, 3)).astype(np.float32)

    def jfn(zz):
        out, mut = jG.apply({'params': gp, 'moments': moments}, zz, train=True,
                            mutable=['moments'])
        return jnp.sum(out * g), (out, mut['moments'])

    (_, (image, new_m)), dz = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(z))
    return gp, moments, z, g, np.asarray(image), jax.device_get(new_m), np.asarray(dz)


@pytest.fixture(scope='module')
def port_images():
    return {}


@pytest.mark.parametrize('memory', ['pack', 'store', 'remat'])
def test_generator_256_matches_jax(jax_run, port_images, memory):
    gp, moments, z, g, image, new_m, dz = jax_run
    G = tm.Generator(**CFG, flrelu_memory=memory)
    assert len(G.synthesis.net) == 15
    assert {layer.flrelu_memory for layer in G.synthesis.net} == {memory}
    G.load_state_dict(convert_stylegan3_generator(gp, moments))
    tz = torch.from_numpy(z).requires_grad_(True)
    out = G(tz, train=True)
    (out * torch.from_numpy(g.transpose(0, 3, 1, 2).copy())).sum().backward()
    assert out.shape == (1, 3, 256, 256)
    _close(_nhwc(out), image, rtol=RTOL, what=f'{memory} G(z)')
    _close(tz.grad.numpy(), dz, rtol=RTOL, what=f'{memory} dz')
    want_m = convert_stylegan3_generator(gp, new_m)
    for name, buf in G.state_dict().items():
        if 'magnitude_ema' in name or 'w_avg' in name:
            _close(buf.numpy(), want_m[name].numpy(), rtol=1e-5, what=f'{memory} {name}')
    port_images[memory] = _nhwc(out)
    for other, img in port_images.items():
        _close(_nhwc(out), img, rtol=1e-6, what=f'{memory} vs {other}')


def test_stylegan3_256_builds_and_steps():
    '''The StyleGAN3 recipe's `build_training` at `image_size` 256 (narrow,
    batch 4, f32 on the CPU): an additive-R1 step (step 0) and a plain one,
    finite losses, the moments moved, G_ema's images of the right shape.'''
    from animeface_tpu_torch.implementations.StyleGAN3 import utils as tu

    args = tu.default_args(image_size=256, batch_size=4, latent_dim=16, style_dim=16,
                           channels=4, max_channels=16, d_channels=4, d_max_channels=16,
                           no_bf16=True)
    run = tu.build_training(args, device='cpu')
    real = torch.rand((4, 3, 256, 256), generator=torch.Generator().manual_seed(1)) * 2 - 1
    assert [run.uses_r1(i) for i in (0, 1)] == [True, False]
    w_avg = run.G.map.w_avg.clone()
    for _ in range(2):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 2 and not torch.equal(run.G.map.w_avg, w_avg)
    with torch.no_grad():
        images = run.G_ema(torch.randn(2, 16))
    assert images.shape == (2, 3, 256, 256) and bool(torch.isfinite(images).all())
