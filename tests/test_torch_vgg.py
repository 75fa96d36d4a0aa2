'''The port's VGG perceptual losses (`animeface_tpu_torch/nnutils/loss/vgg.py`)
against the JAX package's, on the JAX fallback's variables bridged with
`convert_vgg`; the weight loaders and converters. The random-VGG trend
metric built on the same trunk: `tests/test_torch_trend.py`.'''

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animeface_tpu.nnutils.loss import vgg as jvgg
from animeface_tpu_torch.convert_weights import vgg_npz
from animeface_tpu_torch.nnutils.loss import vgg as tvgg
from tools.convert_vgg_weights import convert as tools_convert


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among
    which a full thread pool per process spins many times slower.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_fallback_variables():
    '''The JAX fallback's VGG16 variables (`VGGLoss`'s and the trend
    extractor's: seed 20260816, initialised on a 32x32 input).'''
    return jax.device_get(jvgg.VGGFeatures(16).init(jax.random.PRNGKey(20260816),
                                                     jnp.zeros((1, 32, 32, 3))))


@pytest.fixture(scope='module')
def jax_variables():
    return jax_fallback_variables()


def _npz_of(params, path, layers=16):
    flat = {'__layers__': np.int32(layers)}
    for name, p in params.items():
        flat[f'{name}/kernel'] = np.asarray(p['kernel'])
        flat[f'{name}/bias'] = np.asarray(p['bias'])
    np.savez(path, **flat)
    return str(path)


@pytest.mark.parametrize('p', [1, 2])
def test_losses_and_input_gradients_match_jax(p, jax_variables, tmp_path):
    '''The three losses and their gradients with respect to the fakes, at
    32x32, batch 2, f32: within 1e-4 of their scale.'''
    path = _npz_of(jax_variables['params'], tmp_path / 'vgg16.npz')
    jloss = jvgg.VGGLoss(vgg=16, p=p, weights_path=path)
    tloss = tvgg.VGGLoss(device='cpu', vgg=16, p=p, weights_path=path)
    rng = np.random.default_rng(p)
    real = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    t_real = torch.from_numpy(real.transpose(0, 3, 1, 2).copy())
    for name in ('style_loss', 'content_loss', 'vgg_loss'):
        want, want_grad = jax.value_and_grad(
            lambda f: getattr(jloss, name)(jnp.asarray(real), f))(jnp.asarray(fake))
        t_fake = torch.from_numpy(fake.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
        got = getattr(tloss, name)(t_real, t_fake)
        got.backward()
        want, want_grad = float(want), np.asarray(want_grad).transpose(0, 3, 1, 2)
        assert got.dtype == torch.float32 and want != 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-4, err_msg=name)
        scale = np.abs(want_grad).max()
        assert scale > 0
        np.testing.assert_allclose(t_fake.grad.numpy(), want_grad, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    assert not any(prm.requires_grad for prm in tloss.model.parameters())


def _synthetic_vgg_state_dict(layers, seed=0):
    '''A torchvision-layout VGG state dict (features.N, ReLUs and pools
    between the convs).'''
    g = torch.Generator().manual_seed(seed)
    sd, idx, in_ch = {}, 0, 3
    for n_convs, ch in zip(tvgg._CFG[layers], tvgg._CHANNELS):
        for _ in range(n_convs):
            sd[f'features.{idx}.weight'] = torch.randn((ch, in_ch, 3, 3), generator=g) * 0.05
            sd[f'features.{idx}.bias'] = torch.randn((ch,), generator=g) * 0.05
            idx, in_ch = idx + 2, ch
        idx += 1
    return sd


@pytest.mark.parametrize('layers', [16, 19])
def test_npz_and_pth_loaders(layers, tmp_path):
    '''The port's converter equals the tool's; the .npz and the raw .pth
    load the same state dict, which is the torchvision one renamed.'''
    sd = _synthetic_vgg_state_dict(layers)
    flat = vgg_npz(sd)
    want = tools_convert(sd)
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    np.savez(tmp_path / 'w.npz', **flat)
    torch.save(sd, tmp_path / 'w.pth')
    a = tvgg._load_npz_weights(str(tmp_path / 'w.npz'), layers)
    b = tvgg._load_torch_weights(str(tmp_path / 'w.pth'), layers)
    convs = sorted((k for k in sd if k.endswith('.weight')), key=lambda k: int(k.split('.')[1]))
    names = [n for block in tvgg.VGGFeatures(layers).blocks for n in block]
    assert sorted(a) == sorted(b) == sorted(f'{n}.{leaf}' for n in names
                                            for leaf in ('weight', 'bias'))
    for name, key in zip(names, convs):
        torch.testing.assert_close(a[f'{name}.weight'], sd[key], rtol=0, atol=0)
        torch.testing.assert_close(b[f'{name}.weight'], sd[key], rtol=0, atol=0)
        torch.testing.assert_close(a[f'{name}.bias'], b[f'{name}.bias'], rtol=0, atol=0)


def test_npz_wrong_depth_and_missing_key_raise(tmp_path):
    flat = vgg_npz(_synthetic_vgg_state_dict(16))
    np.savez(tmp_path / 'w.npz', **flat)
    with pytest.raises(ValueError, match='VGG16'):
        tvgg._load_npz_weights(str(tmp_path / 'w.npz'), 19)
    del flat['conv4_2/bias'], flat['__layers__']
    np.savez(tmp_path / 'cut.npz', **flat)
    with pytest.raises(ValueError, match='conv4_2/bias'):
        tvgg._load_npz_weights(str(tmp_path / 'cut.npz'), 16)
    with pytest.raises(ValueError, match='not a VGG16'):
        vgg_npz({'features.0.weight': torch.zeros(64, 3, 3, 3)})


def test_random_fallback_is_loud_once(capsys, monkeypatch):
    '''The provenance line prints once per provenance per process; the
    fallback is flax's default conv init (lecun_normal, zero bias).'''
    monkeypatch.delenv('ANIMEFACE_VGG_WEIGHTS', raising=False)
    tvgg._ANNOUNCED.clear()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        loss = tvgg.VGGLoss(device='cpu', vgg=16)
        tvgg.VGGLoss(device='cpu', vgg=16)
    assert 'RANDOM-INIT' in loss.provenance
    err = capsys.readouterr().err
    assert err.count('RANDOM-INIT') == 1 and 'convert_vgg_weights' in err
    w = loss.model.conv2_0.weight                   # fan_in 128 * 9
    bound = 2 * np.sqrt(1 / (128 * 9)) / tvgg._TRUNCATED_STD
    assert float(w.abs().max()) <= bound
    np.testing.assert_allclose(float(w.std()), np.sqrt(1 / (128 * 9)), rtol=0.02)
    assert float(loss.model.conv2_0.bias.abs().max()) == 0
    with pytest.raises(ValueError):
        tvgg.VGGLoss(device='cpu', p=3)
