'''The port's weight-init registry against `animeface_tpu/nnutils/initialize.py`.

`apply_init`'s leaf rules: a BigGAN G ('sa' attention) and a lambda layer
(norms with scale and bias, `pos_emb`), their flax variables drawn by
`test_torch_biggan.init_vars` (every scale, bias, gamma and statistic off
its init value) and bridged to the port; JAX's `apply_init` and the
port's each sort every entry into redrawn, zeroed, set to one or left
alone, and the two sortings must be equal, buffers (u, running
statistics) untouched. The draws differ (threefry against a torch
generator), so each scheme is held on its statistics in flax's
orientation, beside the JAX initializer's on the same shape: `xavier` and
`kaiming` truncated at 2 sigma' (sigma' = sigma / 0.8796), std within 5% of
sigma; `ortho` orthonormal to 1e-5 in the [fan_in, out] reading (columns
of a conv kernel, rows of a wide dense one); `N002`'s std.
'''

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.BigGAN import model as jm
from animeface_tpu.nnutils import initialize as ji
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.BigGAN import model as tm
from animeface_tpu_torch.nnutils import initialize as ti
from test_torch_biggan import _convert_module, init_vars
from test_torch_pggan import one_thread  # noqa: F401  (autouse fixture)

SCHEMES = ['N01', 'N002', 'ortho', 'xavier', 'kaiming']


def _sort(before, after):
    '''{entry: 'redrawn' | 'zeros' | 'ones' | 'kept'}.'''
    out = {}
    for k, a in after.items():
        a, b = np.asarray(a, np.float64), np.asarray(before[k], np.float64)
        if np.array_equal(a, b):
            out[k] = 'kept'
        elif not a.any():
            out[k] = 'zeros'
        elif (a == 1).all():
            out[k] = 'ones'
        else:
            out[k] = 'redrawn'
    return out


@pytest.fixture(scope='module')
def cases():
    '''{what: (flax variables, port module factory, converter)}.'''
    gv = init_vars(jm.Generator(image_size=16, z_dim=8, channels=4), jnp.zeros((2, 8)))
    lv = init_vars(jm.LambdaLayer(), jnp.zeros((2, 4, 4, 16)), seed=1)
    return {'G': (gv, lambda: tm.Generator(image_size=16, z_dim=8, channels=4),
                  convert.convert_biggan_generator),
            'lambda': (lv, lambda: tm.LambdaLayer(16, 4),
                       lambda v: _convert_module('LambdaLayer', v))}


@pytest.mark.parametrize('name', SCHEMES)
def test_leaf_rules_match_jax(cases, name):
    for what, (v, make_port, conv) in cases.items():
        port = make_port()
        before = conv(v)
        want_params = jax.jit(lambda k, p: ji.apply_init(k, p, name))(jax.random.PRNGKey(3),
                                                                    v['params'])
        want = _sort(before, conv(dict(v, params=jax.device_get(want_params))))
        port.load_state_dict(before)
        ti.apply_init(port, name, torch.Generator().manual_seed(3))
        got = _sort(before, port.state_dict())
        assert got == want, (what, {k: (got[k], want[k]) for k in got if got[k] != want[k]})
        kinds = set(want.values())
        assert kinds == {'redrawn', 'zeros', 'ones', 'kept'}, (what, kinds)
        for k in dict(port.named_buffers()):
            assert got[k] == 'kept', k


def test_extra_names_get_the_scheme():
    '''`names` (the reference's `init(my_classes, names)`) adds leaf names:
    LambdaLayer's `pos_emb` is redrawn from N(0, 0.02) with it, kept
    without it.'''
    layer = tm.LambdaLayer(16, 4, generator=torch.Generator().manual_seed(0))
    before = layer.pos_emb.detach().clone()
    ti.init(names=['pos_emb']).N002(layer, torch.Generator().manual_seed(1))
    assert not torch.equal(before, layer.pos_emb) and float(layer.pos_emb.std()) == \
        pytest.approx(0.02, rel=0.05)
    before = layer.pos_emb.detach().clone()
    ti.init().N002(layer, torch.Generator().manual_seed(2))
    assert torch.equal(before, layer.pos_emb)


@pytest.mark.parametrize('name,scale,mode', [('xavier', 1.0, 'fan_avg'),
                                             ('kaiming', 2.0, 'fan_in')])
def test_truncated_schemes_match_flax(name, scale, mode):
    flax_shape = (3, 3, 256, 256)                          # [kh, kw, in, out]
    fan_in = fan_out = 9 * 256
    sigma = math.sqrt(scale / (fan_in if mode == 'fan_in' else (fan_in + fan_out) / 2))
    cut = 2 * sigma / 0.87962566103423978
    w = ti.get_initializer(name)((256, 256, 3, 3), torch.Generator().manual_seed(0)).numpy()
    j = np.asarray(ji.get_initializer(name)(jax.random.PRNGKey(0), flax_shape))
    for what, a in (('port', w), ('jax', j)):
        assert abs(a.std() / sigma - 1) < 0.05, (what, a.std(), sigma)
        assert cut * 0.97 < np.abs(a).max() <= cut * (1 + 1e-6), (what, np.abs(a).max(), cut)
    assert abs(w.std() / j.std() - 1) < 0.02


@pytest.mark.parametrize('flax_shape', [(3, 3, 64, 128), (120, 4096)], ids=['conv', 'dense'])
def test_ortho_is_flax_orientation(flax_shape):
    torch_shape = (flax_shape[-1],) + ((flax_shape[2], *flax_shape[:2]) if len(flax_shape) == 4
                                       else flax_shape[:1])
    w = ti.get_initializer('ortho')(torch_shape, torch.Generator().manual_seed(0))
    assert tuple(w.shape) == torch_shape
    m = w.double().reshape(torch_shape[0], -1).T                        # [fan_in, out]
    j = np.asarray(ji.get_initializer('ortho')(jax.random.PRNGKey(0), flax_shape),
                   np.float64).reshape(-1, flax_shape[-1])
    for what, a in (('port', m.numpy()), ('jax', j)):
        gram = a.T @ a if a.shape[0] >= a.shape[1] else a @ a.T
        assert np.abs(gram - np.eye(len(gram))).max() < 1e-5, what


@pytest.mark.parametrize('name,std', [('N002', 0.02), ('N01', 1.0)])
def test_normal_schemes(name, std):
    w = ti.get_initializer(name)((128, 64, 3, 3), torch.Generator().manual_seed(0))
    assert abs(float(w.std()) / std - 1) < 0.02 and abs(float(w.mean())) < 0.01 * std
    j = np.asarray(ji.get_initializer(name)(jax.random.PRNGKey(0), (3, 3, 64, 128)))
    assert abs(float(w.std()) / j.std() - 1) < 0.03


def test_unknown_scheme_raises():
    with pytest.raises(KeyError, match='unknown initializer'):
        ti.get_initializer('uniform')
