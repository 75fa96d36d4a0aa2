'''BigGAN's G and D in the port against `animeface_tpu/implementations/
BigGAN/model.py`: the converters, and forwards in train and eval mode of
the normal ladder with attention 'sa', 'se' and 'll', conditional norm
'bn' and 'in', spectral norm on and off, relu and lrelu, with every u and
running statistic they leave; a bf16 forward. The deep ladder (and
prelu) is in `tests/test_torch_biggan_deep.py`, on these helpers. At
32px, channels 4, z 16, batch 4, f32 on the CPU, one intra-op thread,
variables from
`test_torch_biggan.init_vars` (every statistic, scale, gamma and slope off
its init value); tolerance 1e-4 of the output's scale.
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from animeface_tpu.implementations.BigGAN import model as jm
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.BigGAN import model as tm
from test_torch_biggan import B, CH, NET_RTOL, S, Z, _nchw, _nhwc, check_state, init_vars, run_jax
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)

#: G and D variants: (deep, use_sn, att_name, norm_name, act_name); the deep
#: ones run in tests/test_torch_biggan_deep.py
NETS = {
    'normal-sa': (False, True, 'sa', 'bn', 'relu'),
    'normal-se-in-nosn': (False, False, 'se', 'in', 'relu'),
    'normal-ll-lrelu': (False, True, 'll', 'bn', 'lrelu'),
    'deep-sa': (True, True, 'sa', 'bn', 'relu'),
    'deep-se-prelu': (True, True, 'se', 'bn', 'prelu'),
}
NORMAL = [n for n in NETS if not NETS[n][0]]
_VARS = {}


def nets(name):
    '''(JAX G, its variables, JAX D, its variables) of variant `name`,
    drawn once a process.'''
    if name not in _VARS:
        deep, use_sn, att, norm, act = NETS[name]
        jG = jm.Generator(image_size=S, z_dim=Z, channels=CH, deep=deep, use_sn=use_sn,
                          att_name=att, norm_name=norm, act_name=act)
        jD = jm.Discriminator(image_size=S, channels=CH, deep=deep, use_sn=use_sn,
                              att_name=att, act_name=act)
        _VARS[name] = (jG, init_vars(jG, jnp.zeros((2, Z))),
                       jD, init_vars(jD, jnp.zeros((2, S, S, 3)), seed=1))
    return _VARS[name]


def port_models(name, gv=None, dv=None):
    deep, use_sn, att, norm, act = NETS[name]
    G = tm.Generator(image_size=S, z_dim=Z, channels=CH, deep=deep, use_sn=use_sn,
                     att_name=att, norm_name=norm, act_name=act)
    D = tm.Discriminator(image_size=S, channels=CH, deep=deep, use_sn=use_sn, att_name=att,
                         act_name=act)
    if gv is not None:
        G.load_state_dict(convert.convert_biggan_generator(gv))
        D.load_state_dict(convert.convert_biggan_discriminator(dv))
    return G, D


def check_converters(name, g_att, d_att, d_blocks):
    '''The converters cover every state entry of variant `name`; where the
    attention sits and how many entries D's `blocks` has.'''
    _, gv, _, dv = nets(name)
    G, D = port_models(name)
    assert set(convert.convert_biggan_generator(gv)) == set(G.state_dict()), name
    assert set(convert.convert_biggan_discriminator(dv)) == set(D.state_dict()), name
    assert (G.att_index, D.att_index, len(D.blocks)) == (g_att, d_att, d_blocks)


def check_forward(name, train):
    '''G's images and D's logits against JAX, and every state entry
    (parameters, u, running statistics) the forward leaves.'''
    jG, gv, jD, dv = nets(name)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    x = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    G, D = port_models(name, gv, dv)
    want_img, new_gv = run_jax(jG, gv, jnp.asarray(z), train=train)
    want_logit, new_dv = run_jax(jD, dv, jnp.asarray(x), train=train)
    with torch.no_grad():
        img = G(torch.from_numpy(z), train)
        logit = D(_nchw(x), train)
    assert img.shape == (B, 3, S, S) and img.dtype == torch.float32
    assert logit.shape == (B, 1) and logit.dtype == torch.float32
    close(_nhwc(img), want_img, rtol=NET_RTOL, what=f'{name} G')
    close(logit.numpy(), want_logit, rtol=NET_RTOL, what=f'{name} D')
    check_state(G, convert.convert_biggan_generator(new_gv), NET_RTOL, what=f'{name} G state')
    check_state(D, convert.convert_biggan_discriminator(new_dv), NET_RTOL,
                what=f'{name} D state')


@pytest.mark.parametrize('name', NORMAL)
def test_converters_cover_every_entry(name):
    check_converters(name, 1, 0, 4)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('name', NORMAL)
def test_generator_and_discriminator_match_jax(name, train):
    check_forward(name, train)


def test_bf16_forward_is_finite():
    '''The compute dtype reaches every layer: bf16 activations, float32
    images and logits.'''
    _, gv, _, dv = nets('normal-sa')
    G = tm.Generator(image_size=S, z_dim=Z, channels=CH, dtype=torch.bfloat16)
    D = tm.Discriminator(image_size=S, channels=CH, dtype=torch.bfloat16)
    G.load_state_dict(convert.convert_biggan_generator(gv))
    D.load_state_dict(convert.convert_biggan_discriminator(dv))
    seen = []
    for m in (G.blocks[0], G.attention, D.blocks[0], D.attention):
        m.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
    with torch.no_grad():
        img = G(torch.randn(B, Z, generator=torch.Generator().manual_seed(0)))
        logit = D(img)
    assert seen == [torch.bfloat16] * 4
    assert img.dtype == logit.dtype == torch.float32
    assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(logit).all())
