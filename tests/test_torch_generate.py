'''`python -m animeface_tpu_torch.generate` against `tools/generate.py`'s
arithmetic on the JAX StyleGAN2 G.

One G (16px, style 16, channels 8 to 16, 8 mapping layers as the tool
builds it) with its parameters drawn from a seeded numpy stream, bridged
with `convert.convert_generator` and saved as a `G_<step>.pt`. The draws
are injected on both sides: z, z2 and the 4096 latents of the mean style
made with numpy, the noise maps made with numpy and handed to JAX's
`InjectNoise` layers in order (`flax.linen.intercept_methods`). Each flow
of the port (`generate.sample`, f32 on the CPU) is held against the JAX
tool's calls: plain `Generator.apply(z)`; style mixing `apply((z, z2),
injection=mix_layer)`; truncation `map_w`, the mean of the mapped latents,
w_mean + t (w - w_mean), `synthesize_from_w`. The images agree at 1e-4 of
their scale (f32 through 8 dense and 7 modulated conv layers in two
frameworks, as `tests/test_torch_stylegan2.py`). Then `main` on the CPU
writes each flow's grid, and without a card or ANIMEFACE_PLATFORM=cpu it
exits 1.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from animeface_tpu.implementations.StyleGAN2 import model as jm
from animeface_tpu_torch import generate
from animeface_tpu_torch.checkpoint import save_model
from animeface_tpu_torch.convert import convert_generator
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_runtime_cli_dcgan import grid_size, png_size

RTOL = 1e-4
NUM, S, STYLE = 6, 16, 16
WIDTHS = ['--image-size', str(S), '--style-dim', str(STYLE), '--channels', '8',
          '--max-channels', '16']
FLOWS = {'plain': [], 'mix': ['--mix-seed', '3', '--mix-layer', '2'],
         'truncation': ['--truncation', '0.7']}


def _params(jG):
    '''Raw kernels N(0, 1) (the layers scale at run time), biases N(0, 0.1),
    const N(0, 1), from a seeded numpy stream.'''
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jG.init({'params': jax.random.PRNGKey(0)},
                                            jnp.zeros((1, STYLE))))['params']

    def draw(path, leaf):
        scale = 0.1 if str(path[-1].key) == 'bias' else 1.0
        return (rng.standard_normal(leaf.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope='module')
def bridged(tmp_path_factory):
    jG = jm.Generator(image_size=S, style_dim=STYLE, channels=8, max_channels=16)
    params = _params(jG)
    path = tmp_path_factory.mktemp('weights') / 'G_10.pt'
    save_model(str(path), convert_generator(params))
    return jG, params, path


def _args(path, flow, extra=()):
    return generate.parse_args(['--weights', str(path), '--num', str(NUM), *WIDTHS,
                                *FLOWS[flow], *extra])


def _draws(G, args):
    '''The flow's draws made with numpy, as `draw_inputs` lays them out.'''
    rng = np.random.default_rng(5)
    draws = dict(z=rng.standard_normal((NUM, STYLE)),
                 noise=[rng.standard_normal(s) for s in G.noise_shapes(NUM)])
    if generate.flow(args) == 'mix':
        draws['z2'] = rng.standard_normal((NUM, STYLE))
    if generate.flow(args) == 'truncation':
        draws['z_mean'] = rng.standard_normal((generate.MEAN_LATENTS, STYLE))
    return {k: [torch.tensor(m, dtype=torch.float32) for m in v] if k == 'noise'
            else torch.tensor(v, dtype=torch.float32) for k, v in draws.items()}


def _jax_images(jG, params, args, draws):
    '''`tools/generate.py`'s calls for the flow, with the draws injected.'''
    maps = iter([jnp.asarray(m.numpy().transpose(0, 2, 3, 1)) for m in draws['noise']])

    def inject(next_fun, a, kw, context):
        if isinstance(context.module, jm.InjectNoise) and context.method_name == '__call__':
            return a[0] + next(maps).astype(a[0].dtype)
        return next_fun(*a, **kw)

    v = {'params': params}
    z = jnp.asarray(draws['z'].numpy())
    with fnn.intercept_methods(inject):
        kind = generate.flow(args)
        if kind == 'mix':
            images, _ = jG.apply(v, (z, jnp.asarray(draws['z2'].numpy())),
                                 injection=args.mix_layer)
        elif kind == 'truncation':
            w = jG.apply(v, z, method=jm.Generator.map_w)
            w_mean = jnp.mean(jG.apply(v, jnp.asarray(draws['z_mean'].numpy()),
                                       method=jm.Generator.map_w), axis=0, keepdims=True)
            w = w_mean + args.truncation * (w - w_mean)
            images = jG.apply(v, w, method=jm.Generator.synthesize_from_w)
        else:
            images, _ = jG.apply(v, z)
    assert next(maps, None) is None, 'a noise map was not used'
    return np.asarray(images)


@pytest.mark.parametrize('flow', sorted(FLOWS))
def test_flow_matches_jax_tool(bridged, flow):
    jG, params, path = bridged
    args = _args(path, flow)
    assert generate.flow(args) == flow
    G = generate.build_generator(args, 'cpu', torch.float32)
    draws = _draws(G, args)
    got = generate.sample(G, args, draws)
    assert got.shape == (NUM, 3, S, S) and got.dtype == torch.float32
    close(got.numpy().transpose(0, 2, 3, 1), _jax_images(jG, params, args, draws), RTOL,
          what=flow)


def test_draws_follow_their_seeds(bridged):
    '''z and the noise from --seed, z2 from --mix-seed, the mean's latents
    from --seed + 99; the mixing flow wins over truncation, as in the tool.'''
    _, _, path = bridged
    args = _args(path, 'mix', ('--truncation', '0.5'))
    assert generate.flow(args) == 'mix'
    G = generate.build_generator(args, 'cpu', torch.float32)
    a, b = generate.draw_inputs(G, args, 'cpu'), generate.draw_inputs(G, args, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in ('z', 'z2'))
    assert torch.equal(a['z'], torch.randn((NUM, STYLE),
                                           generator=torch.Generator().manual_seed(0)))
    assert torch.equal(a['z2'], torch.randn((NUM, STYLE),
                                            generator=torch.Generator().manual_seed(3)))
    t = generate.draw_inputs(G, _args(path, 'truncation'), 'cpu')
    assert t['z_mean'].shape == (generate.MEAN_LATENTS, STYLE) and 'z2' not in t
    assert torch.equal(t['z_mean'], torch.randn((generate.MEAN_LATENTS, STYLE),
                                                generator=torch.Generator().manual_seed(99)))
    assert [tuple(m.shape) for m in a['noise']] == G.noise_shapes(NUM)


@pytest.mark.parametrize('flow', sorted(FLOWS))
def test_main_writes_the_grid(bridged, tmp_path, monkeypatch, flow):
    _, _, path = bridged
    monkeypatch.setenv('ANIMEFACE_PLATFORM', 'cpu')
    out = tmp_path / f'{flow}.png'
    images = generate.main(['--weights', str(path), '--num', str(NUM), *WIDTHS, *FLOWS[flow],
                            '--out', str(out), '--nrow', '3'])
    assert png_size(out) == grid_size(NUM, 3, S)
    assert bool(torch.isfinite(images).all()) and float(images.abs().max()) <= 1


def test_main_refuses_a_missing_card(bridged, monkeypatch, capsys):
    _, _, path = bridged
    monkeypatch.delenv('ANIMEFACE_PLATFORM', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        generate.main(['--weights', str(path), *WIDTHS])
    assert e.value.code == 1 and 'CUDA' in capsys.readouterr().err
