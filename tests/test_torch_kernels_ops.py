'''The ops registry's kernel path: the plain versions of the port's two CUDA
kernels (`ops/cuda_kernels.py`) against the JAX package's Pallas kernels,
and the kernels' scopes against the Pallas scopes.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them (`tests/test_ops.py`). Same seeded numpy inputs on both
sides, NHWC in JAX and NCHW (or the same [.., C] layout) in the port, f32.
Tolerances: 1e-6 abs for bias_act and 2e-6 abs for filtered_lrelu on
unit-scale inputs, those of the JAX package's Pallas-vs-XLA tests (the same
f32 arithmetic, the FIR taps summed in another order).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.ops import activation_funcs as jactivation_funcs
from animeface_tpu.ops import pallas_kernels as jpk
from animeface_tpu.ops.upfirdn2d import setup_filter as jsetup_filter
from animeface_tpu_torch import ops as tops
from animeface_tpu_torch.ops import cuda_kernels as ck
from animeface_tpu_torch.ops import registry

ACTS = sorted(jactivation_funcs)
SQRT2 = float(np.sqrt(2))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------- bias_act

@pytest.mark.parametrize('clamp', [-1.0, 0.7])
@pytest.mark.parametrize('act', ACTS)
def test_bias_act_plain_matches_pallas(act, clamp):
    '''Both of the port's layouts: the bias on the last axis ([.., C], as
    CIPS runs it) and on axis 1 (NCHW), against `bias_act_pallas` on NHWC.'''
    rng = np.random.default_rng(ACTS.index(act))
    x = rng.standard_normal((2, 16, 16, 128)).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32) * 0.5
    spec = jactivation_funcs[act]
    alpha, gain = 0.3 if act == 'lrelu' else spec.def_alpha, spec.def_gain
    want = np.asarray(jpk.bias_act_pallas(jnp.asarray(x), jnp.asarray(b), -1, act, alpha,
                                          gain, clamp))
    tb = torch.from_numpy(b)
    got = ck.bias_act_plain(torch.from_numpy(x), tb, -1, act, alpha, gain, clamp)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    got = ck.bias_act_plain(_nchw(x), tb, 1, act, alpha, gain, clamp)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-6, rtol=0)


def test_bias_act_cuda_impl_on_cpu_is_the_plain_version():
    '''impl='cuda' on a CPU tensor takes the plain version (in scope) or
    the composition (out of scope), and stays differentiable.'''
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 6, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).requires_grad_(True)
    got = tops.bias_act(x, b, dim=-1, act='swish', clamp=0.5, impl='cuda')
    want = ck.bias_act_plain(x, b, -1, 'swish', 0.0, SQRT2, 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (g,) = torch.autograd.grad(got.sum(), b)
    assert torch.isfinite(g).all()
    before = ck.bias_act_launches
    out_of_scope = tops.bias_act(x[:, :, :64], b[:64], dim=-1, act='lrelu', impl='cuda')
    torch.testing.assert_close(out_of_scope, tops.bias_act(x[:, :, :64], b[:64], dim=-1,
                                                           act='lrelu', impl='torch'))
    assert ck.bias_act_launches == before


# ---------------------------------------------------------- filtered_lrelu

def _flrelu_pair(C=128, pad=11, clamp=None, bias=True, H=16, W=None, fu=None, fd=None, seed=0):
    '''filtered_lrelu_plain against `filtered_lrelu_pallas` (default variant).'''
    rng = np.random.default_rng(seed)
    W = W or H
    hann = np.array(jsetup_filter(np.hanning(12), normalize=True))
    fu = hann if fu is None else fu
    fd = hann if fd is None else fd
    padding = (pad,) * 4 if isinstance(pad, int) else tuple(pad)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    b = (rng.standard_normal(C) * 0.3).astype(np.float32) if bias else None
    want = jpk.filtered_lrelu_pallas(jnp.asarray(x), fu, fd, None if b is None else jnp.asarray(b),
                                     2, 2, padding, SQRT2, 0.2, clamp, False)
    assert want is not None
    got = ck.filtered_lrelu_plain(_nchw(x), torch.from_numpy(fu), torch.from_numpy(fd),
                                  None if b is None else torch.from_numpy(b), padding, SQRT2,
                                  0.2, clamp)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize('kw', [
    dict(),                                     # tests/test_ops.py test_basic
    dict(C=256, clamp=0.5),                     # test_bias_and_clamp / the shift cases
    dict(bias=False),                           # test_no_bias
    dict(H=40, bias=False),                     # several row bands
    dict(H=80, C=256),                          # several W chunks, two channel blocks
    dict(H=80, clamp=0.5, bias=False),
], ids=['basic', 'bias_clamp', 'no_bias', 'h40', 'h80_c256', 'h80_clamp'])
def test_filtered_lrelu_plain_matches_pallas(kw):
    _flrelu_pair(**kw)


def test_filtered_lrelu_plain_matches_pallas_asymmetric():
    '''Asymmetric filters of different lengths, asymmetric padding of
    both parities and a non-square map: a flipped filter or a swapped axis
    would show here (the Hann filter is symmetric).'''
    rng = np.random.default_rng(5)
    fu = rng.uniform(0.1, 1.0, 12).astype(np.float32)
    fd = rng.uniform(0.1, 1.0, 8).astype(np.float32)
    _flrelu_pair(fu=fu / fu.sum(), fd=fd / fd.sum(), pad=(9, 8, 10, 8), H=16, W=24, clamp=0.8,
                 seed=6)


def test_filtered_lrelu_cuda_impl_on_cpu():
    '''The op under impl='cuda' on a CPU tensor: 'store' in scope takes the
    plain version (for f32 the 'store' composition), 'pack' ignores impl,
    and nothing is launched.'''
    rng = np.random.default_rng(7)
    f = tops.setup_filter(np.hanning(12))
    x = torch.from_numpy(rng.standard_normal((2, 128, 16, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    before = ck.filtered_lrelu_launches
    kw = dict(up=2, down=2, padding=11, clamp=256.0)
    want = tops.filtered_lrelu(x, f, f, b, impl='torch', **kw)
    torch.testing.assert_close(tops.filtered_lrelu(x, f, f, b, impl='cuda', **kw), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(tops.filtered_lrelu(x, f, f, b, memory='pack', impl='cuda', **kw),
                               want, rtol=0, atol=1e-6)
    assert ck.filtered_lrelu_launches == before


# ---------------------------------------------------------------- scopes

def _stylegan3_flrelu_calls(image_size=128):
    '''(NCHW x shape, fu, fd, up, down, padding) of each StyleGAN3 layer's
    filtered_lrelu at `image_size`, the recipe's widths, batch 32.'''
    from animeface_tpu_torch.implementations.StyleGAN3.model import Synthesis, get_layer_params
    syn = Synthesis(image_size, 14, 32, 512)
    sizes = get_layer_params(image_size, 14, 32)[1]
    calls = []
    for i, layer in enumerate(syn.net):
        out_ch, _, k, _ = layer.conv.weight.shape
        s = int(sizes[max(i - 1, 0)]) + k - 1           # the conv grows the map by k - 1
        calls.append(((32, out_ch, s, s), layer.up_filter, layer.down_filter, layer.up_factor,
                      layer.down_factor, tuple(layer.padding)))
    return calls


HANN = np.array(jsetup_filter(np.hanning(12), normalize=True))

FLRELU_TABLE = [
    # the StyleGAN3-256 same-resolution layer shapes the kernel phase runs
    ((16, 128, 272, 272), HANN, HANN, 2, 2, (11, 11, 11, 11)),
    ((16, 128, 144, 144), HANN, HANN, 2, 2, (11, 11, 11, 11)),
    ((16, 256, 88, 88), HANN, HANN, 2, 2, (11, 11, 11, 11)),
    ((16, 512, 64, 64), HANN, HANN, 2, 2, (11, 11, 11, 11)),
    # tests/test_ops.py fallback cases: C % 128, up != 2
    ((1, 64, 16, 16), HANN, HANN, 2, 2, (11, 11, 11, 11)),
    ((1, 128, 16, 16), HANN, HANN, 1, 2, (11, 11, 11, 11)),
    # out_h != H, out_h % 8, negative padding, a 2-D filter, no filter
    ((2, 128, 16, 16), HANN, HANN, 2, 2, (10, 10, 10, 10)),
    ((2, 128, 12, 12), HANN, HANN, 2, 2, (11, 11, 11, 11)),
    ((2, 128, 16, 16), HANN, HANN, 2, 2, (-1, 23, 11, 11)),
    ((2, 128, 16, 16), np.outer(HANN, HANN), HANN, 2, 2, (11, 11, 11, 11)),
    ((2, 128, 16, 16), None, HANN, 2, 2, (11, 11, 11, 11)),
    ((2, 128, 16, 24), HANN[:8], HANN, 2, 2, (9, 8, 10, 8)),
]


def test_filtered_lrelu_scope_matches_pallas():
    '''`filtered_lrelu_in_scope` against `_flrelu_config` over the table
    and every StyleGAN3 128px layer (none in scope).'''
    calls = FLRELU_TABLE + [(s, None if fu is None else fu.numpy(),
                             None if fd is None else fd.numpy(), up, down, pad)
                            for s, fu, fd, up, down, pad in _stylegan3_flrelu_calls(128)]
    got, want = [], []
    for shape, fu, fd, up, down, pad in calls:
        N, C, H, W = shape
        x = jax.ShapeDtypeStruct((N, H, W, C), jnp.float32)
        want.append(jpk._flrelu_config(x, fu, fd, up, down, pad) is not None)
        tf = [None if f is None else torch.from_numpy(np.array(f, np.float32))
              for f in (fu, fd)]
        got.append(ck.filtered_lrelu_in_scope(shape, *tf, up, down, pad))
    assert got == want
    assert want[:4] == [True] * 4 and not any(want[len(FLRELU_TABLE):])


BIAS_ACT_TABLE = [
    # CIPS at the recipe's defaults: StyleLayer maps, affines, mapping
    ((16, 16384, 512), 512), ((16, 512), 512), ((16, 1024), 1024),
    # CIPS's bias-free Fourier projection
    ((1, 16384, 512), None),
    # StyleGAN3 128px: mapping and affines, D's dense layers
    ((32, 512), 512), ((32, 1), 1), ((32, 8192), 8192),
    # tests/test_ops.py: C % 128, no bias
    ((2, 4, 4, 64), 64), ((2, 4, 4, 128), None),
    # rows not a multiple of 8; a bias of the wrong length
    ((3, 5, 128), 128), ((4, 2, 256), 128), ((4, 8, 8, 128), 128),
]


def test_bias_act_scope_matches_pallas():
    '''`bias_act_in_scope` against `bias_act_pallas`'s scope (traced
    abstractly: None out of scope) over the table, on the channel axis.'''
    got, want = [], []
    for shape, blen in BIAS_ACT_TABLE:
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        b = None if blen is None else jax.ShapeDtypeStruct((blen,), jnp.float32)
        out = jax.eval_shape(lambda xx, bb: jpk.bias_act_pallas(xx, bb, -1, 'lrelu', 0.2, SQRT2,
                                                                -1.0), x, b)
        want.append(out is not None)
        tb = None if blen is None else torch.zeros(blen)
        got.append(ck.bias_act_in_scope(shape, tb, -1))
        if len(shape) == 4:                  # the same call in the port's NCHW layout
            nchw = (shape[0], shape[3], shape[1], shape[2])
            assert ck.bias_act_in_scope(nchw, tb, 1) == got[-1]
    assert got == want
    assert want[:3] == [True] * 3


# ---------------------------------------------------------------- registry

def test_registry_names_and_default(monkeypatch):
    assert registry.get_default_impl() == 'torch'
    assert registry.resolve_impl(None) == registry.resolve_impl('auto') == 'torch'
    assert registry.resolve_impl('pallas') == 'cuda'       # the JAX package's names
    assert registry.resolve_impl('xla') == 'torch'
    monkeypatch.setattr(registry, '_default_impl', 'torch')
    registry.set_default_impl('cuda')
    assert registry.resolve_impl(None) == 'cuda' and registry.resolve_impl('torch') == 'torch'
    with pytest.raises(AssertionError):
        registry.set_default_impl('triton')


def test_registry_reads_the_jax_variable():
    import subprocess
    import sys
    code = ('import importlib, os\n'
            'from animeface_tpu_torch.ops import registry\n'
            'for value in ("pallas", "cuda", "xla", "torch"):\n'
            '    os.environ["ANIMEFACE_OPS_IMPL"] = value\n'
            '    print(importlib.reload(registry).get_default_impl())\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=300, cwd=str(__import__('pathlib').Path(__file__).parents[1]))
    assert out.stdout.split() == ['cuda', 'cuda', 'torch', 'torch'], out.stderr
