'''The bias_act kernel's host side on the CPU: the layout the wrapper picks
(`bias_act_layout`), its scope (`bias_act_in_scope`), the parameter block
shared with `csrc/bias_act.cu`, and an f32 bias with a bf16 x.

* The layout is held against a brute-force statement of its rules: which
  mode each shape, dim, dtype and alignment takes, the limits of the block
  and grid, and a walk of every thread of the launch through the kernel's
  loops (as `csrc/bias_act.cu` writes them), which must reach every element
  of x exactly once with the bias entry of its channel.
* The scope is held against `bias_act_pallas`'s (traced abstractly: None
  out of scope) on the shapes of `test_bias_act_scope_matches_pallas` and
  on shapes whose rows are not a multiple of 8 or whose C is not one of
  128.
* A bf16 x with an f32 bias through the kernel's plain version and through
  `ops.bias_act(impl='cuda')` on the CPU equals `bias_act_pallas` in
  interpret mode given the bias cast to bf16: exactly for the piecewise
  linear activations, within one bf16 step of the output (2^-7 of it) for
  the transcendental ones (XLA's and PyTorch's f32 functions may differ in
  the last bit before the rounding). CIPS's `StyleLayer`, which now passes
  its f32 bias uncast, gives the same bits as with the cast.
'''

import ctypes
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.ops import pallas_kernels as jpk
from animeface_tpu_torch import ops as tops
from animeface_tpu_torch.implementations.CIPS.model import StyleLayer
from animeface_tpu_torch.ops import cuda_kernels as ck

SOURCE = Path(ck.__file__).resolve().parents[1] / 'csrc' / 'bias_act.cu'
SQRT2 = float(np.sqrt(2))


# ---------------------------------------------------------------- layout

def _walk(lay, V):
    '''For each element of x, how many threads of the launch reach it, and
    the channel whose bias they add: the kernel's loops over its grid and
    block, in Python.'''
    count = np.zeros(lay.n, np.int64)
    chan = np.full(lay.n, -1, np.int64)
    (gx, gy), (bx, by) = lay.grid, lay.block
    for bix, biy, ty, tx in itertools.product(range(gx), range(gy), range(by), range(bx)):
        if lay.mode == 'rows':
            cv = lay.C // V
            col = biy * bx + tx
            if col >= cv:
                continue
            r = bix * by + ty
            while r < lay.rows:
                e = (r * cv + col) * V + np.arange(V)
                count[e] += 1
                chan[e] = col * V + np.arange(V)
                r += gx * by
        elif lay.mode == 'planes':
            iv = lay.inner // V
            plane = bix * by + ty
            while plane < lay.rows:
                v = biy * bx + tx
                while v < iv:
                    e = plane * lay.inner + v * V + np.arange(V)
                    count[e] += 1
                    chan[e] = plane % lay.C
                    v += gy * bx
                plane += gx * by
        else:
            i = bix * bx + tx
            while i < lay.n:
                count[i] += 1
                chan[i] = (i // lay.inner) % lay.C
                i += gx * bx
    return count, chan


LAYOUT_SHAPES = [
    ((16, 512), -1), ((16, 1024), -1),            # CIPS's mapping and affines
    ((2, 64, 512), -1),                           # CIPS's StyleLayer layout, cut
    ((3, 2400), -1),                              # a row wider than 256 vectors
    ((5, 24), -1), ((7, 40), 1),                  # rows of 3-10 vectors: warps span rows
    ((3, 6), -1),                                 # C not a multiple of V: scalar
    ((2, 128, 4, 4), 1), ((2, 16, 8, 8), 1),      # NCHW, inner a multiple of 8
    ((2, 24, 2, 6), 1),                           # inner 12: planes in f32, scalar in bf16
    ((2, 128, 5, 5), 1), ((3, 8, 3), 1),          # inner 25 and 3: scalar
    ((4, 3, 8, 2), 0), ((1, 9, 64, 16), 2),       # the bias on another axis
]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape,dim', LAYOUT_SHAPES,
                         ids=['x'.join(map(str, s)) + f'_d{d}' for s, d in LAYOUT_SHAPES])
def test_bias_act_layout_rules(shape, dim, dtype, monkeypatch):
    '''The mode, the limits of block and grid, and a walk of the launch,
    with x aligned and not, and with grid_x as large as it may be and cut
    to 3 (blocks then loop).'''
    itemsize = dtype.itemsize
    V = 16 // itemsize
    d = dim % len(shape)
    C, inner, n = shape[d], int(np.prod(shape[d + 1:])), int(np.prod(shape))
    for aligned, max_grid in itertools.product((True, False), (ck.BIAS_ACT_MAX_GRID_X, 3)):
        monkeypatch.setattr(ck, 'BIAS_ACT_MAX_GRID_X', max_grid)
        lay = ck.bias_act_layout(shape, dim, itemsize, aligned)
        if aligned and inner == 1 and C % V == 0:
            want = 'rows'
        elif aligned and inner % V == 0:
            want = 'planes'
        else:
            want = 'scalar'
        assert lay.mode == want and lay.mode in ck.BIAS_ACT_MODES
        assert (lay.n, lay.C, lay.inner) == (n, C, inner)
        (gx, gy), (bx, by) = lay.grid, lay.block
        assert 1 <= bx * by <= ck.BIAS_ACT_THREADS and 1 <= gy <= 65535
        assert 1 <= gx <= max_grid
        if lay.mode == 'rows':
            cv = C // V
            assert lay.rows == n // C and bx * gy >= cv and bx * (gy - 1) < cv
            assert gy == 1 or bx % 32 == 0
            assert gx == min(-(-lay.rows // by), max_grid)          # a block a step
        elif lay.mode == 'planes':
            assert lay.rows == n // inner and 32 <= bx <= ck.BIAS_ACT_THREADS and bx % 32 == 0
        else:
            assert lay.rows == n and (bx, by) == (ck.BIAS_ACT_THREADS, 1)
        count, chan = _walk(lay, 1 if lay.mode == 'scalar' else V)
        assert (count == 1).all(), (aligned, max_grid, lay)
        np.testing.assert_array_equal(chan, (np.arange(n) // inner) % C)


def test_bias_act_layout_cips_shapes():
    '''The CIPS forward's shapes: the rows mode, a block for every 4 rows
    of the big call, a handful of blocks for the small ones.'''
    big = ck.bias_act_layout((16, 16384, 512), -1, 2, True)
    assert big == ck.BiasActLayout('rows', 16 * 16384 * 512, 512, 1, 16 * 16384,
                                   (16 * 16384 // 4, 1), (64, 4))
    assert ck.bias_act_layout((16, 512), -1, 4, True).grid == (8, 1)
    assert ck.bias_act_layout((16, 1024), -1, 4, True).block == (256, 1)
    with pytest.raises(ValueError):
        ck.bias_act_layout((0, 512), -1, 4, True)


# ------------------------------------------------------- parameter block

_C_TYPES = {'long long': ctypes.c_longlong, 'int': ctypes.c_int, 'float': ctypes.c_float}


def test_bias_act_params_match_the_source():
    '''`_BiasActParams` lays out `struct BiasActParams` field for field, and the
    Python constants and enums equal the source's.'''
    src = SOURCE.read_text()
    body = re.search(r'struct BiasActParams \{(.*?)\};', src, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r'^\s*(long long|int|float) ([\w, ]+);', body, re.M):
        fields += [(name.strip(), _C_TYPES[ctype]) for name in names.split(',')]
    assert fields == list(ck._BiasActParams._fields_)
    assert ctypes.sizeof(ck._BiasActParams) == 80
    consts = dict(re.findall(r'constexpr int (k\w+) = (\d+);', src))
    assert int(consts['kThreads']) == ck.BIAS_ACT_THREADS
    modes = re.search(r'enum Mode \{(.*?)\}', src).group(1)
    assert [m.split('=')[0].strip() for m in modes.split(',')] == [
        f'k{m.capitalize()}Mode' for m in ck.BIAS_ACT_MODES]
    acts = re.search(r'enum Act \{(.*?)\}', src).group(1)
    assert [a.split('=')[0].strip() for a in acts.split(',')] == [
        'k' + name.capitalize() for name in ck.ACT_INDEX]


# ---------------------------------------------------------------- scope

SCOPE_SHAPES = [
    # test_torch_kernels_ops.py's BIAS_ACT_TABLE
    ((16, 16384, 512), 512), ((16, 512), 512), ((16, 1024), 1024), ((1, 16384, 512), None),
    ((32, 512), 512), ((32, 1), 1), ((32, 8192), 8192), ((2, 4, 4, 64), 64),
    ((2, 4, 4, 128), None), ((3, 5, 128), 128), ((4, 2, 256), 128), ((4, 8, 8, 128), 128),
    # rows not a multiple of 8, C not a multiple of 128
    ((7, 128), 128), ((9, 3, 256), 256), ((2, 3, 384), 384), ((12, 128), 128),
    ((8, 200), 200), ((8, 640), 640), ((1, 1, 8, 128), 128), ((3, 8, 3, 128), 128),
]


@pytest.mark.parametrize('shape,blen', SCOPE_SHAPES,
                         ids=['x'.join(map(str, s)) + f'_b{b}' for s, b in SCOPE_SHAPES])
def test_bias_act_scope_matches_pallas(shape, blen):
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    b = None if blen is None else jax.ShapeDtypeStruct((blen,), jnp.float32)
    out = jax.eval_shape(lambda xx, bb: jpk.bias_act_pallas(xx, bb, -1, 'lrelu', 0.2, SQRT2,
                                                            -1.0), x, b)
    tb = None if blen is None else torch.zeros(blen)
    assert ck.bias_act_in_scope(shape, tb, -1) == (out is not None)
    if len(shape) == 4:                      # the same call in the port's NCHW layout
        nchw = (shape[0], shape[3], shape[1], shape[2])
        assert ck.bias_act_in_scope(nchw, tb, 1) == (out is not None)


# ------------------------------------------------- an f32 bias, a bf16 x

TRANSCENDENTAL = ('tanh', 'sigmoid', 'elu', 'selu', 'softplus', 'swish')


@pytest.mark.parametrize('act', sorted(ck.ACT_INDEX))
def test_f32_bias_with_bf16_x_matches_pallas(act):
    rng = np.random.default_rng(ck.ACT_INDEX[act])
    x32 = rng.standard_normal((2, 8, 256)).astype(np.float32) * 2
    b32 = (rng.standard_normal(256) * 0.7).astype(np.float32)   # not bf16 values
    clamp = 1.5 if act in ('linear', 'lrelu') else -1.0
    xj = jnp.asarray(x32, jnp.bfloat16)
    want = np.asarray(jpk.bias_act_pallas(xj, jnp.asarray(b32).astype(jnp.bfloat16), -1, act,
                                          0.2, 1.3, clamp).astype(jnp.float32))
    x = torch.from_numpy(x32).to(torch.bfloat16)
    assert torch.equal(x.float(), torch.from_numpy(np.array(xj.astype(jnp.float32))))
    b = torch.from_numpy(b32)
    plain = ck.bias_act_plain(x, b, -1, act, 0.2, 1.3, clamp)
    reg = tops.bias_act(x, b, dim=-1, act=act, alpha=0.2, gain=1.3,
                        clamp=None if clamp < 0 else clamp, impl='cuda')
    assert plain.dtype == reg.dtype == torch.bfloat16
    assert torch.equal(plain, reg)
    rtol = 2.0 ** -7 if act in TRANSCENDENTAL else 0
    np.testing.assert_allclose(plain.float().numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize('impl', ['torch', 'cuda'])
def test_style_layer_f32_bias_same_bits(impl):
    '''`StyleLayer` in bf16 passes its f32 bias uncast: the output equals,
    bit for bit, bias_act with the bias cast to bf16 first (the old call).'''
    g = torch.Generator().manual_seed(3)
    layer = StyleLayer(128, 64, 128, dtype=torch.bfloat16, generator=g)
    with torch.no_grad():
        layer.bias.copy_(torch.randn(128, generator=g) * 0.5)
    x = torch.randn((2, 16, 128), generator=g)
    style = torch.randn((2, 64), generator=g)
    before = tops.get_default_impl()
    tops.set_default_impl(impl)
    try:
        with torch.no_grad():
            got = layer(x, style)
            want = tops.bias_act(layer.fc(x, style), layer.bias.to(torch.bfloat16), dim=-1,
                                 act='lrelu')
    finally:
        tops.set_default_impl(before)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
