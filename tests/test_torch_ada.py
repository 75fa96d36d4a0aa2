'''ADA in the port against the JAX package: the derived kernel, the plain
two-pass warp against the Pallas kernel in interpret mode, the dense warp,
the exact geometry, the color stage, the whole pipe in debug_percentile
mode, and the adaptive-p controller.

Same seeded numpy inputs on both sides, f32 on the CPU. Tolerances: 2e-5
for the two-pass forward and 2e-4 for its gradient (the JAX package's own
fused-vs-dense tolerances, tests/test_ada_twopass.py); 1e-4 for whole
warps and pipes, whose f32 homography and filter chains sum in another
order.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.nnutils import ada as jada
from animeface_tpu.nnutils import ada_geometry as jgeo
from animeface_tpu.nnutils.ada_geometry_tpu import twopass_fused as j_twopass_fused
from animeface_tpu_torch.nnutils import ada as tada
from animeface_tpu_torch.nnutils import ada_geometry as tgeo
from animeface_tpu_torch.nnutils.ada_geometry_cuda import twopass_fused

TOL = 1e-4


def _images(B=2, N=32, C=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 8, 8, C)).astype(np.float32)
    x = np.clip(np.asarray(jax.image.resize(x, (B, N, N, C), 'bilinear')), -1, 1)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _maps(B):
    '''A rotation, a fractional translation, and aniso scaling after a
    rotation past 90 degrees (exercises the dihedral fold).'''
    return [
        jada.rotate2d_inv(jnp.full((B,), 0.35)),
        jada.translate2d_inv(jnp.asarray([5.25, -1.5][:B]), jnp.asarray([-2.5, 0.75][:B])),
        jada.scale2d_inv(jnp.asarray([1.4, 0.8][:B]), jnp.asarray([0.8, 1.2][:B]))
        @ jada.rotate2d_inv(jnp.full((B,), -1.9)),
    ]


def test_derive_axis_kernel_matches_jax():
    jh, js = jgeo.derive_axis_kernel()
    th, ts = tgeo.derive_axis_kernel()
    assert (ts, len(th)) == (js, len(jh)) == (6, 6)
    np.testing.assert_allclose(th, jh, atol=1e-6)
    t = np.linspace(-7, 7, 57).astype(np.float32)
    np.testing.assert_allclose(tgeo.eval_kernel(torch.from_numpy(t), th, ts).numpy(),
                               np.asarray(jgeo.eval_kernel(jnp.asarray(t), jh, js)),
                               atol=1e-7)


def _fused_inputs(N=16, B=2, seed=1):
    '''The two-pass kernel's inputs exactly as twopass_warp builds them.'''
    half, support = jgeo.derive_axis_kernel()
    rng = np.random.default_rng(seed)
    E = max(N // 4, support + 2)
    We = N + 2 * E
    ctr = (N - 1) / 2
    P1, P2 = 2 * N - 2, 2 * We - 2
    a = jnp.asarray(rng.uniform(0.8, 1.2, B), jnp.float32)
    shear1 = jnp.asarray(rng.uniform(-0.6, 0.6, B), jnp.float32)
    shear2 = jnp.asarray(rng.uniform(-0.6, 0.6, B), jnp.float32)
    base1 = jnp.asarray(rng.uniform(-3, 3, B), jnp.float32)
    base2 = jnp.asarray(rng.uniform(-3, 3, B) + E, jnp.float32)
    cols = np.arange(We, dtype=np.float32) - E - ctr
    rows = np.arange(N, dtype=np.float32) - ctr
    t1, f1, M1 = jgeo._pass_params(a, shear1, base1, cols, N, P1, half, support)
    t2, f2, M2 = jgeo._pass_params(1 / a, shear2, base2, rows, N, P2, half, support)
    M1 = jnp.pad(M1, ((0, 0), (0, 0), (0, -(-P1 // 8) * 8 - P1)))
    M2 = jnp.pad(M2, ((0, 0), (0, 0), (0, -(-P2 // 8) * 8 - P2)))
    x = jnp.asarray(rng.standard_normal((B, 3, N, We)), jnp.float32)
    return [x, t1, f1, M1, t2, f2, M2], (P1, P2, We, N)


def test_plain_twopass_fused_matches_pallas_interpret():
    arrays, static = _fused_inputs()
    tarrs = [torch.from_numpy(np.array(a)) for a in arrays]
    g = np.random.default_rng(2).standard_normal((2, 3, 16, 16)).astype(np.float32)

    want = jax.jit(lambda *a: j_twopass_fused(*a, *static, True))(*arrays)
    wgrad = jax.jit(jax.grad(
        lambda x: jnp.sum(j_twopass_fused(x, *arrays[1:], *static, True) * g)))(arrays[0])

    x = tarrs[0].requires_grad_(True)
    got = twopass_fused(x, *tarrs[1:], *static)
    (ggrad,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(ggrad.numpy(), np.asarray(wgrad), atol=2e-4)


@pytest.mark.parametrize('fused', [False, True])
def test_twopass_warp_matches_jax_dense(monkeypatch, fused):
    '''Dense and kernel-pair branches (the latter through the wrapper's
    plain version on the CPU) against JAX's dense path.'''
    monkeypatch.setenv('ANIMEFACE_ADA_FUSED', '0')
    jx, tx = _images()
    jgeo.derive_axis_kernel()
    warp = jax.jit(jgeo.twopass_warp)
    for G in _maps(2):
        want = warp(jnp.asarray(jx), G)
        got = tgeo.twopass_warp(tx, torch.from_numpy(np.array(G)), fused=fused)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL)


def test_twopass_warp_gradient_matches_jax(monkeypatch):
    monkeypatch.setenv('ANIMEFACE_ADA_FUSED', '0')
    jx, tx = _images(seed=3)
    G = _maps(2)[0]
    jgeo.derive_axis_kernel()
    want = jax.jit(jax.grad(lambda v: jnp.sum(jnp.square(jgeo.twopass_warp(v, G)))))(
        jnp.asarray(jx))
    x = tx.clone().requires_grad_(True)
    tgeo.twopass_warp(x, torch.from_numpy(np.array(G)), fused=True).square().sum().backward()
    np.testing.assert_allclose(_nhwc(x.grad), np.asarray(want), atol=2e-4)


def test_exact_geometry_and_color_match_jax():
    jx, tx = _images(seed=4)
    jpipe = jada.AugmentPipe(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                             xfrac=1, geom_impl='exact')
    tpipe = tada.AugmentPipe(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                             xfrac=1, geom_impl='exact')
    exact = jax.jit(jpipe._execute_geometry_exact)
    for G in _maps(2):
        want = exact(jnp.asarray(jx), G)
        got = tpipe._execute_geometry_exact(tx, torch.from_numpy(np.array(G)))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL)

    Cm = np.random.default_rng(5).standard_normal((2, 4, 4)).astype(np.float32)
    want = jpipe._execute_color(jnp.asarray(jx), jnp.asarray(Cm))
    got = tpipe._execute_color(tx, torch.from_numpy(Cm))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('dbg', [0.0, 0.3, 0.85])
def test_pipe_debug_percentile_matches_jax(dbg):
    '''All deterministic knobs (every knob but the additive noise, whose
    pixels are random even in debug mode) at p = 1.'''
    knobs = dict(jada.DEFAULT_ADA_KNOBS, imgfilter=1, cutout=1, geom_impl='exact')
    jx, tx = _images(seed=6)
    want = jada.AugmentPipe(**knobs)(jax.random.PRNGKey(0), jnp.asarray(jx), 1.0,
                                     debug_percentile=dbg)
    got = tada.AugmentPipe(**knobs)(tx, 1.0, debug_percentile=dbg)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL)


def test_pipe_noise_and_generator_draws():
    '''The noise knob in debug mode adds sigma = erfinv(dbg) * std noise;
    default draws come from the caller's generator (same seed, same output;
    p = 0 leaves images unchanged up to the geometry's resampling).'''
    _, tx = _images(seed=7)
    pipe = tada.AugmentPipe(noise=1)
    y = pipe(tx, 1.0, generator=torch.Generator().manual_seed(0), debug_percentile=0.5)
    sigma = float(torch.erfinv(torch.tensor(0.5))) * 0.1
    assert abs(float((y - tx).std()) - sigma) < 0.1 * sigma

    pipe = tada.make_ada_pipe()
    runs = [pipe(tx, 0.8, generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], tx, atol=1e-2)
    y0 = pipe(tx, 0.0, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(y0, tx, atol=2e-4, rtol=0)


def test_controller_matches_jax():
    rng = np.random.default_rng(8)
    jstate = jada.ada_init_state(8, interval=3, target_kimg=1)
    tstate = tada.ada_init_state(8, interval=3, target_kimg=1, device='cpu')
    ps = []
    for i in range(11):
        if i % 4 == 3:
            jstate = jada.ada_tick(jstate)
            tstate = tada.ada_tick(tstate)
        else:
            logits = rng.standard_normal((8, 1)).astype(np.float32) + (2.0 if i < 6 else -1.0)
            jstate = jada.ada_update_p(jstate, jnp.asarray(logits))
            tstate = tada.ada_update_p(tstate, torch.from_numpy(logits))
        for k in ('p', 'signsum', 'count', 'num_iter'):
            assert float(tstate[k]) == pytest.approx(float(jstate[k]), abs=1e-7), (i, k)
        ps.append(float(tstate['p']))
    assert max(ps) > 0 and ps[-1] < max(ps)      # p rose, then fell
