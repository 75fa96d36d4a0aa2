'''Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
     set TF32 off for matmuls and convolutions (f32 comparisons stay f32)
     and let cuDNN autotune its convolution algorithms;
  2. build the hand-written kernels from `animeface_tpu_torch/csrc/`;
  3. hold each kernel against its plain PyTorch version at its main path's
     shapes (f32, batch 32): the two-pass warp pair at 256px, the line-pass
     pair at 128px (pass 1 and pass 2); time kernel, plain version and the
     byte/operation bound; check the kernel-path warp against the dense
     warp at both sizes; hold the two-pass forward's row lists against
     `twopass_row_lists_plain` exactly, check that two forward calls give
     bitwise-equal outputs, and print the forward's own time and its parts
     (list build, fused kernel) in ms from torch.profiler; the same for the
     backward:
     its tap lists against `twopass_tap_lists_plain`, dx bitwise
     repeatable, the chain's own time and its parts (list build, stage A,
     stage B); likewise the line pair at both 128px passes: the forward's
     row lists and the backward's tap lists held exactly, both bitwise
     repeatable, each kernel's device time alone with its parts (list
     build, fused or gather) and whether back-to-back calls are host-bound;
  4. drive the StyleGAN2-ADA 256px training step at full width (bench.py's
     settings, bf16 compute, p starting at 0.2, the default ADA knobs), one
     whole 16-step lazy-regularization cycle, with the two-pass kernels'
     launch counts set to 0 just before and read just after; check finite
     losses and the launch counts the cadence implies; profile one step of
     each variant, with the two-pass kernels' rows;
  5. drive the ADA recipe (StyleGAN3 + AugmentPipe) at its 128px CLI
     defaults at full width (batch 32, bf16 compute, p starting at 0.2),
     one 16-step cycle of 15 plain steps and 1 additive-R1 step, with the
     line kernels' launch counts set to 0 just before and read just after;
     check finite losses, 96 forward and 32 backward launches, a finite
     G_ema sample; profile one step of each variant;
     both paths run the ops registry's default 'torch' and must launch
     neither of the registry's kernels;
  6. hold the ops registry's kernels against their plain versions (f32
     within TOL, bf16 within BF16_RTOL of the output's scale): bias_act at
     CIPS's shapes ([16, 16384, 512] bf16, [16, 512] and [16, 1024] f32) and
     all nine activations with and without the clamp; filtered_lrelu at the
     StyleGAN3-256 same-resolution layer shapes (B = 16, bf16, 12-tap Hann
     filters, padding 11, clamp 256) and one f32 shape; time each against
     its plain version and bound; at each bias_act shape the kernel's
     device time alone, ms a call of the wrapper and of the registry's
     entry back to back, torch.add on the linear gain-1 calls and the copy
     ceiling (y.copy_(x)) on the big one, where two calls are bitwise
     equal and an f32 bias gives the same bits as the bias rounded to
     bf16; at the four filtered_lrelu shapes, two calls bitwise equal and
     the kernel's device time alone; check that both refuse a tensor that
     requires grad;
  7. drive the op-level filtered_lrelu (impl='cuda', memory='store') once at
     each of the four shapes: 4 kernel launches;
  8. drive CIPS sampling at the recipe's 128px defaults, nothing cut
     (G_ema forward on 16 fixed latents, bf16, impl='cuda'): 41 bias_act
     launches a forward, finite images, ms a forward, images/s, peak
     memory, one profiled forward; G_ema in f32 on the card against the
     CPU on 2 latents within 1e-3 of the output's scale;
  9. drive CIPS training at the recipe's 128px defaults (batch 32, bf16,
     DiffAugment 'color,translation', the registry's 'torch'): a warm-up
     step of each variant, one 16-step cycle with one additive-R1 step,
     every hand-written kernel's launch count 0 over it, finite losses,
     images/s, peak memory, one profiled step; then one `sample_fn`
     forward with 41 bias_act launches; then one step in f32 on the card
     against the CPU at batch 2 (`check_step_against_cpu`: losses and
     buffers within 1e-3 of their scale, gradients within 1e-3 of their
     norm plus twice the largest relative change of any gradient when the
     CPU's z and reals move by 1e-6);
 10. drive FastGAN at 256px with the recipe's defaults (batch 32, bf16,
     ema off): 2 warm-up steps, 16 timed steps with finite G, D and
     reconstruction losses and no hand-written kernel launched, a finite
     sample, one profiled step, the f32 step against the CPU;
 11. drive StyleGAN2 with its default DiffAugment at 256px (the recipe's
     defaults, batch 32, bf16, pl_lambda 0): 1 warm-up step, 4 timed
     adversarial steps, finite losses, no hand-written kernel launched,
     one profiled step;
 12. print one JSON line of the kernels, the card line, and last
     {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
'''

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

BATCH = 32
IMAGE = 256                    # StyleGAN2-ADA (two-pass warp kernels)
ADA_IMAGE = 128                # the ADA recipe's default (line-pass kernels)
ADA_STEPS = 16                 # one R1 cycle: gp_every = 16
TOL = 1e-4                     # kernel vs plain, abs, f32 unit-scale images
BF16_RTOL = 1.6e-2             # kernel vs plain in bf16, of the output's scale
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
D_K, G_K = 16, 8
#: StyleGAN3-256 same-resolution layer shapes, (size, channels), batch 16
#: (the JAX package's kernel bench, scripts/flrelu_shift_bench.py)
FLRELU_LAYERS = ((272, 128), (144, 128), (88, 256), (64, 512))
FLRELU_BATCH, FLRELU_PAD, FLRELU_CLAMP = 16, 11, 256.0
CIPS_FORWARDS = 8              # timed sampling forwards
SG2_DA_STEPS = 4               # timed adversarial StyleGAN2 + DiffAugment steps
#: bias_act's calls in one CIPS sampling forward at the recipe's defaults:
#: (shape, dtype, activation, gain, calls) for the 15 StyleLayers, the 4
#: mapping layers, the first StyleLayer's affine, and the other 14 + 7 affines
CIPS_BIAS_ACT_CALLS = (((16, 16384, 512), torch.bfloat16, 'lrelu', float(np.sqrt(2)), 15),
                       ((16, 512), torch.float32, 'lrelu', float(np.sqrt(2)), 4),
                       ((16, 1024), torch.float32, 'linear', 1.0, 1),
                       ((16, 512), torch.float32, 'linear', 1.0, 21))
CIPS_BIAS_ACT_PER_FORWARD = sum(c[-1] for c in CIPS_BIAS_ACT_CALLS)      # 41


def _card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters=20):
    '''Mean device time of fn() over `iters` launches, after a warm-up.'''
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _warp_draws(dev, size, seed=0):
    '''A batch of images and the default pipe's geometry draws at p = 1
    for them: the inputs of one augment call's warp on a main path.'''
    from animeface_tpu_torch.nnutils.ada import make_ada_pipe

    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand((BATCH, 3, size, size), generator=g, device=dev) * 2 - 1
    captured = {}

    def capture(x, G_inv):
        captured['G_inv'] = G_inv
        return x

    pipe = make_ada_pipe()
    pipe._execute_geometry = capture          # keep the draws, skip the warp
    pipe(images, 1.0, generator=g)
    return images, captured['G_inv']


def _main_path_warp_inputs(dev, seed=0):
    '''The two-pass kernels' inputs for one augment call at 256px.'''
    from animeface_tpu_torch.nnutils.ada_geometry import fused_inputs, derive_axis_kernel

    images, G_inv = _warp_draws(dev, IMAGE, seed)
    half, support = derive_axis_kernel()
    return images, G_inv, fused_inputs(images, G_inv, half, support)


def _bound(moved, ops):
    '''Least time for a call: `moved` bytes once over the HBM rate against
    `ops` f32 operations over the f32 peak; and which of the two binds.'''
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def _twopass_work(x, t1, f1, M1, t2, f2, M2, P1, P2, We, N):
    '''Bytes and f32 operations of one two-pass call (forward; the backward
    moves and computes as much): inputs and output once, the nonzero taps
    of M1 and M2 and the blends.'''
    B, C = x.shape[:2]
    moved = sum(a.numel() * a.element_size() for a in (x, t1, f1, M1, t2, f2, M2))
    moved += B * C * N * N * 4                         # fwd: out; bwd: g in, dx out
    nnz1 = int((M1[:, :, :P1] != 0).sum())            # taps per image, summed
    nnz2 = int((M2[:, :, :P2] != 0).sum())
    macs = C * (nnz1 * We + nnz2 * N)
    blends = B * C * (P1 * We + P2 * N)
    return moved, 2 * macs + 3 * blends


def _line_work(z, t, f, M):
    '''Bytes and f32 operations of one line pass (forward; the backward
    moves and computes as much): inputs and output once, the nonzero taps
    of M and the blend.'''
    B, C, N, W = z.shape
    P = 2 * N - 2
    moved = sum(a.numel() * a.element_size() for a in (z, t, f, M))
    moved += B * C * M.shape[1] * W * 4
    nnz = int((M[:, :, :P] != 0).sum())               # taps, summed over images
    return moved, 2 * C * W * nnz + 3 * B * C * P * W


def _hold(label, kernel, plain, x, rest, seed):
    '''A kernel pair against its plain version on the same inputs: the
    forward, and the backward into x through autograd. Raises past TOL;
    returns both errors and the mean device times of kernel and plain.'''
    ref = plain(x, *rest)
    got = kernel(x, *rest)
    torch.cuda.synchronize()
    fwd_err = float((got - ref).abs().max())
    g = torch.randn(ref.shape, generator=torch.Generator(device=x.device).manual_seed(seed),
                    device=x.device)
    xr = x.clone().requires_grad_(True)
    ref_out = plain(xr, *rest)
    (dref,) = torch.autograd.grad(ref_out, xr, g, retain_graph=True)
    xk = x.clone().requires_grad_(True)
    got_out = kernel(xk, *rest)
    (dgot,) = torch.autograd.grad(got_out, xk, g, retain_graph=True)
    torch.cuda.synchronize()
    bwd_err = float((dgot - dref).abs().max())
    print(f'{label} {tuple(x.shape)} -> {tuple(got.shape)}  max_abs_err fwd {fwd_err:.3e} '
          f'bwd {bwd_err:.3e} (tol {TOL})')
    if not (fwd_err <= TOL and bwd_err <= TOL):
        raise AssertionError(f'{label}: the kernels disagree with the plain version: '
                             f'fwd {fwd_err}, bwd {bwd_err}')
    ms = dict(
        fwd=_time_ms(lambda: kernel(x, *rest)),
        fwd_plain=_time_ms(lambda: plain(x, *rest)),
        bwd=_time_ms(lambda: torch.autograd.grad(got_out, xk, g, retain_graph=True)),
        bwd_plain=_time_ms(lambda: torch.autograd.grad(ref_out, xr, g, retain_graph=True)))
    print(f'{label}  kernel fwd {ms["fwd"]:.4f} ms  plain {ms["fwd_plain"]:.4f} ms  '
          f'kernel bwd {ms["bwd"]:.4f} ms  plain {ms["bwd_plain"]:.4f} ms')
    return dict(fwd_err=fwd_err, bwd_err=bwd_err, **ms)


def _pair_entries(source, lines, held, bound):
    '''The {"kernels": ...} entries of a forward/backward pair; `lines` are
    the TPU kernels' lines in ada_geometry_tpu.py. One bound serves both.'''
    print(f'{source} bound {bound[0]:.4f} ms ({bound[1]})')
    return [dict(name=f'{source}_{d}', route='cuda',
                 source=f'animeface_tpu_torch/csrc/{source}.cu',
                 replaces=f'animeface_tpu/nnutils/ada_geometry_tpu.py:{line}',
                 launches=None, max_abs_err=held[f'{d}_err'], ms=held[d],
                 plain_ms=held[f'{d}_plain'], bound_ms=bound[0], bound_by=bound[1],
                 library_ms=None)
            for d, line in zip(('fwd', 'bwd'), lines)]


def check_kernels(dev):
    '''The two-pass kernels at the 256px main path's shapes.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    images, G_inv, args = _main_path_warp_inputs(dev)
    held = _hold('twopass', agc.twopass_fused, agc.twopass_fused_plain, args[0], args[1:],
                 seed=1)
    check_twopass_fwd(args)
    check_twopass_bwd_chain(args)
    return images, G_inv, _pair_entries('ada_twopass', (186, 216), held,
                                        _bound(*_twopass_work(*args)))


#: the forward's kernels, by the name the profiler shows, in order
TWOPASS_FWD_PARTS = (('list build', 'twopass_row_lists_kernel'),
                     ('fused', 'twopass_fwd_kernel'))


def _print_parts(what, parts, rows, calls):
    '''The device time a call of each part, from the profiler's rows;
    returns their sum (None if the profiler recorded no device time).'''
    total = None
    for label, kernel in parts:
        ms = sum(r[0] for r in rows if kernel in r[2]) / calls if rows else None
        print(f'{what} part {label} ({kernel}): '
              + (f'{ms:.4f} ms a call' if ms is not None else 'not measured'))
        if ms is not None:
            total = (total or 0.0) + ms
    return total


def check_twopass_fwd(args, calls=10):
    '''The forward at the main path's draws: the row lists it built equal
    `twopass_row_lists_plain` exactly (counts, columns, values), two calls
    give bitwise-equal outputs; the forward's mean device time (no
    autograd), and the device time of each part (list build, fused kernel) over `calls` calls
    under torch.profiler.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    def fwd():
        return agc._launch_fwd(*args)

    out, *lists = fwd()
    for name, got, M, P in zip(('M1', 'M2'), lists, (args[3], args[6]), (args[7], args[8])):
        _hold_lists(f'row lists of {name} {tuple(M.shape)}', got,
                    agc.twopass_row_lists_plain(M, P))
    if not torch.equal(out, fwd()[0]):
        raise AssertionError('two forward calls on the same inputs gave different outputs')
    print('ada_twopass_fwd: two calls give bitwise-equal outputs')
    print(f'ada_twopass_fwd alone (no autograd): {_time_ms(fwd):.4f} ms a call')
    rows = profile_step(f'{calls} ada_twopass_fwd calls', lambda: [fwd() for _ in range(calls)])
    _print_parts('ada_twopass_fwd', TWOPASS_FWD_PARTS, rows, calls)


#: the backward chain's kernels, by the name the profiler shows, in order
TWOPASS_BWD_PARTS = (('list build', 'twopass_lists_kernel'),
                     ('stage A', 'twopass_bwd_rows_kernel'),
                     ('stage B', 'twopass_bwd_cols_kernel'))


def check_twopass_bwd_chain(args, calls=10, seed=1):
    '''The backward chain at the main path's draws: the tap lists it built
    equal `twopass_tap_lists_plain` exactly (counts, rows, values), two
    calls give bitwise-equal dx; the chain's mean device time (no
    autograd) and the device time of each part (list build, stage A,
    stage B) over `calls` calls under torch.profiler.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len = args
    g = torch.randn((x.shape[0], x.shape[1], out_len, x.shape[2]), device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(seed))

    def bwd():
        return agc._launch_bwd(g, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)

    dx, *lists = bwd()
    for name, got, M, P in zip(('M1', 'M2'), lists, (args[3], args[6]), (args[7], args[8])):
        _hold_lists(f'tap lists of {name} {tuple(M.shape)}', got,
                    agc.twopass_tap_lists_plain(M, P))
    if not torch.equal(dx, bwd()[0]):
        raise AssertionError('two backward calls on the same inputs gave different dx')
    print('ada_twopass_bwd: two calls give bitwise-equal dx')
    print(f'ada_twopass_bwd chain alone (no autograd): {_time_ms(bwd):.4f} ms a call')
    rows = profile_step(f'{calls} ada_twopass_bwd calls', lambda: [bwd() for _ in range(calls)])
    _print_parts('ada_twopass_bwd', TWOPASS_BWD_PARTS, rows, calls)


def run_main_path(dev, card):
    from animeface_tpu_torch.implementations.StyleGAN2.utils import (
        build_models, build_train_step, make_optimizers)
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
    from animeface_tpu_torch.nnutils.ada import make_ada_pipe, ada_init_state
    from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
    from animeface_tpu_torch.nnutils.rng import make_generator
    from animeface_tpu_torch.ops import cuda_kernels as ck

    args = SimpleNamespace(
        image_size=IMAGE, image_channels=3, style_dim=512, channels=32, max_channels=512,
        block_num_conv=2, map_num_layers=8, map_lr=0.01, disable_map_norm=False,
        mbsd_groups=4, lr=1e-3, beta1=0.0, beta2=0.99,
        g_k=G_K, d_k=D_K, r1_lambda=10.0, pl_lambda=2.0)
    G, D, G_ema = build_models(args, torch.bfloat16, device=dev, seed=0)
    g_opt, d_opt = make_optimizers(args, G, D)
    state = dict(pl_mean=torch.zeros((), device=dev), step=0,
                 ada=ada_init_state(BATCH, interval=4, target_kimg=500, threshold=0.6,
                                    device=dev),
                 generator=make_generator(0, dev))
    state['ada']['p'] = torch.tensor(0.2, device=dev)
    pipe = make_ada_pipe()

    def augment_fn(images, st):
        return pipe(images, st['ada']['p'], generator=st['generator'])

    steps = {(r1, pl): build_train_step(
        G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), args.r1_lambda, args.pl_lambda,
        D_K, G_K, 0.999, r1, pl, augment_fn=augment_fn, ada_enabled=True)
        for r1, pl in ((False, False), (False, True), (True, True))}

    def pick(i):
        return (i % D_K == 0, i % G_K == 0 or i % D_K == 0)

    real = torch.rand((BATCH, 3, IMAGE, IMAGE), generator=state['generator'], device=dev) * 2 - 1
    t0 = time.perf_counter()
    for variant in steps.values():           # warm-up: each variant once
        variant(state, real)
    torch.cuda.synchronize()
    print(f'warm-up (3 steps, one per variant): {time.perf_counter() - t0:.2f} s')

    agc.fwd_launches = agc.bwd_launches = 0
    agc.line_fwd_launches = agc.line_bwd_launches = 0
    ck.bias_act_launches = ck.filtered_lrelu_launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(1, D_K + 1):
        m = steps[pick(i)](state, real)
        losses.append((m['G'], m['D']))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (agc.fwd_launches, agc.bwd_launches)
    if (agc.line_fwd_launches, agc.line_bwd_launches) != (0, 0):
        raise AssertionError('the 256px path launched the line kernels')
    _check_registry_idle('the 256px path')

    losses = [(float(g), float(d)) for g, d in losses]
    if not all(np.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f'non-finite loss: {losses}')
    adv_d = sum(1 for i in range(1, D_K + 1) if not pick(i)[0])
    adv_g = sum(1 for i in range(1, D_K + 1) if not pick(i)[1])
    if launches != (adv_d + adv_g, adv_g):
        raise AssertionError(f'launches {launches}, expected ({adv_d + adv_g}, {adv_g}): '
                             'one forward per adversarial D and G phase, one backward per '
                             'adversarial G phase')
    p = float(state['ada']['p'])
    if not 0.0 <= p <= 1.0:
        raise AssertionError(f'p out of range: {p}')
    with torch.no_grad():
        z = torch.randn((8, 512), generator=state['generator'], device=dev)
        sample, _ = G_ema(z, noise=state['generator'])
    if sample.shape != (8, 3, IMAGE, IMAGE) or not bool(torch.isfinite(sample).all()):
        raise AssertionError('G_ema sample is not finite or has the wrong shape')
    print('losses (G, D) per step:', json.dumps([[round(g, 5), round(d, 5)] for g, d in losses]))
    print(f'p {p:.6f}  pl_mean {float(state["pl_mean"]):.5f}  launches fwd {launches[0]} '
          f'bwd {launches[1]}')
    print(f'main path: {D_K} steps, batch {BATCH}, {IMAGE}px, full width, bf16: {dt:.3f} s, '
          f'{BATCH * D_K / dt:.2f} images/s on {card}')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    for name, variant in zip(('adversarial', 'pl', 'r1+pl'), steps.values()):
        for ms, count, key in profile_step(name, variant, state, real):
            if 'twopass' in key:
                print(f'  two-pass: {ms:9.3f} ms  x{count:5d}  {key[:100]}')
    return launches


def profile_step(name, step, *args):
    '''Device time by kernel over one call step(*args) (torch.profiler),
    and the device's busy share of its wall time under the profiler. User
    annotations (e.g. `Optimizer.step#Adam.step`) span kernels already
    counted, so they are left out. Returns the rows (ms, count, kernel
    name), largest first.'''
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not getattr(e, 'is_user_annotation', False)),
                  reverse=True)
    if not rows:
        print('profile: the profiler recorded no device time (busy share not measured)')
        return rows
    busy_ms = sum(r[0] for r in rows)
    print(f'profile, one {name} step: wall {wall_ms:.1f} ms, device busy '
          f'{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(rows)} kernels')
    for ms, count, key in rows[:10]:
        print(f'  {ms:9.3f} ms  x{count:5d}  {key[:100]}')
    return rows


def check_warp_against_dense(images, G_inv):
    '''The kernel-path warp against the dense (gather + einsum) warp on the
    same batch: the repo's own reference for the two-pass geometry.'''
    from animeface_tpu_torch.nnutils.ada_geometry import twopass_warp
    got = twopass_warp(images[:4], G_inv[:4])
    want = twopass_warp(images[:4], G_inv[:4], fused=False)
    err = float((got - want).abs().max())
    size = images.shape[2]
    print(f'warp (kernel path) vs dense warp, 4 x {size}px: max_abs_err {err:.3e} (tol {TOL})')
    if not err <= TOL:
        raise AssertionError(f'kernel-path warp disagrees with the dense warp at {size}px: {err}')


def _line_pass_inputs(images, G_inv):
    '''The line kernels' inputs for both passes of one warp, as the warp's
    kernel branch builds them: [(z, t, f, M), (z, t, f, M)].'''
    from animeface_tpu_torch.nnutils import ada_geometry as geo
    from animeface_tpu_torch.nnutils.ada_geometry_cuda import linepass_fused_plain

    half, support = geo.derive_axis_kernel()
    N = images.shape[2]
    x, We, pass1, pass2 = geo._factorize(images, G_inv, support)
    t1, f1, M1 = geo._pass_params(*pass1, N, 2 * N - 2, half, support)
    t2, f2, M2 = geo._pass_params(*pass2, N, 2 * We - 2, half, support)
    z1 = x.contiguous()
    z2 = linepass_fused_plain(z1, t1, f1, M1).transpose(2, 3).contiguous()
    return [(z1, t1, f1, M1), (z2, t2, f2, M2)]


def check_line_kernels(dev):
    '''Both line kernels against the plain version at the 128px main path's
    pass shapes; times and bounds summed over the two passes of one warp
    (`alone_ms`: each kernel's device time alone, from `check_line_fwd`
    and `check_line_bwd`).'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    images, G_inv = _warp_draws(dev, ADA_IMAGE, seed=2)
    total = dict.fromkeys(('fwd_err', 'bwd_err', 'fwd', 'fwd_plain', 'bwd', 'bwd_plain'), 0.0)
    bound_ms, bound_by = 0.0, set()
    passes = _line_pass_inputs(images, G_inv)
    for k, (z, t, f, M) in enumerate(passes, 1):
        held = _hold(f'linepass pass {k}', agc.linepass_fused, agc.linepass_fused_plain,
                     z, (t, f, M), seed=k)
        for key, v in held.items():
            total[key] = max(total[key], v) if key.endswith('_err') else total[key] + v
        ms, by = _bound(*_line_work(z, t, f, M))
        bound_ms += ms
        bound_by.add(by)
    bound = (bound_ms, 'bytes' if bound_by == {'bytes'} else 'operations')
    entries = _pair_entries('ada_linepass', (59, 71), total, bound)
    for entry, alone in zip(entries, (check_line_fwd(passes), check_line_bwd(passes))):
        entry['alone_ms'] = sum(alone)
        print(f'{entry["name"]} alone, both passes: {entry["alone_ms"]:.4f} ms a warp')
    return images, G_inv, entries


#: the line kernels, by the name the profiler shows, in order
LINE_FWD_PARTS = (('list build', 'linepass_row_lists_kernel'), ('fused', 'linepass_fwd_kernel'))
LINE_BWD_PARTS = (('list build', 'linepass_lists_kernel'), ('gather', 'linepass_bwd_kernel'))


def _time_alone(what, call, parts, calls=10):
    '''A kernel call alone (no autograd): each part's device time over
    `calls` calls under torch.profiler, the mean time of back-to-back calls
    by CUDA events, and the host time it takes to issue one (if that
    exceeds the device time, back-to-back calls are host-bound and the
    events time the host). Returns the call's device time: the sum of its
    parts (the events' time if the profiler recorded none).'''
    ms = _time_ms(call)
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    rows = profile_step(f'{calls} {what} calls', lambda: [call() for _ in range(calls)])
    device = _print_parts(what, parts, rows, calls)
    device = ms if device is None else device
    print(f'{what} alone (no autograd): {device:.4f} ms of device time a call; back to back '
          f'{ms:.4f} ms a call by events, the host {host_ms:.4f} ms to issue one '
          f'({"host" if host_ms >= device else "device"}-bound)')
    return device


def _line_grad(z, M, seed):
    '''A seeded output gradient for one line pass of z with M.'''
    B, C, _, W = z.shape
    return torch.randn((B, C, M.shape[1], W), device=z.device,
                       generator=torch.Generator(device=z.device).manual_seed(seed))


def _hold_lists(what, got, want):
    '''Kernel-built lists (count, idx, val) equal the plain ones exactly
    (entries past a count are unwritten scratch).'''
    count, idx, val = got
    keep = torch.arange(idx.shape[2], device=idx.device) < count[..., None]
    if not (torch.equal(count, want[0]) and torch.equal(idx[keep], want[1][keep])
            and torch.equal(val[keep], want[2][keep])):
        raise AssertionError(f'the {what} differ from the plain lists')
    print(f'{what}: {int(count.sum())} taps, at most {int(count.max())} in a list, equal to '
          'the plain lists')


def check_line_fwd(passes):
    '''The line forward at both 128px pass shapes, with the main path's
    draws: the row lists it built equal `twopass_row_lists_plain` exactly,
    the output is within TOL of `linepass_fused_plain`, two calls give
    bitwise-equal outputs; each pass's device time alone and its parts.
    Returns the device ms of each pass.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    times = []
    for k, (z, t, f, M) in enumerate(passes, 1):
        def fwd():
            return agc._launch_line_fwd(z, t, f, M)

        out, lists = fwd()
        _hold_lists(f'row lists of M, pass {k} {tuple(M.shape)}', lists,
                    agc.twopass_row_lists_plain(M, 2 * z.shape[2] - 2))
        err = float((out - agc.linepass_fused_plain(z, t, f, M)).abs().max())
        if not err <= TOL:
            raise AssertionError(f'ada_linepass_fwd pass {k}: error {err} past {TOL}')
        if not torch.equal(out, fwd()[0]):
            raise AssertionError(f'ada_linepass_fwd pass {k}: two calls differ')
        print(f'ada_linepass_fwd pass {k}: max_abs_err {err:.3e}, two calls bitwise equal')
        times.append(_time_alone(f'ada_linepass_fwd pass {k}', fwd, LINE_FWD_PARTS))
    return times


def check_line_bwd(passes):
    '''The line backward at both 128px pass shapes, with the main path's
    draws: the tap lists it built equal `twopass_tap_lists_plain` exactly,
    dz is within TOL of autograd through `linepass_fused_plain`, two calls
    give bitwise-equal dz; each pass's device time alone and its parts.
    Returns the device ms of each pass.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    times = []
    for k, (z, t, f, M) in enumerate(passes, 1):
        N = z.shape[2]
        g = _line_grad(z, M, seed=k)

        def bwd():
            return agc._launch_line_bwd(g, t, f, M, N)

        dz, lists = bwd()
        _hold_lists(f'tap lists of M, pass {k} {tuple(M.shape)}', lists,
                    agc.twopass_tap_lists_plain(M, 2 * N - 2))
        zr = z.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(agc.linepass_fused_plain(zr, t, f, M), zr, g)
        err = float((dz - want).abs().max())
        if not err <= TOL:
            raise AssertionError(f'ada_linepass_bwd pass {k}: error {err} past {TOL}')
        if not torch.equal(dz, bwd()[0]):
            raise AssertionError(f'ada_linepass_bwd pass {k}: two calls differ')
        print(f'ada_linepass_bwd pass {k}: max_abs_err {err:.3e}, two calls bitwise equal')
        times.append(_time_alone(f'ada_linepass_bwd pass {k}', bwd, LINE_BWD_PARTS))
    return times


def run_ada_path(dev, card, **overrides):
    '''The ADA recipe at its 128px CLI defaults (`overrides` change them),
    full width: warm-up (the R1 variant at step 0, the plain one at step 1),
    then one 16-step cycle with the kernels' counts read around it.'''
    from animeface_tpu_torch.implementations.ADA.utils import build_training, default_args
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
    from animeface_tpu_torch.ops import cuda_kernels as ck

    args = default_args(**overrides)
    print('ADA args:', json.dumps(vars(args)))
    run = build_training(args, device=dev, seed=0)
    state = run.state
    state['ada']['p'] = torch.tensor(0.2, device=dev)
    real = torch.rand((args.batch_size, 3, args.image_size, args.image_size),
                      generator=state['generator'], device=dev) * 2 - 1
    t0 = time.perf_counter()
    for _ in range(2):                        # step 0: R1, step 1: plain
        run.train_step(state, real)
    torch.cuda.synchronize()
    print(f'ADA warm-up (2 steps, one per variant): {time.perf_counter() - t0:.2f} s')

    torch.cuda.reset_peak_memory_stats()
    agc.line_fwd_launches = agc.line_bwd_launches = 0
    agc.fwd_launches = agc.bwd_launches = 0
    ck.bias_act_launches = ck.filtered_lrelu_launches = 0
    first = state['step']
    variants = [run.uses_r1(i) for i in range(first, first + ADA_STEPS)]
    losses = []
    t0 = time.perf_counter()
    for _ in range(ADA_STEPS):
        m = run.train_step(state, real)
        losses.append((m['g'], m['d']))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (agc.line_fwd_launches, agc.line_bwd_launches)
    twopass = (agc.fwd_launches, agc.bwd_launches)
    _check_registry_idle('the ADA path')

    losses = [(float(g), float(d)) for g, d in losses]
    if not all(np.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f'non-finite loss: {losses}')
    if sum(variants) != 1:
        raise AssertionError(f'expected one R1 step in the cycle, got {variants}')
    # per step: real and fake warps in the D phase, fake2 in the G phase,
    # two passes each; only fake2's warp is differentiated
    want = (6 * ADA_STEPS, 2 * ADA_STEPS)
    if launches != want or twopass != (0, 0):
        raise AssertionError(f'line launches {launches} (want {want}), two-pass {twopass} '
                             '(want (0, 0))')
    p = float(state['ada']['p'])
    if not 0.0 <= p <= 1.0:
        raise AssertionError(f'p out of range: {p}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        z = torch.randn((8, args.latent_dim), generator=state['generator'], device=dev)
        sample = run.G_ema(z)
    if sample.shape != (8, 3, args.image_size, args.image_size) \
            or not bool(torch.isfinite(sample).all()):
        raise AssertionError('G_ema sample is not finite or has the wrong shape')
    print('ADA losses (G, D) per step:',
          json.dumps([[round(g, 5), round(d, 5)] for g, d in losses]))
    print(f'ADA p {p:.6f}  R1 at cycle step {variants.index(True) + 1}  line launches fwd '
          f'{launches[0]} bwd {launches[1]}')
    print(f'ADA path: {ADA_STEPS} steps, batch {args.batch_size}, {args.image_size}px, full '
          f'width, bf16: {dt:.3f} s, {args.batch_size * ADA_STEPS / dt:.2f} images/s on {card}')
    print(f'ADA peak device memory {peak:.2f} GiB')
    for name, do_r1 in (('ADA plain', False), ('ADA r1', True)):
        profile_step(name, run.steps[do_r1], state, real)
    check_models_against_cpu(run, args, dev)
    return launches


def check_models_against_cpu(run, args, dev, batch=2, rtol=1e-3):
    '''The cycle's G_ema and D at full width, in f32 on the card (TF32 off)
    and on the CPU, on the same latents: images and logits agree to `rtol`
    of their scale (f32 on both sides, summed in other orders through 15
    layers of convolutions, FIR chains and demodulation).'''
    from animeface_tpu_torch.implementations.StyleGAN3.utils import build_models

    z = torch.randn((batch, args.latent_dim), generator=torch.Generator().manual_seed(3))
    outs = []
    t0 = time.perf_counter()
    for device in (dev, torch.device('cpu')):
        G, D, _ = build_models(args, torch.float32, device=device)
        G.load_state_dict(run.G_ema.state_dict())
        D.load_state_dict(run.D.state_dict())
        with torch.no_grad():
            images = G(z.to(device))
            outs.append((images.cpu(), D(images).cpu()))
    for what, got, want in (('images', outs[0][0], outs[1][0]),
                            ('logits', outs[0][1], outs[1][1])):
        scale = max(float(want.abs().max()), 1e-6)
        err = float((got - want).abs().max())
        print(f'ADA G_ema/D f32, card vs CPU, {batch} samples: {what} max_abs_err {err:.3e} '
              f'(scale {scale:.3e}, tol {rtol} x scale)')
        if not (bool(torch.isfinite(got).all()) and err <= rtol * scale):
            raise AssertionError(f'{what} on the card disagree with the CPU: {err} vs {scale}')
    print(f'card vs CPU check: {time.perf_counter() - t0:.2f} s')


# ------------------------------------------------- the ops registry's kernels

def _check_registry_idle(path):
    '''A path run with the default 'torch' implementation launched
    neither of the ops registry's kernels.'''
    from animeface_tpu_torch.ops import cuda_kernels as ck
    counts = (ck.bias_act_launches, ck.filtered_lrelu_launches)
    if counts != (0, 0):
        raise AssertionError(f'{path} launched the registry kernels (bias_act, '
                             f'filtered_lrelu): {counts}')


def _hold_fwd(label, kernel, plain, args):
    '''A forward-only kernel against its plain version on the same
    inputs: f32 within TOL abs, bf16 within BF16_RTOL of the output's
    scale. Returns the error and the mean device times of both.'''
    ref = plain(*args)
    got = kernel(*args)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = TOL if ref.dtype == torch.float32 else BF16_RTOL * max(1.0, scale)
    if not (got.shape == ref.shape and got.dtype == ref.dtype and err <= tol):
        raise AssertionError(f'{label}: the kernel disagrees with the plain version: {err} '
                             f'(tol {tol}), shapes {tuple(got.shape)}/{tuple(ref.shape)}')
    ms, plain_ms = _time_ms(lambda: kernel(*args)), _time_ms(lambda: plain(*args))
    print(f'{label}: max_abs_err {err:.3e} (tol {tol:.3e}, scale {scale:.3e})  kernel '
          f'{ms:.4f} ms  plain {plain_ms:.4f} ms')
    return err, ms, plain_ms


def _bias_act_work(x, act):
    '''Bytes (x once in, y once out, the bias along the last axis) and f32
    operations (bias add, lrelu's compare and multiply, gain) of one call.'''
    assert act in ('linear', 'lrelu')
    ops = (1 if act == 'linear' else 4) * x.numel()
    return (2 * x.numel() + x.shape[-1]) * x.element_size(), ops


#: what the profiler's names of bias_act's kernels hold (the rows, planes
#: and scalar kernels of csrc/bias_act.cu, and an older design's one kernel)
BIAS_ACT_KERNEL = 'bias_act'


def _bias_act_inputs(dev):
    '''(label, x, b, act, gain, calls) at each shape of a CIPS forward's
    calls (CIPS_BIAS_ACT_CALLS), the bias in x's dtype.'''
    g = torch.Generator(device=dev).manual_seed(4)
    out = []
    for shape, dtype, act, gain, calls in CIPS_BIAS_ACT_CALLS:
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        b = torch.randn(shape[-1], generator=g, device=dev).to(dtype)
        out.append((f'bias_act {act} {tuple(shape)} {str(dtype)[6:]}', x, b, act, gain, calls))
    return out


def _device_ms(what, fn, kernel, calls=20):
    '''fn()'s device time a call: by torch.profiler over `calls` calls when
    it recorded a launch of `kernel` for each of them (in a long run it may
    record fewer), else by CUDA events over `calls` launches queued behind a
    spin of the stream, so that the device, not the host, bounds them.'''
    rows = profile_step(f'{calls} {what} calls', lambda: [fn() for _ in range(calls)])
    recorded = sum(r[1] for r in rows if kernel in r[2])
    if recorded == calls:
        ms, how = sum(r[0] for r in rows if kernel in r[2]) / calls, 'profiler'
    else:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)                  # a few ms: the launches queue behind it
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / calls
        how = f'events behind a spin; the profiler recorded {recorded} of {calls} launches'
    print(f'{what} alone: {ms:.4f} ms of device time a call ({how})')
    return ms


def time_bias_act(label, x, b, act, gain, small_iters=200):
    '''One CIPS call shape: (a) the kernel's device time alone
    (`_device_ms`); then, by CUDA events over back-to-back calls, two
    rounds in turns (A, B, .., B, A): (b) ms a call
    of `ck.bias_act` ('wrapper') and of `ops.bias_act(impl='cuda')`
    ('registry'), (c) of torch.add(x, b) ('add') on a linear gain-1 call,
    and (d) on the big shape the copy ceiling y.copy_(x) ('copy'), what
    this card's memory delivers for the same bytes. torch.add and the copy
    are yardsticks the port never calls. Returns each one's mean.'''
    from animeface_tpu_torch import ops
    from animeface_tpu_torch.ops import cuda_kernels as ck

    big = x.numel() >= 1 << 24
    timed = dict(
        wrapper=lambda: ck.bias_act(x, b, -1, act, 0.2, gain, -1.0),
        registry=lambda: ops.bias_act(x, b, dim=-1, act=act, alpha=0.2, gain=gain, impl='cuda'))
    if act == 'linear' and gain == 1:
        timed['add'] = lambda: torch.add(x, b)
    if big:
        y = torch.empty_like(x)
        timed['copy'] = lambda: y.copy_(x)
    out = dict(device=_device_ms(label, timed['wrapper'], BIAS_ACT_KERNEL))
    rounds = {k: [] for k in timed}
    for k in list(timed) + list(reversed(timed)):
        rounds[k].append(_time_ms(timed[k], 20 if big else small_iters))
    print(f'{label}: back to back, ms a call (two rounds): ' + ', '.join(
        f'{k} {v[0]:.4f} / {v[1]:.4f}' for k, v in rounds.items()))
    out.update({k: sum(v) / len(v) for k, v in rounds.items()})
    return out


def check_bias_act_kernel(dev):
    '''bias_act against its plain version at the CIPS forward's shapes
    (and, at the big shape, an f32 bias against the same bias rounded to
    bf16, bitwise, and two calls bitwise equal), timed by `time_bias_act`,
    and every activation with and without the clamp at a small shape.
    Returns the kernels-line entry without launches; ms, plain_ms,
    bound_ms and device_ms sum one forward's 41 calls; small_call_ms and
    small_call_library_ms are the kernel's and torch.add's ms a call over
    the 22 linear gain-1 calls.'''
    from animeface_tpu_torch.ops import cuda_kernels as ck

    err = ms = plain_ms = bound_ms = device_ms = linear_ms = linear_lib_ms = 0.0
    linear_calls, copy_ms = 0, None
    for label, x, b, act, gain, calls in _bias_act_inputs(dev):
        args = (x, b, -1, act, 0.2, gain, -1.0)
        e, t, tp = _hold_fwd(label, ck.bias_act, ck.bias_act_plain, args)
        bound, _ = _bound(*_bias_act_work(x, act))
        r = time_bias_act(label, x, b, act, gain)
        print(f'  x{calls} a forward; bound {bound:.4f} ms')
        err, ms, plain_ms = max(err, e), ms + calls * t, plain_ms + calls * tp
        bound_ms, device_ms = bound_ms + calls * bound, device_ms + calls * r['device']
        if 'add' in r:
            linear_calls += calls
            linear_ms += calls * r['wrapper']
            linear_lib_ms += calls * r['add']
        if 'copy' in r:
            copy_ms = r['copy']
            print(f'  copy ceiling {copy_ms:.4f} ms: the kernel alone at '
                  f'{100 * copy_ms / r["device"]:.1f}% of it, {100 * bound / r["device"]:.1f}% '
                  'of its bound')
            if not torch.equal(ck.bias_act(*args), ck.bias_act(*args)):
                raise AssertionError(f'{label}: two calls on the same inputs differ')
            g = torch.Generator(device=dev).manual_seed(6)
            b32 = b.float() + torch.randn(b.shape, generator=g, device=dev) * 1e-3  # not bf16
            got = ck.bias_act(x, b32, -1, act, 0.2, gain, -1.0)
            if not torch.equal(got, ck.bias_act(x, b32.to(x.dtype), -1, act, 0.2, gain, -1.0)):
                raise AssertionError(f'{label}: an f32 bias is not rounded as b.to(x.dtype)')
            _hold_fwd(f'{label}, f32 bias', ck.bias_act, ck.bias_act_plain,
                      (x, b32, -1, act, 0.2, gain, -1.0))
            print(f'{label}: two calls bitwise equal; an f32 bias equals it rounded to bf16, '
                  'bitwise')
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((64, 256), generator=g, device=dev) * 3
    b = torch.randn(256, generator=g, device=dev)
    for act in sorted(ck.ACT_INDEX):
        for clamp in (-1.0, 0.5):
            ref = ck.bias_act_plain(x, b, -1, act, 0.3, 1.7, clamp)
            got = ck.bias_act(x, b, -1, act, 0.3, 1.7, clamp)
            e = float((got - ref).abs().max())
            if not e <= TOL:
                raise AssertionError(f'bias_act {act} clamp {clamp}: {e}')
            err = max(err, e)
    print(f'bias_act: 9 activations x clamp on/off at (64, 256) f32 agree within {TOL}')
    print(f'bias_act, one CIPS forward (41 calls): kernel {ms:.4f} ms back to back, '
          f'{device_ms:.4f} ms of device time alone, plain {plain_ms:.4f} ms, bound '
          f'{bound_ms:.4f} ms (bytes)')
    print(f'bias_act, the forward\'s {linear_calls} linear gain-1 calls: kernel '
          f'{linear_ms:.4f} ms, torch.add {linear_lib_ms:.4f} ms')
    # no one library call computes the lrelu calls, so library_ms stays null;
    # the linear calls' times are their own keys
    return dict(name='bias_act', route='cuda', source='animeface_tpu_torch/csrc/bias_act.cu',
                replaces='animeface_tpu/ops/pallas_kernels.py:815', launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by='bytes', library_ms=None, linear_ms=linear_ms,
                linear_library_ms=linear_lib_ms, device_ms=device_ms,
                small_call_ms=linear_ms / linear_calls,
                small_call_library_ms=linear_lib_ms / linear_calls, copy_ceiling_ms=copy_ms)


def _flrelu_work(x, Lu, Ld, pad):
    '''Bytes (x, bias and the same-size output once) and f32 operations of
    one same-resolution call: the separable polyphase stages at the
    composition's sizes (up along H and W, Lu / 2 taps a sample; down
    along W and H, Ld taps), 2 a multiply-add, and 3 for the activation,
    gain and clamp of each 2x sample.'''
    N, C, H, W = x.shape
    OH, OW = H, W
    Ly = 2 * H + 2 * pad - Lu + 1
    Lx = 2 * W + 2 * pad - Lu + 1
    half = (Lu + 1) // 2
    macs = Ly * W * half + Ly * Lx * half + Ly * OW * Ld + OH * OW * Ld
    ops = N * C * (2 * macs + 3 * Ly * Lx)
    moved = (2 * x.numel() + C) * x.element_size()
    return moved, ops


def _flrelu_inputs(dev):
    '''(label, x, b) at the four StyleGAN3-256 shapes in bf16, and one f32
    shape.'''
    g = torch.Generator(device=dev).manual_seed(5)
    cases = [(FLRELU_BATCH, c, s, torch.bfloat16) for s, c in FLRELU_LAYERS]
    cases.append((4, 256, 64, torch.float32))
    out = []
    for n, c, s, dtype in cases:
        x = (torch.randn((n, c, s, s), generator=g, device=dev) * 2).to(dtype)
        b = (torch.randn(c, generator=g, device=dev) * 0.3).to(dtype)
        out.append((f'filtered_lrelu {(n, c, s, s)} {str(dtype)[6:]}', x, b))
    return out


#: the filtered_lrelu kernel, by the name the profiler shows (the templated
#: kernel; the loop kernel for filters past 24 taps is named apart)
FLRELU_PARTS = (('kernel', 'filtered_lrelu_kernel'),)


def check_filtered_lrelu_kernel(dev, fu):
    '''filtered_lrelu against its plain version at the four path shapes and
    one f32 shape; at each path shape two calls are bitwise equal, and the
    kernel's device time alone. Returns the kernels-line entry without
    launches; ms, plain_ms, bound_ms and alone_ms sum the four path shapes
    (one call each).'''
    from animeface_tpu_torch.ops import cuda_kernels as ck

    pad = (FLRELU_PAD,) * 4
    err = ms = plain_ms = bound_ms = alone_ms = 0.0
    bound_by = set()
    for k, (label, x, b) in enumerate(_flrelu_inputs(dev)):
        args = (x, fu, fu, b, pad, float(np.sqrt(2)), 0.2, FLRELU_CLAMP)
        e, t, tp = _hold_fwd(label, ck.filtered_lrelu, ck.filtered_lrelu_plain, args)
        err = max(err, e)
        bound, by = _bound(*_flrelu_work(x, fu.numel(), fu.numel(), FLRELU_PAD))
        print(f'  bound {bound:.4f} ms ({by})')
        if k < len(FLRELU_LAYERS):
            if not torch.equal(ck.filtered_lrelu(*args), ck.filtered_lrelu(*args)):
                raise AssertionError(f'{label}: two calls on the same inputs differ')
            print(f'{label}: two calls bitwise equal')
            alone_ms += _time_alone(label, lambda: ck.filtered_lrelu(*args), FLRELU_PARTS)
            ms, plain_ms, bound_ms = ms + t, plain_ms + tp, bound_ms + bound
            bound_by.add(by)
        torch.cuda.empty_cache()
    print(f'filtered_lrelu, the four path shapes: kernel {ms:.4f} ms ({alone_ms:.4f} ms of '
          f'device time alone), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms')
    return dict(name='filtered_lrelu', route='cuda',
                source='animeface_tpu_torch/csrc/filtered_lrelu.cu',
                replaces='animeface_tpu/ops/pallas_kernels.py:565', launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by='operations' if 'operations' in bound_by else 'bytes',
                library_ms=None, alone_ms=alone_ms)


def check_grad_refused(dev, fu):
    '''impl='cuda' on a CUDA tensor that requires grad raises (no
    backward exists), for both of the registry's kernels.'''
    from animeface_tpu_torch import ops

    x = torch.randn((16, 128, 16, 16), device=dev, requires_grad=True)
    b = torch.zeros(128, device=dev)
    for name, call in (
            ('bias_act', lambda: ops.bias_act(x, b, act='lrelu', impl='cuda')),
            ('filtered_lrelu', lambda: ops.filtered_lrelu(x, fu, fu, b, up=2, down=2,
                                                          padding=FLRELU_PAD, impl='cuda'))):
        try:
            call()
        except RuntimeError as exc:
            if 'forward only' not in str(exc):
                raise
        else:
            raise AssertionError(f'{name}: a tensor that requires grad did not raise')
    print('bias_act and filtered_lrelu refuse a CUDA tensor that requires grad')


def run_flrelu_path(dev, fu):
    '''The op-level filtered_lrelu (impl='cuda', memory='store') once at
    each StyleGAN3-256 shape, the counts set to 0 just before and read just
    after: one launch a call, output against the plain version.'''
    from animeface_tpu_torch import ops
    from animeface_tpu_torch.ops import cuda_kernels as ck

    inputs = _flrelu_inputs(dev)[:len(FLRELU_LAYERS)]
    kw = dict(up=2, down=2, padding=FLRELU_PAD, gain=float(np.sqrt(2)), slope=0.2,
              clamp=FLRELU_CLAMP)
    ck.bias_act_launches = ck.filtered_lrelu_launches = 0
    outs, counts = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for _, x, b in inputs:
            outs.append(ops.filtered_lrelu(x, fu, fu, b, impl='cuda', **kw))
            counts.append(ck.filtered_lrelu_launches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ck.filtered_lrelu_launches
    if counts != list(range(1, len(inputs) + 1)) or ck.bias_act_launches:
        raise AssertionError(f'op-level filtered_lrelu: kernel launches after each call '
                             f'{counts}, bias_act {ck.bias_act_launches}; want one a call')
    for (label, x, b), out in zip(inputs, outs):
        ref = ck.filtered_lrelu_plain(x, fu, fu, b, (FLRELU_PAD,) * 4, kw['gain'], 0.2,
                                      FLRELU_CLAMP)
        err = float((out.float() - ref.float()).abs().max())
        if not (out.shape == x.shape and bool(torch.isfinite(out).all())
                and err <= BF16_RTOL * max(1.0, float(ref.float().abs().max()))):
            raise AssertionError(f'op-level {label}: wrong output (err {err})')
    print(f'op-level filtered_lrelu path: {launches} launches for {len(inputs)} calls, '
          f'{dt * 1e3:.2f} ms wall')
    return launches


def cips_sampler(dev, **overrides):
    '''CIPS's sampler at the recipe's 128px defaults (`overrides` change
    them): G_ema on num_test fixed latents, impl='cuda', after two warm-up
    forwards. Returns (args, G_ema, sample).'''
    from animeface_tpu_torch.implementations.CIPS.utils import (
        build_models, default_args, make_sampler)

    args = default_args(**overrides)
    print('CIPS args:', json.dumps(vars(args)))
    _, _, G_ema = build_models(args, device=dev, seed=0)
    sample = make_sampler(G_ema, args, seed=0, impl='cuda')
    t0 = time.perf_counter()
    for _ in range(2):
        sample()
    torch.cuda.synchronize()
    print(f'CIPS warm-up (2 forwards): {time.perf_counter() - t0:.2f} s')
    return args, G_ema, sample


def run_cips_path(dev, card, **overrides):
    '''CIPS sampling at the recipe's 128px defaults (`cips_sampler`):
    CIPS_FORWARDS forwards with the counts read around them.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
    from animeface_tpu_torch.ops import cuda_kernels as ck

    args, G_ema, sample = cips_sampler(dev, **overrides)
    torch.cuda.reset_peak_memory_stats()
    ck.bias_act_launches = ck.filtered_lrelu_launches = 0
    agc.fwd_launches = agc.bwd_launches = agc.line_fwd_launches = agc.line_bwd_launches = 0
    t0 = time.perf_counter()
    for _ in range(CIPS_FORWARDS):
        images = sample()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ck.bias_act_launches
    others = (ck.filtered_lrelu_launches, agc.fwd_launches, agc.bwd_launches,
              agc.line_fwd_launches, agc.line_bwd_launches)
    want = CIPS_BIAS_ACT_PER_FORWARD * CIPS_FORWARDS
    if launches != want or any(others):
        raise AssertionError(f'CIPS: bias_act launches {launches} (want {want}), other kernels '
                             f'{others} (want 0)')
    size = args.image_size
    if images.shape != (args.num_test, args.image_channels, size, size) \
            or not bool(torch.isfinite(images).all()):
        raise AssertionError('CIPS samples are not finite or have the wrong shape')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'CIPS path: {CIPS_FORWARDS} forwards of {args.num_test} latents, {size}px, full '
          f'width, bf16: {dt / CIPS_FORWARDS * 1e3:.3f} ms a forward, '
          f'{args.num_test * CIPS_FORWARDS / dt:.2f} images/s on {card}; bias_act launches '
          f'{launches} ({launches // CIPS_FORWARDS} a forward)')
    print(f'CIPS peak device memory {peak:.2f} GiB')
    rows = profile_step('CIPS sampling forward', sample)
    if rows:
        busy = sum(r[0] for r in rows)
        kern = sum(r[0] for r in rows if BIAS_ACT_KERNEL in r[2])
        print(f'CIPS profile: bias_act kernel {kern:.3f} ms of {busy:.3f} ms device busy '
              f'({100 * kern / busy:.1f}%)')
    check_cips_against_cpu(G_ema, args, dev)
    return launches


def check_cips_against_cpu(G_ema, args, dev, batch=2, rtol=1e-3):
    '''The sampled G_ema at full width, in f32 under impl='cuda' on the card
    (the kernels, TF32 off) and on the CPU (their plain versions), on the
    same latents: images agree to `rtol` of their scale.'''
    from animeface_tpu_torch.implementations.CIPS.utils import build_models
    from animeface_tpu_torch.ops import registry

    f32 = SimpleNamespace(**dict(vars(args), no_bf16=True))
    z = torch.randn((batch, args.latent_dim), generator=torch.Generator().manual_seed(3))
    outs = []
    t0 = time.perf_counter()
    registry.set_default_impl('cuda')
    try:
        for device in (dev, torch.device('cpu')):
            _, _, G = build_models(f32, device=device)
            G.load_state_dict(G_ema.state_dict())
            with torch.no_grad():
                outs.append(G(z.to(device)).cpu())
            del G
    finally:
        registry.set_default_impl('torch')
    scale = max(float(outs[1].abs().max()), 1e-6)
    err = float((outs[0] - outs[1]).abs().max())
    print(f'CIPS G_ema f32, card vs CPU, {batch} samples: max_abs_err {err:.3e} '
          f'(scale {scale:.3e}, tol {rtol} x scale); {time.perf_counter() - t0:.2f} s')
    if not (bool(torch.isfinite(outs[0]).all()) and err <= rtol * scale):
        raise AssertionError(f'CIPS images on the card disagree with the CPU: {err} vs {scale}')


# --------------------------------------- the recipes that train with DiffAugment

def _reset_launches():
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
    from animeface_tpu_torch.ops import cuda_kernels as ck
    ck.bias_act_launches = ck.filtered_lrelu_launches = 0
    agc.fwd_launches = agc.bwd_launches = agc.line_fwd_launches = agc.line_bwd_launches = 0


def _launches():
    '''(bias_act, filtered_lrelu, two-pass fwd, bwd, line fwd, bwd) launches.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
    from animeface_tpu_torch.ops import cuda_kernels as ck
    return (ck.bias_act_launches, ck.filtered_lrelu_launches, agc.fwd_launches,
            agc.bwd_launches, agc.line_fwd_launches, agc.line_bwd_launches)


def _check_no_launches(path):
    counts = _launches()
    if any(counts):
        raise AssertionError(f'{path} launched hand-written kernels (bias_act, filtered_lrelu, '
                             f'two-pass fwd/bwd, line fwd/bwd): {counts}')


def _to(obj, device):
    '''Tensors in nested dicts, lists and tuples, on `device`.'''
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def _real_images(args, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((args.batch_size, args.image_channels, args.image_size, args.image_size),
                      generator=g, device=dev) * 2 - 1


def _cycle(label, run, real, steps, card, losses_of):
    '''`steps` calls of run.train_step with every launch count set to 0
    just before and read just after: finite losses, no hand-written kernel
    launched (training runs the registry's 'torch'); then one profiled
    step. Returns the cycle's wall s.'''
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(losses_of(run.train_step(run.state, real)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check_no_launches(label)
    losses = [[float(v) for v in ls] for ls in losses]
    if not all(np.isfinite(v) for ls in losses for v in ls):
        raise AssertionError(f'{label}: non-finite loss: {losses}')
    B, size = real.shape[0], real.shape[-1]
    print(f'{label} losses per step:', json.dumps([[round(v, 5) for v in ls] for ls in losses]))
    print(f'{label}: {steps} steps, batch {B}, {size}px, full width, bf16: {dt:.3f} s, '
          f'{B * steps / dt:.2f} images/s on {card}')
    print(f'{label} peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    profile_step(label, run.train_step, run.state, real)
    return dt


def check_step_against_cpu(label, build_models, make_step, draw, args, run, dev, batch=2,
                           rtol=1e-3, nudge=1e-6, max_nudged=0.1):
    '''One training step at full width in f32 on the card (TF32 off) and on
    the CPU, from `run`'s weights and buffers and the same draws (made on
    the CPU). Plain SGD on both sides, so the G phase sees the same D (an
    Adam step with beta1 = 0 is about lr * sign(g) and would turn a
    last-bit difference of a near-zero gradient into 2 lr).
    The losses and every buffer after the step (spectral norm's u, running
    statistics, moments) must agree to `rtol` of their largest magnitude.
    A gradient of such a step moves by more than that when its inputs move
    at f32 rounding (leaky ReLU inputs within rounding of 0 take the other
    slope; BatchNorm's E[x^2] - E[x]^2 cancels), and by how much varies
    from tensor to tensor and draw to draw. So the CPU runs the step a
    second time with the reals and z moved by `nudge` * N(0, 1) (about 8
    ulps of a value near 1); S is the largest L2 change, relative to its
    norm, that this makes to any gradient (at most `max_nudged`, or the
    comparison would say nothing), and every gradient must agree in L2 to
    (`rtol` + 2 S) of its norm.'''
    f32 = SimpleNamespace(**dict(vars(args), no_bf16=True, batch_size=batch))
    cpu = torch.device('cpu')
    real = _real_images(f32, cpu, seed=5)
    g = torch.Generator().manual_seed(7)

    def nudged(t):
        return t + nudge * torch.randn(t.shape, generator=g)

    outs = []
    t0 = time.perf_counter()
    for device, moved in ((dev, False), (cpu, False), (cpu, True)):
        G, D, G_ema = build_models(f32, device)
        for mine, theirs in ((G, run.G), (D, run.D), (G_ema, run.G_ema)):
            mine.load_state_dict(theirs.state_dict())
        state = dict(step=0, generator=torch.Generator(device=device).manual_seed(0))
        step = make_step(G, D, G_ema, torch.optim.SGD(G.parameters(), lr=1e-3),
                         torch.optim.SGD(D.parameters(), lr=1e-3))
        draws = draw(G, real, f32)
        images = real
        if moved:
            images, draws['z'] = nudged(real), nudged(draws['z'])
        metrics = step(state, images.to(device), _to(draws, device))
        if isinstance(metrics, tuple):
            metrics = metrics[0]
        got = {f'loss {k}': v.detach().cpu() for k, v in metrics.items()}
        for name, module in (('G', G), ('D', D)):
            got.update({f'grad {name}.{n}': p.grad.cpu() for n, p in module.named_parameters()})
            got.update({f'buffer {name}.{n}': b.cpu() for n, b in module.named_buffers()})
        outs.append({k: v.double() for k, v in got.items()})
        del G, D, G_ema, step
    card, want, moved = outs

    def rel_l2(a, key):
        return float((a[key] - want[key]).norm()) / max(float(want[key].norm()), 1e-30)

    grads = [k for k in want if k.startswith('grad')]
    nudged_worst = max((rel_l2(moved, k), k) for k in grads)
    if nudged_worst[0] > max_nudged:
        raise AssertionError(f'{label}: a {nudge} move of the inputs moves {nudged_worst[1]} by '
                             f'{nudged_worst[0]:.3e} of its norm on the CPU: too sensitive to '
                             'hold the card against')
    tol = rtol + 2 * nudged_worst[0]
    worst = {'loss/buffer max': (0.0, ''), 'grad l2': (0.0, ''), 'nudged grad l2 (S)': nudged_worst}
    bad = []
    for key, w in want.items():
        if key.startswith('grad'):
            err = rel_l2(card, key)
            worst['grad l2'] = max(worst['grad l2'], (err, key))
            ok = err <= tol
        else:
            rel = float((card[key] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            worst['loss/buffer max'] = max(worst['loss/buffer max'], (rel, key))
            ok = rel <= rtol
        if not (ok and bool(torch.isfinite(card[key]).all())):
            bad.append(key)
    print(f'{label} f32 step, card vs CPU, batch {batch}, {len(want)} tensors; worst '
          + ', '.join(f'{k} {v[0]:.3e} ({v[1]})' for k, v in worst.items())
          + f'; gradient tol {tol:.3e} of the norm; {time.perf_counter() - t0:.2f} s')
    if bad:
        raise AssertionError(f'{label}: on the card, {len(bad)} tensors disagree with the CPU: '
                             + ', '.join(bad[:12]))


def run_cips_train_path(dev, card, **overrides):
    '''CIPS training at the recipe's 128px defaults (`overrides` change
    them), full width, bf16: warm-up (the R1 variant at step 0, the plain
    one at step 1), one 16-step cycle with no hand-written kernel launched,
    then one `sample_fn` forward: 41 bias_act launches. Then the f32 step
    on the card against the CPU.'''
    from animeface_tpu_torch.implementations.CIPS import utils as cu
    from animeface_tpu_torch.implementations.StyleGAN3.utils import draw_step_inputs
    from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss

    args = cu.default_args(**overrides)
    print('CIPS train args:', json.dumps(vars(args)))
    run = cu.build_training(args, device=dev, seed=0)
    real = _real_images(args, dev)
    t0 = time.perf_counter()
    for _ in range(2):                        # step 0: R1, step 1: plain
        run.train_step(run.state, real)
    torch.cuda.synchronize()
    print(f'CIPS train warm-up (2 steps, one per variant): {time.perf_counter() - t0:.2f} s')
    first = run.state['step']
    variants = [run.uses_r1(i) for i in range(first, first + ADA_STEPS)]
    if sum(variants) != 1:
        raise AssertionError(f'expected one R1 step in the CIPS cycle, got {variants}')
    _cycle('CIPS train', run, real, ADA_STEPS, card, lambda m: (m['g'], m['d']))
    print(f'CIPS train: R1 at cycle step {variants.index(True) + 1}')
    _reset_launches()
    images = run.sample_fn()
    torch.cuda.synchronize()
    counts = _launches()
    if counts != (CIPS_BIAS_ACT_PER_FORWARD, 0, 0, 0, 0, 0) \
            or not bool(torch.isfinite(images).all()):
        raise AssertionError(f'CIPS sample_fn after training: launches {counts} (want '
                             f'{CIPS_BIAS_ACT_PER_FORWARD} bias_act), finite '
                             f'{bool(torch.isfinite(images).all())}')
    print(f'CIPS sample_fn after training: {counts[0]} bias_act launches, finite images '
          f'{tuple(images.shape)}')
    check_step_against_cpu(
        'CIPS', lambda a, d: cu.build_models(a, d),
        lambda G, D, G_ema, g_opt, d_opt: cu.build_train_step(
            G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), args.gp_lambda, False,
            policy=args.policy),
        lambda G, real, a: draw_step_inputs(G, real, torch.Generator().manual_seed(6),
                                            a.policy),
        args, run, dev)


def _fastgan_losses(out):
    metrics, recons = out
    recon, small, recon_part, img_part = recons
    recon_loss = ((recon - small) ** 2).mean() + ((recon_part - img_part) ** 2).mean()
    return metrics['G'], metrics['D'], recon_loss


def run_fastgan_path(dev, card, **overrides):
    '''FastGAN at the BASELINE config's 256px with the recipe's defaults
    (`overrides` change them), full width, bf16, ema off: 2 warm-up steps,
    16 timed steps (finite G, D and reconstruction losses, no hand-written
    kernel launched), a finite sample; then the f32 step on the card
    against the CPU.'''
    from animeface_tpu_torch.implementations.FastGAN import utils as fu
    from animeface_tpu_torch.nnutils.loss import HingeLoss

    args = fu.default_args(**overrides)
    print('FastGAN args:', json.dumps(vars(args)))
    run = fu.build_training(args, device=dev, seed=0)
    real = _real_images(args, dev)
    t0 = time.perf_counter()
    for _ in range(2):
        run.train_step(run.state, real)
    torch.cuda.synchronize()
    print(f'FastGAN warm-up (2 steps): {time.perf_counter() - t0:.2f} s')
    _cycle('FastGAN', run, real, ADA_STEPS, card, _fastgan_losses)
    images = run.sample_fn()
    size = args.image_size
    if images.shape != (args.num_test, args.image_channels, size, size) \
            or not bool(torch.isfinite(images).all()):
        raise AssertionError('FastGAN samples are not finite or have the wrong shape')
    check_step_against_cpu(
        'FastGAN', lambda a, d: fu.build_models(a, d),
        lambda G, D, G_ema, g_opt, d_opt: fu.build_train_step(
            G, D, G_ema, g_opt, d_opt, HingeLoss(), args.policy, args.ema),
        lambda G, real, a: fu.draw_step_inputs(G, real, torch.Generator().manual_seed(6),
                                               a.policy),
        args, run, dev)


def run_stylegan2_diffaugment_path(dev, card, **overrides):
    '''StyleGAN2 with its default DiffAugment at 256px, the recipe's
    defaults otherwise (pl_lambda 0; `overrides` change them), full width,
    bf16: 1 warm-up step and 4 timed adversarial steps, finite losses, no
    hand-written kernel launched.'''
    from animeface_tpu_torch.implementations.StyleGAN2 import utils as su

    args = su.default_args(**dict(dict(image_size=IMAGE), **overrides))
    print('StyleGAN2 + DiffAugment args:', json.dumps(vars(args)))
    run = su.build_training(args, device=dev, seed=0)
    real = _real_images(args, dev)
    t0 = time.perf_counter()
    run.train_step(run.state, real)
    torch.cuda.synchronize()
    print(f'StyleGAN2 + DiffAugment warm-up (1 step): {time.perf_counter() - t0:.2f} s')
    first = run.state['step']
    if any(any(run.variant(i)) for i in range(first, first + SG2_DA_STEPS)):
        raise AssertionError('the timed StyleGAN2 + DiffAugment steps must be adversarial')
    _cycle('StyleGAN2 + DiffAugment', run, real, SG2_DA_STEPS, card,
           lambda m: (m['G'], m['D']))


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this run needs one GPU', file=sys.stderr)
        return 1
    from animeface_tpu_torch import _build, resolve_device

    dev = resolve_device('cuda')
    card = _card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True     # autotune conv algorithms in the warm-up
    print(f'torch {torch.__version__}  cuda {torch.version.cuda}  '
          f'{torch.cuda.get_device_name(0)}')

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f'kernel build: {time.perf_counter() - t0:.2f} s')
    for name, report in reports.items():
        for line in report.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    images, G_inv, kernels = check_kernels(dev)
    check_warp_against_dense(images, G_inv)
    images, G_inv, line_kernels = check_line_kernels(dev)
    check_warp_against_dense(images, G_inv)
    del images, G_inv

    kernels[0]['launches'], kernels[1]['launches'] = run_main_path(dev, card)
    torch.cuda.empty_cache()
    line_kernels[0]['launches'], line_kernels[1]['launches'] = run_ada_path(dev, card)
    kernels += line_kernels
    torch.cuda.empty_cache()

    from animeface_tpu_torch.ops import setup_filter
    fu = setup_filter(np.hanning(12), device=dev)
    bias_act_entry = check_bias_act_kernel(dev)
    flrelu_entry = check_filtered_lrelu_kernel(dev, fu)
    check_grad_refused(dev, fu)
    flrelu_entry['launches'] = run_flrelu_path(dev, fu)
    torch.cuda.empty_cache()
    bias_act_entry['launches'] = run_cips_path(dev, card)
    kernels += [bias_act_entry, flrelu_entry]
    for path in (run_cips_train_path, run_fastgan_path, run_stylegan2_diffaugment_path):
        torch.cuda.empty_cache()
        path(dev, card)

    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
