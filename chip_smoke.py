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
     warp at both sizes;
  4. drive the StyleGAN2-ADA 256px training step at full width (bench.py's
     settings, bf16 compute, p starting at 0.2, the default ADA knobs), one
     whole 16-step lazy-regularization cycle, with the two-pass kernels'
     launch counts set to 0 just before and read just after; check finite
     losses and the launch counts the cadence implies;
  5. drive the ADA recipe (StyleGAN3 + AugmentPipe) at its 128px CLI
     defaults at full width (batch 32, bf16 compute, p starting at 0.2),
     one 16-step cycle of 15 plain steps and 1 additive-R1 step, with the
     line kernels' launch counts set to 0 just before and read just after;
     check finite losses, 96 forward and 32 backward launches, a finite
     G_ema sample; profile one step of each variant;
  6. print one JSON line of the kernels, the card line, and last
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
D_K, G_K = 16, 8


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
    return images, G_inv, _pair_entries('ada_twopass', (186, 216), held,
                                        _bound(*_twopass_work(*args)))


def run_main_path(dev, card):
    from animeface_tpu_torch.implementations.StyleGAN2.utils import (
        build_models, build_train_step, make_optimizers)
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
    from animeface_tpu_torch.nnutils.ada import make_ada_pipe, ada_init_state
    from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
    from animeface_tpu_torch.nnutils.rng import make_generator

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
        profile_step(name, variant, state, real)
    return launches


def profile_step(name, step, state, real):
    '''Device time by kernel over one step (torch.profiler), and the
    device's busy share of that step's wall time under the profiler.'''
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, real)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    if not rows:
        print('profile: the profiler recorded no device time (busy share not measured)')
        return
    busy_ms = sum(r[0] for r in rows)
    print(f'profile, one {name} step: wall {wall_ms:.1f} ms, device busy '
          f'{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(rows)} kernels')
    for ms, count, key in rows[:10]:
        print(f'  {ms:9.3f} ms  x{count:5d}  {key[:100]}')


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
    pass shapes; times and bounds summed over the two passes of one warp.'''
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    images, G_inv = _warp_draws(dev, ADA_IMAGE, seed=2)
    total = dict.fromkeys(('fwd_err', 'bwd_err', 'fwd', 'fwd_plain', 'bwd', 'bwd_plain'), 0.0)
    bound_ms, bound_by = 0.0, set()
    for k, (z, t, f, M) in enumerate(_line_pass_inputs(images, G_inv), 1):
        held = _hold(f'linepass pass {k}', agc.linepass_fused, agc.linepass_fused_plain,
                     z, (t, f, M), seed=k)
        for key, v in held.items():
            total[key] = max(total[key], v) if key.endswith('_err') else total[key] + v
        ms, by = _bound(*_line_work(z, t, f, M))
        bound_ms += ms
        bound_by.add(by)
    bound = (bound_ms, 'bytes' if bound_by == {'bytes'} else 'operations')
    return images, G_inv, _pair_entries('ada_linepass', (59, 71), total, bound)


def run_ada_path(dev, card, **overrides):
    '''The ADA recipe at its 128px CLI defaults (`overrides` change them),
    full width: warm-up (the R1 variant at step 0, the plain one at step 1),
    then one 16-step cycle with the kernels' counts read around it.'''
    from animeface_tpu_torch.implementations.ADA.utils import build_training, default_args
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

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
    first = state['step']
    variants = [run.uses_r1(i) for i in range(first, first + ADA_STEPS)]
    losses = []
    t0 = time.perf_counter()
    for _ in range(ADA_STEPS):
        m = run.train_step(state, real)
        losses.append((m['G'], m['D']))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (agc.line_fwd_launches, agc.line_bwd_launches)
    twopass = (agc.fwd_launches, agc.bwd_launches)

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

    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
