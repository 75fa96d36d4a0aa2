'''Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
     set TF32 off for matmuls and convolutions (f32 comparisons stay f32)
     and let cuDNN autotune its convolution algorithms;
  2. build the hand-written kernels from `animeface_tpu_torch/csrc/`;
  3. hold each kernel against its plain PyTorch version at the main-path
     shapes (StyleGAN2-ADA 256px, batch 32, f32) and time kernel, plain
     version and the byte/operation bound;
  4. drive the main path: the StyleGAN2-ADA 256px training step at full
     width (bench.py's settings, bf16 compute, p starting at 0.2, the
     default ADA knobs), one whole 16-step lazy-regularization cycle, with
     the kernels' launch counts set to 0 just before and read just after;
     check finite losses, the launch counts the cadence implies, finite
     outputs, and the kernel-path warp against the dense warp;
  5. print one JSON line of the kernels, the card line, and last
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
IMAGE = 256
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


def _main_path_warp_inputs(dev, seed=0):
    '''The warp's kernel inputs for one augment call of the main path: a
    batch of images through the default pipe's geometry draws at p = 1.'''
    from animeface_tpu_torch.nnutils.ada import make_ada_pipe
    from animeface_tpu_torch.nnutils.ada_geometry import fused_inputs, derive_axis_kernel

    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand((BATCH, 3, IMAGE, IMAGE), generator=g, device=dev) * 2 - 1
    captured = {}

    def capture(x, G_inv):
        captured['G_inv'] = G_inv
        return x

    pipe = make_ada_pipe()
    pipe._execute_geometry = capture          # keep the draws, skip the warp
    pipe(images, 1.0, generator=g)
    half, support = derive_axis_kernel()
    return images, captured['G_inv'], fused_inputs(images, captured['G_inv'], half, support)


def _bound(args):
    '''Least time for the call: bytes moved once over HBM rate, and the
    f32 operations the nonzero taps need over the f32 peak.'''
    x, t1, f1, M1, t2, f2, M2, P1, P2, We, N = args
    B, C = x.shape[:2]
    params = sum(a.numel() * a.element_size() for a in (t1, f1, M1, t2, f2, M2))
    out_bytes = B * C * N * N * 4
    moved = params + x.numel() * 4 + out_bytes        # fwd: x in, out; bwd: g in, dx out
    nnz1 = int((M1[:, :, :P1] != 0).sum())            # taps per image, summed
    nnz2 = int((M2[:, :, :P2] != 0).sum())
    macs = C * (nnz1 * We + nnz2 * N)
    blends = B * C * (P1 * We + P2 * N)
    ops = 2 * macs + 3 * blends
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def check_kernels(dev):
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    images, G_inv, args = _main_path_warp_inputs(dev)
    x = args[0]
    rest = args[1:]
    ref = agc.twopass_fused_plain(x, *rest)
    got = agc.twopass_fused(x, *rest)
    torch.cuda.synchronize()
    fwd_err = float((got - ref).abs().max())
    print(f'twopass fwd  {tuple(x.shape)} -> {tuple(got.shape)}  max_abs_err {fwd_err:.3e} '
          f'(tol {TOL})')
    if not fwd_err <= TOL:
        raise AssertionError(f'forward kernel disagrees with the plain version: {fwd_err}')

    g = torch.randn(ref.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    xr = x.clone().requires_grad_(True)
    ref_out = agc.twopass_fused_plain(xr, *rest)
    (dref,) = torch.autograd.grad(ref_out, xr, g, retain_graph=True)
    xk = x.clone().requires_grad_(True)
    got_out = agc.twopass_fused(xk, *rest)
    (dgot,) = torch.autograd.grad(got_out, xk, g, retain_graph=True)
    torch.cuda.synchronize()
    bwd_err = float((dgot - dref).abs().max())
    print(f'twopass bwd  {tuple(g.shape)} -> {tuple(dgot.shape)}  max_abs_err {bwd_err:.3e} '
          f'(tol {TOL})')
    if not bwd_err <= TOL:
        raise AssertionError(f'backward kernel disagrees with the plain version: {bwd_err}')

    fwd_ms = _time_ms(lambda: agc.twopass_fused(x, *rest))
    fwd_plain = _time_ms(lambda: agc.twopass_fused_plain(x, *rest))
    bwd_ms = _time_ms(lambda: torch.autograd.grad(got_out, xk, g, retain_graph=True))
    bwd_plain = _time_ms(lambda: torch.autograd.grad(ref_out, xr, g, retain_graph=True))
    fwd_bound, fwd_by = _bound(args)     # the backward moves and computes as much
    bwd_bound, bwd_by = fwd_bound, fwd_by
    for name, ms, plain, bound in (('fwd', fwd_ms, fwd_plain, fwd_bound),
                                   ('bwd', bwd_ms, bwd_plain, bwd_bound)):
        print(f'twopass {name}  kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {bound:.4f} ms')
    source = 'animeface_tpu_torch/csrc/ada_twopass.cu'
    return images, G_inv, [
        dict(name='ada_twopass_fwd', route='cuda', source=source,
             replaces='animeface_tpu/nnutils/ada_geometry_tpu.py:186',
             launches=None, max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain,
             bound_ms=fwd_bound, bound_by=fwd_by, library_ms=None),
        dict(name='ada_twopass_bwd', route='cuda', source=source,
             replaces='animeface_tpu/nnutils/ada_geometry_tpu.py:216',
             launches=None, max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain,
             bound_ms=bwd_bound, bound_by=bwd_by, library_ms=None),
    ]


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
    losses = []
    t0 = time.perf_counter()
    for i in range(1, D_K + 1):
        m = steps[pick(i)](state, real)
        losses.append((m['G'], m['D']))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (agc.fwd_launches, agc.bwd_launches)

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
    same 256px batch: the repo's own reference for the two-pass geometry.'''
    from animeface_tpu_torch.nnutils.ada_geometry import twopass_warp
    got = twopass_warp(images[:4], G_inv[:4])
    want = twopass_warp(images[:4], G_inv[:4], fused=False)
    err = float((got - want).abs().max())
    print(f'warp (kernel path) vs dense warp, 4 x 256px: max_abs_err {err:.3e} (tol {TOL})')
    if not err <= TOL:
        raise AssertionError(f'kernel-path warp disagrees with the dense warp: {err}')


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
    launches = run_main_path(dev, card)
    kernels[0]['launches'], kernels[1]['launches'] = launches

    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
