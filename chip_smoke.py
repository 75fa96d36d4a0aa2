'''Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
     set TF32 off for matmuls and convolutions (f32 comparisons stay f32)
     and let cuDNN autotune its convolution algorithms, among the first 3
     of its heuristics' candidates for each convolution (BENCHMARK_LIMIT);
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
 10. drive FastGAN at 256px with the recipe's defaults otherwise (batch 32,
     bf16, ema off): 2 warm-up steps, 16 timed steps with finite G, D and
     reconstruction losses and no hand-written kernel launched, a finite
     sample, one profiled step, the f32 step against the CPU;
 11. drive StyleGAN2 with its default DiffAugment at 256px (the recipe's
     defaults, batch 32, bf16, pl_lambda 0): 1 warm-up step, 4 timed
     adversarial steps, finite losses, no hand-written kernel launched,
     one profiled step;
 12. drive the training CLI, `python -m animeface_tpu_torch <recipe>
     --synthetic-data`, in-process through `__main__.main` with the result
     directories in a temporary ANIMEFACE_IMPLEMENTATIONS_DIR, at the
     recipes' defaults (full width, batch 32, bf16): ADA at 128px for 20
     steps saving every 10, then `--resume` from its checkpoint directory
     to 24: 6 line-pass forward and 2 backward launches a step (120/40)
     and no other hand-written kernel; StyleGAN2 at 256px for 17 steps
     saving every 16 (the R1 step at 16), then a resume to 18: no
     hand-written kernel. Each: the artifacts (args-*.json, the grids,
     G_<step>.pt, checkpoints with finite losses), every step's variant
     from its index (lazy R1 for StyleGAN2, additive R1 for ADA) in both
     runs, the resumed run from the restored step with the checkpoint's
     controller state; images/s over a window of steps without a snapshot
     or an R1 step beside the direct run's, the loader's time a batch,
     each checkpoint's seconds and MiB;
 13. drive StyleGAN3 at 256px (the recipe's defaults otherwise, batch 32,
     bf16, DiffAugment): a warm-up step of each variant, one 16-step cycle
     (15 plain, 1 additive R1) with no hand-written kernel launched,
     images/s, peak memory, one profiled plain step, G_ema and D in f32 on
     the card against the CPU on 2 latents;
 14. drive the CLI as in 12 for DCGAN and WGAN-gp at 64px (20 steps saving
     every 10, resumed to 24 and 25; WGAN-gp's G steps at 4, 9, ..., 24),
     GAN and WGAN at 64px (10 steps, resumed to 12; WGAN's D within
     +-0.01), CIPS at 128px (17 steps saving every 16, resumed to 18; R1 at
     0 and 16; 41 bias_act launches for each sample forward of a snapshot
     and none in the steps) and FastGAN at 256px (likewise, with
     `recon.jpg`); before each of the four 64px recipes, 10 steps of its
     `build_training` on one batch, the direct images/s its CLI's stand
     beside (CIPS's and FastGAN's are phases 9 and 10); after DCGAN's and
     WGAN-gp's runs, the f32 step (WGAN-gp's full step, double backward
     included) on the card against the CPU;
     each phase's wall time and the run's total;
 15. the progressive recipes, PGGAN then StyleGAN (v1), at the modules'
     widths (up to 512) and --image-size 128 (max_depth 5; latent 100 and
     512): the recipe's step at 128px, batch 16, alpha 0.5, in each mode
     pair the phase machine produces (G_transition, stable, D_transition):
     first each pair's f32 step on the card against the CPU from the
     seeded weights (`check_step_against_cpu`; StyleGAN's noise maps
     zero), then 2 warm-up and 5 timed bf16 steps: finite
     losses, no hand-written kernel launched, ms a step, images/s, peak
     memory, one profiled stable step; then the CLI, `python -m
     animeface_tpu_torch <recipe> --synthetic-data --image-size 32
     --num-images 64 --save 30`, through four resolutions in bf16 (the
     64px and 128px ones are the direct steps' alone): the
     phase order D_stab, (G_trans, G_stab, D_trans, D_stab) x 3, alpha from
     0 to 1 in each transition, finite losses, the grids at each
     snapshot's resolution, G_<step>.pt with its sidecar G_<step>.json,
     final.png and G_final.pt, no kernel launched, the seconds of each
     resolution; for PGGAN, a kill and resume on the card: PGGAN to 8px in
     f32 in subprocesses with deterministic algorithms, one run
     uninterrupted and one SIGKILLed after ckpt-2 (the 4 -> 8px growth
     boundary) and, resumed, after ckpt-3 (inside the 8px G_transition),
     each resumed to the end by a process started beside the killed one:
     G_final.pt bitwise equal (or within 1e-4 of each
     tensor's scale where a warning names an op without a deterministic
     kernel); each recipe's wall time;
 16. the BigGAN family at the CLI's defaults (128px, channels 64, z 120,
     batch 32, bf16), BigGAN then SEBigGAN: the direct steps of
     `build_training` on one batch (2 warm-up and 5 timed steps; BigGAN
     --deep 1 and 2) with the layers' GMAC and the step's
     TFLOP, ms a step, images/s and peak memory, no hand-written kernel
     launched, one profiled BigGAN step; the CLI a block shallower at
     64px, 5 steps saving every 4 and a resume to 6 (`run_cli_path`); the
     f32 step on the card
     against the CPU from the CLI run's last checkpoint (SEBigGAN's ICR
     step with its draws z and n; the structurally zero gradients, conv
     biases that a train-mode BatchNorm follows, left out of S and held
     below 1e-5 of their model's largest norm); each part's seconds and
     each recipe's wall time;
 17. the simple-GAN recipes at their CLI's defaults (full width, batch 32,
     bf16; TransGAN at 64px, where its last stage's attention over 4,096
     tokens fits the card, HiT, ConvNeXt and VAN at 128px), cuDNN's
     autotuning as each CLI has it (off for ConvNeXt and VAN): the direct
     steps of `build_training` on one batch (the models' forward FLOP from
     the shapes, 2 warm-up and 5 timed steps, ConvNeXt and VAN 1 and 1: ms
     a step, images/s, TFLOP/s, peak memory, no hand-written kernel
     launched, one profiled step); the CLI, 3 steps saving at 3 and a
     resume to 4 (`run_cli_path`; a stage shallower: TransGAN at 32px,
     ConvNeXt and VAN at 64px); the f32 step on the card against the CPU
     from the CLI run's last checkpoint (the R1 variant, HiT's plain one;
     TransGAN without dropout); each part's seconds; then `python -m
     animeface_tpu_torch.generate` in-process on
     the StyleGAN2 CLI run's newest G_<step>.pt at that run's widths: the
     plain, truncated and mixed grids (16 images, bf16), each PNG's size,
     finite images in [-1, 1], no hand-written kernel launched, and the
     plain flow in f32 on the card against the CPU on 4 images within
     1e-3 of the images' scale;
 18. the paired data tasks: every task's loader (`build_loader`: image,
     celeba, sr, xdog, gray, label, onehot) on its synthetic stand-in at
     the CLI's defaults (128px, batch 32, 128 images) for one epoch
     through `Accelerator.iter_loader`: each batch on the card, images
     NCHW float32 in [-1, 1], int32 labels and one-hot rows, each task's
     seconds and ms a batch; then pix2pix (xdog: line art to image), SRGAN
     and ESRGAN (sr: 64px to 128px) at their CLI's defaults (full width,
     batch 32, bf16): the direct steps of `build_training` on one paired
     batch (the models' and VGG16's forward FLOP, 2 warm-up and 5 timed
     steps: ms a step, images/s, TFLOP/s, peak memory, no hand-written
     kernel launched, one profiled step), the CLI, 5 steps saving at 4 and
     a resume to 6 (the grids of three columns), and the f32 step on the
     card against the CPU from the CLI run's last checkpoint (every image
     of the pair nudged; SRGAN's and ESRGAN's spectral norms' u after the
     step held; conv biases that an instance norm follows structurally
     zero); each part's seconds and the phases' total;
 19. the line-art recipes of the xdog task, NAFNet, Restormer, pix2pixHD,
     CycleGAN, normalizations, SPADE and SCFT, at their CLI's defaults
     (128px, full width, batch 32, bf16, no cuDNN autotuning as their
     CLIs): the direct steps of `build_training` on one paired batch
     (pix2pixHD's local fine step; the models' and VGG16's forward FLOP, 2
     warm-up and 5 timed steps: ms a step, images/s, TFLOP/s, peak memory,
     no hand-written kernel launched, one profiled step); the CLI a stage
     shallower at 64px (SPADE's and SCFT's at 128px, where their Ds work),
     5 steps saving at 4 and a resume to 6 (pix2pixHD: first its global invocation at 32px,
     which writes global_final.pt, then the local one from it, 64 images
     and fine_from 1, so that steps 0-1 train the local G alone and 2-5
     everything, each step's variant recorded); the f32 step on the card
     against the CPU from the CLI run's last checkpoint (pix2pixHD's fine
     step, CycleGAN's with spectral norm and S over both Ds' logits,
     SPADE's with its encoder's noise the draw z, SCFT's with the TPS
     offsets); each part's seconds and the phases' total;
 20. the metrics, on the snapshots that phase 12 left in place: the
     InceptionV3 extractor at full size on random weights that do not
     collapse (He-normal kernels, BN variances in [0.5, 1.5], from a fixed
     seed, written to a temporary .npz in the converter's layout and read
     through ANIMEFACE_INCEPTION_WEIGHTS), in f32 on the card against the
     CPU on 2 images of 256px (the resize to 299 included) within 1e-3 of
     the features' scale, its images/s at batch 64 and peak memory; the
     port's statistics, Frechet distance and KID (4 subsets) of two sets of
     2560 features in f64 on the card against a numpy copy of the same
     formulas within 1e-9 relative; `fid_cli.main` in-process on the
     StyleGAN2 CLI run's newest G_<step>.pt (256px, 1024 samples, batch 64,
     --kid: finite FID and KID, the seconds of the real stream, the fake
     stream, the statistics and the KID); `fid_trend.main` in-process on
     the ADA CLI run's result directory (128px, latent 512, 256 samples:
     trend.json with a finite fd for every snapshot, exit 0 when the gate
     holds and 1 when it fails, the verdict printed), and with `--model
     PGGAN` on the PGGAN CLI run's (32px, each snapshot sampled at its
     sidecar's resolution and alpha, which are printed); `VGGLoss(vgg=16)` at
     256px, batch 32, f32 (finite losses and gradient with respect to the
     fakes, ms a forward plus backward; at batch 2 pooled to 128px the
     card against the CPU with the step gate's tolerances); no hand-written
     kernel launched; its wall time;
 21. print one JSON line of the kernels, the card line, and last
     {"ok": true, "device": {...}}.
The card-vs-CPU step gate (`check_step_against_cpu`) runs the step in
f32 on the card first, recording the branch of every sign-dependent call
(`animeface_tpu_torch/utils/branches.py`), then in float64 replaying those
branches: three times on the card with the inputs moved by 1e-6, and once
on the CPU, the reference, in a thread beside the phases that follow
(`deferred_gates`). From the nudges (`nudged_tolerances`): S, the
gradients' largest relative L2 move,
widens the gradients' tolerance to 1e-3 + 2 S of their norm, and each
loss's own largest move d widens its tolerance to 1e-3 of its value + 2 d
(both capped at 0.1 of the gradient's norm and of the loss's summands).
It prints the branches replayed and how many elements the card took the
other way, each nudge's S, each loss's sensitivity and error over its
tolerance, and each gate's worst/tolerance ratio (`GATE <label>: ...`).
A failing phase is named on stderr (`chip_smoke: phase <name> failed`).
Imports nothing of JAX or of the JAX package.
'''

from __future__ import annotations

import concurrent.futures
import contextlib
import contextvars
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
#: the algorithms cuDNN's autotuning times for each new convolution (PyTorch's
#: default is 10): on an H100 the main path's warm-up took 31.19 s with 3
#: against 45.95-66.28 s with 10 and its cycle the same (1 made the penalty
#: steps 40% slower), FastGAN's 3.73 s against 17.05 and ADA's 11.01 against
#: 21.01 (`time_chip_smoke_parts.py limit-paths`, `limit-main`). The f32 step
#: gates replay the card's branches, so the algorithms the card picks move
#: no kink
BENCHMARK_LIMIT = 3
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
    counted, so they are left out. The device events are summed by name
    straight from the trace (`kineto_results`): `key_averages()` first
    builds an event object for every host op and launch, minutes for a step
    of 100k launches. Returns the rows (ms, count, kernel name), largest
    first.'''
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not getattr(e, 'is_user_annotation',
                                                              lambda: False)():
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    rows = sorted(((ms, count, key) for key, (ms, count) in by_name.items() if ms > 0),
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
    return launches, args.batch_size * ADA_STEPS / dt


def check_models_against_cpu(run, args, dev, batch=2, rtol=1e-3, label='ADA'):
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
        print(f'{label} G_ema/D f32, card vs CPU, {batch} samples: {what} max_abs_err {err:.3e} '
              f'(scale {scale:.3e}, tol {rtol} x scale)')
        if not (bool(torch.isfinite(got).all()) and err <= rtol * scale):
            raise AssertionError(f'{what} on the card disagree with the CPU: {err} vs {scale}')
    print(f'{label} card vs CPU check: {time.perf_counter() - t0:.2f} s')


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


def _to(obj, device, dtype=None):
    '''Tensors in nested dicts, lists and tuples, on `device`; with `dtype`,
    the floating-point ones as copies in it.'''
    if isinstance(obj, torch.Tensor):
        if dtype is not None and obj.is_floating_point():
            return obj.to(device, dtype, copy=True)
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device, dtype) for v in obj)
    return obj


def _map_images(fn, real):
    '''`fn` of the reals, or of each image of a paired batch.'''
    return tuple(fn(x) for x in real) if isinstance(real, tuple) else fn(real)


def _real_images(args, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    channels = getattr(args, 'image_channels', 3)
    return torch.rand((args.batch_size, channels, args.image_size, args.image_size),
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


def _model_of(key):
    '''The model of a 'grad G.x' or 'grad D.x' key: its word after 'grad'.'''
    return key.split()[1].split('.')[0]


def nudged_tolerances(want, moved, rtol=1e-3, max_nudged=0.1, loss_scales=None,
                      zero_grad=None):
    '''The gate's tolerances from a CPU run and its nudged reruns.

    `want` maps keys to float64 tensors of the CPU run; `moved` yields the
    same maps from reruns whose inputs moved by f32 rounding (each is read
    once). For the 'grad ...' keys, S is the largest L2 change, relative to
    its norm, that any nudge makes to any gradient, and each gradient is
    held in L2 to (rtol + 2 S) of its norm. For each 'loss ...' key, its own
    sensitivity d is the largest change any nudge makes to it, and the loss
    is held to rtol * |loss| + 2 d: a mean of a few summands that nearly
    cancel (a WGAN loss over 2 logits) moves by a large share of itself
    under f32 rounding of any one. Either check would say nothing if the
    nudges moved too much, so S above `max_nudged` raises, and so does a d
    above `max_nudged` times the loss's scale: `loss_scales[key]`, the
    magnitude of its summands (not of a mean that may be near 0), default
    |loss|.

    The option `zero_grad`, for steps where that rule cannot hold: a
    gradient whose norm is below `zero_grad` of its model's largest
    gradient norm is structurally zero (a conv bias that a train-mode
    BatchNorm follows: f32 rounding on either side, which moves by its
    whole size). It is left out of S and of the relative check, and the
    card's must lie within that bound (`zero_grad` of the model's largest
    norm) of the CPU's in L2.

    Returns dict(S, S_key, per_nudge [(S, key) for each nudge], grad_tol,
    grad_norms {key: norm}, zero_grads {key: bound}, loss_sens {key: d},
    loss_tol {key: tolerance}).'''
    loss_scales = loss_scales or {}
    grads = [k for k in want if k.startswith('grad')]
    losses = [k for k in want if k.startswith('loss')]
    norms = {k: max(float(want[k].norm()), 1e-30) for k in grads}
    zero = {}
    if zero_grad is not None:
        top = {}
        for k in grads:
            top[_model_of(k)] = max(top.get(_model_of(k), 0.0), norms[k])
        zero = {k: zero_grad * top[_model_of(k)] for k in grads
                if norms[k] < zero_grad * top[_model_of(k)]}
    held = [k for k in grads if k not in zero]

    def rel_l2(a, b):
        return {k: float((a[k] - b[k]).norm()) / norms[k] for k in held}

    per_nudge, loss_sens = [], dict.fromkeys(losses, 0.0)
    for m in moved:
        per_nudge.append(max(((v, k) for k, v in rel_l2(m, want).items()), default=(0.0, '')))
        for key in losses:
            loss_sens[key] = max(loss_sens[key], float((m[key] - want[key]).abs().max()))
    S = max(per_nudge, default=(0.0, ''))
    if S[0] > max_nudged:
        raise AssertionError(f'a nudge of the inputs moves {S[1]} by {S[0]:.3e} of its '
                             'norm on the CPU: too sensitive to hold the card against')
    loss_tol = {}
    for key in losses:
        size = float(want[key].abs().max())
        scale = max(float(loss_scales.get(key, 0.0)), size)
        if loss_sens[key] > max_nudged * scale:
            raise AssertionError(f'a nudge of the inputs moves {key} by {loss_sens[key]:.3e} at a '
                                 f'summand scale of {scale:.3e}: too sensitive to hold the card '
                                 'against')
        loss_tol[key] = rtol * size + 2 * loss_sens[key]
    return dict(S=S[0], S_key=S[1], per_nudge=per_nudge, grad_tol=rtol + 2 * S[0],
                grad_norms=norms, zero_grads=zero, loss_sens=loss_sens, loss_tol=loss_tol)


def gate_ratios(card, want, tols):
    '''Each loss's and gradient's error on the card over its tolerance from
    `nudged_tolerances` (above 1 fails): a loss's absolute error, a
    structurally zero gradient's L2 error, any other gradient's L2 error
    relative to its norm.'''
    out = {}
    for key, w in want.items():
        if key.startswith('loss'):
            err, tol = float((card[key] - w).abs().max()), tols['loss_tol'][key]
        elif key in tols['zero_grads']:
            err, tol = float((card[key] - w).norm()), tols['zero_grads'][key]
        elif key.startswith('grad'):
            err = float((card[key] - w).norm()) / tols['grad_norms'][key]
            tol = tols['grad_tol']
        else:
            continue
        out[key] = (float('inf') if not np.isfinite(err) or (tol <= 0 and err > 0)
                    else err / tol if tol > 0 else 0.0)
    return out


def _print_loss_gate(label, want, tols, ratios):
    '''Print each loss's sensitivity and error over its tolerance; returns
    the worst ratio.'''
    keys = list(tols['loss_tol'])
    print(f'{label} losses, card vs CPU: ' + '; '.join(
        f'{k} {float(want[k]):.6g}: sensitivity {tols["loss_sens"][k]:.3e}, tolerance '
        f'{tols["loss_tol"][k]:.3e}, err/tol {ratios[k]:.3f}' for k in keys))
    return max((ratios[k] for k in keys), default=0.0)


class DeferredGates:
    '''The step gates' CPU references, run one at a time in a thread of
    their own while the run goes on (`deferred_gates`). Each gate's card runs
    are done when it is submitted; `drain()` waits for every reference in
    order and raises the first gate's error, named with the phase that
    submitted it.'''

    def __init__(self):
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.pending = []

    def submit(self, label, reference):
        self.pending.append((_PHASE.get(), label, self.pool.submit(reference)))

    def drain(self):
        try:
            for name, label, future in self.pending:
                try:
                    future.result()
                except BaseException as e:
                    print(f'chip_smoke: phase {name} failed: {label} gate: {type(e).__name__}: '
                          f'{e}', file=sys.stderr, flush=True)
                    raise
        finally:
            self.pool.shutdown(cancel_futures=True)


#: the current phase's name (`phase`) and, inside `deferred_gates`, where
#: the step gates send their CPU references
_PHASE = contextvars.ContextVar('phase', default='')
_DEFERRED = contextvars.ContextVar('deferred_gates', default=None)


@contextlib.contextmanager
def deferred_gates():
    '''Inside, `check_step_against_cpu` hands its float64 CPU reference to
    a `DeferredGates` and returns None; on leaving, every reference is
    waited for (the first failure raises).'''
    gates = DeferredGates()
    token = _DEFERRED.set(gates)
    try:
        yield gates
    except BaseException:
        gates.pool.shutdown(wait=False, cancel_futures=True)
        raise
    finally:
        _DEFERRED.reset(token)
    gates.drain()


def _float64(module):
    '''`module` in float64, its compute dtype too (the gate's reference runs).'''
    module = module.double()
    for m in module.modules():
        if getattr(m, 'dtype', None) == torch.float32:
            m.dtype = torch.float64
    return module


def check_step_against_cpu(label, build_models, make_step, draw, args, run, dev, batch=2,
                           rtol=1e-3, nudge=1e-6, max_nudged=0.1, nudges=3, zero_grad=None,
                           make_real=None, d_logits=None, hooked=None):
    '''One training step at full width in float32 on the card (TF32 off)
    against the same step in float64 on the CPU that takes the card's
    branches, from `run`'s weights and buffers (its G, D and G_ema: modules
    or state dicts) and the same draws (made on the CPU). Plain SGD on both
    sides, so the G phase sees the same D (an Adam step with beta1 = 0 is
    about lr * sign(g) and would turn a last-bit difference of a near-zero
    gradient into 2 lr).
    The card's float32 run goes first, under `utils.branches.Branches`,
    which records the branch of every sign-dependent call (ReLU and leaky
    ReLU inputs, a hinge, clamps, abs, comparisons, max pooling); the
    float64 runs replay them, so that where an input lies within f32
    rounding of a kink both sides differentiate the same side of it (a call
    sequence that differs from the card's raises).
    Every buffer after the step (spectral norm's u, running statistics,
    moments) must agree to `rtol` of its largest magnitude. A gradient or a
    loss of such a step still moves by more than that when its inputs move
    at f32 rounding (BatchNorm's E[x^2] - E[x]^2 cancels; a mean of two
    nearly cancelling logits), by an amount that varies from tensor to
    tensor and draw to draw. So the step runs again `nudges` times in
    float64 with the card's branches replayed, each with the reals and z
    moved by `nudge` * N(0, 1) (about 8 ulps of a value near 1) from a
    generator of its own seed; these smooth moves are the function's, and
    run on the card, where float64 costs a second. `nudged_tolerances` turns
    what they change into the gradients' S (every gradient within rtol + 2 S
    of its norm in L2) and each loss's own sensitivity d (within rtol *
    |loss| + 2 d), capped at `max_nudged` of the gradient's norm and of the
    loss's summands (the largest |output| of D in the CPU step); `zero_grad`
    is its option. The float64 CPU reference, the run the card is held
    against, runs on the nudges' models moved to the CPU and takes every
    intra-op thread; inside `deferred_gates` it runs in a thread of its own
    while the caller goes on (its step made before, here, so that no
    recipe function a later phase wraps is read there), and this returns
    None.
    `build_models(args, device)` returns (G, D, G_ema), G_ema None for a
    recipe without one. A paired recipe's batch is a tuple of images
    (`make_real(args, device, seed)` makes it; every image is nudged) and
    its draws may have no z; `d_logits(output)` picks the tensors of D's
    output whose largest |value| is the losses' summand scale (default:
    the output's tensors, or those of its tuple or list), and
    `hooked(D)` the modules whose outputs those are (default D itself).
    Prints the branches replayed and how many elements the card took the
    other way, S for each nudge, each loss's sensitivity and error over its
    tolerance, and each gate's worst error over its tolerance; returns
    those ratios.'''
    from animeface_tpu_torch.utils.branches import Branches

    f32 = SimpleNamespace(**dict(vars(args), no_bf16=True, batch_size=batch))
    cpu = torch.device('cpu')
    real = (make_real or _real_images)(f32, cpu, seed=5)
    d_logits = d_logits or (lambda o: o if isinstance(o, (tuple, list)) else (o,))
    states = {name: m if isinstance(m, dict) else m.state_dict()
              for name, m in (('G', run.G), ('D', run.D), ('G_ema', getattr(run, 'G_ema', None)))
              if m is not None}
    run_s = {}

    def build(device, dtype):
        '''G, D and G_ema on `device` in `dtype`.'''
        return tuple(m if m is None or dtype == torch.float32 else _float64(m)
                     for m in build_models(f32, device))

    def prepare(models, device, dtype, seed):
        '''The step on `models` (on `device`, in `dtype`) from `run`'s state,
        and its inputs: (step, state, images, draws, (G, D)). Made where the
        caller is, so that the recipe's functions are read there.'''
        G, D, G_ema = models
        for name, mine in (('G', G), ('D', D), ('G_ema', G_ema)):
            if mine is not None:
                mine.load_state_dict(states[name])
                for p in mine.parameters():
                    p.grad = None
        state = dict(step=0, generator=torch.Generator(device=device).manual_seed(0))
        step = make_step(G, D, G_ema, torch.optim.SGD(G.parameters(), lr=1e-3),
                         torch.optim.SGD(D.parameters(), lr=1e-3))
        draws = _to(draw(G, real, f32), cpu, dtype)
        images = _to(real, cpu, dtype)
        if seed is not None:
            g = torch.Generator().manual_seed(seed)
            images = _map_images(
                lambda x: x + nudge * torch.randn(x.shape, generator=g, dtype=dtype), images)
            if 'z' in draws:
                draws['z'] = draws['z'] + nudge * torch.randn(draws['z'].shape, generator=g,
                                                              dtype=dtype)
        return step, state, _to(images, device), _to(draws, device), (G, D)

    def execute(prepared, branches, key):
        '''The prepared step under `branches`: its losses, gradients and
        buffers (float64, on the CPU) and the largest |output| of D in it;
        its seconds go to run_s[key].'''
        t_run = time.perf_counter()
        step, state, images, draws, (G, D) = prepared
        sizes = []
        hooks = [m.register_forward_hook(lambda m, i, o: sizes.append(max(
            (float(t.detach().abs().max()) for t in d_logits(o) if isinstance(t, torch.Tensor)),
            default=0.0))) for m in (hooked(D) if hooked else (D,))]
        try:
            with branches:
                metrics = step(state, images, draws)
        finally:
            for hook in hooks:
                hook.remove()
        branches.done()
        if isinstance(metrics, tuple):
            metrics = metrics[0]
        got = {f'loss {k}': v.detach().cpu() for k, v in metrics.items()}
        for name, module in (('G', G), ('D', D)):
            got.update({f'grad {name}.{n}': p.grad.cpu() for n, p in module.named_parameters()})
            got.update({f'buffer {name}.{n}': b.cpu() for n, b in module.named_buffers()})
        run_s[key] = time.perf_counter() - t_run
        return {k: v.double() for k, v in got.items()}, max(sizes, default=0.0)

    # on the card: the float32 run recording its branches, then the float64
    # nudges replaying them (no autotuning of the float64 shapes); the
    # reference's step is made here too, on the float64 models moved to the
    # CPU, and only run in the reference's thread
    t0 = time.perf_counter()
    record = Branches()
    card, _ = execute(prepare(build(dev, torch.float32), dev, torch.float32, None), record,
                      'card')
    models = build(dev, torch.float64)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        moved = [execute(prepare(models, dev, torch.float64, 7 + k),
                         Branches(replay=record.taken), 7 + k)[0] for k in range(nudges)]
    finally:
        torch.backends.cudnn.benchmark = benchmark
    taken = record.on(cpu)
    del record
    reference_step = prepare(tuple(None if m is None else m.to(cpu) for m in models), cpu,
                             torch.float64, None)
    del models
    t_card = time.perf_counter() - t0

    def reference():
        '''The float64 CPU run replaying the card's branches; holds the card
        against it and prints the gate (docstring).'''
        t1 = time.perf_counter()
        unmoved = Branches(replay=taken)
        want, d_size = execute(reference_step, unmoved, 'cpu')
        try:
            tols = nudged_tolerances(want, moved, rtol, max_nudged,
                                     {k: d_size for k in want if k.startswith('loss')}, zero_grad)
        except AssertionError as e:
            raise AssertionError(f'{label}: {e}') from None
        kinds = {}
        for b in taken:
            kinds[b.op] = kinds.get(b.op, 0) + 1
        print(f'{label} f32 step: the card\'s {len(taken)} branching calls ('
              + ', '.join(f'{k} {v}' for k, v in kinds.items())
              + f'; {sum(b.taken.numel() for b in taken)} elements) replayed in float64; the '
              f'card took {unmoved.flips} of them the other way from the CPU\'s own')
        print(f'{label} f32 step: S per nudge (seeds 7-{6 + nudges}, float64 on the card) '
              + ', '.join(f'{v:.3e} ({k})' for v, k in tols['per_nudge']))
        gated = gate_ratios(card, want, tols)
        loss_ratio = _print_loss_gate(label, want, tols, gated)
        zero, tol = tols['zero_grads'], tols['grad_tol']
        held = [k for k in want if k.startswith('grad') and k not in zero]
        worst = {'buffer max': (0.0, ''),
                 'grad l2': max(((gated[k] * tol, k) for k in held), default=(0.0, '')),
                 'nudged grad l2 (S)': (tols['S'], tols['S_key'])}
        bad = []
        for key, w in want.items():
            if key in gated:
                ok = gated[key] <= 1
            else:
                rel = float((card[key] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                worst['buffer max'] = max(worst['buffer max'], (rel, key))
                ok = rel <= rtol
            if not (ok and bool(torch.isfinite(card[key]).all())):
                bad.append(key)
        ratios = {'loss': loss_ratio, 'buffer': worst['buffer max'][0] / rtol,
                  'grad': worst['grad l2'][0] / tol}
        if zero:
            ratios['zero grad'] = max(gated[k] for k in zero)
            print(f'{label}: {len(zero)} structurally zero gradients (below {zero_grad} of '
                  f'their model\'s largest norm) left out of S, each within that bound of the '
                  f'CPU\'s: worst err/bound {ratios["zero grad"]:.3f}')
        print(f'{label} f32 step, card vs CPU, batch {batch}, {len(want)} tensors; worst '
              + ', '.join(f'{k} {v[0]:.3e} ({v[1]})' for k, v in worst.items())
              + f'; gradient tol {tol:.3e} of the norm; worst/tol: loss {ratios["loss"]:.3f}, '
              f'buffer {ratios["buffer"]:.3f}, grad {ratios["grad"]:.3f}; on the card '
              f'{t_card:.2f} s (the f32 run {run_s["card"]:.2f} s, the float64 nudges '
              + ', '.join(f'{run_s[7 + k]:.2f}' for k in range(nudges))
              + f' s, the builds included), the CPU reference {time.perf_counter() - t1:.2f} s '
              f'(its run {run_s["cpu"]:.2f} s)')
        print(f'GATE {label}: worst/tol {max(ratios.values()):.3f}')
        if bad:
            raise AssertionError(f'{label}: on the card, {len(bad)} tensors disagree with the '
                                 'CPU: ' + ', '.join(bad[:12]))
        return ratios

    deferred = _DEFERRED.get()
    if deferred is None:
        return reference()
    deferred.submit(label, reference)
    return None


def run_cips_train_path(dev, card, **overrides):
    '''CIPS training at the recipe's 128px defaults (`overrides` change
    them), full width, bf16: warm-up (the R1 variant at step 0, the plain
    one at step 1), one 16-step cycle with no hand-written kernel launched,
    then one `sample_fn` forward: 41 bias_act launches. Then the f32 step
    on the card against the CPU. Returns the cycle's images/s.'''
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
    dt = _cycle('CIPS train', run, real, ADA_STEPS, card, lambda m: (m['g'], m['d']))
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
    return args.batch_size * ADA_STEPS / dt


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
    against the CPU. Returns the 16 steps' images/s and the gate's
    worst/tolerance ratios.'''
    from animeface_tpu_torch.implementations.FastGAN import utils as fu

    args = fu.default_args(**dict(dict(image_size=IMAGE), **overrides))
    print('FastGAN args:', json.dumps(vars(args)))
    run = fu.build_training(args, device=dev, seed=0)
    real = _real_images(args, dev)
    t0 = time.perf_counter()
    for _ in range(2):
        run.train_step(run.state, real)
    torch.cuda.synchronize()
    print(f'FastGAN warm-up (2 steps): {time.perf_counter() - t0:.2f} s')
    dt = _cycle('FastGAN', run, real, ADA_STEPS, card, _fastgan_losses)
    images = run.sample_fn()
    size = args.image_size
    if images.shape != (args.num_test, args.image_channels, size, size) \
            or not bool(torch.isfinite(images).all()):
        raise AssertionError('FastGAN samples are not finite or have the wrong shape')
    return args.batch_size * ADA_STEPS / dt, check_fastgan_step_against_cpu(args, run, dev)


def check_fastgan_step_against_cpu(args, run, dev):
    '''FastGAN's f32 step on the card against the CPU from `run`'s models.'''
    from animeface_tpu_torch.implementations.FastGAN import utils as fu
    from animeface_tpu_torch.nnutils.loss import HingeLoss

    return check_step_against_cpu(
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
    dt = _cycle('StyleGAN2 + DiffAugment', run, real, SG2_DA_STEPS, card,
                lambda m: (m['G'], m['D']))
    return args.batch_size * SG2_DA_STEPS / dt


def run_stylegan3_256_path(dev, card, **overrides):
    '''StyleGAN3 at the BASELINE config's 256px with the recipe's defaults
    otherwise (DiffAugment 'color,translation', gp_lambda 3 every 16;
    `overrides` change them), full width, bf16: a warm-up step of each
    variant (R1 at step 0, plain at 1), one 16-step cycle of 15 plain
    steps and 1 additive-R1 step with no hand-written kernel launched,
    images/s, peak memory, one profiled plain step; then G_ema and D in
    f32 on the card against the CPU on 2 latents.'''
    from animeface_tpu_torch.implementations.StyleGAN3 import utils as sg3

    args = sg3.default_args(**dict(dict(image_size=IMAGE), **overrides))
    print('StyleGAN3 256px args:', json.dumps(vars(args)))
    run = sg3.build_training(args, device=dev, seed=0)
    real = _real_images(args, dev)
    t0 = time.perf_counter()
    for _ in range(2):                        # step 0: R1, step 1: plain
        run.train_step(run.state, real)
    torch.cuda.synchronize()
    print(f'StyleGAN3 256px warm-up (2 steps, one per variant): {time.perf_counter() - t0:.2f} s')
    first = run.state['step']
    variants = [run.uses_r1(i) for i in range(first, first + ADA_STEPS)]
    if sum(variants) != 1 or run.uses_r1(first + ADA_STEPS):
        raise AssertionError(f'expected one R1 step in the cycle and a plain one after it, '
                             f'got {variants}')
    _cycle('StyleGAN3 256px', run, real, ADA_STEPS, card, lambda m: (m['g'], m['d']))
    print(f'StyleGAN3 256px: R1 at cycle step {variants.index(True) + 1}')
    check_models_against_cpu(run, args, dev, label='StyleGAN3 256px')


# ------------------------------------------------------------ the training CLI

#: (recipe, flags, steps, save interval, steps after the resume, timed window
#: [first, last) of step indices: no snapshot and no R1 step inside; WGAN-gp's
#: holds critic and G steps alike)
CLI_RUNS = {
    'ADA': ((), 20, 10, 24, (1, 9)),
    'StyleGAN2': (('--image-size', str(IMAGE)), 17, 16, 18, (1, 15)),
    'DCGAN': (('--image-size', '64'), 20, 10, 24, (1, 9)),
    'WGAN_gp': (('--image-size', '64'), 20, 10, 25, (1, 9)),
    'GAN': (('--image-size', '64'), 10, 5, 12, (1, 4)),
    'WGAN': (('--image-size', '64'), 10, 5, 12, (1, 4)),
    'CIPS': ((), 17, 16, 18, (1, 15)),
    'FastGAN': (('--image-size', str(IMAGE)), 17, 16, 18, (1, 15)),
    'BigGAN': (('--image-size', '64'), 5, 4, 6, (1, 3)),
    'SEBigGAN': (('--image-size', '64'), 5, 4, 6, (1, 3)),
    'TransGAN': (('--image-size', '32'), 3, 3, 4, (1, 2)),
    'HiT': ((), 3, 3, 4, (1, 2)),
    'ConvNeXt': (('--image-size', '64'), 3, 3, 4, (1, 2)),
    'VAN': (('--image-size', '64'), 3, 3, 4, (1, 2)),
    'pix2pix': ((), 5, 4, 6, (1, 3)),
    'SRGAN': ((), 5, 4, 6, (1, 3)),
    'ESRGAN': ((), 5, 4, 6, (1, 3)),
    'NAFNet': (('--image-size', '64'), 5, 4, 6, (1, 3)),
    'Restormer': (('--image-size', '64'), 5, 4, 6, (1, 3)),
    # 64 images at batch 32: two steps an epoch; the local run's steps 0-1
    # train the local G alone (fine_from 1), steps 2 on everything
    'pix2pixHD': (('--image-size', '64', '--num-images', '64', '--fine-from', '1'), 5, 4, 6,
                  (1, 3)),
    'CycleGAN': (('--image-size', '64'), 5, 4, 6, (1, 3)),
    # SPADE's second D scale and SCFT's VALID D need 128px
    'normalizations': (('--image-size', '64'), 5, 4, 6, (1, 3)),
    'SPADE': ((), 5, 4, 6, (1, 3)),
    'SCFT': ((), 5, 4, 6, (1, 3)),
}
#: the sample grids of the recipes that set them: (images, images a row)
CLI_GRIDS = {'DCGAN': (16, 4), 'GAN': (16, 4), 'WGAN': (25, 5), 'WGAN_gp': (25, 5),
             'CIPS': (16, 4), 'FastGAN': (16, 4), 'BigGAN': (16, 4), 'SEBigGAN': (16, 4),
             'TransGAN': (16, 4), 'HiT': (16, 4), 'ConvNeXt': (16, 4), 'VAN': (16, 4),
             'pix2pix': (12, 6), 'SRGAN': (18, 9), 'ESRGAN': (18, 9), 'NAFNet': (12, 6),
             'Restormer': (12, 6), 'pix2pixHD': (12, 6), 'CycleGAN': (12, 4),
             'normalizations': (12, 6), 'SPADE': (18, 6), 'SCFT': (27, 6)}


def _variant_recorder(module, seen):
    '''A stand-in for `module.build_train_step` whose steps record
    (step index at entry, do_r1, do_pl) in `seen`.'''
    import inspect
    orig = module.build_train_step
    sig = inspect.signature(orig)

    def build(*a, **k):
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        tag = (bound.arguments['do_r1'], bound.arguments.get('do_pl', False))
        step = orig(*a, **k)

        def recorded(state, real, draws=None):
            seen.append((state['step'],) + tag)
            return step(state, real, draws)
        return recorded
    return orig, build


def _png_size(path):
    '''(width, height) from a PNG's IHDR chunk.'''
    with open(path, 'rb') as f:
        head = f.read(24)
    return tuple(int.from_bytes(head[i:i + 4], 'big') for i in (16, 20))


def _grid_size(n, nrow, size, pad=2):
    '''`utils/misc.py:_grid_uint8`'s (width, height) for n images.'''
    ncol = min(nrow, n)
    return ncol * (size + pad) + pad, -(-n // ncol) * (size + pad) + pad


def _recipe_module(recipe):
    '''The recipe's `utils` module in the port.'''
    import importlib
    return importlib.import_module(f'animeface_tpu_torch.implementations.{recipe}.utils')


def _cli_module(recipe):
    '''The module whose `run_training` (and `build_train_step`) the recipe's
    CLI calls: its own, or that of the recipe whose runtime it shares.'''
    import importlib
    if recipe in SIMPLE_GANS:
        return importlib.import_module('animeface_tpu_torch.nnutils.simple_gan')
    if recipe in PAIRED + LINE_ART:
        return importlib.import_module('animeface_tpu_torch.nnutils.paired')
    shares = {'ADA': 'StyleGAN3', 'CIPS': 'StyleGAN3', 'GAN': 'DCGAN', 'WGAN': 'DCGAN',
              'WGAN_gp': 'DCGAN', 'SEBigGAN': 'BigGAN'}
    return _recipe_module(shares.get(recipe, recipe))


def run_cli_path(recipe, card, direct_ips=None, want_line=(0, 0)):
    '''`python -m animeface_tpu_torch <recipe> --synthetic-data` in-process
    through `__main__.main`, at the recipe's defaults (full width, bf16,
    batch 32; `CLI_RUNS` sets the image size and the steps), then
    `--resume` from its checkpoint directory. Checks, in each run: the line
    kernels' launches (`want_line` a step: (forward, backward)), CIPS's 41
    bias_act launches for each sample forward of a snapshot, and no other
    hand-written kernel; the artifacts (the grids' size from `CLI_GRIDS`,
    FastGAN's `recon.jpg`); finite losses; every step took the variant of
    its index (lazy R1 for StyleGAN2, additive R1 for ADA and CIPS, G steps
    where (i + 1) % n_critic == 0 for the WGANs) and the resumed run went
    on from the restored step with the checkpoint's state; WGAN's D within
    +-clip_value. Prints images/s and ms a step over the timed window
    (beside `direct_ips`, a direct `build_training` run's, where given),
    the loader's time a batch, and each checkpoint's seconds and MiB.
    Returns the result directory and the bias_act launches of both runs.'''
    import os
    from animeface_tpu_torch import checkpoint as ckpt_mod
    from animeface_tpu_torch.__main__ import main as cli_main
    from animeface_tpu_torch.dataset.synthetic import SyntheticImage
    from animeface_tpu_torch.implementations.StyleGAN2 import utils as su
    from animeface_tpu_torch.implementations.StyleGAN3 import utils as sg3
    from animeface_tpu_torch.utils import argument

    flags, steps, save, resume_to, (t_first, t_last) = CLI_RUNS[recipe]
    module = _cli_module(recipe)
    root = os.environ['ANIMEFACE_IMPLEMENTATIONS_DIR']
    if argument.IMPLEMENTATIONS_DIR != root:
        raise AssertionError(f'result_dir writes to {argument.IMPLEMENTATIONS_DIR}, not {root}')
    out = os.path.join(root, recipe, 'result')
    ckpt_dir = os.path.join(out, 'checkpoint')
    argv = [recipe, '--synthetic-data', *flags, '--max-iters', str(steps), '--save', str(save)]

    seen, stamps, entries, loads, saves, statuses, samples = [], {}, [], [], [], [], [0]
    recorded = module in (su, sg3)
    orig_build, build = _variant_recorder(module, seen) if recorded else (None, None)
    orig_run_training = module.run_training
    orig_getitem = SyntheticImage.__getitem__
    orig_save = ckpt_mod.Checkpointer.save

    def run_training(**kw):
        inner, sample = kw['train_step'], kw['sample_fn']

        def train_step(state, batch):
            i = state['run']['step']
            if not entries:
                entries.append({k: v.clone() if isinstance(v, torch.Tensor) else v
                                for k, v in state['run'].get('ada', {}).items()})
            if i in (t_first, t_last):
                torch.cuda.synchronize()
                stamps[i] = time.perf_counter()
            return inner(state, batch)

        def sample_fn(state):
            samples[0] += 1
            return sample(state)
        result = orig_run_training(**dict(kw, train_step=train_step, sample_fn=sample_fn))
        statuses.append(result[1])
        return result

    def getitem(self, index):
        t0 = time.perf_counter()
        item = orig_getitem(self, index)
        loads.append(time.perf_counter() - t0)
        return item

    def timed_save(self, step, state, meta=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = orig_save(self, step, state, meta)
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        saves.append((step, time.perf_counter() - t0, size / 2 ** 20))
        return path

    def launched(run_steps):
        '''Check one run's launches against the path's; returns bias_act's.'''
        counts = _launches()
        want = (CIPS_BIAS_ACT_PER_FORWARD * samples[0] if recipe == 'CIPS' else 0, 0, 0, 0,
                want_line[0] * run_steps, want_line[1] * run_steps)
        if counts != want:
            raise AssertionError(f'{recipe} CLI launches {counts} (bias_act, filtered_lrelu, '
                                 f'two-pass fwd/bwd, line fwd/bwd), want {want}')
        return counts

    if recorded:
        module.build_train_step = build
    module.run_training = run_training
    SyntheticImage.__getitem__, ckpt_mod.Checkpointer.save = getitem, timed_save
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        cli_main(argv)
        wall = time.perf_counter() - t0
        counts = launched(steps)
        first_samples = samples[0]
        first = list(seen)
        files = os.listdir(out)
        want_files = {f'{save}.png', f'{steps}.png', f'G_{steps}.pt', 'checkpoint'}
        if recipe == 'FastGAN':
            want_files.add('recon.jpg')
        if want_files - set(files) or not any(f.startswith('args-') for f in files):
            raise AssertionError(f'{recipe} CLI artifacts {sorted(files)} lack '
                                 f'{sorted(want_files - set(files))} or args-*.json')
        with open(os.path.join(ckpt_dir, f'ckpt-{steps}', 'meta.json')) as f:
            meta = json.load(f)
        losses = meta['status']['loss']
        if not all(np.isfinite(v) for vs in losses.values() for v in vs):
            raise AssertionError(f'{recipe} CLI: non-finite losses in meta.json')
        saved = torch.load(os.path.join(ckpt_dir, f'ckpt-{steps}', 'state.pt'),
                           map_location='cpu', weights_only=True)['run']

        seen.clear()
        entries.clear()
        samples[0] = 0
        _reset_launches()
        t0 = time.perf_counter()
        cli_main(argv + ['--resume', ckpt_dir, '--max-iters', str(resume_to)])
        resume_wall = time.perf_counter() - t0
        resume_counts = launched(resume_to - steps)
        resumed = list(seen)
    finally:
        if recorded:
            module.build_train_step = orig_build
        module.run_training = orig_run_training
        SyntheticImage.__getitem__, ckpt_mod.Checkpointer.save = orig_getitem, orig_save

    a = meta['args']           # the run's arguments, as strings

    def rule(i):
        if recipe == 'StyleGAN2':
            return (float(a['r1_lambda']) > 0 and i % int(a['d_k']) == 0 and i != 0,
                    float(a['pl_lambda']) > 0 and i % int(a['g_k']) == 0 and i != 0)
        return (float(a['gp_lambda']) > 0 and i % int(a['gp_every']) == 0, False)

    if recorded:
        for label, got, span in (('run', first, range(steps)),
                                 ('resume', resumed, range(steps, resume_to))):
            want = [(i,) + rule(i) for i in span]
            if [(i, bool(r1), bool(pl)) for i, r1, pl in got] != want:
                raise AssertionError(f'{recipe} CLI {label}: steps and variants {got}, '
                                     f'want {want}')
    if statuses[-1].batches_done != resume_to:
        raise AssertionError(f'{recipe} CLI resume ended at {statuses[-1].batches_done}')
    final = os.path.join(ckpt_dir, f'ckpt-{resume_to}')
    with open(os.path.join(final, 'meta.json')) as f:
        final_losses = json.load(f)['status']['loss']
    if len(final_losses['d' if 'd' in final_losses else 'D']) != resume_to:
        raise AssertionError(f'{recipe} CLI: the resumed loss history is not {resume_to} long')
    variants = ''
    if recipe.startswith('WGAN'):
        n_critic = int(a['n_critic'])
        g_at = [i for i, g in enumerate(final_losses['g']) if g != 0]
        if g_at != [i for i in range(resume_to) if (i + 1) % n_critic == 0]:
            raise AssertionError(f'{recipe} CLI: G steps at {g_at}, want every {n_critic}th')
        variants = f', G steps at {g_at} (run and resume)'
    if recipe == 'WGAN':
        D = torch.load(os.path.join(final, 'state.pt'), map_location='cpu',
                       weights_only=True)['D']
        top = max(float(v.abs().max()) for k, v in D.items() if not k.startswith('norms.')
                  or k.endswith(('weight', 'bias')))
        if top > float(a['clip_value']):
            raise AssertionError(f'WGAN CLI: a D parameter reaches {top} > {a["clip_value"]}')
        variants += f', D parameters within +-{top:.4f}'
    if recipe in CLI_GRIDS:
        n, nrow = CLI_GRIDS[recipe]
        size = int(a['image_size'])
        got = _png_size(os.path.join(out, f'{resume_to}.png'))
        if got != _grid_size(n, nrow, size):
            raise AssertionError(f'{recipe} CLI grid {got}, want {n} images {nrow} a row')
    if 'ada' in saved:
        restored = entries[0]
        for k, v in saved['ada'].items():
            if not torch.equal(restored[k].cpu(), v):
                raise AssertionError(f'ADA resume: ada[{k!r}] {restored[k]} is not the '
                                     f"checkpoint's {v}")
        print(f"{recipe} CLI resume: p {float(restored['p']):.6f} restored from ckpt-{steps}, "
              f"ada state equal; final p {float(statuses[-1].state_dict()['loss']['p'][-1]):.6f}")

    B, size = int(a['batch_size']), int(a['image_size'])
    n = t_last - t_first
    window = stamps[t_last] - stamps[t_first]
    ips = B * n / window
    r1_at = [i for i, r1, _ in first + resumed if r1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{recipe} CLI: {steps} steps then resumed to {resume_to} ({wall:.2f} s and '
          f'{resume_wall:.2f} s wall, set-up included, peak device memory {peak:.2f} GiB)'
          + (f', R1 at steps {r1_at}' if recorded else '') + variants
          + f', line launches {counts[4]}/{counts[5]} in the first run')
    if recipe == 'CIPS':
        print(f'CIPS CLI: bias_act launches {counts[0]} and {resume_counts[0]} '
              f'({CIPS_BIAS_ACT_PER_FORWARD} for each of {first_samples} and {samples[0]} '
              'sample forwards), none inside the steps')
    print(f'{recipe} CLI: {ips:.2f} images/s, {window / n * 1e3:.1f} ms a step over steps '
          f'{t_first}-{t_last - 1} ({n} steps, batch {B}, {size}px, bf16, loader and Status '
          'included)'
          + (f' against {direct_ips:.2f} images/s of the direct build_training run '
             f'({ips / direct_ips:.3f} of it)' if direct_ips else '') + f' on {card}')
    per_batch = sum(loads) / (len(loads) / B)
    print(f'{recipe} CLI loader: {per_batch * 1e3:.1f} ms a batch of {B} synthetic '
          f'{size}px images ({len(loads)} images, one producer thread) on {card}')
    for step, secs, mib in saves:
        print(f'{recipe} CLI checkpoint ckpt-{step}: {secs:.3f} s, {mib:.1f} MiB on {card}')
    print(card)
    return out, counts[0] + resume_counts[0]


def run_direct_steps(recipe, dev, card, steps=10, warmup=5, label=None, overrides=None,
                     flop=None, profile=False, make_real=None):
    '''The recipe's `build_training` at the image size of its CLI phase and
    its defaults otherwise (`overrides` change them; full width, batch 32,
    bf16) on one batch of reals, without the loader and Status: `warmup`
    steps (one n_critic cycle of the WGANs; cuDNN autotunes), then `steps`
    steps (their variants as the cadence gives) with every launch count set
    to 0 just before and read just after: finite losses, no hand-written
    kernel launched, ms a step, images/s and peak device memory; with
    `flop(run, args)` (one step's FLOP) also TFLOP/s; with `profile`, one
    profiled step. `make_real(args, device)` makes a paired recipe's batch.
    Prints the build's seconds. Returns the images/s, the CLI phase's
    `direct_ips`.'''
    label = label or recipe
    flags = CLI_RUNS[recipe][0]
    sizes = {'image_size': int(flags[1])} if flags else {}
    args = _recipe_module(recipe).default_args(**dict(sizes, **(overrides or {})))
    t0 = time.perf_counter()
    run = _recipe_module(recipe).build_training(args, device=dev, seed=0)
    t_build = time.perf_counter() - t0
    step_flop = flop(run, args) if flop else None
    real = (make_real or _real_images)(args, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        run.train_step(run.state, real)
    torch.cuda.synchronize()
    print(f'{label} build {t_build:.2f} s, warm-up ({warmup} steps): '
          f'{time.perf_counter() - t0:.2f} s')
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    metrics = [run.train_step(run.state, real) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check_no_launches(f'{label} direct')
    losses = [[float(v) for v in m.values()] for m in metrics]
    if not all(np.isfinite(v) for ls in losses for v in ls):
        raise AssertionError(f'{label} direct: non-finite loss: {losses}')
    ips = args.batch_size * steps / dt
    print(f'{label} losses ({", ".join(metrics[0])}) per step:',
          json.dumps([[round(v, 5) for v in ls] for ls in losses]))
    print(f'{label} direct: {steps} steps, batch {args.batch_size}, {args.image_size}px, full '
          f'width, bf16: {dt * 1e3 / steps:.2f} ms a step, {ips:.2f} images/s'
          + (f', {step_flop * steps / dt / 1e12:.1f} TFLOP/s' if step_flop else '')
          + f', peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on '
          f'{card}')
    if profile:
        profile_step(label, run.train_step, run.state, real)
    return ips


def _last_checkpoint(out):
    '''The state dicts (on the CPU) and the arguments (as strings) of the
    latest checkpoint of the CLI run under `out`.'''
    import os
    from animeface_tpu_torch import checkpoint as ckpt_mod

    ckpt_dir = os.path.join(out, 'checkpoint')
    latest = os.path.join(ckpt_dir, f'ckpt-{ckpt_mod.Checkpointer(ckpt_dir).latest_step()}')
    state = torch.load(os.path.join(latest, 'state.pt'), map_location='cpu', weights_only=True)
    with open(os.path.join(latest, 'meta.json')) as f:
        return state, json.load(f)['args']


#: BigGAN's and SEBigGAN's gates: a gradient below this share of its
#: model's largest norm is structurally zero (`nudged_tolerances`'
#: `zero_grad`): a conv bias that a train-mode BatchNorm follows lay at
#: 2e-9 to 6e-8 of the largest norm on the CPU (32px and 64px, channels 8
#: and 16), the smallest other gradient at 3.6e-5
ZERO_GRAD = 1e-5


def check_cli_step_against_cpu(recipe, out, dev):
    '''The f32 step on the card against the CPU at batch 2
    (`check_step_against_cpu`), from the weights and buffers of the CLI
    run's last checkpoint under `out`: DCGAN's (its only variant);
    WGAN-gp's full step (the penalty's double backward included); BigGAN's, and
    SEBigGAN's ICR step (its draws z and n; the nudges move z and the
    reals), with their structurally zero gradients left out of S
    (ZERO_GRAD).'''
    from animeface_tpu_torch.nnutils.loss import GANLoss, HingeLoss, WGANLoss

    state, ran = _last_checkpoint(out)
    module = _recipe_module(recipe)
    draw_args, gate, G_ema = (), {}, None
    if recipe in ('DCGAN', 'WGAN_gp'):
        du = _recipe_module('DCGAN')
        sizes = dict(image_size=int(ran['image_size']), latent_dim=int(ran['latent_dim']))

        def build(a, d):
            return du.build_models(a, d) + (None,)
        if recipe == 'DCGAN':
            args = du.default_args(**sizes)

            def make_step(G, D, G_ema, g_opt, d_opt):
                return du.build_train_step(G, D, g_opt, d_opt, GANLoss())
        else:
            args = module.default_args(**sizes, gp_gamma=float(ran['gp_gamma']))

            def make_step(G, D, G_ema, g_opt, d_opt):
                return module.build_steps(G, D, g_opt, d_opt, WGANLoss(), args.gp_gamma)['full']
    else:
        args = module.default_args(image_size=int(ran['image_size']), z_dim=int(ran['z_dim']),
                                   channels=int(ran['channels']))
        draw_args, gate = (args.policy,), dict(zero_grad=ZERO_GRAD)
        if recipe == 'SEBigGAN':
            draw_args += (args.noise_sigma,)
            build, G_ema = module.build_models, state['G_ema']
            lambdas = (args.real_lambda, args.fake_lambda, args.latent_d_lambda,
                       args.latent_g_lambda)

            def make_step(G, D, G_ema, g_opt, d_opt):
                return module.build_train_step(G, D, G_ema, g_opt, d_opt, HingeLoss(),
                                               args.policy, lambdas, args.noise_sigma)
        else:
            def build(a, d):
                return module.build_models(a, d)[:2] + (None,)

            def make_step(G, D, G_ema, g_opt, d_opt):
                return module.build_train_step(G, D, None, g_opt, d_opt, HingeLoss(),
                                               args.policy, False)

    def draw(G, real, a):
        return module.draw_step_inputs(G, real, torch.Generator().manual_seed(6), *draw_args)
    return check_step_against_cpu(f'{recipe} {args.image_size}px', build, make_step, draw, args,
                                  SimpleNamespace(G=state['G'], D=state['D'], G_ema=G_ema), dev,
                                  **gate)


# ---------------------------------------------------- BigGAN and SEBigGAN

#: the direct steps of the BigGAN family at the CLI's defaults (128px,
#: channels 64, z 120, batch 32, bf16): (label, recipe, overrides, warm-up
#: steps, timed steps, profiled). Their CLIs and gates run a block
#: shallower at 64px (`CLI_RUNS`): the gates' CPU runs a quarter of 128px's
BIGGAN_DIRECT = (('BigGAN', 'BigGAN', {'image_size': 128}, 2, 5, True),
                 ('BigGAN-deep', 'BigGAN', {'image_size': 128, 'deep': True}, 1, 2, False),
                 ('SEBigGAN', 'SEBigGAN', {'image_size': 128}, 2, 5, False))


def biggan_macs(G, D, image_size):
    '''Multiply-adds of one sample's G and D forward (eval mode, on G's
    device): every spectral-normalized conv and dense layer (output size
    times fan_in) and SAGAN's two products; not the lambda layer's einsums
    (no phase runs it).'''
    from animeface_tpu_torch.implementations.BigGAN.model import SelfAttention
    from animeface_tpu_torch.nnutils.spectral_norm import SNConv, SNDense

    def count(model, x):
        macs = [0]

        def layer(mod, i, o):
            macs[0] += o.numel() * mod.weight[0].numel()

        def attention(mod, i, o):
            B, C, H, W = i[0].shape
            macs[0] += B * H * W * (H * W // 4) * (C // 8 + C // 2)

        hooks = [m.register_forward_hook(layer) for m in model.modules()
                 if isinstance(m, (SNConv, SNDense))]
        hooks += [m.register_forward_hook(attention) for m in model.modules()
                  if isinstance(m, SelfAttention)]
        with torch.no_grad():
            model(x, train=False)
        for h in hooks:
            h.remove()
        return macs[0]
    device = next(G.parameters()).device
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False       # no autotuning of batch-1 shapes for a count
    try:
        return (count(G, torch.zeros((1, G.z_dim), device=device)),
                count(D, torch.zeros((1, 3, image_size, image_size), device=device)))
    finally:
        torch.backends.cudnn.benchmark = benchmark


#: forwards' worth of G and D in one step, a backward of a module whose
#: parameters train counted as two: BigGAN G 1 (the D phase, no grad) + 3,
#: D 2 + 4 in the D phase and 1 + 1 in the G phase (D's parameters frozen
#: there: its backward is the input gradient alone); SEBigGAN's ICR step
#: G 2 + 6, D 5 + 10 and 1 + 1
BIGGAN_STEP_FORWARDS = {'BigGAN': (4, 8), 'SEBigGAN': (8, 17)}


def biggan_flop(label, recipe, run, args):
    '''One step's FLOP at `args`' batch from the layers' multiply-adds
    (`biggan_macs`) and BIGGAN_STEP_FORWARDS; prints them.'''
    g_macs, d_macs = biggan_macs(run.G, run.D, args.image_size)
    fg, fd = BIGGAN_STEP_FORWARDS[recipe]
    step_flop = 2 * args.batch_size * (fg * g_macs + fd * d_macs)
    print(f'{label}: G forward {g_macs / 1e9:.2f} GMAC, D forward {d_macs / 1e9:.2f} GMAC a '
          f'sample; a step {step_flop / 1e12:.2f} TFLOP at batch {args.batch_size} '
          f'({step_flop / 989e12 * 1e3:.2f} ms at the bf16 peak)')
    return step_flop


def run_biggan_phase(recipe, dev, card):
    '''One recipe of the BigGAN family: its direct steps at 128px
    (`BIGGAN_DIRECT`), the CLI with its resume at 64px (`run_cli_path`), and
    the f32 step on the card against the CPU from the CLI run's last
    checkpoint. Prints each part's seconds.'''
    import functools

    parts = {}
    for label, rec, overrides, warmup, steps, profile in BIGGAN_DIRECT:
        if rec == recipe:
            torch.cuda.empty_cache()
            t = time.perf_counter()
            run_direct_steps(rec, dev, card, steps, warmup, label, overrides,
                             functools.partial(biggan_flop, label, rec), profile)
            parts[f'direct {label}'] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out, _ = run_cli_path(recipe, card)          # at 64px: no direct images/s beside it
    parts['CLI'] = time.perf_counter() - t
    t = time.perf_counter()
    check_cli_step_against_cpu(recipe, out, dev)
    parts['f32 gate'] = time.perf_counter() - t
    print(f'phase {recipe} parts: ' + ', '.join(f'{k} {v:.1f} s' for k, v in parts.items()))


# ---------------------------------------------------- the progressive recipes

PROGRESSIVE_IMAGE = 128        # --image-size: max_depth 5, G and D widths up to 512
PROGRESSIVE_MODES = (('t', 's'), ('s', 's'), ('s', 't'))   # G_trans, stable, D_trans
PROGRESSIVE_STEPS = 5          # timed bf16 steps per mode pair, after 2
PROGRESSIVE_CLI_IMAGE = 32     # the CLI grows to 32px (max_depth 3); the steps run 128px
PROGRESSIVE_CLI = ('--image-size', str(PROGRESSIVE_CLI_IMAGE), '--num-images', '64', '--save',
                   '30')
PROGRESSIVE_PHASES = (['D_stablization']
                      + ['G_transition', 'G_stablization', 'D_transition', 'D_stablization'] * 3)
KILL_IMAGE, KILL_AT = 8, (2, 3)      # the 4 -> 8px growth boundary, then inside its G_transition
KILL_SAVE = 3                  # no snapshot at step 2: ckpt-2 is the boundary's alone
KILL_RUNNER = """
import importlib, json, os, runpy, signal, sys
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
argv, kill_at = json.loads(sys.argv[1]), int(sys.argv[2])
if sys.argv[3:] == ['wait']:
    # a resume started beside the run it resumes: its imports and the
    # card's context made, it waits for the line that says the run is dead
    importlib.import_module('animeface_tpu_torch.implementations.' + argv[0])
    torch.zeros(1, device='cuda' if torch.cuda.is_available() else 'cpu')
    sys.stdin.readline()
if kill_at:
    from animeface_tpu_torch import checkpoint
    save = checkpoint.Checkpointer.save

    def save_then_kill(self, step, state, meta=None):
        path = save(self, step, state, meta)
        if step == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        return path
    checkpoint.Checkpointer.save = save_then_kill
sys.argv = ['animeface_tpu_torch', *argv]
runpy.run_module('animeface_tpu_torch', run_name='__main__', alter_sys=True)
"""


def run_progressive_steps(recipe, dev, card, image_size=PROGRESSIVE_IMAGE, **overrides):
    """The recipe's step at `image_size` (full depth, the modules' widths)
    and the recipe's batch there (`resl2batch_size`: 16 at 128px), alpha
    0.5, in each mode pair the phase machine produces. First one f32 step
    of each pair on the card against the CPU at batch 2
    (`check_step_against_cpu`) from the seeded weights, a state no run on
    the card has moved, StyleGAN's noise maps zero: a noise_scale's
    gradient sums noise x upstream over the batch, the pixels and 512
    channels, where the instance norm that follows leaves the upstream
    about zero-mean, and in f32 it is rounding: two H100 runs from the
    same inputs gave 4.225e-2 and 9.054e-2 of its norm from the CPU (the
    CPU parity tests hold the noise path against JAX, float64 included).
    Then, per pair, 2 warm-up and PROGRESSIVE_STEPS
    timed steps in bf16: finite losses, no hand-written kernel launched, ms
    a step, images/s, peak memory, one profiled stable step. Returns {mode
    pair: images/s}."""
    from animeface_tpu_torch.implementations.PGGAN import config
    from animeface_tpu_torch.implementations.PGGAN.model import RESOLUTIONS
    from animeface_tpu_torch.nnutils.rng import make_generator

    module = _recipe_module(recipe)
    args = module.default_args(image_size=image_size,
                               batch_size=config.resl2batch_size[image_size], **overrides)
    depth = RESOLUTIONS.index(image_size)
    G, D = module.build_models(args, dev, seed=0)
    loss = module.RECIPE.loss()
    real = _real_images(args, dev)

    def make(G, D, g_opt, d_opt, g_mode, d_mode):
        inner = module.build_train_step(G, D, g_opt, d_opt, loss, args.gp_lambda,
                                        args.drift_epsilon, depth, g_mode, d_mode)

        def step(state, real, draws=None):
            state.setdefault('alpha', torch.full((), 0.5, device=real.device))
            state.setdefault('alpha_delta', torch.zeros((), device=real.device))
            return inner(state, real, draws)
        return step

    def draw(G, real, a):
        draws = module.draw_step_inputs(G, real, torch.Generator().manual_seed(6), depth)
        if 'noise' in draws:
            draws['noise'] = [torch.zeros_like(m) for m in draws['noise']]
        return draws

    for g_mode, d_mode in PROGRESSIVE_MODES:
        check_step_against_cpu(
            f'{recipe} {image_size}px ({g_mode}, {d_mode})',
            lambda a, d: module.build_models(a, d) + (None,),
            lambda G, D, G_ema, g_opt, d_opt: make(G, D, g_opt, d_opt, g_mode, d_mode),
            draw, args, SimpleNamespace(G=G, D=D), dev)

    ips = {}
    for g_mode, d_mode in PROGRESSIVE_MODES:
        label = f'{recipe} {image_size}px ({g_mode}, {d_mode})'
        g_opt, d_opt = _recipe_module('PGGAN').make_optimizers(G, D, image_size)
        step = make(G, D, g_opt, d_opt, g_mode, d_mode)
        state = dict(step=0, generator=make_generator(0, dev))
        for _ in range(2):
            step(state, real)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        losses = [step(state, real) for _ in range(PROGRESSIVE_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check_no_launches(label)
        values = [float(m[k]) for m in losses for k in ('d', 'g')]
        if not all(np.isfinite(values)):
            raise AssertionError(f'{label}: non-finite loss: {values}')
        B = args.batch_size
        ips[(g_mode, d_mode)] = B * PROGRESSIVE_STEPS / dt
        print(f'{label}: {PROGRESSIVE_STEPS} steps, batch {B}, full width, bf16: '
              f'{dt * 1e3 / PROGRESSIVE_STEPS:.2f} ms a step, {ips[(g_mode, d_mode)]:.2f} '
              f'images/s, peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} '
              f'GiB on {card}')
        if (g_mode, d_mode) == ('s', 's'):
            profile_step(label, step, state, real)
        del step, state, g_opt, d_opt
    return ips


def _epoch_groups(epochs):
    """Consecutive epochs of one (phase, resolution) merged: [(phase,
    resolution, alphas)]."""
    groups = []
    for e in epochs:
        if groups and groups[-1][:2] == (e['phase'], e['resolution']):
            groups[-1][2].extend(e['alphas'])
        else:
            groups.append((e['phase'], e['resolution'], list(e['alphas'])))
    return groups


def run_progressive_cli(recipe, card, flags=PROGRESSIVE_CLI, want_phases=PROGRESSIVE_PHASES):
    """`python -m animeface_tpu_torch <recipe> --synthetic-data` through
    every resolution to PROGRESSIVE_CLI_IMAGE, in-process, bf16. Checks: the
    phase order `want_phases` (Step.get_mode is read once an epoch), alpha
    from 0 to 1 in every transition phase, finite losses, the grids at
    each snapshot's resolution, G_<step>.pt with its sidecar, final.png
    and G_final.pt, no hand-written kernel launched. Prints the seconds of
    each resolution (checkpoints and snapshots included) and its steps.
    Returns the result directory."""
    import os
    from animeface_tpu_torch.__main__ import main as cli_main
    pu = _recipe_module('PGGAN')

    root = os.environ['ANIMEFACE_IMPLEMENTATIONS_DIR']
    out = os.path.join(root, recipe, 'result')
    epochs = []
    orig_get_mode, orig_build = pu.Step.get_mode, pu.build_train_step

    def get_mode(self):
        torch.cuda.synchronize()
        epochs.append(dict(phase=self.current_phase, resolution=self.current_resolution,
                           t=time.perf_counter(), alphas=[]))
        return orig_get_mode(self)

    def build(*a, **k):
        step = orig_build(*a, **k)

        def recorded(state, real, draws=None):
            epochs[-1]['alphas'].append(state['alpha'])
            return step(state, real, draws)
        return recorded

    pu.Step.get_mode, pu.build_train_step = get_mode, build
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        cli_main([recipe, '--synthetic-data', *flags])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        pu.Step.get_mode, pu.build_train_step = orig_get_mode, orig_build
    _check_no_launches(f'{recipe} CLI')

    groups = _epoch_groups(epochs)
    if [g[0] for g in groups] != want_phases:
        raise AssertionError(f'{recipe} CLI phases {[g[:2] for g in groups]}')
    for phase, resl, alphas in groups:
        a = [float(v) for v in alphas]
        if phase.endswith('transition') and not (
                a[0] == 0.0 and a[-1] == 1.0 and all(x <= y for x, y in zip(a, a[1:]))):
            raise AssertionError(f'{recipe} CLI {phase} {resl}px: alpha {a}')
    steps = sum(len(e['alphas']) for e in epochs)
    files = set(os.listdir(out))
    snaps = sorted(int(f[2:-3]) for f in files if f.startswith('G_') and f[2:-3].isdigit())
    if not snaps or not {'final.png', 'G_final.pt', 'checkpoint'} <= files:
        raise AssertionError(f'{recipe} CLI artifacts {sorted(files)}')
    for k in snaps:
        with open(os.path.join(out, f'G_{k}.json')) as f:
            side = json.load(f)
        if _png_size(os.path.join(out, f'{k}.png')) != _grid_size(16, 4, side['resolution']):
            raise AssertionError(f'{recipe} CLI: {k}.png is not 16 images at {side}')
    if _png_size(os.path.join(out, 'final.png')) != _grid_size(16, 4, groups[-1][1]):
        raise AssertionError(f'{recipe} CLI: final.png is not at {groups[-1][1]}px')
    ckpt_dir = os.path.join(out, 'checkpoint')
    last = max(int(n.split('-')[1]) for n in os.listdir(ckpt_dir) if n.startswith('ckpt-'))
    with open(os.path.join(ckpt_dir, f'ckpt-{last}', 'meta.json')) as f:
        loss = json.load(f)['status']['loss']
    if last != steps or not all(np.isfinite(v) for k in ('d', 'g') for v in loss[k]):
        raise AssertionError(f'{recipe} CLI: {steps} steps, last checkpoint {last}, or '
                             'non-finite losses')

    per_resl = {}
    for e, nxt in zip(epochs, epochs[1:] + [dict(t=t_end)]):
        secs, n = per_resl.get(e['resolution'], (0.0, 0))
        per_resl[e['resolution']] = (secs + nxt['t'] - e['t'], n + len(e['alphas']))
    print(f'{recipe} CLI to {groups[-1][1]}px: {steps} steps in {t_end - t0:.2f} s '
          f'(set-up and the final artifacts included), {len(groups)} phases in order, alpha '
          f'0 -> 1 in each transition, snapshots {snaps} with sidecars, peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}')
    print(f'{recipe} CLI seconds per resolution (steps): '
          + ', '.join(f'{r}px {s:.2f} s ({n})' for r, (s, n) in sorted(per_resl.items())))
    return out


def run_progressive_kill_resume(card, image_size=KILL_IMAGE, kills=KILL_AT, save=KILL_SAVE,
                                env=None):
    """PGGAN to `image_size` in f32, in subprocesses with deterministic
    algorithms (`torch.use_deterministic_algorithms(True, warn_only=True)`,
    CUBLAS_WORKSPACE_CONFIG=:4096:8, cuDNN autotuning off), in lanes side
    by side: one run uninterrupted and, for each checkpoint of `kills`, one
    killed with SIGKILL right after publishing it and resumed from its
    checkpoint directory to the end (the resume's process started beside
    the killed run, its imports and its context on the card made while
    that run trains). The first kill must land on a growth
    boundary (`opt_fresh`), the second inside a G_transition epoch. Each
    killed lane's G_final.pt must equal the uninterrupted run's bitwise,
    or, where a warning names an op without a deterministic kernel, within
    1e-4 of each tensor's scale."""
    import concurrent.futures
    import os
    import signal
    import tempfile

    argv = ['PGGAN', '--synthetic-data', '--image-size', str(image_size), '--num-images', '64',
            '--save', str(save), '--no-bf16']
    with tempfile.TemporaryDirectory(prefix='chip_smoke_kill_') as tmp:
        def lane(name, kill_at):
            env_ = dict(os.environ, **(env or {}), CUBLAS_WORKSPACE_CONFIG=':4096:8',
                        PYTHONUNBUFFERED='1',
                        ANIMEFACE_IMPLEMENTATIONS_DIR=os.path.join(tmp, name))
            ckpt = os.path.join(tmp, name, 'PGGAN', 'result', 'checkpoint')
            meta = None

            def start(extra, kill, *wait):
                return subprocess.Popen(
                    [sys.executable, '-c', KILL_RUNNER, json.dumps(argv + extra), str(kill),
                     *wait], env=env_, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            # a killed lane's resume starts beside the run it resumes and
            # waits, imported and on the card, until that run is dead
            procs = [start([], kill_at)] + ([start(['--resume', ckpt], 0, 'wait')]
                                            if kill_at else [])
            runs = []
            try:
                for i, proc in enumerate(procs):
                    if i:
                        proc.stdin.write('run\n')
                        proc.stdin.flush()
                    out, err = proc.communicate(timeout=600)
                    runs.append(SimpleNamespace(returncode=proc.returncode, stdout=out,
                                                stderr=err))
                    if kill_at and not i and proc.returncode == -signal.SIGKILL:
                        with open(os.path.join(ckpt, f'ckpt-{kill_at}', 'meta.json')) as f:
                            meta = json.load(f)
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            want = [0] if not kill_at else [-signal.SIGKILL, 0]
            for run, code in zip(runs, want):
                if run.returncode != code:
                    raise AssertionError(f'PGGAN kill lane {name}: exit {run.returncode}, want '
                                         f'{code}:\n' + run.stderr[-3000:])
            resumed = None
            if kill_at:
                resumed = next((ln for ln in runs[1].stdout.splitlines()
                                + runs[1].stderr.splitlines()
                                if ln.startswith(f'[resume] from {ckpt} @ step {kill_at} ')), None)
                if resumed is None:
                    raise AssertionError(f'PGGAN lane {name}: the resume did not start at '
                                         f'ckpt-{kill_at}')
            warned = {ln.strip() for run in runs for ln in run.stderr.splitlines()
                      if 'deterministic' in ln}
            final = torch.load(os.path.join(tmp, name, 'PGGAN', 'result', 'G_final.pt'),
                               weights_only=True)
            return final, meta, resumed, warned

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1 + len(kills)) as pool:
            futures = [pool.submit(lane, f'kill{k}' if k else 'base', k) for k in (0, *kills)]
            (want, _, _, warned), *lanes = [f.result() for f in futures]
        dt = time.perf_counter() - t0
    where = [(m['machine']['current_phase'], m['phase_batch_idx'], m['opt_fresh'])
             for _, m, _, _ in lanes]
    if len(where) != 2 or not (where[0][1:] == (0, True) and where[1][0] == 'G_transition'
                               and where[1][1] > 0):
        raise AssertionError(f'PGGAN kills at {kills} landed at {where}, not at a growth '
                             'boundary and inside a G_transition epoch')
    warned = sorted(warned.union(*(w for _, _, _, w in lanes)))
    notes = []
    for kill, (got, _, resumed, _) in zip(kills, lanes):
        unequal = [k for k in want if not torch.equal(got[k], want[k])]
        worst = max((float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()),
                                                                 1e-30), k) for k in want)
        if unequal and not (warned and worst[0] <= 1e-4):
            raise AssertionError(f'PGGAN killed at ckpt-{kill}: {len(unequal)} of {len(want)} '
                                 f'tensors of G_final.pt differ (worst {worst}); warnings: '
                                 f'{warned}')
        notes.append(f'killed after ckpt-{kill}, resumed at {resumed[resumed.index("("):]}: '
                     f'{len(want) - len(unequal)} of {len(want)} tensors bitwise equal (worst '
                     f'{worst[0]:.3e})')
    print(f'PGGAN kill and resume on the card ({image_size}px, f32, deterministic algorithms), '
          f'G_final.pt against the uninterrupted run: ' + '; '.join(notes)
          + f'; nondeterministic-op warnings: {warned or "none"}; {dt:.1f} s for the '
          f'{1 + len(kills)} lanes on {card}')


# --------------------------------------------------------------------- the metrics

METRICS_IMAGE = 256            # the StyleGAN2 CLI phase's size
METRICS_BATCH = 64             # fid_cli's default batch
STATS_BATCHES = 40             # 2560 features a set: full-rank 2048-dim covariances
KID_SUBSETS = 4                # the numpy copy's KID stays short
VGG_BATCH = 32
VGG_CHECK_IMAGE = 128          # the card-vs-CPU check's images, pooled from 256px
FID_SAMPLES = 1024             # fid_cli's --num-samples (KID's subsets of 1000 fit)
TREND_SAMPLES = 256            # fid_trend's --num-samples
METRICS_RTOL = 1e-9            # the port's statistics against the numpy copy


def write_inception_weights(path, seed=0):
    '''Random InceptionV3 weights whose features do not collapse, written to
    `path` in the converter's layout: He-normal conv kernels, BN scales in
    [0.8, 1.2], small BN biases and means, BN variances in [0.5, 1.5].'''
    from animeface_tpu_torch.convert_weights import inception_npz
    from animeface_tpu_torch.metrics.inception import InceptionV3Features

    rng = np.random.default_rng(seed)
    state = {}
    for key, v in InceptionV3Features().state_dict().items():
        shape = tuple(v.shape)
        if key.endswith('conv.weight'):
            a = rng.normal(0, np.sqrt(2.0 / v[0].numel()), shape)
        elif key.endswith('running_var'):
            a = rng.uniform(0.5, 1.5, shape)
        elif key.endswith('bn.weight'):
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.normal(0, 0.1, shape)
        state[key] = a.astype(np.float32)
    np.savez(path, **inception_npz(state))


def _metric_images(kind, n, size, dev, g):
    '''`n` images in [-1, 1]: 'noise' uniform per pixel, 'smooth' the same
    noise averaged over 8x8 cells and upsampled (another distribution).'''
    x = torch.rand((n, 3, size, size), generator=g, device=dev) * 2 - 1
    if kind == 'smooth':
        x = torch.nn.functional.interpolate(torch.nn.functional.avg_pool2d(x, 8) * 4,
                                            size=(size, size), mode='bilinear').clamp(-1, 1)
    return x


def check_inception(dev, card):
    '''The extractor in f32 on the card against the CPU on 2 images of
    METRICS_IMAGE px (the resize to 299 included): within 1e-3 of the
    features' scale. Then STATS_BATCHES batches of METRICS_BATCH of each of
    two image sets: the extractor's images/s and peak memory. Returns the
    two sets' features.'''
    from animeface_tpu_torch.metrics.inception import make_extractor

    extract, extract_cpu = make_extractor(device=dev), make_extractor(device='cpu')
    x = _metric_images('noise', 2, METRICS_IMAGE, 'cpu', torch.Generator().manual_seed(3))
    want = extract_cpu(x)
    got = extract(x.to(dev)).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    print(f'inception features card vs CPU: max abs err {err:.3e} at scale {scale:.4f} '
          f'(std {float(want.std()):.4f}; tolerance {1e-3 * scale:.3e})')
    if not (got.shape == (2, 2048) and err <= 1e-3 * scale and float(want.std()) > 1e-2 * scale):
        raise AssertionError(f'inception: card vs CPU {err:.3e} at scale {scale:.4f}, '
                             f'or the features collapse')

    g = torch.Generator(device=dev).manual_seed(4)
    for kind in ('noise', 'smooth'):                 # warm-up: cuDNN autotunes
        extract(_metric_images(kind, METRICS_BATCH, METRICS_IMAGE, dev, g))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    feats, dt = {'noise': [], 'smooth': []}, 0.0
    for _ in range(STATS_BATCHES):
        for kind in feats:
            images = _metric_images(kind, METRICS_BATCH, METRICS_IMAGE, dev, g)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats[kind].append(extract(images))
            torch.cuda.synchronize()
            dt += time.perf_counter() - t0
    n = 2 * STATS_BATCHES * METRICS_BATCH
    print(f'inception extractor: {n} images of {METRICS_IMAGE}px resized to 299, batch '
          f'{METRICS_BATCH}, f32: {n / dt:.1f} images/s, peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}')
    return torch.cat(feats['noise']), torch.cat(feats['smooth'])


def _np_statistics(f):
    f = np.asarray(f, np.float64)
    n = f.shape[0]
    mu = f.sum(axis=0) / n
    return mu, (f.T @ f - n * np.outer(mu, mu)) / (n - 1)


def _np_sqrtm_psd(m):
    vals, vecs = np.linalg.eigh((m + m.T) / 2.0)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def _np_frechet(mu1, s1, mu2, s2):
    half = _np_sqrtm_psd(s2)
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * np.trace(_np_sqrtm_psd(half @ s1 @ half)))


def _np_kid(x, y, num_subsets, subset_size, seed):
    rng = np.random.default_rng(seed)
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    n = min(subset_size, x.shape[0], y.shape[0])

    def k(a, b):
        return (a @ b.T / a.shape[1] + 1.0) ** 3

    total = 0.0
    for _ in range(num_subsets):
        xi = x[rng.choice(x.shape[0], n, replace=False)]
        yi = y[rng.choice(y.shape[0], n, replace=False)]
        kxx, kyy, kxy = k(xi, xi), k(yi, yi), k(xi, yi)
        total += ((kxx.sum() - np.trace(kxx)) / (n * (n - 1))
                  + (kyy.sum() - np.trace(kyy)) / (n * (n - 1)) - 2 * kxy.mean())
    return float(total / num_subsets)


def check_fid_statistics(fa, fb, card):
    '''The port's statistics, Frechet distance and KID (KID_SUBSETS subsets
    of 1000) on the card in f64 against the numpy copy of the same
    formulas on the host: within METRICS_RTOL relative.'''
    from animeface_tpu_torch.metrics.fid import compute_kid, frechet_distance, gaussian_statistics

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (mu_a, s_a), (mu_b, s_b) = gaussian_statistics(fa), gaussian_statistics(fb)
    fd = frechet_distance(mu_a, s_a, mu_b, s_b)
    t1 = time.perf_counter()
    kid = compute_kid(fa, fb, num_subsets=KID_SUBSETS, subset_size=1000, seed=0)
    t2 = time.perf_counter()
    na, nb = fa.double().cpu().numpy(), fb.double().cpu().numpy()
    (mu_a_np, s_a_np), (mu_b_np, s_b_np) = _np_statistics(na), _np_statistics(nb)
    fd_np = _np_frechet(mu_a_np, s_a_np, mu_b_np, s_b_np)
    t3 = time.perf_counter()
    kid_np = _np_kid(na, nb, KID_SUBSETS, 1000, 0)
    t4 = time.perf_counter()

    def rel(got, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        return float(np.abs(got - want).max() / np.abs(want).max())

    errs = {'mu': max(rel(mu_a, mu_a_np), rel(mu_b, mu_b_np)),
            'cov': max(rel(s_a, s_a_np), rel(s_b, s_b_np)),
            'fd': rel(fd, fd_np), 'kid': rel(kid, kid_np)}
    print(f'fid statistics of {fa.shape[0]} + {fb.shape[0]} features: FD {fd:.6f} (numpy '
          f'{fd_np:.6f}), KID over {KID_SUBSETS} subsets {kid:.8f} (numpy {kid_np:.8f}); '
          'relative errors ' + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
          + f'; port on the card {t1 - t0:.3f} s (statistics and FD) + {t2 - t1:.3f} s '
          f'(KID), numpy on the host {t3 - t2:.3f} s + {t4 - t3:.3f} s on {card}')
    bad = {k: v for k, v in errs.items() if not v <= METRICS_RTOL}
    if bad or not (np.isfinite(fd) and np.isfinite(kid)):
        raise AssertionError(f'fid statistics against numpy: {bad}, FD {fd}, KID {kid}')


def run_fid_cli(sg2_out, card):
    '''`fid_cli.main` in-process on the StyleGAN2 CLI phase's newest
    `G_<step>.pt` at 256px, FID_SAMPLES samples, batch 64, with KID: the FID and
    KID finite; the seconds of the real stream, the fake stream, the
    statistics and the KID.'''
    import glob
    import os
    from animeface_tpu_torch.metrics import fid as fid_mod
    from animeface_tpu_torch.metrics import fid_cli

    snaps = sorted(glob.glob(os.path.join(sg2_out, 'G_*.pt')),
                   key=lambda p: int(os.path.basename(p)[2:-3]))
    marks = {}
    orig_fid, orig_kid = fid_mod.compute_fid, fid_mod.compute_kid

    def mark(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    def timed_fid(real, fake, extract, **kw):
        def fake_stream():
            mark('real')
            yield from fake

        def timed_extract(images):
            out = extract(images)
            mark('fake')
            return out

        mark('start')
        try:
            return orig_fid(real, fake_stream(), timed_extract, **kw)
        finally:
            mark('fid')

    def timed_kid(*a, **kw):
        mark('kid streams')
        try:
            return orig_kid(*a, **kw)
        finally:
            mark('kid')

    argv = ['--weights', snaps[-1], '--image-size', str(METRICS_IMAGE), '--synthetic-data',
            '--num-samples', str(FID_SAMPLES), '--batch-size', str(METRICS_BATCH), '--kid']
    fid_mod.compute_fid, fid_mod.compute_kid = timed_fid, timed_kid
    try:
        t0 = time.perf_counter()
        out = fid_cli.main(argv)
        dt = time.perf_counter() - t0
    finally:
        fid_mod.compute_fid, fid_mod.compute_kid = orig_fid, orig_kid
    if not (np.isfinite(out['fid']) and np.isfinite(out['kid'])):
        raise AssertionError(f'fid_cli: FID {out["fid"]}, KID {out["kid"]}')
    print(f'fid_cli on {os.path.basename(snaps[-1])}: FID {out["fid"]:.4f}, KID '
          f'{out["kid"]:.6f}; {dt:.1f} s: real stream {marks["real"] - marks["start"]:.1f} s, '
          f'fake stream {marks["fake"] - marks["real"]:.1f} s, statistics '
          f'{marks["fid"] - marks["fake"]:.2f} s, KID streams '
          f'{marks["kid streams"] - marks["fid"]:.1f} s, KID (100 subsets of 1000) '
          f'{marks["kid"] - marks["kid streams"]:.3f} s on {card}')


def run_fid_trend(out, card, model='ADA', flags=('--image-size', str(ADA_IMAGE),
                                                 '--latent-dim', '512')):
    '''`fid_trend.main` in-process on a CLI phase's result directory `out`
    (by default the ADA run's at 128px, latent 512), TREND_SAMPLES samples:
    `trend.json` with a finite fd for every snapshot, exit 0 when the gate
    holds and 1 when it fails (after a short run the verdict is the run's
    quality; it is printed), the `gate_ok` its exit code gives, and each
    snapshot's resolution and alpha where its sidecar gives them.'''
    import glob
    import os
    from animeface_tpu_torch.metrics import fid_trend

    steps = sorted(int(os.path.basename(p)[2:-3]) for p in glob.glob(os.path.join(out, 'G_*.pt'))
                   if os.path.basename(p)[2:-3].isdigit())
    t0 = time.perf_counter()
    try:
        fid_trend.main(['--result-dir', out, '--model', model, *flags, '--synthetic-data',
                        '--num-samples', str(TREND_SAMPLES)])
        code = 0
    except SystemExit as e:
        code = e.code
    dt = time.perf_counter() - t0
    with open(os.path.join(out, 'trend.json')) as f:
        report = json.load(f)
    fds = [r['fd'] for r in report['results']]
    if ([r['step'] for r in report['results']] != steps or not all(np.isfinite(fds))
            or code != (0 if report['gate_ok'] else 1)):
        raise AssertionError(f'fid_trend: exit {code}, snapshots {steps}, report {report}')
    geometry = ''
    if any('resolution' in r for r in report['results']):
        geometry = ' (' + ', '.join(f'G_{r["step"]} {r.get("resolution", "-")}px alpha '
                                    f'{r["alpha"]:.2f}' for r in report['results']) + ')'
    print(f'fid_trend --model {model} on the {model} CLI run (G_{", G_".join(map(str, steps))})'
          f'{geometry}: fd ' + ' -> '.join(f'{v:.4f}' for v in fds)
          + f'; gate {"OK" if report["gate_ok"] else "FAILED"}, gate_ok {report["gate_ok"]} '
          f'(exit {code}; the verdict of {steps[-1]} steps of training, not of the port); '
          f'{dt:.1f} s on {card}')


VGG_LOSSES = ('style_loss', 'content_loss', 'vgg_loss')


def _vgg_grads(lossf, real, fake):
    '''{'loss <name>': value, 'grad <name>': gradient with respect to
    `fake`} for each VGG loss, f64 on the CPU.'''
    out = {}
    for name in VGG_LOSSES:
        f = fake.clone().requires_grad_(True)
        value = getattr(lossf, name)(real, f)
        value.backward()
        out[f'loss {name}'] = value.detach().double().cpu()
        out[f'grad {name}'] = f.grad.double().cpu()
    return out


def check_vgg_loss(dev, card, batch=2, rtol=1e-3, nudge=1e-6, nudges=3):
    '''`VGGLoss(vgg=16)` (the fixed-seed fallback weights) at 256px, batch
    VGG_BATCH, f32: the style, content and vgg losses and the gradient of
    their sum with respect to the fakes finite, ms for a forward plus
    backward of the three. Then each loss and its gradient at `batch` on
    the images average-pooled to VGG_CHECK_IMAGE, on the card against the
    CPU, with the step gate's tolerances
    (`nudged_tolerances`) from `nudges` CPU reruns with the reals and fakes
    moved by `nudge` * N(0, 1): each loss within `rtol` of its value plus
    twice its own sensitivity, the gradients in L2 within (`rtol` + 2 S) of
    their norm (ReLU inputs near 0 and near-tied max-pool windows switch
    under f32 rounding, as in `check_step_against_cpu`).'''
    import warnings
    from animeface_tpu_torch.nnutils.loss.vgg import VGGLoss

    with warnings.catch_warnings():
        warnings.simplefilter('ignore')          # the provenance line says it
        loss, loss_cpu = VGGLoss(device=dev, vgg=16), VGGLoss(device='cpu', vgg=16)

    def run(real, fake):
        fake = fake.clone().requires_grad_(True)
        values = [getattr(loss, name)(real, fake) for name in VGG_LOSSES]
        sum(values).backward()
        return [v.detach() for v in values], fake.grad

    g = torch.Generator(device=dev).manual_seed(5)
    real = _metric_images('smooth', VGG_BATCH, METRICS_IMAGE, dev, g)
    fake = _metric_images('noise', VGG_BATCH, METRICS_IMAGE, dev, g)
    run(real, fake)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        values, grad = run(real, fake)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    values = [float(v) for v in values]
    if not (all(np.isfinite(values)) and bool(torch.isfinite(grad).all())):
        raise AssertionError(f'VGGLoss: losses {values} or the gradient are not finite')
    print(f'VGGLoss(vgg=16) at {METRICS_IMAGE}px, batch {VGG_BATCH}, f32: style, content, vgg '
          f'{values[0]:.6g}, {values[1]:.6g}, {values[2]:.6g}; {ms:.1f} ms a forward plus '
          f'backward of the three, peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}')

    # the card-vs-CPU check on the images pooled to VGG_CHECK_IMAGE: its CPU
    # runs a quarter of 256px's
    pool = METRICS_IMAGE // VGG_CHECK_IMAGE
    real2, fake2 = (torch.nn.functional.avg_pool2d(x[:batch], pool).cpu() for x in (real, fake))
    t0 = time.perf_counter()
    want = _vgg_grads(loss_cpu, real2, fake2)
    got = _vgg_grads(loss, real2.to(dev), fake2.to(dev))
    moved = []
    for k in range(nudges):
        gk = torch.Generator().manual_seed(7 + k)
        moved.append(_vgg_grads(loss_cpu, real2 + nudge * torch.randn(real2.shape, generator=gk),
                                fake2 + nudge * torch.randn(fake2.shape, generator=gk)))
    tols = nudged_tolerances(want, moved, rtol)
    gated = gate_ratios(got, want, tols)
    loss_ratio = _print_loss_gate('VGGLoss', want, tols, gated)
    grad_errs = [gated[f'grad {n}'] * tols['grad_tol'] for n in VGG_LOSSES]
    print(f'VGGLoss card vs CPU at batch {batch}, {VGG_CHECK_IMAGE}px (style, content, vgg): '
          f'losses worst err/tol {loss_ratio:.3f}; gradients '
          f'{", ".join(f"{e:.2e}" for e in grad_errs)} of their norm (tolerance '
          f'{tols["grad_tol"]:.3e}, S {tols["S"]:.3e} over {nudges} nudges of {nudge}); '
          f'{time.perf_counter() - t0:.1f} s')
    if loss_ratio > 1 or max(grad_errs) > tols['grad_tol']:
        raise AssertionError(f'VGGLoss card vs CPU: losses err/tol {loss_ratio}, gradients '
                             f'{grad_errs}, S {tols["S"]}')


def run_metrics_path(dev, card, sg2_out, ada_out, pggan_out=None):
    '''The metrics (`animeface_tpu_torch/metrics/`, `nnutils/loss/vgg.py`):
    the Inception extractor on random weights that do not collapse (loaded
    through ANIMEFACE_INCEPTION_WEIGHTS from a temporary .npz), its
    statistics, FD and KID against numpy, `fid_cli` on the StyleGAN2 CLI
    run's snapshot, `fid_trend` on the ADA CLI run's and (`--model PGGAN`)
    on the PGGAN CLI run's, and `VGGLoss`; no hand-written kernel
    launched.'''
    import os
    import tempfile
    from animeface_tpu_torch.metrics.inception import WEIGHTS_ENV

    _reset_launches()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_inception_') as tmp:
        os.environ[WEIGHTS_ENV] = os.path.join(tmp, 'inception.npz')
        try:
            write_inception_weights(os.environ[WEIGHTS_ENV])
            fa, fb = check_inception(dev, card)
            check_fid_statistics(fa, fb, card)
            del fa, fb
            run_fid_cli(sg2_out, card)
        finally:
            del os.environ[WEIGHTS_ENV]
    torch.cuda.empty_cache()
    run_fid_trend(ada_out, card)
    torch.cuda.empty_cache()
    if pggan_out is not None:
        run_fid_trend(pggan_out, card, 'PGGAN', ('--image-size', str(PROGRESSIVE_CLI_IMAGE)))
        torch.cuda.empty_cache()
    check_vgg_loss(dev, card)
    _check_no_launches('metrics')


# ---------------------------------------------------- the simple-GAN recipes and generate

#: the recipes on the simple-GAN trunk (`nnutils/simple_gan.py`); their CLI
#: phases patch the trunk's `run_training`
SIMPLE_GANS = ('TransGAN', 'HiT', 'ConvNeXt', 'VAN')
#: their direct steps: (warm-up steps, timed steps); ConvNeXt's and VAN's
#: R1 steps take 0.8 and 2.2 s on an H100, so fewer of them
SIMPLE_GAN_DIRECT = {'TransGAN': (2, 5), 'HiT': (2, 5), 'ConvNeXt': (1, 1), 'VAN': (1, 1)}
#: the direct steps' image size where the CLI and its gate run smaller (one
#: G stage fewer): TransGAN's CLI at 32px (its gate's CPU attention over
#: 1,024 tokens, not 4,096), ConvNeXt's and VAN's at 64px (their gates' CPU
#: runs of R1's double backward a quarter of 128px's; their direct steps
#: took as long at 64px as at 128px, host-bound, first step included)
SIMPLE_GAN_DIRECT_IMAGE = {'TransGAN': 64, 'ConvNeXt': 128, 'VAN': 128}
#: TransGAN's gate runs without dropout: the card and the CPU cannot draw
#: the same masks (the CPU tests hold the dropout against flax's)
NO_DROPOUT = dict(g_dropout=0.0, g_attn_dropout=0.0, d_dropout=0.0, d_attn_dropout=0.0)
#: forwards' worth of G and D in one simple-GAN step, a backward as two: G
#: 1 (the D phase, no grad) + 3; D 2 + 4 in the D phase and 1 + 1 in the G
#: phase (its parameters frozen: the input gradient alone); R1 adds D's
#: forward, its input-gradient backward and the double backward (4)
SIMPLE_GAN_FORWARDS = {'plain': (4, 8), 'r1': (4, 14)}


def forward_flop(fn, *inputs):
    '''The FLOP of `fn(*inputs)` under torch.no_grad(): every op it
    dispatches that `torch.utils.flop_counter`'s formulas cover (matmuls,
    convolutions, attention products), from its operands' shapes.'''
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*a, **(kw or {}), out_val=out)
            return out

    with torch.no_grad(), Count() as counter:
        fn(*inputs)
    return counter.total


def simple_gan_flop(run, args):
    '''One timed step's FLOP at `args`' batch, from G's forward on one
    latent and D's on two images (`forward_flop`) and SIMPLE_GAN_FORWARDS
    for the variant of the timed steps; prints them. The model's work: R1's
    double backward of a depthwise conv runs more (one convolution per
    channel).'''
    dev = next(run.G.parameters()).device
    t0 = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False       # no autotuning of these shapes for a count
    try:
        g = forward_flop(run.G, torch.zeros((1, run.G.latent_dim), device=dev))
        d = forward_flop(run.D, torch.zeros((2, 3, args.image_size, args.image_size),
                                            device=dev)) / 2
    finally:
        torch.backends.cudnn.benchmark = benchmark
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    variant = run.variant(SIMPLE_GAN_DIRECT[args.name][0])
    fg, fd = SIMPLE_GAN_FORWARDS[variant]
    flop = args.batch_size * (fg * g + fd * d)
    print(f'{args.name}: G forward {g / 2e9:.2f} GMAC, D forward {d / 2e9:.2f} GMAC a sample; a '
          f'{variant} step {flop / 1e12:.3f} TFLOP at batch {args.batch_size} '
          f'({flop / 989e12 * 1e3:.2f} ms at the bf16 peak); counted in {t_count:.2f} s')
    return flop


def check_simple_gan_step_against_cpu(recipe, out, dev, overrides=None):
    '''The f32 step on the card against the CPU at batch 2
    (`check_step_against_cpu`) from the weights of the CLI run's last
    checkpoint under `out` (the run at the recipe's defaults, its image
    size, `overrides`): the R1 variant where gp_lambda is above 0
    (TransGAN, ConvNeXt, VAN), else the plain one (HiT); TransGAN without
    dropout.'''
    from animeface_tpu_torch.nnutils import simple_gan

    state, ran = _last_checkpoint(out)
    module = _recipe_module(recipe)
    args = module.default_args(**dict(overrides or {}, image_size=int(ran['image_size'])),
                               **(NO_DROPOUT if recipe == 'TransGAN' else {}))
    do_r1 = args.gp_lambda > 0
    policy = getattr(args, 'policy', '')

    def make_step(G, D, G_ema, g_opt, d_opt):
        return module.build_step(args, G, D, G_ema, g_opt, d_opt, do_r1)

    def draw(G, real, a):
        return simple_gan.draw_step_inputs(a.latent_dim, real, torch.Generator().manual_seed(6),
                                           policy)
    return check_step_against_cpu(
        f'{recipe} {args.image_size}px ({"R1" if do_r1 else "plain"})', module.build_models,
        make_step, draw, args, SimpleNamespace(G=state['G'], D=state['D'],
                                               G_ema=state.get('G_ema')), dev)


def run_simple_gan_phase(recipe, dev, card, overrides=None):
    '''One simple-GAN recipe at its CLI's defaults (full width, batch 32,
    bf16; `overrides` change them and must match `CLI_RUNS`' flags): the
    direct steps of `build_training` on one batch (TransGAN at 64px, the
    others at 128px; `SIMPLE_GAN_DIRECT`; cuDNN autotunes in the warm-up
    where the recipe's CLI does, not for ConvNeXt and VAN (their
    `AUTOTUNE`); the models' FLOP, ms a step, images/s, peak memory, no
    hand-written kernel launched, one profiled step but for ConvNeXt and
    VAN), the CLI with its
    resume beside the direct images/s (`run_cli_path`; TransGAN at 32px,
    ConvNeXt and VAN at 64px, without them), the f32 step on the card
    against the CPU from the CLI's checkpoint. Prints each part's
    seconds.'''
    parts = {}
    warmup, steps = SIMPLE_GAN_DIRECT[recipe]
    direct_overrides = dict(overrides or {})
    if recipe in SIMPLE_GAN_DIRECT_IMAGE:
        direct_overrides['image_size'] = SIMPLE_GAN_DIRECT_IMAGE[recipe]
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = getattr(_recipe_module(recipe), 'AUTOTUNE', True)
    try:
        torch.cuda.empty_cache()
        t = time.perf_counter()
        # no profile of ConvNeXt's and VAN's R1 steps (130k launches a VAN
        # step: about 20 s of the run for a breakdown PERF.md holds)
        direct = run_direct_steps(recipe, dev, card, steps, warmup, overrides=direct_overrides,
                                  flop=simple_gan_flop, profile=recipe not in ('ConvNeXt', 'VAN'))
        parts['direct'] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        # no direct images/s to stand beside where the CLI runs smaller
        out, _ = run_cli_path(recipe, card,
                              None if recipe in SIMPLE_GAN_DIRECT_IMAGE else direct)
        parts['CLI'] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        check_simple_gan_step_against_cpu(recipe, out, dev, overrides)
        parts['f32 gate'] = time.perf_counter() - t
    finally:
        torch.backends.cudnn.benchmark = benchmark
    print(f'phase {recipe} parts: ' + ', '.join(f'{k} {v:.1f} s' for k, v in parts.items()))


# ---------------------------------------------------- the paired tasks and recipes

#: the tasks of `build_dataset`, each iterated once on its synthetic stand-in
DATA_TASKS = ('image', 'celeba', 'sr', 'xdog', 'gray', 'label', 'onehot')
DATA_IMAGES = 128              # a task's stand-in: 4 batches of 32 at 128px
#: the recipes on the paired runtime (`nnutils/paired.py`); their CLI phases
#: patch its `run_training`
PAIRED = ('pix2pix', 'SRGAN', 'ESRGAN')
PAIRED_DIRECT = (2, 5)         # direct steps: warm-up, timed
#: forwards' worth of G, D and the VGG16 trunk in one step, a backward as
#: two: G 1 (the D phase, no grad) + 3; D 2 + 4 in the D phase and 1 + 1 in
#: the G phase (its parameters frozen: the input gradient alone), ESRGAN's
#: second real forward there 1 more; the content loss's trunk on HR and on
#: G's output with its input gradient, 1 + 2
PAIRED_FORWARDS = {'pix2pix': (4, 8, 0), 'SRGAN': (4, 8, 3), 'ESRGAN': (4, 9, 3)}


def run_data_path(dev, card):
    """Every task's loader on its synthetic stand-in (`build_loader`, the
    CLI's defaults: 128px, batch 32; DATA_IMAGES images) over one epoch
    through `Accelerator.iter_loader`: each batch on the card, its images
    NCHW float32 in [-1, 1] (the labels int32, the one-hot rows float32);
    the seconds of the epoch and the ms a batch, the producer thread's
    drawing and the copy included. No hand-written kernel launched."""
    from animeface_tpu_torch.dataset import build_loader
    from animeface_tpu_torch.nnutils.accelerate import Accelerator
    from animeface_tpu_torch.utils.argument import get_default_parser

    args = get_default_parser().parse_args(['data', '--synthetic-data', '--num-images',
                                            str(DATA_IMAGES)])
    benchmark = torch.backends.cudnn.benchmark
    accel = Accelerator(dev)
    torch.backends.cudnn.benchmark = benchmark
    _reset_launches()
    for task in DATA_TASKS:
        loader = build_loader(args, task)
        t0 = time.perf_counter()
        batches = list(accel.iter_loader(loader))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if len(batches) != DATA_IMAGES // args.batch_size:
            raise AssertionError(f'data {task}: {len(batches)} batches')
        leaves = batches[0] if isinstance(batches[0], tuple) else (batches[0],)
        for leaf in (x for b in batches for x in (b if isinstance(b, tuple) else (b,))):
            if leaf.device.type != dev.type or leaf.shape[0] != args.batch_size:
                raise AssertionError(f'data {task}: a batch of {tuple(leaf.shape)} on '
                                     f'{leaf.device}')
            if leaf.ndim == 4 and not (leaf.dtype == torch.float32
                                       and float(leaf.abs().max()) <= 1):
                raise AssertionError(f'data {task}: images not float32 in [-1, 1]')
        shapes = ', '.join(f'{tuple(x.shape)} {str(x.dtype)[6:]}' for x in leaves)
        print(f'data {task}: {type(loader.dataset).__name__}, {len(batches)} batches of '
              f'{shapes}, {dt:.2f} s, {dt * 1e3 / len(batches):.1f} ms a batch (one producer '
              f'thread, first epoch) on {card}')
    _check_no_launches('data')


def paired_batch(args, dev, seed=1):
    """One batch of the recipe's task at `args`' sizes on `dev`, uniform in
    [-1, 1] from `seed`: (target RGB, source line art) for pix2pix and the
    line-art recipes (xdog), (LR, HR) for SRGAN and ESRGAN."""
    g = torch.Generator(device=dev).manual_seed(seed)
    size = args.image_size
    shapes = (((3, size), (1, size)) if args.name in ('pix2pix', *LINE_ART) else
              ((args.image_channels, int(size // args.scale)), (args.image_channels, size)))
    return tuple(torch.rand((args.batch_size, c, n, n), generator=g, device=dev) * 2 - 1
                 for c, n in shapes)


def paired_flop(run, args):
    """One step's FLOP at `args`' batch from G's, D's and the VGG trunk's
    forwards on one sample (`forward_flop`, train=False: no buffer moves)
    and PAIRED_FORWARDS; prints them."""
    dev = next(run.G.parameters()).device
    one = paired_batch(SimpleNamespace(**dict(vars(args), batch_size=1)), dev)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False       # no autotuning of these shapes for a count
    try:
        if args.name == 'pix2pix':
            target, source = one
            g = forward_flop(run.G, source)
            d = forward_flop(run.D, torch.cat([target, source], dim=1))
            v = 0
        else:
            lr, hr = one
            g = forward_flop(lambda x: run.G(x, train=False), lr)
            d = forward_flop(lambda x: run.D(x, train=False), hr)
            v = forward_flop(run.vgg.model, hr)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    fg, fd, fv = PAIRED_FORWARDS[args.name]
    flop = args.batch_size * (fg * g + fd * d + fv * v)
    print(f'{args.name}: G forward {g / 2e9:.2f} GMAC, D forward {d / 2e9:.2f} GMAC'
          + (f', VGG16 forward {v / 2e9:.2f} GMAC (f32)' if v else '')
          + f' a sample; a step {flop / 1e12:.3f} TFLOP at batch {args.batch_size}')
    return flop


def check_paired_step_against_cpu(recipe, out, dev):
    """The f32 step on the card against the CPU at batch 2
    (`check_step_against_cpu`) from the weights and buffers of the CLI
    run's last checkpoint under `out`, on a paired batch (`paired_batch`,
    every image nudged); SRGAN and ESRGAN with one VGG16 trunk a device
    (its fixed-seed weights) and S over D's logits; conv biases that an
    instance norm follows are structurally zero (ZERO_GRAD)."""
    from animeface_tpu_torch.implementations.SRGAN import utils as srgan
    from animeface_tpu_torch.nnutils.loss import LSGANLoss, NonSaturatingLoss
    from animeface_tpu_torch.nnutils.loss.vgg import VGGLoss

    state, ran = _last_checkpoint(out)
    module = _recipe_module(recipe)
    args = module.default_args(image_size=int(ran['image_size']))
    d_logits = None
    if recipe == 'pix2pix':
        def make_step(G, D, G_ema, g_opt, d_opt):
            return module.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), args.pixelwise_gamma)
    else:
        vggs = {d.type: VGGLoss(d, vgg=16) for d in (torch.device('cpu'), dev)}

        def make_step(G, D, G_ema, g_opt, d_opt):
            return srgan.build_train_step(
                G, D, g_opt, d_opt, NonSaturatingLoss(), vggs[next(G.parameters()).device.type],
                args.adv_lambda, args.vgg_lambda, relativistic=recipe == 'ESRGAN')

        def d_logits(outs):
            return [logits for logits, _ in outs]
    return check_step_against_cpu(
        f'{recipe} {args.image_size}px', module.build_models, make_step, lambda G, real, a: {},
        args, SimpleNamespace(G=state['G'], D=state['D']), dev, zero_grad=ZERO_GRAD,
        make_real=paired_batch, d_logits=d_logits)


def run_paired_phase(recipe, dev, card):
    """One paired recipe at its CLI's defaults (128px, full width, batch
    32, bf16; pix2pix's UNet to 1x1, SRGAN's and ESRGAN's LR at 64px): the
    direct steps of `build_training` on one batch (`PAIRED_DIRECT`; the
    models' FLOP, ms a step, images/s, TFLOP/s, peak memory, no
    hand-written kernel launched, one profiled step), the CLI with its
    resume beside the direct images/s (`run_cli_path`), the f32 step on the
    card against the CPU. Prints each part's seconds."""
    parts = {}
    warmup, steps = PAIRED_DIRECT
    torch.cuda.empty_cache()
    t = time.perf_counter()
    direct = run_direct_steps(recipe, dev, card, steps, warmup, flop=paired_flop, profile=True,
                              make_real=paired_batch)
    parts['direct'] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out, _ = run_cli_path(recipe, card, direct)
    parts['CLI'] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    check_paired_step_against_cpu(recipe, out, dev)
    parts['f32 gate'] = time.perf_counter() - t
    print(f'phase {recipe} parts: ' + ', '.join(f'{k} {v:.1f} s' for k, v in parts.items()))


# ------------------------------------------------------ the line-art recipes

#: the line-art recipes of the xdog task on the paired runtime
#: (`nnutils/paired.py`): NAFNet and Restormer on NAFNet's restoration
#: step, pix2pixHD in two invocations, CycleGAN with spectral norm;
#: normalizations (its default 'in'), SPADE (its encoder, spectral norm
#: and BatchNorm on) and SCFT (the TPS warp, the triplet loss)
LINE_ART = ('NAFNet', 'Restormer', 'pix2pixHD', 'CycleGAN', 'normalizations', 'SPADE', 'SCFT')
LINE_ART_DIRECT = (2, 5)         # direct steps at the CLI's 128px default: warm-up, timed
LINE_ART_IMAGE = 128
#: forwards' worth of one G, one D and the VGG16 trunk in a step, a
#: backward as two. The restoration step: G 1 (the D phase, no grad) + 3;
#: D 2 + 4 in the D phase, 1 + 1 in the G phase (its parameters frozen: the
#: input gradient alone). pix2pixHD's fine step: D once more in the G phase
#: (the real pair's features, no grad). CycleGAN, for each G: 1 in the D
#: phase, 3 for its fake and 3 for its cycle reconstruction; each D as the
#: restoration D. normalizations: VGG on the image and on the fake (1 + 2)
#: for the style and again for the content loss (on the line art; computed
#: at content_lambda 0 too). SPADE (G with E): D's real pair once more in
#: the G phase. SCFT: G 1 + 2 x 3 (its positive and negative references);
#: VGG 1 + 3 for the style and again for the perceptual loss
LINE_ART_FORWARDS = {'NAFNet': (4, 8, 0), 'Restormer': (4, 8, 0), 'pix2pixHD': (4, 9, 0),
                     'CycleGAN': (7, 8, 0), 'normalizations': (4, 8, 8), 'SPADE': (4, 9, 0),
                     'SCFT': (7, 8, 8)}


def line_art_flop(run, args):
    """One step's FLOP at `args`' batch from G's and D's forwards on one
    sample (`forward_flop`, no buffer moves; CycleGAN's both Gs and both
    Ds) and LINE_ART_FORWARDS; prints them."""
    dev = next(run.G.parameters()).device
    image, line = paired_batch(SimpleNamespace(**dict(vars(args), batch_size=1)), dev)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False       # no autotuning of these shapes for a count
    try:
        if args.name == 'CycleGAN':
            g = forward_flop(lambda: (run.G['G_ab'](image, train=False),
                                      run.G['G_ba'](line, train=False)))
            d = forward_flop(lambda: (run.D['D_a'](image, train=False),
                                      run.D['D_b'](line, train=False)))
        elif args.name == 'SPADE':
            z = torch.zeros(1, args.z_dim, device=dev)
            g = forward_flop(lambda: (run.G['G'](z, line, train=False),
                                      run.G['E'](image, z, train=False)))
            d = forward_flop(lambda x: run.D(x, train=False), torch.cat([image, line], dim=1))
        elif args.name in ('normalizations', 'SCFT'):
            g = forward_flop(lambda: run.G(line, image, train=False))
            d = forward_flop(lambda x: run.D(x, train=False),
                             image if args.name == 'normalizations'
                             else torch.cat([line, image], dim=1))
        elif args.name == 'pix2pixHD':
            g = forward_flop(run.G, line)
            d = forward_flop(run.D, torch.cat([line, image], dim=1))
        else:
            g = forward_flop(run.G, line)
            d = forward_flop(lambda x: run.D(x, train=False), torch.cat([image, line], dim=1))
        v = forward_flop(run.vgg.model, image) if hasattr(run, 'vgg') else 0
    finally:
        torch.backends.cudnn.benchmark = benchmark
    fg, fd, fv = LINE_ART_FORWARDS[args.name]
    flop = args.batch_size * (fg * g + fd * d + fv * v)
    params = sum(p.numel() for p in run.G.parameters())
    print(f'{args.name}: G forward {g / 2e9:.2f} GMAC, D forward {d / 2e9:.2f} GMAC'
          + (f', VGG16 forward {v / 2e9:.2f} GMAC (f32)' if v else '') + ' a sample'
          + (' (both Gs, both Ds)' if args.name == 'CycleGAN' else '')
          + (' (G with E)' if args.name == 'SPADE' else '')
          + f'; G {params / 1e6:.1f}M parameters; a step {flop / 1e12:.3f} TFLOP at batch '
          f'{args.batch_size}')
    return flop


def check_line_art_step_against_cpu(recipe, out, dev):
    """The f32 step on the card against the CPU at batch 2
    (`check_step_against_cpu`) from the weights and buffers of the CLI
    run's last checkpoint under `out`, on a paired batch (`paired_batch`,
    every image nudged): NAFNet's and Restormer's restoration step,
    pix2pixHD's local fine step (everything trained; the global G's image
    head, which the local image never reads, has a zero gradient), CycleGAN's
    step with spectral norm on (S over both Ds' logits); normalizations'
    (DiffAugment 'color' and VGG16 on both devices, S over D's logits),
    SPADE's (its encoder's noise the draw z, S over D's logits) and SCFT's
    (DiffAugment, the TPS offsets, VGG16 with p=1); conv biases that an
    instance norm, a group norm or a train-mode BatchNorm follows are
    structurally zero (ZERO_GRAD)."""
    from animeface_tpu_torch.implementations.NAFNet import utils as nafnet
    from animeface_tpu_torch.nnutils.loss import HingeLoss, LSGANLoss
    from animeface_tpu_torch.nnutils.loss.vgg import VGGLoss

    state, ran = _last_checkpoint(out)
    module = _recipe_module(recipe)
    args = module.default_args(image_size=int(ran['image_size']))
    d_logits = hooked = None

    def draw(G, real, a):
        return {}
    if recipe in ('normalizations', 'SCFT'):
        vggs = {d.type: VGGLoss(d, vgg=16, p=1 if recipe == 'SCFT' else 2)
                for d in (torch.device('cpu'), dev)}
        weights = ((args.recon_lambda, args.style_lambda, args.content_lambda)
                   if recipe == 'normalizations' else
                   (args.recon_lambda, args.style_lambda, args.perc_lambda, args.triplet_lambda,
                    args.margin))

        def make_step(G, D, G_ema, g_opt, d_opt):
            return module.build_train_step(G, D, g_opt, d_opt, LSGANLoss(),
                                           vggs[next(G.parameters()).device.type], *weights)

        def draw(G, real, a):
            return module.draw_step_inputs(real[0], torch.Generator().manual_seed(6))
    if recipe in ('normalizations', 'SPADE'):
        def d_logits(outs):
            return [logits for logits, _ in outs]
    if recipe == 'SPADE':
        def make_step(G, D, G_ema, g_opt, d_opt):
            return module.build_train_step(G, D, g_opt, d_opt, HingeLoss(), args.feat_lambda,
                                           args.kld_lambda)

        def draw(G, real, a):
            return module.draw_step_inputs(G, real[0], torch.Generator().manual_seed(6))
    elif recipe in ('NAFNet', 'Restormer'):
        def make_step(G, D, G_ema, g_opt, d_opt):
            return nafnet.build_restoration_step(G, D, g_opt, d_opt, LSGANLoss(),
                                                 args.pixel_lambda)
    elif recipe == 'pix2pixHD':
        def make_step(G, D, G_ema, g_opt, d_opt):
            return module.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), args.feat_lambda,
                                           min(args.l_d_scale, args.d_num_scale), (), False)

        def d_logits(outs):
            return [logits for logits, _ in outs]
    elif recipe == 'CycleGAN':
        def make_step(G, D, G_ema, g_opt, d_opt):
            return module.build_train_step(G, D, g_opt, d_opt, LSGANLoss(), args.cycle_lambda)

        def hooked(D):
            return D['D_a'], D['D_b']
    return check_step_against_cpu(
        f'{recipe} {args.image_size}px', lambda a, d: module.build_models(a, d), make_step,
        draw, args, SimpleNamespace(G=state['G'], D=state['D']), dev, zero_grad=ZERO_GRAD,
        make_real=paired_batch, d_logits=d_logits, hooked=hooked)


def _pix2pixhd_recorder(seen):
    """A stand-in for pix2pixHD's `build_train_step` whose steps record
    (step index at entry, 'global', 'pre' or 'fine') in `seen`."""
    from animeface_tpu_torch.implementations.pix2pixHD import utils as hd

    orig = hd.build_train_step

    def build(G, D, g_opt, d_opt, loss, feat_lambda, d_scale, g_frozen, global_phase):
        step = orig(G, D, g_opt, d_opt, loss, feat_lambda, d_scale, g_frozen, global_phase)
        tag = 'global' if global_phase else ('pre' if g_frozen else 'fine')

        def recorded(state, batch, draws=None):
            seen.append((state['step'], tag))
            return step(state, batch, draws)
        return recorded
    return hd, orig, build


def run_pix2pixhd_cli(card):
    """pix2pixHD's two invocations of one command: the first (no
    `global_final.pt` yet) trains the global G at half the size and writes
    the file; then `run_cli_path`'s run and resume are the second
    invocation, the local phase from that file, crossing `fine_from`.
    Checks the file (G and D whole, finite, the keys the models have), no
    hand-written kernel launched, and each step's variant: every step of
    the first invocation global, the local run's steps pre before
    `fine_from`'s step and fine after, the resume's fine. Returns the
    second invocation's result directory."""
    import os
    from animeface_tpu_torch.__main__ import main as cli_main
    from animeface_tpu_torch.utils import add_args
    from animeface_tpu_torch.utils.argument import get_default_parser

    flags, steps, save, resume_to, _ = CLI_RUNS['pix2pixHD']
    out = os.path.join(os.environ['ANIMEFACE_IMPLEMENTATIONS_DIR'], 'pix2pixHD', 'result')
    seen = []
    hd, orig, build = _pix2pixhd_recorder(seen)
    path = os.path.join(out, hd.GLOBAL_CKPT)
    if os.path.exists(path):
        raise AssertionError(f'{path} exists before the first invocation')
    hd.build_train_step = build
    try:
        _reset_launches()
        t0 = time.perf_counter()
        cli_main(['pix2pixHD', '--synthetic-data', *flags, '--max-iters', str(steps), '--save',
                  str(save)])
        wall = time.perf_counter() - t0
        _check_no_launches('pix2pixHD global CLI')
        first = list(seen)
        saved = torch.load(path, map_location='cpu', weights_only=True)
        args = add_args(get_default_parser(), hd.PIX2PIXHD_ARGS).parse_args(['pix2pixHD',
                                                                            *flags])
        G, D, _ = hd.build_models(args, 'cpu')
        for name, model in (('G', G), ('D', D)):
            if set(saved[name]) != set(model.state_dict()) or not all(
                    bool(torch.isfinite(v).all()) for v in saved[name].values()):
                raise AssertionError(f'pix2pixHD {hd.GLOBAL_CKPT}: {name} is not the model\'s '
                                     'state or not finite')
        seen.clear()
        out_local, _ = run_cli_path('pix2pixHD', card)
    finally:
        hd.build_train_step = orig
    fine_at = int(flags[flags.index('--fine-from') + 1]) * int(
        flags[flags.index('--num-images') + 1]) // args.batch_size
    want = ([(i, 'global') for i in range(steps)],
            [(i, 'pre' if i < fine_at else 'fine') for i in range(resume_to)])
    if (first, seen) != want:
        raise AssertionError(f'pix2pixHD CLI steps {first} then {seen}, want {want}')
    print(f'pix2pixHD CLI: the global invocation {wall:.2f} s ({steps} steps at '
          f'{args.image_size // 2}px, {hd.GLOBAL_CKPT} with G and D whole), then the local run '
          f'and its resume: steps {seen} (fine from step {fine_at}) on {card}')
    return out_local


def run_line_art_phase(recipe, dev, card):
    """One line-art recipe: the direct steps of `build_training` at the CLI's
    128px defaults (full width, batch 32, bf16, no cuDNN autotuning as the
    recipe's CLI; pix2pixHD's local fine step) on one batch
    (`LINE_ART_DIRECT`; the models' FLOP, ms a step, images/s,
    TFLOP/s, peak memory, no hand-written kernel launched, one profiled
    step), the CLI with its resume at `CLI_RUNS`' size (64px; SPADE's and
    SCFT's 128px: `run_cli_path`; pix2pixHD both invocations,
    `run_pix2pixhd_cli`), the f32 step on the card against the CPU. Prints
    each part's seconds."""
    parts = {}
    warmup, steps = LINE_ART_DIRECT
    overrides = dict(image_size=LINE_ART_IMAGE, **({'fine_from': 0} if recipe == 'pix2pixHD'
                                                   else {}))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = _recipe_module(recipe).AUTOTUNE     # as the CLI runs
    try:
        run_direct_steps(recipe, dev, card, steps, warmup, overrides=overrides,
                         flop=line_art_flop, profile=True, make_real=paired_batch)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    parts['direct'] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out = (run_pix2pixhd_cli(card) if recipe == 'pix2pixHD'
           else run_cli_path(recipe, card)[0])        # at 64px: no direct images/s beside it
    parts['CLI'] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    check_line_art_step_against_cpu(recipe, out, dev)
    parts['f32 gate'] = time.perf_counter() - t
    print(f'phase {recipe} parts: ' + ', '.join(f'{k} {v:.1f} s' for k, v in parts.items()))


#: generate's three flows, their flags
GENERATE_FLOWS = {'plain': (), 'truncation': ('--truncation', '0.7'),
                  'mix': ('--mix-seed', '1', '--mix-layer', '8')}
GENERATE_NUM = 16              # images a grid (the tool's default)
GENERATE_HELD = 4              # images of the f32 card-vs-CPU hold


def run_generate_path(dev, card, sg2_out):
    '''`python -m animeface_tpu_torch.generate` in-process on the StyleGAN2
    CLI run's newest G_<step>.pt, with that run's widths (its arguments):
    the plain, truncated and mixed grids (16 images, 4 a row, bf16), each
    PNG's size, finite images in [-1, 1], each flow's seconds; then the
    plain flow in f32 on the card against the CPU on GENERATE_HELD images
    with the same draws (made on the CPU), within 1e-3 of the images'
    scale; no hand-written kernel launched.'''
    import os
    from animeface_tpu_torch import generate
    from animeface_tpu_torch.checkpoint import Checkpointer

    snaps = [f for f in os.listdir(sg2_out) if f.startswith('G_') and f[2:-3].isdigit()]
    weights = os.path.join(sg2_out, max(snaps, key=lambda f: int(f[2:-3])))
    ckpt_dir = os.path.join(sg2_out, 'checkpoint')
    with open(os.path.join(ckpt_dir, f'ckpt-{Checkpointer(ckpt_dir).latest_step()}',
                           'meta.json')) as f:
        ran = json.load(f)['args']                  # the run's arguments, as strings
    widths = ['--weights', weights, '--image-size', ran['image_size'], '--style-dim',
              ran['style_dim'], '--channels', ran['channels'], '--max-channels',
              ran['max_channels']]
    if int(ran['map_num_layers']) != 8:
        raise AssertionError(f'generate builds 8 mapping layers; the run had '
                             f'{ran["map_num_layers"]}')
    _reset_launches()
    size = int(ran['image_size'])
    for name, flags in GENERATE_FLOWS.items():
        path = os.path.join(os.environ['ANIMEFACE_IMPLEMENTATIONS_DIR'], f'generate_{name}.png')
        t0 = time.perf_counter()
        images = generate.main([*widths, '--num', str(GENERATE_NUM), '--out', path, *flags])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if _png_size(path) != _grid_size(GENERATE_NUM, 4, size):
            raise AssertionError(f'generate {name}: {path} is not {GENERATE_NUM} images 4 a row')
        if not (bool(torch.isfinite(images).all()) and float(images.abs().max()) <= 1):
            raise AssertionError(f'generate {name}: images not finite or outside [-1, 1]')
        print(f'generate {name}: {GENERATE_NUM} images at {size}px, grid '
              f'{_png_size(path)}, {dt:.2f} s (G built and loaded, bf16) on {card}')
    _check_no_launches('generate')

    args = generate.parse_args([*widths, '--num', str(GENERATE_HELD)])
    cpu = torch.device('cpu')
    t0 = time.perf_counter()
    G_cpu = generate.build_generator(args, cpu, torch.float32)
    draws = generate.draw_inputs(G_cpu, args, cpu)
    want = generate.sample(G_cpu, args, draws)
    got = generate.sample(generate.build_generator(args, dev, torch.float32), args,
                          _to(draws, dev)).cpu()
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    print(f'generate plain, f32, card vs CPU on {GENERATE_HELD} images: max err {err:.3e} of '
          f'the scale (tol 1e-3), {time.perf_counter() - t0:.2f} s')
    if not err <= 1e-3:
        raise AssertionError(f'generate: the card is {err:.3e} of the scale off the CPU')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this run needs one GPU', file=sys.stderr)
        return 1
    import os
    import tempfile
    with tempfile.TemporaryDirectory(prefix='chip_smoke_results_') as results:
        # the training CLI's result directories (read when the port's
        # argument module is first imported, below)
        os.environ['ANIMEFACE_IMPLEMENTATIONS_DIR'] = results
        return run_all()


@contextlib.contextmanager
def phase(name):
    '''Names the phase on stderr when the code inside raises; the error
    goes on (the run exits nonzero). A step gate deferred inside it carries
    its name (`DeferredGates`).'''
    token = _PHASE.set(name)
    try:
        yield
    except BaseException as e:
        print(f'chip_smoke: phase {name} failed: {type(e).__name__}: {e}', file=sys.stderr,
              flush=True)
        raise
    finally:
        _PHASE.reset(token)


def run_all() -> int:
    from animeface_tpu_torch import _build, resolve_device

    t_start = time.perf_counter()
    dev = resolve_device('cuda')
    card = _card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True     # autotune conv algorithms in the warm-up
    torch.backends.cudnn.benchmark_limit = BENCHMARK_LIMIT
    print(f'torch {torch.__version__}  cuda {torch.version.cuda}  '
          f'{torch.cuda.get_device_name(0)}')

    with phase('kernel build'):
        t0 = time.perf_counter()
        reports = _build.build_all()
        print(f'kernel build: {time.perf_counter() - t0:.2f} s')
        for name, report in reports.items():
            for line in report.splitlines():
                if 'registers' in line or 'spill' in line:
                    print(f'  {name}: {line.strip()}')

    with phase('warp kernels'):
        images, G_inv, kernels = check_kernels(dev)
        check_warp_against_dense(images, G_inv)
        images, G_inv, line_kernels = check_line_kernels(dev)
        check_warp_against_dense(images, G_inv)
        del images, G_inv

    # the step gates' float64 CPU references run in a thread of their own
    # beside the phases that follow theirs; all are waited for at the end
    with deferred_gates():
        with phase('main path'):
            kernels[0]['launches'], kernels[1]['launches'] = run_main_path(dev, card)
            torch.cuda.empty_cache()
        with phase('ADA'):
            (line_kernels[0]['launches'], line_kernels[1]['launches']), ada_ips = \
                run_ada_path(dev, card)
            kernels += line_kernels
            torch.cuda.empty_cache()

        with phase('bias_act and filtered_lrelu'):
            from animeface_tpu_torch.ops import setup_filter
            fu = setup_filter(np.hanning(12), device=dev)
            bias_act_entry = check_bias_act_kernel(dev)
            flrelu_entry = check_filtered_lrelu_kernel(dev, fu)
            check_grad_refused(dev, fu)
            flrelu_entry['launches'] = run_flrelu_path(dev, fu)
            torch.cuda.empty_cache()
        with phase('CIPS sampling'):
            bias_act_entry['launches'] = run_cips_path(dev, card)
            kernels += [bias_act_entry, flrelu_entry]
            torch.cuda.empty_cache()
        with phase('CIPS training'):
            cips_ips = run_cips_train_path(dev, card)
            torch.cuda.empty_cache()
        with phase('FastGAN'):
            fastgan_ips, _ = run_fastgan_path(dev, card)
            torch.cuda.empty_cache()
        with phase('StyleGAN2 + DiffAugment'):
            sg2_ips = run_stylegan2_diffaugment_path(dev, card)
            torch.cuda.empty_cache()

        with phase('ADA CLI'):
            ada_out, _ = run_cli_path('ADA', card, ada_ips, want_line=(6, 2))
            torch.cuda.empty_cache()
        with phase('StyleGAN2 CLI'):
            sg2_out, _ = run_cli_path('StyleGAN2', card, sg2_ips)

        # the other BASELINE configs (StyleGAN3 256px, DCGAN and WGAN-gp 64px,
        # FastGAN 256px through the CLI), GAN and WGAN on DCGAN's runtime, CIPS
        with phase('StyleGAN3 256px'):
            torch.cuda.empty_cache()
            t = time.perf_counter()
            run_stylegan3_256_path(dev, card)
            print(f'phase StyleGAN3 256px: {time.perf_counter() - t:.1f} s')
        for recipe in ('DCGAN', 'WGAN_gp', 'GAN', 'WGAN', 'CIPS', 'FastGAN'):
            with phase(f'{recipe} CLI'):
                torch.cuda.empty_cache()
                t = time.perf_counter()
                direct = {'CIPS': cips_ips, 'FastGAN': fastgan_ips}.get(recipe)
                if direct is None:
                    direct = run_direct_steps(recipe, dev, card)
                out, _ = run_cli_path(recipe, card, direct)
                if recipe in ('DCGAN', 'WGAN_gp'):
                    check_cli_step_against_cpu(recipe, out, dev)
                print(f'phase {recipe} CLI: {time.perf_counter() - t:.1f} s')

        # the progressive recipes: direct steps at 128px, the CLI through
        # every phase, PGGAN's kill and resume
        pggan_out = None
        for recipe in ('PGGAN', 'StyleGAN'):
            with phase(recipe):
                torch.cuda.empty_cache()
                t = time.perf_counter()
                run_progressive_steps(recipe, dev, card)
                torch.cuda.empty_cache()
                out = run_progressive_cli(recipe, card)
                if recipe == 'PGGAN':
                    pggan_out = out
                    run_progressive_kill_resume(card)
                print(f'phase {recipe}: {time.perf_counter() - t:.1f} s')

        # the BigGAN family at the CLI's 128px defaults: direct steps, the CLI
        # with its resume, the f32 step on the card against the CPU
        for recipe in ('BigGAN', 'SEBigGAN'):
            with phase(recipe):
                torch.cuda.empty_cache()
                t = time.perf_counter()
                run_biggan_phase(recipe, dev, card)
                print(f'phase {recipe}: {time.perf_counter() - t:.1f} s')

        # the simple-GAN recipes (direct steps: TransGAN at 64px, the others at
        # 128px; the CLIs of TransGAN at 32px, ConvNeXt and VAN at 64px): direct
        # steps, the CLI with its resume, the f32 step gate; then
        # generate on the StyleGAN2 CLI run's snapshot
        for recipe in SIMPLE_GANS:
            with phase(recipe):
                t = time.perf_counter()
                run_simple_gan_phase(recipe, dev, card)
                print(f'phase {recipe}: {time.perf_counter() - t:.1f} s')
        with phase('generate'):
            torch.cuda.empty_cache()
            t = time.perf_counter()
            run_generate_path(dev, card, sg2_out)
            print(f'phase generate: {time.perf_counter() - t:.1f} s')

        # the paired data tasks, then pix2pix (xdog), SRGAN and ESRGAN (sr) at
        # their CLI's defaults: direct steps, the CLI with its resume, the gate
        t_paired = time.perf_counter()
        with phase('data'):
            run_data_path(dev, card)
            print(f'phase data: {time.perf_counter() - t_paired:.1f} s')
        for recipe in PAIRED:
            with phase(recipe):
                t = time.perf_counter()
                run_paired_phase(recipe, dev, card)
                print(f'phase {recipe}: {time.perf_counter() - t:.1f} s')
        print(f'phases data and paired recipes: {time.perf_counter() - t_paired:.1f} s')

        # the line-art recipes of the xdog task at their CLI's defaults: direct
        # steps at 128px, the CLI with its resume at 64px (pix2pixHD's two
        # invocations), the gate
        t_line_art = time.perf_counter()
        for recipe in LINE_ART:
            with phase(recipe):
                t = time.perf_counter()
                run_line_art_phase(recipe, dev, card)
                print(f'phase {recipe}: {time.perf_counter() - t:.1f} s')
        print(f'phases line-art recipes: {time.perf_counter() - t_line_art:.1f} s')

        # the metrics, on the StyleGAN2, ADA and PGGAN CLI runs' snapshots
        with phase('metrics'):
            torch.cuda.empty_cache()
            t = time.perf_counter()
            run_metrics_path(dev, card, sg2_out, ada_out, pggan_out)
            print(f'phase metrics: {time.perf_counter() - t:.1f} s')
        t = time.perf_counter()
    print(f'step gates\' CPU references: {time.perf_counter() - t:.1f} s waited for after the '
          'metrics')

    print(f'chip_smoke total: {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
