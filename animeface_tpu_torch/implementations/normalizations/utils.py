'''The normalizations recipe in PyTorch: reference-based colorization of
line art with a selectable normalization.

Counterpart of `animeface_tpu/implementations/normalizations/utils.py`
(`build_train_step`, `train`, `main`). Semantics kept:
  * a batch is (image, line art) of the xdog task: the image is the style
    reference and the target, the line art the content; DiffAugment
    'color' moves the image (`style_aug`) once a step;
  * D phase: G's fake under no gradient, its BatchNorm statistics (with
    'bn') KEPT; SRGAN's D (one scale, no spectral norm) on `style_aug`,
    then on the fake; LSGAN's D losses summed over the scales; an Adam step;
  * G phase: G and D again, their buffer updates DROPPED (JAX keeps the D
    phase's); LSGAN's G losses, the L1 between the fake and `style_aug`
    times `recon_lambda`, VGG16's style loss times `style_lambda` and its
    content loss against the line art as RGB times `content_lambda`
    (computed at the default 0 as well); an Adam step;
  * Adam (betas (0.5, 0.999), eps 1e-8) at `lr` for both; the metrics `D`
    and `G`, NaN turned to 0; the grid's images are (line art as RGB,
    image, G(line art, image)) for each test sample, 6 a row, G in eval
    mode; no cuDNN autotuning (`AUTOTUNE`).
The step draws DiffAugment's uniforms from `state['generator']` unless
given (`draw_step_inputs`), mutates `state` and the modules in place and
returns the losses as 0-dim tensors without a host sync.
'''

from __future__ import annotations

from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.NAFNet.utils import AUTOTUNE  # no cuDNN autotuning
from animeface_tpu_torch.implementations.normalizations.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.loss import LSGANLoss
from animeface_tpu_torch.nnutils.loss.vgg import VGGLoss
from animeface_tpu_torch.nnutils.rng import make_generator
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.nnutils.training import buffers_dropped, step_all_parameters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `normalizations/utils.py:main`, names, defaults and help)
NORMALIZATIONS_ARGS = dict(
    num_test=[4, 'number images for test.'],
    norm_name=['in', 'normalization layer name'],
    lr=[0.0002, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    style_lambda=[10., 'lambda for style loss'],
    content_lambda=[0., 'lambda for content loss'],
    recon_lambda=[5., 'lambda for reconstruction loss'],
    channels=[32, 'G channel width (reference hardcodes 32)'],
    style_dim=[512, 'style vector dimension (reference hardcodes 512)'],
    d_num_scale=[1, 'D scales (reference hardcodes num_discs=1)'],
    d_channels=[64, 'D channel width (reference hardcodes 64)'],
)
POLICY = 'color'
#: the xdog task's (image, line art) channels
CHANNELS = (3, 1)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('normalizations', NORMALIZATIONS_ARGS, overrides)


def build_models(args, device=None, seed=0, channels=CHANNELS):
    '''G, D and None (no EMA copy) on `device` (default `cuda`), weights
    drawn from `seed`; `channels` those of the (image, line art) batch;
    bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    G = Generator(args.image_size, in_channels=channels[1], style_channels=channels[0],
                  channels=args.channels, style_dim=args.style_dim, norm_name=args.norm_name,
                  dtype=dtype, generator=g)
    D = Discriminator(num_scale=args.d_num_scale, channels=args.d_channels, sn=False,
                      image_channels=channels[0], dtype=dtype, generator=g)
    return G.to(device), D.to(device), None


def draw_step_inputs(image, generator):
    '''Every random draw of one step: DiffAugment's for the image (`aug`).'''
    B, _, H, W = image.shape
    return dict(aug=draw_diff_augment(B, H, W, POLICY, generator, image.dtype))


def build_train_step(G, D, g_opt, d_opt, loss, vgg, recon_lambda, style_lambda,
                     content_lambda):
    '''One iteration (module docstring). Returns `train_step(state, batch,
    draws=None) -> metrics`, `batch` (image, line art).'''

    def train_step(state, batch, draws=None):
        style_img, content = batch
        if draws is None:
            draws = draw_step_inputs(style_img, state['generator'])
        style_aug = diff_augment(style_img, POLICY, draws['aug'])

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = G(content, style_aug, train=True)
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = 0.0
        for (r, _), (f, _) in zip(D(style_aug, train=True), D(fake, train=True)):
            d_loss = d_loss + loss.d_loss(r, f)
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase (its buffer updates dropped) ----------------
        with buffers_dropped(G, D):
            D.requires_grad_(False)
            g_opt.zero_grad(set_to_none=True)
            fake2 = G(content, style_aug, train=True)
            g_loss = 0.0
            for f, _ in D(fake2, train=True):
                g_loss = g_loss + loss.g_loss(f)
            g_loss = g_loss + (fake2 - style_aug).abs().mean() * recon_lambda
            g_loss = g_loss + vgg.style_loss(style_aug, fake2) * style_lambda
            g_loss = g_loss + vgg.content_loss(paired.as_rgb(content), fake2) * content_lambda
            g_loss.backward()
            step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        state['step'] += 1
        return dict(D=torch.nan_to_num(d_loss.detach()), G=torch.nan_to_num(g_loss.detach()))

    return train_step


def build_training(args, device=None, seed=0, test_batch=None):
    '''Everything one step needs, from `seed`: a namespace with G, D, the
    optimizers, `vgg`, `state` (the step count and the generator the draws
    come from), `train_step(state, batch, draws=None) -> metrics` (VGG16's
    losses on `vgg`, a `VGGLoss` on G's device) and, given a
    test batch (numpy NHWC (image, line art)), `sample_fn`.'''
    channels = CHANNELS if test_batch is None else tuple(int(a.shape[-1]) for a in test_batch)
    G, D, _ = build_models(args, device, seed, channels)
    device = next(G.parameters()).device
    g_opt, d_opt = (torch.optim.Adam(m.parameters(), lr=args.lr, betas=tuple(args.betas), eps=1e-8)
                    for m in (G, D))
    vgg = VGGLoss(device, vgg=16, p=2)
    step = build_train_step(G, D, g_opt, d_opt, LSGANLoss(), vgg, args.recon_lambda,
                            args.style_lambda, args.content_lambda)
    sample_fn = None
    if test_batch is not None:
        style, content = paired.nchw(test_batch, device)
        sample_fn = paired.make_grid_sampler(lambda: G(content, style, train=False),
                                             (paired.as_rgb(content), style))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, vgg=vgg,
                           state=dict(step=0, generator=make_generator(seed, device)),
                           train_step=step, sample_fn=sample_fn)


def train(args, max_iters, loader, test_batch):
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    run = build_training(args, accel.device, args.seed, test_batch)
    return paired.run_paired('normalizations', run, args, accel, loader, max_iters, nrow=6)


def main(parser):
    parser = add_args(parser, NORMALIZATIONS_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader, test_batch = paired.load_task(args, 'xdog')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader, test_batch)
