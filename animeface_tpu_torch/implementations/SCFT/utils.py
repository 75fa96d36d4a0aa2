'''The SCFT recipe in PyTorch: sketch colorization from a reference image,
with LSGAN on (sketch ‖ image), an L1 reconstruction, VGG16's style and
perceptual losses and the similarity triplet loss over SCFT's (q, k).

Counterpart of `animeface_tpu/implementations/SCFT/utils.py`
(`triplet_loss`, `build_train_step`, `train`, `main`). Semantics kept:
  * a batch is (image, line art) of the xdog task; DiffAugment 'color'
    moves the image once a step (`real_aug`), and the TPS warp of that
    (`tps.py`, the step's offsets) is the reference G colours from
    (`real_s`);
  * D phase: G(sketch, real_s) under no gradient, its u updates DROPPED;
    D on (sketch ‖ real_aug), then on (sketch ‖ fake), its u moving through
    both and kept; LSGAN's D loss; an Adam step;
  * G phase: G on real_s, then on real_aug (the negative), the second
    from the u the first left: both updates KEPT; D (at its new parameters)
    on the fake pair, its update dropped; LSGAN's G loss, the L1 between
    the fake and real_aug times `recon_lambda`, VGG16's (p=1) style loss
    times `style_lambda`, its perceptual loss over blocks 0-3 times
    `perc_lambda`, and `triplet_loss(q of real_s, k of real_aug, k of
    real_s, margin)` times `triplet_lambda` (each term where its lambda is
    above 0); an Adam step;
  * Adam (betas (0.5, 0.999), eps 1e-8), G at `g_lr`, D at `d_lr`;
  * the metrics `d` and `g`, NaN turned to 0; the grid's images are
    (sketch as RGB, image, G(sketch, image)) for each test sample, 6 a row,
    G in eval mode; no cuDNN autotuning (`AUTOTUNE`).
The step draws DiffAugment's uniforms and the TPS offsets from
`state['generator']` unless given (`draw_step_inputs`), mutates `state`
and the modules in place and returns the losses as 0-dim tensors without a
host sync.
'''

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.NAFNet.utils import AUTOTUNE  # no cuDNN autotuning
from animeface_tpu_torch.implementations.SCFT.model import Discriminator, Generator
from animeface_tpu_torch.implementations.SCFT.tps import TPSWarp, draw_offsets
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

#: the recipe's flags (JAX `SCFT/utils.py:main`, names, defaults and help)
SCFT_ARGS = dict(
    num_test=[9, 'number of image for eval'],
    sketch_channels=[1, 'number of channels for sketch images'],
    ref_channels=[3, 'number of channels for reference images'],
    bottom_width=[8, 'bottom width'],
    enc_channels=[16, 'channel width multiplier for encoder/decoder'],
    layer_per_resl=[2, 'number of layers per resolution'],
    num_res_blocks=[7, 'number of residual blocks in G'],
    disable_sn=[False, 'disable spectral norm'],
    disable_bias=[False, 'disable bias'],
    enable_scft_bias=[False, 'enable bias in scft'],
    norm_name=['in', 'normalization layer name'],
    act_name=['lrelu', 'activation function name'],
    num_layers=[3, 'number of layers in D'],
    d_channels=[32, 'channels_width multiplier'],
    d_lr=[0.0002, 'learning rate for D'],
    g_lr=[0.0001, 'learning rate for G'],
    betas=[[0.5, 0.999], 'betas'],
    recon_lambda=[30., 'lambda for reconstruction loss'],
    triplet_lambda=[1., 'lambda for triplet loss'],
    margin=[12., 'margin for triplet loss'],
    perc_lambda=[0.01, 'lambda for percrptual loss'],
    style_lambda=[50., 'lambda for style loss'],
)
POLICY = 'color'


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('SCFT', SCFT_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G, D and None (no EMA copy) on `device` (default `cuda`), weights
    drawn from `seed`, bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    sk_ch, ref_ch = int(args.sketch_channels), int(args.ref_channels)
    G = Generator(args.image_size, sk_ch, ref_ch, args.bottom_width, args.enc_channels,
                  args.layer_per_resl, args.num_res_blocks, not args.disable_sn,
                  not args.disable_bias, args.enable_scft_bias, args.norm_name, args.act_name,
                  dtype, g)
    D = Discriminator(sk_ch + ref_ch, args.num_layers, args.d_channels, not args.disable_sn,
                      not args.disable_bias, args.norm_name, args.act_name, dtype, g)
    return G.to(device), D.to(device), None


def triplet_loss(anchor, negative, positive, margin):
    '''mean(relu(-a.p + a.n + margin)), the dot products over each sample's
    flattened features scaled by 1 / sqrt(their size).'''
    a, n, p = (t.flatten(1) for t in (anchor, negative, positive))
    scale = np.sqrt(a.shape[1])
    ap = (a * p).sum(dim=1) / scale
    an = (a * n).sum(dim=1) / scale
    return F.relu(-ap + an + margin).mean()


def draw_step_inputs(image, generator):
    '''Every random draw of one step: DiffAugment's for the image (`aug`)
    and the TPS control points' offsets (`tps`).'''
    B, _, H, W = image.shape
    return dict(aug=draw_diff_augment(B, H, W, POLICY, generator, image.dtype),
                tps=draw_offsets(B, generator, dtype=image.dtype))


def build_train_step(G, D, g_opt, d_opt, loss, vgg, recon_lambda, style_lambda, perc_lambda,
                     triplet_lambda, margin):
    '''One iteration (module docstring). Returns `train_step(state, batch,
    draws=None) -> metrics`, `batch` (image, line art).'''
    warps = {}

    def train_step(state, batch, draws=None):
        real, sketch = batch
        if draws is None:
            draws = draw_step_inputs(real, state['generator'])
        size = tuple(real.shape[-2:])
        if size not in warps:
            warps[size] = TPSWarp(*size, device=real.device)
        real_aug = diff_augment(real, POLICY, draws['aug'])
        real_s = warps[size](real_aug, draws['tps'])

        def d_in(x):
            return torch.cat([sketch.to(x.dtype), x], dim=1)

        # ---------------- D phase ----------------
        with torch.no_grad(), buffers_dropped(G):
            fake = G(sketch, real_s, train=True)
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_logits, _ = D(d_in(real_aug), train=True)
        fake_logits, _ = D(d_in(fake), train=True)
        d_loss = loss.d_loss(real_logits, fake_logits)
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase (D's buffer update dropped) ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        fake2, qk_pos = G(sketch, real_s, return_qk=True, train=True)
        _, qk_neg = G(sketch, real_aug, return_qk=True, train=True)
        with buffers_dropped(D):
            fake_logits, _ = D(d_in(fake2), train=True)
        g_loss = loss.g_loss(fake_logits)
        if recon_lambda > 0:
            g_loss = g_loss + (fake2 - real_aug).abs().mean() * recon_lambda
        if style_lambda > 0:
            g_loss = g_loss + vgg.style_loss(real_aug, fake2) * style_lambda
        if perc_lambda > 0:
            g_loss = g_loss + vgg.vgg_loss(real_aug, fake2, (0, 1, 2, 3)) * perc_lambda
        if triplet_lambda > 0:
            g_loss = g_loss + triplet_loss(qk_pos[0], qk_neg[1], qk_pos[1], margin) \
                * triplet_lambda
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        state['step'] += 1
        return dict(d=torch.nan_to_num(d_loss.detach()), g=torch.nan_to_num(g_loss.detach()))

    return train_step


def build_training(args, device=None, seed=0, test_batch=None):
    '''Everything one step needs, from `seed`: a namespace with G, D, the
    optimizers, `vgg`, `state` (the step count and the generator the draws
    come from), `train_step(state, batch, draws=None) -> metrics` (VGG16's
    losses on `vgg`, a `VGGLoss(p=1)` on G's device) and, given
    a test batch (numpy NHWC (image, line art)), `sample_fn`.'''
    if test_batch is not None and int(test_batch[1].shape[-1]) != int(args.sketch_channels):
        raise ValueError(f'--sketch-channels {args.sketch_channels} does not match the dataset '
                         f'sketch channels {test_batch[1].shape[-1]}')
    G, D, _ = build_models(args, device, seed)
    device = next(G.parameters()).device
    g_opt = torch.optim.Adam(G.parameters(), lr=args.g_lr, betas=tuple(args.betas), eps=1e-8)
    d_opt = torch.optim.Adam(D.parameters(), lr=args.d_lr, betas=tuple(args.betas), eps=1e-8)
    vgg = VGGLoss(device, vgg=16, p=1)
    step = build_train_step(G, D, g_opt, d_opt, LSGANLoss(), vgg, args.recon_lambda,
                            args.style_lambda, args.perc_lambda, args.triplet_lambda, args.margin)
    sample_fn = None
    if test_batch is not None:
        image, sketch = paired.nchw(test_batch, device)
        sample_fn = paired.make_grid_sampler(lambda: G(sketch, image, train=False),
                                             (paired.as_rgb(sketch), image))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, vgg=vgg,
                           state=dict(step=0, generator=make_generator(seed, device)),
                           train_step=step, sample_fn=sample_fn)


def train(args, max_iters, loader, test_batch):
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    run = build_training(args, accel.device, args.seed, test_batch)
    return paired.run_paired('SCFT', run, args, accel, loader, max_iters, nrow=6)


def main(parser):
    parser = add_args(parser, SCFT_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader, test_batch = paired.load_task(args, 'xdog')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader, test_batch)
