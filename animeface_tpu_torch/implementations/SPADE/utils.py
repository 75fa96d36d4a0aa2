'''The SPADE recipe in PyTorch: line art to colour with spatially adaptive
normalization, a VAE encoder for the style, the hinge loss and feature
matching over SRGAN's multi-scale D.

Counterpart of `animeface_tpu/implementations/SPADE/utils.py`
(`build_train_step`, `train`, `main`). Semantics kept:
  * a batch is (image, line art) of the xdog task; D sees (image ‖ line
    art); G is a module dict of the generator (`G`) and, unless
    `--no-encoder`, the encoder (`E`), so that one Adam covers both as the
    JAX optimizer does, and `G_<step>.pt` holds both;
  * z is E's reparameterization of the image with the step's draw `z` as
    its noise (the same draw in both phases, as JAX's one key), or the
    draw itself without E;
  * D phase: E and G under no gradient, their buffer updates (u, running
    statistics) DROPPED; D on the real pair, then the fake one, its u moving
    through both and kept; the hinge loss summed over the scales; an Adam
    step;
  * G phase: E and G again, their updates KEPT; D (at its new parameters)
    on the real and the fake pairs, each from the D phase's u, its updates
    dropped; the hinge G loss
    and, with `feat_lambda` > 0, pix2pixHD's `feature_matching` / the
    number of scales * `feat_lambda` for each scale; with E and
    `kld_lambda` > 0 the KL divergence (a sum) times `kld_lambda`; an Adam
    step;
  * D is SRGAN's with `num_scale` scales of `num_layers` layers at
    `channels`, spectral norm unless `--d-disable-sn`, its norm 'in': the
    JAX recipe reads `--d-norm-name` nowhere, and neither does the port;
  * Adam at `lr` with betas (beta1, beta2), or with `--ttur` G at lr / 2
    and D at lr * 2 with betas (0, 0.9); eps 1e-8;
  * the metrics `d` and `g`, NaN turned to 0; the grid's images are (line
    art as RGB, image, G(z, line art)) for each test sample, 6 a row, z a
    fixed draw, G in eval mode; no cuDNN autotuning (`AUTOTUNE`).
The step draws z from `state['generator']` unless given
(`draw_step_inputs`), mutates `state` and the modules in place and returns
the losses as 0-dim tensors without a host sync.
'''

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.NAFNet.utils import AUTOTUNE  # no cuDNN autotuning
from animeface_tpu_torch.implementations.SPADE.model import Discriminator, Encoder, Generator
from animeface_tpu_torch.implementations.pix2pixHD.utils import feature_matching
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import HingeLoss
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.nnutils.training import buffers_dropped, step_all_parameters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `SPADE/utils.py:main`, names, defaults and help)
SPADE_ARGS = dict(
    line_channels=[1, 'number of channels of line art images'],
    rgb_channels=[3, 'number of channels of the generated images'],
    test_images=[6, 'number of images for test'],
    z_dim=[256, 'number of dimensions for input z'],
    channels=[32, 'channel width multiplier'],
    max_channels=[1024, 'maximum number of channels'],
    block_num_conv=[2, 'number of convolution layers per residual block'],
    spade_hidden_channels=[128, 'number of channels in SPADE hidden layers'],
    g_norm_name=['bn', 'normalization layer name of G'],
    g_act_name=['lrelu', 'activation function name of G'],
    g_disable_bias=[False, 'do not use bias in G'],
    g_disable_sn=[False, 'do not use spectral normalization in G'],
    num_scale=[2, 'number of scales to discriminate'],
    num_layers=[3, 'number of layers in D'],
    d_norm_name=['bn', 'normalization layer name of D'],
    d_act_name=['lrelu', 'activation function name of D'],
    d_disable_bias=[False, 'do not use bias in D (fixed: biased convs in the shared patch D)'],
    d_disable_sn=[False, 'do not use spectral normalization in D'],
    no_encoder=[False, 'do not use encoder'],
    target_resl=[4, 'to what resolution down-sample to before FC layers in E'],
    e_norm_name=['bn', 'normalization layer name of E'],
    e_act_name=['lrelu', 'activation function name of E'],
    e_disable_bias=[False, 'do not use bias in E'],
    e_disable_sn=[False, 'do not use spectral normalization in E'],
    lr=[0.0002, 'learning rate'],
    beta1=[0.5, 'beta1'],
    beta2=[0.999, 'beta2'],
    ttur=[False, 'use TTUR'],
    kld_lambda=[0.05, 'lambda for KL divergence'],
    feat_lambda=[10., 'lambda for feature matching loss'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('SPADE', SPADE_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G (a module dict: the generator `G` and, unless `no_encoder`, the
    encoder `E`), D and None (no EMA copy) on `device` (default `cuda`),
    weights drawn from `seed`, bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    seg_ch, rgb_ch = int(args.line_channels), int(args.rgb_channels)
    G = nn.ModuleDict(dict(G=Generator(
        args.image_size, args.z_dim, seg_ch, rgb_ch, args.channels, args.max_channels,
        args.block_num_conv, args.spade_hidden_channels, args.g_norm_name, args.g_act_name,
        not args.g_disable_sn, not args.g_disable_bias, dtype, g)))
    if not args.no_encoder:
        G['E'] = Encoder(args.image_size, args.z_dim, args.target_resl, args.channels,
                         norm_name=args.e_norm_name, act_name=args.e_act_name,
                         use_sn=not args.e_disable_sn, use_bias=not args.e_disable_bias,
                         in_channels=rgb_ch, dtype=dtype, generator=g)
    D = Discriminator(args.num_scale, args.num_layers, args.channels, not args.d_disable_sn,
                      args.d_act_name, use_bias=not args.d_disable_bias,
                      image_channels=rgb_ch + seg_ch, dtype=dtype, generator=g)
    return G.to(device), D.to(device), None


def draw_step_inputs(G, image, generator):
    '''Every random draw of one step: `z` [B, z_dim], E's noise or G's input.'''
    return dict(z=sample_nnoise((image.shape[0], G['G'].z_dim), generator))


def build_train_step(G, D, g_opt, d_opt, loss, feat_lambda, kld_lambda):
    '''One iteration (module docstring). Returns `train_step(state, batch,
    draws=None) -> metrics`, `batch` (image, line art).'''
    gen, enc = G['G'], G['E'] if 'E' in G else None

    def generate(image, seg, z):
        mu = logvar = None
        if enc is not None:
            z, mu, logvar = enc(image, z, train=True)
        return gen(z, seg, train=True), mu, logvar

    def train_step(state, batch, draws=None):
        image, seg = batch
        if draws is None:
            draws = draw_step_inputs(G, image, state['generator'])

        def d_in(x):
            return torch.cat([x, seg.to(x.dtype)], dim=1)

        # ---------------- D phase ----------------
        with torch.no_grad(), buffers_dropped(G):
            fake, _, _ = generate(image, seg, draws['z'])
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = 0.0
        for (r, _), (f, _) in zip(D(d_in(image), train=True), D(d_in(fake), train=True)):
            d_loss = d_loss + loss.d_loss(r, f)
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase (D's buffer updates dropped) ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        fake2, mu, logvar = generate(image, seg, draws['z'])
        with buffers_dropped(D):          # each from the D phase's u, as JAX's
            real_outs = D(d_in(image), train=True)
        with buffers_dropped(D):
            fake_outs = D(d_in(fake2), train=True)
        g_loss = 0.0
        for (_, r_feats), (f, f_feats) in zip(real_outs, fake_outs):
            g_loss = g_loss + loss.g_loss(f)
            if feat_lambda > 0:
                g_loss = g_loss + feature_matching(r_feats, f_feats) / len(real_outs) \
                    * feat_lambda
        if enc is not None and kld_lambda > 0:
            kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
            g_loss = g_loss + kld * kld_lambda
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        state['step'] += 1
        return dict(d=torch.nan_to_num(d_loss.detach()), g=torch.nan_to_num(g_loss.detach()))

    return train_step


def make_optimizers(args, G, D):
    '''Adam for (G, E) and for D (module docstring).'''
    if args.ttur:
        (g_lr, d_lr), betas = (args.lr / 2, args.lr * 2), (0.0, 0.9)
    else:
        (g_lr, d_lr), betas = (args.lr, args.lr), (args.beta1, args.beta2)
    return (torch.optim.Adam(G.parameters(), lr=g_lr, betas=betas, eps=1e-8),
            torch.optim.Adam(D.parameters(), lr=d_lr, betas=betas, eps=1e-8))


def build_training(args, device=None, seed=0, test_batch=None):
    '''Everything one step needs, from `seed`: a namespace with G, D, the
    optimizers, `state` (the step count and the generator the draws come
    from), `train_step(state, batch, draws=None) -> metrics` and, given a
    test batch (numpy NHWC (image, line art)), `sample_fn`.'''
    if test_batch is not None and int(test_batch[1].shape[-1]) != int(args.line_channels):
        raise ValueError(f'--line-channels {args.line_channels} does not match the dataset '
                         f'line-art channels {test_batch[1].shape[-1]}')
    G, D, _ = build_models(args, device, seed)
    device = next(G.parameters()).device
    g_opt, d_opt = make_optimizers(args, G, D)
    kld_lambda = 0.0 if args.no_encoder else args.kld_lambda
    step = build_train_step(G, D, g_opt, d_opt, HingeLoss(), args.feat_lambda, kld_lambda)
    sample_fn = None
    if test_batch is not None:
        image, seg = paired.nchw(test_batch, device)
        const_z = sample_nnoise((seg.shape[0], args.z_dim), make_generator(seed + 1, device))
        sample_fn = paired.make_grid_sampler(lambda: G['G'](const_z, seg, train=False),
                                             (paired.as_rgb(seg), image))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt,
                           state=dict(step=0, generator=make_generator(seed, device)),
                           train_step=step, sample_fn=sample_fn)


def train(args, max_iters, loader, test_batch):
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    run = build_training(args, accel.device, args.seed, test_batch)
    return paired.run_paired('SPADE', run, args, accel, loader, max_iters, nrow=6)


def main(parser):
    parser = add_args(parser, SPADE_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader, test_batch = paired.load_task(args, 'xdog', args.test_images)
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader, test_batch)
