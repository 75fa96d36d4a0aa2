'''The SRGAN recipe in PyTorch: paired LR/HR training (the sr task) with the
non-saturating loss over the multi-scale D and VGG16's content loss.

Counterpart of `animeface_tpu/implementations/SRGAN/utils.py`
(`build_train_step`, the models and optimizers of `train`, the CLI schema
`SRGAN_ARGS`); ESRGAN's recipe runs the same step with `relativistic`.
Semantics kept:
  * the buffers (every spectral norm's u; BatchNorm's running statistics
    with `--g-norm-name bn` or `--d-norm-name bn`) thread as in JAX: G's
    forward in the D phase stores G's; D on the reals, then on the fakes,
    as two calls, stores D's in turn; the G phase's forwards of G and D
    run in training mode from those buffers and their updates are dropped
    (each of ESRGAN's two D forwards there starts from the same buffers);
  * D's loss summed over the scales; G's: the content loss (VGG16's third
    block, MSE) times `vgg_lambda` plus each scale's adversarial loss
    times `adv_lambda`; relativistic (ESRGAN): D on r - mean(f) and
    f - mean(r), G on f - mean(r) with r from a second real forward of D
    and no gradient through it;
  * Adam (lr 2e-4, betas (0.5, 0.999), eps 1e-8) stepping every parameter
    every iteration; the metrics `D` and `G` through `nan_to_num`;
  * the sampler: G with train=False on the test batch; the grid's rows
    are (LR upsampled nearest to HR's size, HR, G(LR)), 9 images a row.
The VGG trunk's weights load as `nnutils/loss/vgg.py` says (random ones
from a fixed seed without `ANIMEFACE_VGG_WEIGHTS`).
'''

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.SRGAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from animeface_tpu_torch.nnutils.loss.vgg import VGGLoss
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.nnutils.training import buffers_dropped, step_all_parameters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `SRGAN/utils.py:SRGAN_ARGS`, names, defaults and help)
SRGAN_ARGS = dict(
    num_test=[6, 'number of samples used in eval'],
    scale=[2, 'upsample scale'],
    disable_sn=[False, 'disable spectral norm'],
    disable_bias=[False, 'disable bias'],
    image_channels=[3, 'input image channels'],
    g_channels=[64, 'channel width multiplier for G'],
    num_blocks=[5, 'number of residual blocks in G'],
    g_norm_name=['in', 'normalization layer name for G'],
    g_act_name=['prelu', 'activation function name for G'],
    num_scale=[2, 'number of scales in D'],
    d_channels=[32, 'channel width multiplier for D'],
    num_layers=[3, 'number of layers in D'],
    d_norm_name=['in', 'normalization layer name for D'],
    d_act_name=['prelu', 'activation function name for D'],
    lr=[0.0002, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    adv_lambda=[0.001, 'lambda for adversarial loss'],
    vgg_lambda=[1., 'lambda for perceptual loss'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('SRGAN', SRGAN_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def build_discriminator(args, generator):
    '''The multi-scale D of `args` (SRGAN's and ESRGAN's flags).'''
    return Discriminator(args.num_scale, args.num_layers, args.d_channels, not args.disable_sn,
                         args.d_act_name, args.d_norm_name, not args.disable_bias,
                         args.image_channels, compute_dtype(args), generator)


def build_models(args, device=None, seed=0):
    '''G, D and None (no EMA copy) on `device` (default `cuda`), weights
    drawn from `seed`, computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    G = Generator(args.scale, args.image_channels, args.g_channels, args.num_blocks,
                  not args.disable_sn, args.g_act_name, args.g_norm_name, not args.disable_bias,
                  compute_dtype(args), g).to(device)
    return G, build_discriminator(args, g).to(device), None


def make_optimizers(args, G, D):
    '''Adam for G and D at lr, betas, eps 1e-8 (optax's default).'''
    return tuple(torch.optim.Adam(m.parameters(), lr=args.lr, betas=tuple(args.betas), eps=1e-8)
                 for m in (G, D))


def build_train_step(G, D, g_opt, d_opt, loss, vgg, adv_lambda, vgg_lambda,
                     relativistic=False):
    '''One iteration (D phase, G phase). Returns
    `train_step(state, batch, draws=None) -> metrics`, `batch` (LR, HR);
    the step draws nothing.'''

    def d_terms(real_outs, fake_outs):
        total = 0.0
        for (r, _), (f, _) in zip(real_outs, fake_outs):
            total = total + (loss.d_loss(r - f.mean(), f - r.mean()) if relativistic
                             else loss.d_loss(r, f))
        return total

    def train_step(state, batch, draws=None):
        lr, hr = batch

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = G(lr, train=True)
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_outs = D(hr, train=True)
        d_loss = d_terms(real_outs, D(fake, train=True))
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase (its buffer updates dropped) ----------------
        with buffers_dropped(G, D):
            D.requires_grad_(False)
            g_opt.zero_grad(set_to_none=True)
            fake2 = G(lr, train=True)
            if relativistic:
                with buffers_dropped(D), torch.no_grad():
                    real_outs = D(hr, train=True)
            g_loss = vgg.content_loss(hr, fake2) * vgg_lambda
            for j, (f, _) in enumerate(D(fake2, train=True)):
                g_loss = g_loss + loss.g_loss(f - real_outs[j][0].mean() if relativistic
                                              else f) * adv_lambda
            g_loss.backward()
            step_all_parameters(g_opt, G)
            D.requires_grad_(True)
        state['step'] += 1
        return dict(D=torch.nan_to_num(d_loss.detach()), G=torch.nan_to_num(g_loss.detach()))

    return train_step


def build_recipe(G, D, args, device, test_batch, relativistic):
    '''The `build_training` namespace of SRGAN's step (ESRGAN's with
    `relativistic`) around built models.'''
    g_opt, d_opt = make_optimizers(args, G, D)
    vgg = VGGLoss(device, vgg=16)
    train_step = build_train_step(G, D, g_opt, d_opt, NonSaturatingLoss(), vgg,
                                  args.adv_lambda, args.vgg_lambda, relativistic)
    sample_fn = None
    if test_batch is not None:
        lr, hr = paired.nchw(test_batch, device)
        shown = F.interpolate(lr, size=hr.shape[-2:], mode='nearest-exact')
        sample_fn = paired.make_grid_sampler(lambda: G(lr, train=False), (shown, hr))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, vgg=vgg, state=dict(step=0),
                           train_step=train_step, sample_fn=sample_fn)


def build_training(args, device=None, seed=0, test_batch=None):
    '''Everything one SRGAN step needs, from `seed`: a namespace with G, D,
    the optimizers, the VGG loss, `state` (the step count),
    `train_step(state, batch, draws=None) -> metrics` and, given a test
    batch (numpy NHWC (LR, HR)), `sample_fn`.'''
    G, D, _ = build_models(args, device, seed)
    return build_recipe(G, D, args, next(G.parameters()).device, test_batch, False)


def main(parser):
    parser = add_args(parser, SRGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader, test_batch = paired.load_task(args, 'sr')
    max_iters = default_max_iters(args, loader)
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed, test_batch=test_batch)
    paired.run_paired('SRGAN', run, args, accel, loader, max_iters, nrow=9)
