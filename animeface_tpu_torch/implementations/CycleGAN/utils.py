'''The CycleGAN recipe in PyTorch: image <-> line art with LSGAN and an L1
cycle consistency, spectral norm on in every G and D by default.

Counterpart of `animeface_tpu/implementations/CycleGAN/utils.py`
(`build_train_step`, `make_decay_schedule`, `train`, `main`). Semantics
kept, as the JAX code runs (its docstring names the domains the other way):
  * a batch is (a, b) = (image, line art) of the xdog task; G_ab maps a to
    b, G_ba b to a; D_a judges a, D_b judges b. `G` and `D` are module
    dicts of the two, so one Adam covers both Gs and one both Ds, and
    `G_<step>.pt` holds both Gs (`G_ab.*`, `G_ba.*`);
  * D phase: both Gs' fakes under no gradient, their spectral norms' u
    updates DROPPED; each D on its real and then its fake images, its u
    moving through both and kept; LSGAN's D losses summed; an Adam step;
  * G phase: both Gs again from the state's u, those updates KEPT; the
    cycle reconstructions (each G from the u its first forward left) and
    the Ds on the fakes (from the D phase's u, at their new parameters)
    keep nothing; LSGAN's G losses plus `cycle_lambda` times the mean L1
    of both reconstructions; an Adam step;
  * Adam (betas (0.5, 0.999), eps 1e-8) at `lr` for `epochs` epochs, then
    linear to lr / decay_epochs (not to 0) over `decay_epochs` epochs
    (`make_decay_schedule`, on the count of updates before each);
  * the metrics `d` and `g`, NaN turned to 0; the grid's images are (a,
    G_ab(a) as RGB) for the test images, 4 a row, G in eval mode (u not
    stored); no cuDNN autotuning (`AUTOTUNE`).
The step mutates `state` and the modules in place and returns the losses
as 0-dim tensors without a host sync.
'''

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.CycleGAN.model import Discriminator, Generator
from animeface_tpu_torch.implementations.NAFNet.utils import AUTOTUNE  # no cuDNN autotuning
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import LSGANLoss
from animeface_tpu_torch.nnutils.optim import constant_then_linear, scheduled
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.nnutils.training import buffers_dropped, step_all_parameters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `CycleGAN/utils.py:main`, names, defaults and help)
CYCLEGAN_ARGS = dict(
    line_channels=[1, 'number of channels of line art images'],
    rgb_channels=[3, 'number of channels of the generated images'],
    test_images=[6, 'number of images for test'],
    channels=[32, 'channel width multiplier'],
    max_channels=[1024, 'maximum channels width'],
    downsample_to=[32, 'bottom width'],
    num_blocks=[6, 'number of residual blocks'],
    block_num_conv=[2, 'number of conv in resblock'],
    g_disable_sn=[False, 'disable spectral norm'],
    g_disable_bias=[False, 'disable bias'],
    g_norm_name=['in', 'normalization layer name'],
    g_act_name=['relu', 'activation function name'],
    num_layers=[3, 'number of layers in PatchGAN D'],
    d_disable_sn=[False, 'disable spectral norm'],
    d_disable_bias=[False, 'disable bias'],
    d_norm_name=['in', 'normalization layer name'],
    d_act_name=['relu', 'activation function name'],
    epochs=[100, 'epochs to train with const lr'],
    decay_epochs=[1000, 'epochs to train with linearly decaying lr'],
    lr=[0.0002, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    cycle_lambda=[10., 'lambda for cycle consistency loss'],
)



def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('CycleGAN', CYCLEGAN_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G (`G_ab`, `G_ba`), D (`D_a`, `D_b`) as module dicts and None (no EMA
    copy) on `device` (default `cuda`), weights drawn from `seed`, bf16
    unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    a_ch, b_ch = int(args.rgb_channels), int(args.line_channels)

    def make_g(i, o):
        return Generator(args.image_size, i, o, args.downsample_to, args.channels,
                         args.max_channels, args.num_blocks, args.block_num_conv,
                         args.g_norm_name, args.g_act_name, not args.g_disable_sn,
                         not args.g_disable_bias, dtype, g)

    def make_d(i):
        return Discriminator(i, args.channels, args.num_layers, args.d_norm_name,
                             args.d_act_name, not args.d_disable_sn, not args.d_disable_bias,
                             dtype, g)
    G = nn.ModuleDict(dict(G_ab=make_g(a_ch, b_ch), G_ba=make_g(b_ch, a_ch)))
    D = nn.ModuleDict(dict(D_a=make_d(a_ch), D_b=make_d(b_ch)))
    return G.to(device), D.to(device), None


def build_train_step(G, D, g_opt, d_opt, loss, cycle_lambda):
    '''One iteration (module docstring). Returns `train_step(state, batch,
    draws=None) -> metrics`, `batch` (a, b); the step draws nothing.'''
    G_ab, G_ba, D_a, D_b = G['G_ab'], G['G_ba'], D['D_a'], D['D_b']

    def train_step(state, batch, draws=None):
        a, b = batch

        # ---------------- D phase ----------------
        with torch.no_grad(), buffers_dropped(G):
            fake_b, fake_a = G_ab(a), G_ba(b)
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = loss.d_loss(D_a(a), D_a(fake_a)) + loss.d_loss(D_b(b), D_b(fake_b))
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        fake_b, fake_a = G_ab(a), G_ba(b)
        with buffers_dropped(G, D):
            rec_a, rec_b = G_ba(fake_b), G_ab(fake_a)
            adv = loss.g_loss(D_b(fake_b)) + loss.g_loss(D_a(fake_a))
        cycle = (rec_a - a).abs().mean() + (rec_b - b).abs().mean()
        g_loss = adv + cycle * cycle_lambda
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        state['step'] += 1
        return dict(d=torch.nan_to_num(d_loss.detach()), g=torch.nan_to_num(g_loss.detach()))

    return train_step


def make_decay_schedule(args, steps_per_epoch):
    '''`lr` for `epochs` epochs, then linear to lr / decay_epochs over
    `decay_epochs` epochs (the JAX `optax.join_schedules`).'''
    return constant_then_linear(args.lr, args.epochs * steps_per_epoch,
                                args.lr / max(1, args.decay_epochs),
                                args.decay_epochs * steps_per_epoch)


def build_training(args, device=None, seed=0, test_batch=None, steps_per_epoch=1):
    '''Everything one CycleGAN step needs, from `seed`: a namespace with G,
    D, the optimizers, `state` (the step count), `train_step(state, batch,
    draws=None) -> metrics` (its learning rate from `make_decay_schedule`
    over `steps_per_epoch`) and, given a test batch (numpy NHWC (a, b)),
    `sample_fn`.'''
    G, D, _ = build_models(args, device, seed)
    if test_batch is not None:
        got = tuple(int(t.shape[-1]) for t in test_batch)
        if got != (int(args.rgb_channels), int(args.line_channels)):
            raise ValueError(f'--rgb-channels/--line-channels ({args.rgb_channels},'
                             f'{args.line_channels}) do not match the dataset batch channels '
                             f'{got}')
    g_opt, d_opt = (torch.optim.Adam(m.parameters(), lr=args.lr, betas=tuple(args.betas), eps=1e-8)
                    for m in (G, D))
    step = build_train_step(G, D, g_opt, d_opt, LSGANLoss(), args.cycle_lambda)
    sample_fn = None
    if test_batch is not None:
        a = paired.nchw(test_batch[:1], next(G.parameters()).device)[0]
        sample_fn = paired.make_grid_sampler(lambda: paired.as_rgb(G['G_ab'](a, train=False)),
                                             (paired.as_rgb(a),))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, state=dict(step=0),
                           train_step=scheduled(step, (g_opt, d_opt),
                                                make_decay_schedule(args, steps_per_epoch)),
                           sample_fn=sample_fn)


def train(args, max_iters, loader, test_batch, name='CycleGAN'):
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    run = build_training(args, accel.device, args.seed, test_batch, max(1, len(loader)))
    return paired.run_paired(name, run, args, accel, loader, max_iters, nrow=4)


def main(parser):
    parser = add_args(parser, CYCLEGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader, test_batch = paired.load_task(args, 'xdog', args.test_images)
    if args.max_iters and args.max_iters > 0:
        max_iters = default_max_iters(args, loader)
    else:
        max_iters = len(loader) * (args.epochs + args.decay_epochs)
    train(args, max_iters, loader, test_batch)
