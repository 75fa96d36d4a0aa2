'''The NAFNet recipe in PyTorch: line art to colour with LSGAN on (image ‖
line art) plus a pixel L1, and the restoration runtime Restormer shares.

Counterpart of `animeface_tpu/implementations/NAFNet/utils.py`
(`build_restoration_step`, `run_restoration`, the CLI schema of `main`).
Semantics kept:
  * a batch is (image, line art) of the xdog task; G maps the line art to
    the image's channels, D sees (image ‖ line art);
  * D phase: G's fake under no gradient, D in train mode on the real pair
    and then on the fake one, its BatchNorm statistics moving through both
    and kept, LSGAN's D loss, an Adam step;
  * G phase: G again on the line art, D on its NEW parameters in train
    mode (batch statistics from that forward, which are dropped afterwards),
    LSGAN's G loss plus `pixel_lambda` times the mean |fake - image|, an
    Adam step;
  * Adam (lr 2e-4, betas (0.5, 0.999), eps 1e-8) stepping every parameter
    every iteration; the metrics `G` and `D`, NaN turned to 0 as JAX's
    `nan_to_num`; no EMA copy of G: `G_<step>.pt` is G's own state; no
    cuDNN autotuning (`AUTOTUNE`);
  * the sampler: G on the test batch's line art; the grid's images are
    (image, line art as RGB, G(line art)) for each test sample, 6 a row.
The step mutates `state` and the modules in place and returns the losses
as 0-dim tensors without a host sync.
'''

from __future__ import annotations

from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.NAFNet.model import Discriminator, NAFNet
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import LSGANLoss
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.nnutils.training import buffers_dropped, step_all_parameters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `NAFNet/utils.py:main`, names, defaults and help)
NAFNET_ARGS = dict(
    num_test=[4, 'eval samples'],
    image_channels=[3],
    bottom=[16, 'bottom width'],
    g_channels=[64, 'minimum channel width'],
    blocks_per_scale=[2, 'NAF blocks per scale'],
    mid_blocks=[6, 'number of NAF blocks in bottom'],
    mlp_ratio=[1, 'ratio for MLP, like in Transformers.'],
    g_norm_name=['ln', 'normalization layer name'],
    g_act_name=[str, 'activation function name. Sigmoid==GLU'],
    num_layers=[3, 'number of layers'],
    d_channels=[64, 'minimum channel width'],
    max_channels=[512, 'maximum channel width'],
    d_norm_name=['bn', 'normalization layer name'],
    d_act_name=['lrelu', 'activation function name'],
    lr=[0.0002, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    pixel_lambda=[10., 'lambda for pixel-wise loss'],
)
#: the line art's channels in the xdog task
LINE_CHANNELS = 1
#: no cuDNN autotuning, for the four line-art recipes (NAFNet, Restormer,
#: pix2pixHD, CycleGAN): at 128px, batch 32, bf16 on an H100 their steps
#: took the same time with the heuristics' algorithms as autotuned (within
#: the 3% spread of two runs in turns), and autotuning took 4-14 s of the
#: first step at each image size
AUTOTUNE = False


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('NAFNet', NAFNET_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def build_models(args, device=None, seed=0, line_channels=LINE_CHANNELS):
    '''G, D and None (no EMA copy) on `device` (default `cuda`), weights
    drawn from `seed`, computing in bf16 unless `args.no_bf16`
    (`mlp_ratio` is read by neither, as in JAX).'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = compute_dtype(args)
    G = NAFNet(args.image_size, args.bottom, args.g_channels, args.max_channels,
               args.blocks_per_scale, args.mid_blocks, args.g_norm_name, args.g_act_name,
               line_channels, args.image_channels, dtype, g).to(device)
    D = Discriminator(args.image_channels + line_channels, args.num_layers, args.d_channels,
                      args.max_channels, args.d_norm_name, args.d_act_name, dtype, g).to(device)
    return G, D, None


def make_optimizers(args, G, D):
    '''Adam for G and D at lr, betas, eps 1e-8 (optax's default).'''
    return tuple(torch.optim.Adam(m.parameters(), lr=args.lr, betas=tuple(args.betas), eps=1e-8)
                 for m in (G, D))


def build_restoration_step(G, D, g_opt, d_opt, loss, pixel_lambda):
    '''One iteration (D phase, G phase; module docstring). Returns
    `train_step(state, batch, draws=None) -> metrics`, `batch` (image,
    line art); the step draws nothing.'''

    def train_step(state, batch, draws=None):
        real, line = batch

        def d_in(image):
            return torch.cat([image, line], dim=1)

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = G(line)
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = loss.d_loss(D(d_in(real), train=True), D(d_in(fake), train=True))
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        fake2 = G(line)
        with buffers_dropped(D):
            fake_logits = D(d_in(fake2), train=True)
        g_loss = loss.g_loss(fake_logits) + (fake2 - real).abs().mean() * pixel_lambda
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        state['step'] += 1
        return dict(G=torch.nan_to_num(g_loss.detach()), D=torch.nan_to_num(d_loss.detach()))

    return train_step


def build_restoration(args, G, D, test_batch=None):
    '''Everything one step of a restoration recipe (NAFNet, Restormer)
    needs around its G and D: a namespace with G, D, the optimizers,
    `state` (the step count), `train_step(state, batch, draws=None) ->
    metrics` and, given a test batch (numpy NHWC (image, line art)),
    `sample_fn`.'''
    g_opt, d_opt = make_optimizers(args, G, D)
    train_step = build_restoration_step(G, D, g_opt, d_opt, LSGANLoss(), args.pixel_lambda)
    sample_fn = None
    if test_batch is not None:
        real, line = paired.nchw(test_batch, next(G.parameters()).device)
        sample_fn = paired.make_grid_sampler(lambda: G(line), (real, paired.as_rgb(line)))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, state=dict(step=0),
                           train_step=train_step, sample_fn=sample_fn)


def line_channels_of(test_batch):
    return LINE_CHANNELS if test_batch is None else int(test_batch[1].shape[-1])


def build_training(args, device=None, seed=0, test_batch=None):
    '''NAFNet's `build_restoration` namespace, its models from `seed`.'''
    G, D, _ = build_models(args, device, seed, line_channels_of(test_batch))
    return build_restoration(args, G, D, test_batch)


def run_restoration(name, args, build_training, loader, test_batch, max_iters):
    '''The loop of a restoration recipe: its `build_training(args, device,
    seed, test_batch)` namespace in `run_training`, grids of 6 a row, G's
    state as `G_<step>.pt`.'''
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    run = build_training(args, accel.device, seed=args.seed, test_batch=test_batch)
    return paired.run_paired(name, run, args, accel, loader, max_iters, nrow=6)


def main(parser):
    parser = add_args(parser, NAFNET_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader, test_batch = paired.load_task(args, 'xdog')
    run_restoration('NAFNet', args, build_training, loader, test_batch,
                    default_max_iters(args, loader))
