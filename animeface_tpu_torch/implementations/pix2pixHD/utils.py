'''The pix2pixHD recipe in PyTorch: line art to colour, coarse to fine, in
two invocations of the same command.

Counterpart of `animeface_tpu/implementations/pix2pixHD/utils.py`
(`feature_matching`, `_mask_grads`, `build_train_step`, `_decay_schedule`,
`train`, `main`). Semantics kept:
  * the first invocation (no `global_final.pt` in the recipe's result
    directory) trains the global G alone at half the image size, through
    `Generator.global_forward`, against the finest `g_d_scale` of D's
    scales; at its end it writes G and D whole (the untrained local G
    too) to `global_final.pt`. The JAX package writes `.msgpack`; the port
    writes its own `torch.save` file. The second invocation loads both and
    trains at full size against `l_d_scale` scales: the local G alone
    until `fine_from` epochs, then everything;
  * a batch is (image, line art); D sees (line art ‖ image); the D phase
    sums LSGAN's D loss over the scales trained; the G phase sums LSGAN's G
    loss and, with `feat_lambda` > 0, the feature matching (the L1 between
    each layer's features on the real and the fake pair, 4 / len a layer,
    the real ones held constant) times `feat_lambda / d_scale`, D at its
    new parameters;
  * what a phase does not train gets ZERO gradients, not None (`frozen`
    sets `requires_grad` off for the forward, `step_all_parameters` fills
    zeros): Adam's step count advances for it as optax's shared count does
    and its moments stay zero, so its parameters do not move;
  * N(0, 0.02) kernels, zero biases (`apply_init`); Adam (betas (0.5,
    0.999), eps 1e-8) at `lr`, constant, then lower by lr / epochs / 2 an
    epoch past half the run (`decay_schedule`, on the count of updates
    before each, as optax's);
  * the metrics `d` and `g`, NaN turned to 0; `G_<step>.pt` is G's own
    state; the grid's images are (line art as RGB, G(line art), image) for
    each test sample, 6 a row; no cuDNN autotuning (`AUTOTUNE`).
The step mutates `state` and the modules in place and returns the losses
as 0-dim tensors without a host sync.
'''

from __future__ import annotations

import contextlib
import os
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.NAFNet.utils import AUTOTUNE  # no cuDNN autotuning
from animeface_tpu_torch.implementations.pix2pixHD.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.initialize import apply_init
from animeface_tpu_torch.nnutils.loss import LSGANLoss
from animeface_tpu_torch.nnutils.optim import scheduled
from animeface_tpu_torch.nnutils.training import step_all_parameters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults, result_dir

#: the recipe's flags (JAX `pix2pixHD/utils.py:main`, names, defaults and help)
PIX2PIXHD_ARGS = dict(
    num_test=[4, 'eval samples'],
    input_channels=[1, 'input image channels'],
    target_channels=[3, 'output image channels'],
    channels=[32, 'channel width multiplier'],
    local_num_blocks=[3, 'number of resblocks in local G'],
    global_num_blocks=[3, 'number of reblocks in global G'],
    global_num_downs=[4, 'number of down sampling blocks in global G'],
    g_norm_name=['in', 'normalization layer name'],
    g_act_name=['relu', 'activation function name'],
    d_num_scale=[3, 'number of scales'],
    d_norm_name=['in', 'normalization layer name'],
    d_act_name=['lrelu', 'activatoin function name'],
    g_epochs=[200, 'epochs to train global G'],
    g_d_scale=[2, 'number of scales in D when training global G'],
    l_epochs=[100, 'epochs to train local G'],
    l_d_scale=[3, 'number of scales in D when training local G'],
    fine_from=[10, 'when to start fine-tune when training local G'],
    lr=[0.0002, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    feat_lambda=[10., 'lambda for feature matching loss'],
)
#: the first invocation's file, in the recipe's result directory
GLOBAL_CKPT = 'global_final.pt'


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('pix2pixHD', PIX2PIXHD_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G, D and None (no EMA copy) on `device` (default `cuda`): N(0, 0.02)
    kernels drawn from `seed`, zero biases; bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    G = Generator(args.input_channels, args.target_channels, args.channels,
                  args.local_num_blocks, args.global_num_blocks, args.global_num_downs,
                  args.g_norm_name, args.g_act_name, dtype, g)
    D = Discriminator(args.input_channels + args.target_channels, args.channels,
                      args.d_num_scale, args.d_norm_name, args.d_act_name, dtype, g)
    return apply_init(G, 'N002', g).to(device), apply_init(D, 'N002', g).to(device), None


def feature_matching(real_feats, fake_feats):
    '''The L1 between each layer's features, 4 / len a layer, the real ones
    held constant.'''
    loss = 0.0
    w = 4.0 / len(real_feats)
    for rf, ff in zip(real_feats, fake_feats):
        loss = loss + (rf.detach() - ff).abs().mean() * w
    return loss


@contextlib.contextmanager
def frozen(module, children):
    '''`module`'s named `children` without gradients inside the block
    (None or () freezes nothing); the step's `step_all_parameters` then
    gives them zero gradients (the JAX `_mask_grads`).'''
    params = [p for name in (children or ()) for p in getattr(module, name).parameters()]
    kept = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, k in zip(params, kept):
            p.requires_grad_(k)


def build_train_step(G, D, g_opt, d_opt, loss, feat_lambda, d_scale, g_frozen, global_phase):
    '''One iteration (module docstring): D's finest `d_scale` scales (the
    others get zero gradients), G's children named in `g_frozen` held
    (zero gradients), G through `global_forward` in the global phase.
    Returns `train_step(state, batch, draws=None) -> metrics`, `batch`
    (image, line art); the step draws nothing.'''

    def generate(line):
        return G.global_forward(line) if global_phase else G(line)[0]

    def train_step(state, batch, draws=None):
        image, line = batch

        def d_in(x):
            return torch.cat([line, x], dim=1)

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = generate(line)
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_outs, fake_outs = D(d_in(image), d_scale), D(d_in(fake), d_scale)
        d_loss = 0.0
        for (real_logits, _), (fake_logits, _) in zip(real_outs, fake_outs):
            d_loss = d_loss + loss.d_loss(real_logits, fake_logits)
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        with frozen(G, g_frozen):
            fake2 = generate(line)
            with torch.no_grad():
                real_outs = D(d_in(image), d_scale)
            fake_outs = D(d_in(fake2), d_scale)
            g_loss = 0.0
            for (_, real_feats), (fake_logits, fake_feats) in zip(real_outs, fake_outs):
                g_loss = g_loss + loss.g_loss(fake_logits)
                if feat_lambda > 0:
                    g_loss = g_loss + (feature_matching(real_feats, fake_feats)
                                       * feat_lambda / d_scale)
            g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        state['step'] += 1
        return dict(d=torch.nan_to_num(d_loss.detach()), g=torch.nan_to_num(g_loss.detach()))

    return train_step


def decay_schedule(base_lr, max_iters, steps_per_epoch):
    '''`schedule(count) -> lr`: `base_lr`, lower by base_lr / epochs / 2 for
    each epoch of `count` past half of `max_iters` (the JAX
    `_decay_schedule`).'''
    spe = max(steps_per_epoch, 1)
    epochs = (max_iters + steps_per_epoch - 1) // steps_per_epoch
    delta = base_lr / max(epochs, 1) / 2
    half_epoch = (max_iters // 2 + 1) // spe

    def schedule(count):
        return max(base_lr - delta * max(count // spe - half_epoch, 0), 0.0)
    return schedule


def phase_iters(args, global_phase, steps_per_epoch):
    '''The phase's steps: `--max-iters` when > 0, else its epochs'.'''
    if args.max_iters and args.max_iters > 0:
        return args.max_iters
    return steps_per_epoch * (args.g_epochs if global_phase else args.l_epochs)


def build_training(args, device=None, seed=0, test_batch=None, global_phase=False,
                   saved=None, steps_per_epoch=1):
    '''Everything one phase's steps need: a namespace with G, D (from
    `seed`, then `saved`'s {'G', 'D'} state dicts where given), the
    optimizers, `state` (the step count), `train_step(state, batch,
    draws=None) -> metrics` (the phase's variant for the step's index, its
    learning rate from `decay_schedule` over `steps_per_epoch`) and, given
    a test batch (numpy NHWC (image, line art) at the phase's size),
    `sample_fn`.'''
    G, D, _ = build_models(args, device, seed)
    if saved is not None:
        G.load_state_dict(saved['G'])
        D.load_state_dict(saved['D'])
    g_opt, d_opt = (torch.optim.Adam(m.parameters(), lr=args.lr, betas=tuple(args.betas), eps=1e-8)
                    for m in (G, D))

    def variant(d_scale, g_frozen):
        return build_train_step(G, D, g_opt, d_opt, LSGANLoss(), args.feat_lambda,
                                min(d_scale, args.d_num_scale), g_frozen, global_phase)
    if global_phase:
        pre = fine = variant(args.g_d_scale, ('local_g',))
    else:
        pre, fine = variant(args.l_d_scale, ('global_g',)), variant(args.l_d_scale, ())
    fine_from_iter = steps_per_epoch * args.fine_from

    def train_step(state, batch, draws=None):
        return (fine if state['step'] >= fine_from_iter else pre)(state, batch, draws)

    schedule = decay_schedule(args.lr, phase_iters(args, global_phase, steps_per_epoch),
                              steps_per_epoch)
    sample_fn = None
    if test_batch is not None:
        image, line = paired.nchw(test_batch, next(G.parameters()).device)
        sample_fn = paired.make_grid_sampler(
            lambda: G.global_forward(line) if global_phase else G(line)[0],
            (paired.as_rgb(line),), (image,))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, state=dict(step=0),
                           train_step=scheduled(train_step, (g_opt, d_opt), schedule),
                           sample_fn=sample_fn)


def train(args, loader, test_batch, global_phase, global_ckpt, name='pix2pixHD'):
    '''One invocation's phase (module docstring); the global phase writes
    `global_ckpt` at its end.'''
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    saved = None if global_phase else torch.load(global_ckpt, map_location=accel.device,
                                                 weights_only=True)
    run = build_training(args, accel.device, args.seed, test_batch, global_phase, saved,
                         max(len(loader), 1))
    out = paired.run_paired(name, run, args, accel, loader,
                            phase_iters(args, global_phase, len(loader)), nrow=6)
    if global_phase:
        torch.save({'G': run.G.state_dict(), 'D': run.D.state_dict()}, global_ckpt)
        print('global phase done; run the same command again to train the local generator.')
    return out


def main(parser):
    parser = add_args(parser, PIX2PIXHD_ARGS)
    args = parser.parse_args()
    save_args(args)

    global_ckpt = os.path.join(result_dir('pix2pixHD'), GLOBAL_CKPT)
    global_phase = not os.path.exists(global_ckpt)
    # the data at the phase's size
    size = args.image_size
    args.image_size = size // 2 if global_phase else size
    loader, test_batch = paired.load_task(args, 'xdog')
    args.image_size = size
    train(args, loader, test_batch, global_phase, global_ckpt)
