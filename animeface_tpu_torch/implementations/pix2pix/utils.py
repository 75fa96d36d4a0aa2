'''The pix2pix recipe in PyTorch: LSGAN plus an L1 pixel loss on the xdog
task's pairs (line art -> image).

Counterpart of `animeface_tpu/implementations/pix2pix/utils.py`
(`build_train_step`, the models and optimizers of `train`, the CLI schema
of `main`). Semantics kept:
  * a batch is (target image, source line art); G maps the source to the
    target's channels, D sees (image ‖ source);
  * D phase: G's fake under no gradient, D's LSGAN loss on the real and
    fake pairs, an Adam step; G phase: G again on the same source with the
    same dropout masks (one seed a step, `g_dropout`, drawn only when G
    has dropout), LSGAN's G loss on D's new parameters plus
    `pixelwise_gamma` times the mean |fake - target|, an Adam step;
  * Adam (lr 5e-4, betas (0.5, 0.999), eps 1e-8) stepping every parameter
    every iteration; the metrics `d` and `g`;
  * the sampler: G without dropout on the test batch; the grid's rows are
    (source as RGB, target, G(source)), 6 images a row.
The step mutates `state` and the modules in place and returns the losses
as 0-dim tensors without a host sync.
'''

from __future__ import annotations

from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.pix2pix.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import LSGANLoss
from animeface_tpu_torch.nnutils.rng import make_generator
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.nnutils.training import step_all_parameters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `pix2pix/utils.py:main`, names, defaults and help)
PIX2PIX_ARGS = dict(
    num_test=[4, 'eval samples'],
    drop_out=[0.0, 'dropout rate'],
    lr=[0.0005, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    pixelwise_gamma=[100., 'lambda for L1 loss'],
)
#: (target, source) channels of the xdog task: an RGB image and its line art
CHANNELS = (3, 1)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('pix2pix', PIX2PIX_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def build_models(args, device=None, seed=0, channels=CHANNELS):
    '''G, D and None (no EMA copy) on `device` (default `cuda`), weights
    drawn from `seed`, for (target, source) `channels`, computing in bf16
    unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    target, source = channels
    dtype = compute_dtype(args)
    G = Generator(args.image_size, target, source, args.drop_out, dtype, g).to(device)
    D = Discriminator(target + source, dtype, g).to(device)
    return G, D, None


def make_optimizers(args, G, D):
    '''Adam for G and D at lr, betas, eps 1e-8 (optax's default).'''
    return tuple(torch.optim.Adam(m.parameters(), lr=args.lr, betas=tuple(args.betas), eps=1e-8)
                 for m in (G, D))


def draw_step_inputs(G, generator):
    '''Every random draw of one step: G's dropout seed (`g_dropout`) from
    the CPU `generator`, when G has dropout.'''
    if not G.has_dropout:
        return {}
    return dict(g_dropout=int(torch.randint(2 ** 62, (1,), generator=generator)))


def build_train_step(G, D, g_opt, d_opt, loss, pixelwise_gamma):
    '''One iteration (D phase, G phase). Returns
    `train_step(state, batch, draws=None) -> metrics`, `batch` (target,
    source).'''

    def train_step(state, batch, draws=None):
        target, source = batch
        if draws is None:
            draws = draw_step_inputs(G, state.get('dropout_generator'))

        def generate():
            masks = ({'dropout': make_generator(draws['g_dropout'], source.device)}
                     if 'g_dropout' in draws else {})
            return G(source, **masks)

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = generate()
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = loss.d_loss(D(torch.cat([target, source], dim=1)),
                             D(torch.cat([fake, source], dim=1)))
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        fake2 = generate()
        g_loss = (loss.g_loss(D(torch.cat([fake2, source], dim=1)))
                  + (fake2 - target).abs().mean() * pixelwise_gamma)
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        state['step'] += 1
        return dict(d=d_loss.detach(), g=g_loss.detach())

    return train_step


def build_training(args, device=None, seed=0, test_batch=None):
    '''Everything one pix2pix step needs, from `seed`: a namespace with G,
    D, the optimizers, `state` (step count; with dropout the CPU generator
    its seeds come from), `train_step(state, batch, draws=None) -> metrics`
    and, given a test batch (numpy NHWC (target, source)), `sample_fn`.'''
    channels = CHANNELS if test_batch is None else tuple(int(a.shape[-1]) for a in test_batch)
    G, D, _ = build_models(args, device, seed, channels)
    g_opt, d_opt = make_optimizers(args, G, D)
    state = dict(step=0)
    if G.has_dropout:
        state['dropout_generator'] = torch.Generator().manual_seed(int(seed))
    train_step = build_train_step(G, D, g_opt, d_opt, LSGANLoss(), args.pixelwise_gamma)
    sample_fn = None
    if test_batch is not None:
        target, source = paired.nchw(test_batch, next(G.parameters()).device)
        sample_fn = paired.make_grid_sampler(lambda: G(source), (paired.as_rgb(source), target))
    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, state=state,
                           train_step=train_step, sample_fn=sample_fn)


def train(args, max_iters, loader, test_batch):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed, test_batch=test_batch)
    return paired.run_paired('pix2pix', run, args, accel, loader, max_iters, nrow=6)


def main(parser):
    parser = add_args(parser, PIX2PIX_ARGS)
    args = parser.parse_args()
    save_args(args)

    # xdog pairs are (image, line art): the line art is the source
    loader, test_batch = paired.load_task(args, 'xdog')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader, test_batch)
