'''The FastGAN recipe's training step in PyTorch.

Counterpart of `animeface_tpu/implementations/FastGAN/utils.py`
(`build_train_step`, the models, optimizers and sampler of `train`, the
CLI defaults of `main`). Semantics kept:
  * hinge loss; D's loss adds its reconstruction loss on the reals;
  * DiffAugment with the policy: the reals, the D-phase fakes and the
    G-phase fakes each with their own draws (ar, af, ag);
  * the running statistics (BatchNorm, spectral norm's u) thread as in
    JAX: G's forward in the D phase updates G's; D on the augmented reals,
    then on the augmented fakes from the reals' updates; the G phase's
    forwards of G and D run in training mode and their updates are
    dropped (the buffers are restored after the phase);
  * the two D-phase part quadrants are draws (`qid`, from pk1 and pk2;
    the G phase needs D's logits only);
  * Adam (lr 2e-4, betas (0.5, 0.999), eps 1e-8) for G and D; with `ema`,
    G EMA of the parameters (0.999) every step and G's buffers copied.
The step mutates `state` and the modules in place and returns (metrics,
recons) as the JAX step does: the losses as 0-dim tensors without a host
sync, and D's reconstructions on the reals [recon, small, recon_part,
img_part]. Saving them as an image grid is the runtime's (not ported).
'''

from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.FastGAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.loss import HingeLoss
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.training import step_all_parameters, update_ema

#: the recipe's CLI defaults (`main`; `num_sle` None: half the up blocks but
#: the last), at the BASELINE config's 256px and the global batch 32
FASTGAN_DEFAULTS = dict(
    image_size=256, batch_size=32, num_test=16, image_channels=3, latent_dim=128,
    g_channels=32, g_max_channels=512, interp_size=4, g_bottom=4, norm_name='bn',
    transposed=False, num_sle=None, d_channels=32, d_max_channels=512, d_bottom=8,
    init_down_size=256, decoder_image_size=128, lr=0.0002, betas=(0.5, 0.999),
    policy='color,translation', ema=False, no_bf16=False)


def default_args(**overrides):
    '''The recipe's defaults as an argument namespace, with overrides.'''
    unknown = set(overrides) - set(FASTGAN_DEFAULTS)
    if unknown:
        raise TypeError(f'unknown FastGAN arguments: {sorted(unknown)}')
    return SimpleNamespace(**dict(FASTGAN_DEFAULTS, **overrides))


def build_models(args, device=None, seed=0):
    '''G, D and the EMA copy of G on `device` (default `cuda`), weights
    drawn from `seed`, computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    g = torch.Generator().manual_seed(int(seed))
    G = Generator(latent_dim=args.latent_dim, image_size=args.image_size,
                  channels=args.g_channels, max_channels=args.g_max_channels,
                  interp_size=args.interp_size, image_channels=args.image_channels,
                  bottom=args.g_bottom, norm_name=args.norm_name, transposed=args.transposed,
                  num_sle=args.num_sle, dtype=dtype, generator=g)
    D = Discriminator(image_size=args.image_size,
                      init_down_size=min(args.init_down_size, args.image_size),
                      image_channels=args.image_channels, channels=args.d_channels,
                      max_channels=args.d_max_channels, norm_name=args.norm_name,
                      bottom=args.d_bottom,
                      decoder_image_size=min(args.decoder_image_size, args.image_size),
                      dtype=dtype, generator=g)
    G, D = G.to(device), D.to(device)
    G_ema = copy.deepcopy(G).requires_grad_(False)
    return G, D, G_ema


def make_optimizers(args, G, D):
    '''Adam for G and for D (eps 1e-8, optax's default).'''
    def adam(module):
        return torch.optim.Adam(module.parameters(), lr=args.lr, betas=tuple(args.betas),
                                eps=1e-8)
    return adam(G), adam(D)


def draw_step_inputs(G, real, generator, policy):
    '''Every random draw of one step: z, DiffAugment's draws for the reals
    (`aug_r`), the D-phase fakes (`aug_f`) and the G-phase fakes (`aug_g`),
    and D's part quadrants for the reals and the fakes (`qid`, [2]).'''
    B, _, H, W = real.shape
    return dict(z=sample_nnoise((B, G.latent_dim), generator),
                aug_r=draw_diff_augment(B, H, W, policy, generator, real.dtype),
                aug_f=draw_diff_augment(B, H, W, policy, generator),
                aug_g=draw_diff_augment(B, H, W, policy, generator),
                qid=torch.randint(0, 4, (2,), generator=generator, device=generator.device))


def build_train_step(G, D, G_ema, g_opt, d_opt, loss, policy, use_ema: bool,
                     ema_decay: float = 0.999):
    '''One iteration (D phase, G phase, optional EMA). Returns
    `train_step(state, real, draws=None) -> (metrics, recons)`.'''
    buffers = list(G.buffers()) + list(D.buffers())

    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G, real, state['generator'], policy)
        z = draws['z']

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = G(z, train=True)
            real_aug = diff_augment(real, policy, draws['aug_r'])
            fake_aug = diff_augment(fake, policy, draws['aug_f'])
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_prob, recon_loss, recons = D(real_aug, draws['qid'][0], train=True)
        fake_prob, _, _ = D(fake_aug, draws['qid'][1], train=True)
        d_loss = loss.d_loss(real_prob, fake_prob) + recon_loss
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase (its buffer updates dropped) ----------------
        kept = [b.clone() for b in buffers]
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        fake2 = G(z, train=True)
        g_loss = loss.g_loss(D(diff_augment(fake2, policy, draws['aug_g']), train=True))
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        with torch.no_grad():
            for b, v in zip(buffers, kept):
                b.copy_(v)

        if use_ema:
            update_ema(G, G_ema, ema_decay)
            with torch.no_grad():
                for e, b in zip(G_ema.buffers(), G.buffers()):
                    e.copy_(b)
        state['step'] += 1
        metrics = dict(G=g_loss.detach(), D=d_loss.detach())
        return metrics, [r.detach() for r in recons]

    return train_step


def make_sampler(G, args, seed=0):
    '''The recipe's `sample_fn`: `sample()` runs G (G_ema with `ema`) with
    train=False under torch.no_grad() on `num_test` latents drawn once from
    `seed` on G's device.'''
    device = next(G.parameters()).device
    const_z = sample_nnoise((args.num_test, args.latent_dim), make_generator(seed, device))

    def sample():
        with torch.no_grad():
            return G(const_z, train=False)

    return sample


def build_training(args, device=None, seed=0):
    '''Everything one FastGAN training step needs, from `seed`: returns a
    namespace with G, D, G_ema, the optimizers, `state` (step count, the
    generator the draws come from), `train_step(state, real, draws=None)
    -> (metrics, recons)` and `sample_fn`.'''
    G, D, G_ema = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    state = dict(step=0, generator=make_generator(seed, next(G.parameters()).device))
    train_step = build_train_step(G, D, G_ema, g_opt, d_opt, HingeLoss(), args.policy,
                                  args.ema)
    sample_fn = make_sampler(G_ema if args.ema else G, args, seed)
    return SimpleNamespace(G=G, D=D, G_ema=G_ema, g_opt=g_opt, d_opt=d_opt, state=state,
                           train_step=train_step, sample_fn=sample_fn)
