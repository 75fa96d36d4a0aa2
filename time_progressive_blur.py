'''StyleGAN (v1)'s [1, 2, 1] blur on the card, differentiated by autograd
through `ops/upfirdn2d.py`'s depthwise conv (groups = C) against the
model's form, whose backward is the FIR's adjoint (`StyleGAN/model.py:_FIR`),
so that the penalty's double backward differentiates no conv weight:

    python3 time_progressive_blur.py

(a) the recipe's 128px step (full depth and width, batch 16, bf16, alpha
0.5) in the stable ('s', 's') and D_transition ('s', 't') mode pairs, 10
steps after 2, finite losses, with each blur form in turns (autograd,
adjoint, adjoint, autograd) on one pair of models; (b) each form alone at G's
five upsampling and D's five downsampling shapes at batch 16 in bf16:
forward, the input gradient with `create_graph=True` and its backward,
the penalty's pattern, by CUDA events. Prints the card's name and power
limit and one JSON line of the numbers last. Needs one CUDA card;
imports nothing of JAX.
'''

import json
import time

import torch

#: (channels, resolution) of the blur's inputs: G's upsampling, D's downsampling
UP_SHAPES = ((512, 4), (512, 8), (256, 16), (128, 32), (64, 64))
DOWN_SHAPES = ((64, 128), (128, 64), (256, 32), (512, 16), (512, 8))
STEPS = 10


def main():
    import chip_smoke as s
    from animeface_tpu_torch.implementations.PGGAN import utils as pu
    from animeface_tpu_torch.implementations.StyleGAN import model as sm
    from animeface_tpu_torch.implementations.StyleGAN import utils as su
    from animeface_tpu_torch.nnutils.rng import make_generator
    from animeface_tpu_torch.ops import downsample2d, setup_filter, upsample2d

    dev = torch.device('cuda')
    card = s._card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    forms = {
        'autograd': (lambda x: upsample2d(x, setup_filter(sm._BLUR, device=x.device), up=2),
                     lambda x: downsample2d(x, setup_filter(sm._BLUR, device=x.device), down=2)),
        'adjoint': (sm.upsample_blur, sm.blur_downsample),
    }
    out = {'step_ms': [], 'blur_ms': {}}
    args = su.default_args(image_size=128, batch_size=16)
    G, D = su.build_models(args, dev)
    real = torch.rand((16, 3, 128, 128), generator=torch.Generator().manual_seed(1)).to(dev) * 2 - 1
    try:
        for form in ('autograd', 'adjoint', 'adjoint', 'autograd'):
            sm.upsample_blur, sm.blur_downsample = forms[form]
            for modes in (('s', 's'), ('s', 't')):
                g_opt, d_opt = pu.make_optimizers(G, D, 128)
                step = su.build_train_step(G, D, g_opt, d_opt, su.RECIPE.loss(), args.gp_lambda,
                                           args.drift_epsilon, 5, *modes)
                state = dict(step=0, generator=make_generator(0, dev),
                             alpha=torch.full((), 0.5, device=dev),
                             alpha_delta=torch.zeros((), device=dev))
                for _ in range(2):
                    step(state, real)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = [step(state, real) for _ in range(STEPS)]
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / STEPS
                if not all(bool(torch.isfinite(m[k])) for m in losses for k in ('d', 'g')):
                    raise AssertionError(f'blur {form} {modes}: non-finite losses')
                out['step_ms'].append([form, ''.join(modes), ms])
                print(f'StyleGAN 128px step {modes}, blur {form}: {ms:.2f} ms a step (batch 16, '
                      f'bf16) on {card}')
    finally:
        sm.upsample_blur, sm.blur_downsample = forms['adjoint']

    for form, (up, down) in forms.items():
        for name, fn, shapes in (('up', up, UP_SHAPES), ('down', down, DOWN_SHAPES)):
            total = 0.0
            for C, R in shapes:
                x = torch.randn((16, C, R, R), device=dev, dtype=torch.bfloat16,
                                requires_grad=True)

                def run():
                    (g,) = torch.autograd.grad((fn(x).float() ** 2).sum(), x, create_graph=True)
                    (g.float() ** 2).sum().backward()
                total += s._time_ms(run, iters=5)
            out['blur_ms'][f'{name} {form}'] = total
            print(f'blur {name}, {form}: {total:.3f} ms over its five shapes (forward, input '
                  f'gradient, its backward) on {card}')
    print(card)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
