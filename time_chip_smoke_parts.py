'''Parts of `chip_smoke.py` on the card, alone or under another cuDNN
setting, to size and time its phases:

    python3 time_chip_smoke_parts.py line-art
    python3 time_chip_smoke_parts.py autotune
    python3 time_chip_smoke_parts.py limit-main 10 1 3
    python3 time_chip_smoke_parts.py limit-paths 10 3 10
    python3 time_chip_smoke_parts.py gates

`line-art`: the line-art phases (`run_line_art_phase`: NAFNet, Restormer,
pix2pixHD, CycleGAN, normalizations, SPADE, SCFT) alone in one process,
each phase's seconds and the total. `autotune`: each line-art recipe's direct steps at
its CLI's 128px defaults with cuDNN's autotuning on, off, on, off in turns
(`run_direct_steps`: warm-up, ms a step). `limit-main`: for each value of
cuDNN's `benchmark_limit` (the algorithms autotuning times for each new
convolution; -1 keeps PyTorch's default), `run_main_path` in a process of
its own (its warm-up, cycle and profiles, the path's seconds); then
PGGAN's kill lanes at 16px with kills at ckpt-18 and ckpt-21
(`run_progressive_kill_resume`). `limit-paths`: for each value, one
process through the main path, ADA, CIPS training, FastGAN and StyleGAN3
256px (profiles off): each path's warm-up, cycle and seconds. `gates`:
the f32 step gates that failed now and then before their branches were
replayed (BigGAN's, SEBigGAN's and WGAN-gp's from their CLI runs,
FastGAN's from its 256px path), each with cuDNN's autotuning on, then
off (other convolution algorithms in the card run): each gate's
worst/tolerance ratio (`GATE` lines) and seconds. Each run's
result directories go to a temporary directory. Needs one CUDA card;
imports nothing of JAX.
'''

import os
import subprocess
import sys
import tempfile
import time

import torch

LIMIT_MAIN = '''
import sys, time, torch
import chip_smoke as s
from animeface_tpu_torch import _build
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = True
limit = int(sys.argv[1])
if limit >= 0:
    torch.backends.cudnn.benchmark_limit = limit
print('benchmark_limit', torch.backends.cudnn.benchmark_limit)
t = time.perf_counter()
s.run_main_path(torch.device('cuda'), s._card_line())
print(f'MAINPATH limit {limit}: {time.perf_counter() - t:.1f} s')
'''

LIMIT_PATHS = '''
import sys, time, torch
import chip_smoke as s
from animeface_tpu_torch import _build
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = True
torch.backends.cudnn.benchmark_limit = int(sys.argv[1])
s.profile_step = lambda *a, **k: []          # the profiles alone left out
dev, card = torch.device('cuda'), s._card_line()
t0 = time.perf_counter()
for name, path in (('main', s.run_main_path), ('ADA', s.run_ada_path),
                   ('CIPS train', s.run_cips_train_path), ('FastGAN', s.run_fastgan_path),
                   ('StyleGAN3 256px', s.run_stylegan3_256_path)):
    t = time.perf_counter()
    path(dev, card)
    torch.cuda.empty_cache()
    print(f'PART limit {sys.argv[1]} {name}: {time.perf_counter() - t:.1f} s', flush=True)
print(f'PART limit {sys.argv[1]} all: {time.perf_counter() - t0:.1f} s')
'''


def _setup():
    '''The card, its line, and chip_smoke's precision settings.'''
    import chip_smoke as s
    from animeface_tpu_torch import resolve_device

    dev = resolve_device('cuda')
    card = s._card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return s, dev, card


def line_art():
    s, dev, card = _setup()
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    for recipe in s.LINE_ART:
        t = time.perf_counter()
        s.run_line_art_phase(recipe, dev, card)
        print(f'phase {recipe}: {time.perf_counter() - t:.1f} s')
    print(f'line-art total {time.perf_counter() - t0:.1f} s')


def autotune():
    s, dev, card = _setup()
    for recipe in s.LINE_ART:
        over = dict(image_size=s.LINE_ART_IMAGE, **({'fine_from': 0} if recipe == 'pix2pixHD'
                                                    else {}))
        for bench in (True, False, True, False):
            torch.backends.cudnn.benchmark = bench
            t = time.perf_counter()
            s.run_direct_steps(recipe, dev, card, 5, 2, label=f'{recipe} autotune {bench}',
                               overrides=over, make_real=s.paired_batch)
            print(f'{recipe} autotune {bench}: {time.perf_counter() - t:.1f} s')
            torch.cuda.empty_cache()


def gates():
    s, dev, card = _setup()
    s.profile_step = lambda *a, **k: []
    torch.backends.cudnn.benchmark = True
    outs = {}
    for recipe in ('BigGAN', 'SEBigGAN', 'WGAN_gp'):
        outs[recipe], _ = s.run_cli_path(recipe, card)
        torch.cuda.empty_cache()
    from animeface_tpu_torch.implementations.FastGAN import utils as fu
    args = fu.default_args(image_size=s.IMAGE)
    run = fu.build_training(args, device=dev, seed=0)
    real = s._real_images(args, dev)
    for _ in range(4):
        run.train_step(run.state, real)
    for bench in (True, False):
        torch.backends.cudnn.benchmark = bench
        for recipe in (*outs, 'FastGAN'):
            t = time.perf_counter()
            try:
                if recipe == 'FastGAN':
                    s.check_fastgan_step_against_cpu(args, run, dev)
                else:
                    s.check_cli_step_against_cpu(recipe, outs[recipe], dev)
                verdict = 'held'
            except AssertionError as e:
                verdict = f'FAILED: {e}'
            print(f'gate {recipe}, autotuning {bench}: {verdict}, '
                  f'{time.perf_counter() - t:.1f} s', flush=True)


def _processes(code, limits, keep=None):
    for limit in limits:
        t = time.perf_counter()
        r = subprocess.run([sys.executable, '-c', code, limit], capture_output=True, text=True)
        out = r.stdout + r.stderr
        lines = (out.splitlines() if keep is None
                 else [ln for ln in out.splitlines() if any(k in ln for k in keep)])
        print('\n'.join(lines[-60:]), flush=True)
        print(f'limit {limit}: rc {r.returncode}, {time.perf_counter() - t:.1f} s', flush=True)


def limit_main(limits):
    _processes(LIMIT_MAIN, limits, ('warm-up', 'main path:', 'MAINPATH', 'profile, one',
                                    'benchmark_limit', 'Error'))
    s, _, card = _setup()
    t = time.perf_counter()
    s.run_progressive_kill_resume(card, image_size=16, kills=(18, 21), save=7)
    print(f'kill lanes at 16px: {time.perf_counter() - t:.1f} s')


def limit_paths(limits):
    _processes(LIMIT_PATHS, limits, ('PART', 'warm-up', 'images/s on', 'Error'))


def main():
    if not torch.cuda.is_available():
        print('time_chip_smoke_parts: no CUDA device', file=sys.stderr)
        return 1
    mode, rest = sys.argv[1], sys.argv[2:]
    with tempfile.TemporaryDirectory(prefix='chip_smoke_parts_') as results:
        os.environ['ANIMEFACE_IMPLEMENTATIONS_DIR'] = results
        {'line-art': line_art, 'autotune': autotune, 'gates': gates,
         'limit-main': lambda: limit_main(rest), 'limit-paths': lambda: limit_paths(rest)}[mode]()
    return 0


if __name__ == '__main__':
    sys.exit(main())
