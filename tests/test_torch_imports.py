'''The port imports nothing of JAX or of the JAX package, and its entry
points refuse a missing card instead of falling back to the CPU.'''

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

GUARD = '''
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'animeface_tpu'):
    sys.modules[name] = None          # any import of these now raises
import animeface_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(animeface_tpu_torch.__path__,
                                              'animeface_tpu_torch.')]
for name in mods:
    importlib.import_module(name)
import chip_smoke, time_line_kernels, time_flrelu_kernel, time_bias_act_kernel
print(' '.join(mods))
'''

#: modules that must be among those the guard imported
REQUIRED = (
    'animeface_tpu_torch.nnutils.ada_geometry_cuda',
    'animeface_tpu_torch.nnutils.diffaugment',
    'animeface_tpu_torch.ops.activations',
    'animeface_tpu_torch.ops.bias_act',
    'animeface_tpu_torch.ops.conv2d_resample',
    'animeface_tpu_torch.ops.filtered_lrelu',
    'animeface_tpu_torch.ops.registry',
    'animeface_tpu_torch.ops.cuda_kernels',
    'animeface_tpu_torch.implementations.CIPS.model',
    'animeface_tpu_torch.implementations.CIPS.utils',
    'animeface_tpu_torch.implementations.StyleGAN2.utils',
    'animeface_tpu_torch.implementations.StyleGAN3.model',
    'animeface_tpu_torch.implementations.StyleGAN3.utils',
    'animeface_tpu_torch.implementations.ADA.utils',
    'animeface_tpu_torch.implementations.FastGAN.model',
    'animeface_tpu_torch.implementations.FastGAN.utils',
)


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, '-c', GUARD], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 23 and not set(REQUIRED) - mods, sorted(set(REQUIRED) - mods)


def test_cuda_request_without_card_raises(monkeypatch):
    from animeface_tpu_torch import resolve_device
    from animeface_tpu_torch.implementations.ADA.utils import build_training, default_args
    from animeface_tpu_torch.nnutils.ada import ada_init_state
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        ada_init_state(8)
    with pytest.raises(RuntimeError):
        build_training(default_args())
    assert resolve_device('cpu') == torch.device('cpu')
    assert ada_init_state(8, device='cpu')['p'].device == torch.device('cpu')
