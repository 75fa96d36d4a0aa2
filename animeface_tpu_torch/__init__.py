'''animeface_tpu_torch — the PyTorch/CUDA port of animeface_tpu.

It runs the StyleGAN2-ADA training step, the ADA recipe's step (StyleGAN3
with the AugmentPipe) and CIPS sampling on an NVIDIA H100. The JAX package
`animeface_tpu` is the reference; nothing here imports it or JAX. Every
kernel that the JAX package wrote in Pallas for the TPU is a hand-written
CUDA kernel here (`csrc/`), built by `nvcc` at first use (`_build.py`); the
ops registry's two (`ops/registry.py`, `ops/cuda_kernels.py`) run only
under impl 'cuda', forward only, as the JAX package's 'pallas' ones do.

Entry points run on `cuda` unless the caller passes `device='cpu'`.
'''

import torch


def resolve_device(device=None) -> torch.device:
    '''`cuda` by default; raise rather than fall back when it is absent.'''
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA was requested but no CUDA device is available; '
                           "pass device='cpu' to run on the CPU")
    return device
