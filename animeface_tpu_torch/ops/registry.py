'''Kernel-implementation registry.

Counterpart of `animeface_tpu/ops/registry.py`. Ops that have a
hand-written kernel select between two implementations by name:
  * 'torch' — the plain PyTorch composition (the default; always available);
  * 'cuda'  — the hand-written CUDA kernel (`ops/cuda_kernels.py`), for the
    calls in its scope; every other call takes the 'torch' composition, as
    the JAX package's registry falls back to 'xla'. Forward only: the
    kernels have no backward, as the JAX package's Pallas kernels have none.

The default comes from $ANIMEFACE_OPS_IMPL, the JAX package's variable; its
names 'xla' and 'pallas' read as 'torch' and 'cuda'.
'''

from __future__ import annotations

import os

_VALID = ('torch', 'cuda')
_JAX_NAMES = {'xla': 'torch', 'pallas': 'cuda'}


def _canonical(impl: str) -> str:
    impl = _JAX_NAMES.get(impl, impl)
    assert impl in _VALID, impl
    return impl


_default_impl = _canonical(os.environ.get('ANIMEFACE_OPS_IMPL', 'torch'))


def set_default_impl(impl: str) -> None:
    global _default_impl
    _default_impl = _canonical(impl)


def get_default_impl() -> str:
    return _default_impl


def resolve_impl(impl: str | None) -> str:
    if impl is None or impl == 'auto':
        return _default_impl
    return _canonical(impl)
