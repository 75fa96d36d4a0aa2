'''bias_act — bias add, activation, gain and clamp.

Counterpart of `animeface_tpu/ops/bias_act.py`: its `activation_funcs`
table (kept in `ops/activations.py`, which the kernel's plain version reads
too), and `bias_act` with the ops registry's two implementations
(`ops/registry.py`). 'torch' (the default) is the plain composition in x's
dtype, the JAX package's 'xla' path. 'cuda' sends the calls in the kernel's
scope (a bias on the channel axis, C % 128 == 0, numel / C a multiple of 8)
to the hand-written kernel (`ops/cuda_kernels.py:bias_act`, f32 inside, one
rounding; forward only), as the JAX package's 'pallas' sends them to
`bias_act_pallas`; the others take the composition.

The bias runs along `dim`, by default axis 1: the NCHW channel axis, and the
feature axis of a [batch, features] input (the JAX package defaults to -1,
its NHWC channel axis; CIPS's [B, S^2, C] passes dim=-1). Both
implementations round the bias to x's dtype before the add, so a caller
may pass an f32 bias with a bf16 x.
'''

from __future__ import annotations

from animeface_tpu_torch.ops import cuda_kernels
from animeface_tpu_torch.ops.activations import activation_funcs
from animeface_tpu_torch.ops.registry import resolve_impl


def bias_act(x, b=None, dim: int = 1, act: str = 'linear', alpha=None, gain=None,
             clamp=None, impl: str | None = None):
    '''x + b (along `dim`), then the activation, times `gain`, clipped to
    [-clamp, clamp]. `alpha`, `gain` default to the activation's own;
    `impl` to the registry's default.'''
    assert clamp is None or clamp >= 0
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    if resolve_impl(impl) == 'cuda' and cuda_kernels.bias_act_in_scope(x.shape, b, dim):
        return cuda_kernels.bias_act(x, b, dim, act, alpha, gain,
                                     -1.0 if clamp is None else float(clamp))
    if b is not None:
        axis = dim % x.ndim
        assert b.ndim == 1 and b.shape[0] == x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.func(x, alpha=alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
