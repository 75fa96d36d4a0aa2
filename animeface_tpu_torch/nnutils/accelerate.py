'''Accelerator: the device, the compute dtype and the batch feed.

Counterpart of `animeface_tpu/nnutils/accelerate.py:Accelerator` on one
device (`num_devices` is 1; the dp mesh is ROADMAP Queue 1 item 9). Where
JAX placed a pytree on a mesh, the port's modules are built on the device,
so what is left is the policy (bf16 or f32) and `iter_loader`, the
counterpart of `parallel/mesh.py:prefetch_to_device`: each NHWC numpy batch
is copied from pinned host memory with `non_blocking=True` on a side
stream, `prefetch` batches in flight, dequantized there when it is uint8,
and made NCHW, the layout the port's steps take.
'''

from __future__ import annotations

import collections
import os

import numpy as np
import torch

from animeface_tpu_torch import resolve_device


def default_device() -> torch.device:
    '''`cuda`, or what `ANIMEFACE_PLATFORM` names (`cpu` for CPU runs, the
    variable `main.py` reads); raises without a card unless it names the
    CPU.'''
    return resolve_device(os.environ.get('ANIMEFACE_PLATFORM') or None)


def _to_device(x: np.ndarray, device: torch.device, non_blocking: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if non_blocking:
        t = t.pin_memory()
    t = t.to(device, non_blocking=non_blocking)
    if t.dtype == torch.uint8 and t.ndim == 4:
        t = t.float() / 127.5 - 1.0
    if t.ndim == 4:
        t = t.permute(0, 3, 1, 2).contiguous()
    return t


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    return fn(batch)


class Accelerator:
    '''The device and precision policy of a run.

    >>> accel = Accelerator(bf16=True)            # cuda, or ANIMEFACE_PLATFORM
    >>> for batch in accel.iter_loader(loader):   # NCHW on the device
    ...     state, metrics = train_step(state, batch)
    '''

    def __init__(self, device=None, bf16: bool = True, autotune: bool = True):
        self.device = default_device() if device is None else resolve_device(device)
        self.bf16 = bf16
        if self.device.type == 'cuda':
            # the settings the card's f32 checks were made under: convolutions
            # autotuned, no TF32 in matmuls or convolutions. A caller that
            # asked for deterministic algorithms gets no autotuning: it may
            # pick another algorithm in each process; `autotune=False` is a
            # recipe's own choice
            torch.backends.cudnn.benchmark = (
                autotune and not torch.are_deterministic_algorithms_enabled())
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.bf16 else torch.float32

    @property
    def num_devices(self) -> int:
        return 1

    def iter_loader(self, loader, prefetch: int = 2):
        '''The loader's batches on the device, NCHW, float32 in [-1, 1];
        on `cuda` `prefetch` batches are copied ahead on a side stream.'''
        if self.device.type != 'cuda':
            for batch in loader:
                yield _tree_map(lambda x: _to_device(x, self.device, False), batch)
            return
        stream = torch.cuda.Stream(self.device)
        buf = collections.deque()

        def put(batch):
            with torch.cuda.stream(stream):
                out = _tree_map(lambda x: _to_device(x, self.device, True), batch)
                done = torch.cuda.Event()
                done.record(stream)
            return out, done

        it = iter(loader)
        exhausted = False
        while True:
            while not exhausted and len(buf) < prefetch:
                try:
                    buf.append(put(next(it)))
                except StopIteration:
                    exhausted = True
            if not buf:
                return
            out, done = buf.popleft()
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            # made on the side stream, used on this one: keep the allocator
            # from reusing the memory before this stream is done with it
            _tree_map(lambda t: t.record_stream(current), out)
            yield out
