'''Host and device time of the bias_act kernel of one checkout, so that two
checkouts can be compared in one call on one card:

    python3 time_bias_act_kernel.py [TREE] [--kernel-only]

TREE (default: this checkout) is the root of the checkout whose
`animeface_tpu_torch` is timed; the inputs and the timers are this
checkout's `chip_smoke.py` helpers (`_bias_act_inputs`, `time_bias_act`,
`cips_sampler`). At each shape of a CIPS sampling forward's calls (the
bias in x's dtype) it prints (a) the kernel's device time alone (by
torch.profiler, or by CUDA events where the profiler missed launches:
`_device_ms`), (b) ms a call of `ck.bias_act` and of
`ops.bias_act(impl='cuda')` back to back, (c) of torch.add(x, b) on the
linear gain-1 shapes and (d) of the copy ceiling y.copy_(x) on the big
one; (e) at the (16, 512) f32 linear shape, the host microseconds to
issue torch.add, `ck.bias_act` and the registry's entry, and (where the
wrapper keeps parameter blocks) the parts of `ck.bias_act`: the output's
torch.empty_like, the ctypes call with its launch, the memo's lookup and
the registry's scope test; then (unless --kernel-only) CIPS sampling at
the recipe's 128px defaults: ms a forward over 8 forwards, twice, and the
device kernels of one profiled forward. A freshly built kernel's ptxas
lines come first, and one JSON line of the numbers last. Run it on two
checkouts in turns (A, B, B, A). Needs one CUDA card; imports nothing of
JAX.
'''

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CIPS_FORWARDS = 8


def _issue_us(fn, n=3000):
    '''Host microseconds to issue fn() (launches queued, not waited for),
    a call over n calls after 100 warm-up calls.'''
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_parts(ck, ops, x, b):
    '''(e): the host cost of one small linear call and of its parts.'''
    parts = {'torch.add': lambda: torch.add(x, b),
             'ck.bias_act': lambda: ck.bias_act(x, b, -1, 'linear', 0.2, 1.0, -1.0),
             'ops.bias_act': lambda: ops.bias_act(x, b, dim=-1, impl='cuda')}
    if hasattr(ck, '_bias_act_plans'):          # the wrapper that keeps parameter blocks
        key = (x.shape, x.dtype, b.shape, b.dtype, -1, 'linear', 0.2, 1.0, -1.0, True)
        plan = ck._bias_act_plans[key]
        y, stream = torch.empty_like(x), ck._raw_stream(x.get_device())
        ptrs = (x.data_ptr(), b.data_ptr(), y.data_ptr())
        parts.update({
            'empty_like': lambda: torch.empty_like(x),
            'ctypes call and launch': lambda: ck._bias_act_fwd(*ptrs, plan[1], stream),
            'memo lookup': lambda: ck._bias_act_plans.get(
                (x.shape, x.dtype, b.shape, b.dtype, -1, 'linear', 0.2, 1.0, -1.0,
                 x.data_ptr() % 16 == 0)),
            'scope test': lambda: ck.bias_act_in_scope(x.shape, b, -1)})
    return {k: _issue_us(fn) for k, fn in parts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print('time_bias_act_kernel: no CUDA device', file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if a != '--kernel-only']
    tree = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(tree))          # the timed package, before this checkout's
    spec = importlib.util.spec_from_file_location('chip_smoke', HERE / 'chip_smoke.py')
    s = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(s)
    from animeface_tpu_torch import _build
    from animeface_tpu_torch.ops import cuda_kernels as ck

    print(f'{s._card_line()}; timing {ck.__file__}')
    for line in _build.build_all().get('bias_act', '').splitlines():
        if 'entry function' in line or 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}')
    dev = torch.device('cuda')
    result = dict(tree=tree.name, shapes={})
    for label, x, b, act, gain, _ in s._bias_act_inputs(dev):
        result['shapes'][label] = s.time_bias_act(f'{tree.name} {label}', x, b, act, gain)
        if label.startswith('bias_act linear (16, 512)'):
            from animeface_tpu_torch import ops
            result['host_us'] = host_parts(ck, ops, x, b)
            print(f'{tree.name} {label}: host us to issue a call: ' + ', '.join(
                f'{k} {v:.2f}' for k, v in result['host_us'].items()))
    del x, b
    torch.cuda.empty_cache()
    if '--kernel-only' in sys.argv:
        print(json.dumps(result))
        return 0

    _, _, sample = s.cips_sampler(dev)
    result['cips_forward_ms'] = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(CIPS_FORWARDS):
            sample()
        torch.cuda.synchronize()
        result['cips_forward_ms'].append((time.perf_counter() - t0) * 1e3 / CIPS_FORWARDS)
    rows = s.profile_step('CIPS sampling forward', sample)
    result['cips_device_kernels'] = sum(r[1] for r in rows) if rows else None
    print(f'{tree.name} CIPS sampling: ' + ' / '.join(
        f'{ms:.3f}' for ms in result['cips_forward_ms'])
          + f' ms a forward; {result["cips_device_kernels"]} device kernels a forward')
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
