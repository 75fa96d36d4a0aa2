'''Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, in `build/` beside this file (listed in
`.gitignore`), and loaded with `ctypes`. The library's file name carries a
hash of its source and of the headers in `csrc/` (`*.cuh`), so an edited
source or header is rebuilt and an unchanged one is reused. All sources compile in parallel, one `nvcc` each, at the first call
of `library()` or `build_all()`; nothing is built at import time.
'''

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD = Path(__file__).resolve().parent / 'build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-lineinfo', '-Xptxas', '-v']

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the '
                       'CUDA toolkit is installed')


def _target(src: Path) -> Path:
    '''The library of `src`, named by a hash of the source and of every
    header beside it (any of them may be included), so that an edited
    header rebuilds the sources too.'''
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob('*.cuh')):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD / f'{src.stem}-{h.hexdigest()[:12]}.so'


def build_all() -> dict[str, str]:
    '''Compile every stale source in `csrc/` in parallel; return the ptxas
    report (registers, shared memory, spills) of each source built now.'''
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [(src, _target(src)) for src in sorted(CSRC.glob('*.cu'))
            if not _target(src).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    for src, target in todo:
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(src)]
        procs.append((src, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for src, target, tmp, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{src.name}:\n{output}')
            Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
        reports[src.stem] = output
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    '''The loaded library of `csrc/<name>.cu`, built at first use.'''
    lib = _loaded.get(name)
    if lib is None:
        src = CSRC / f'{name}.cu'
        if not src.exists():
            raise FileNotFoundError(src)
        build_all()
        lib = ctypes.CDLL(str(_target(src)))
        _loaded[name] = lib
    return lib
