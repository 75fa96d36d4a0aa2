'''The kernel builder's cache key: a library is named by a hash of its
source and of the headers beside it, so an edited header rebuilds every
source, and an unchanged tree is reused without calling nvcc. No nvcc is
needed: the sources are written to a temporary `csrc/` and nvcc is
replaced by a stand-in that fails if it is called.'''

import pytest

from animeface_tpu_torch import _build


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / 'csrc', tmp_path / 'build'
    csrc.mkdir()
    (csrc / 'a.cu').write_text('#include "common.cuh"\n__global__ void k() {}\n')
    (csrc / 'b.cu').write_text('__global__ void k2() {}\n')
    (csrc / 'common.cuh').write_text('#pragma once\n')
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD', build)

    def no_nvcc():
        raise AssertionError('nvcc was called')

    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    return csrc


def test_target_changes_with_a_header(tree):
    src = tree / 'a.cu'
    before = _build._target(src)
    assert before.parent == _build.BUILD and before.name.startswith('a-')
    (tree / 'common.cuh').write_text('#pragma once\n// edited\n')
    edited = _build._target(src)
    assert edited != before
    (tree / 'common.cuh').write_text('#pragma once\n')
    assert _build._target(src) == before
    (tree / 'other.cuh').write_text('#pragma once\n')
    assert _build._target(src) != before


def test_target_changes_with_the_source(tree):
    src = tree / 'b.cu'
    before = _build._target(src)
    src.write_text('__global__ void k3() {}\n')
    assert _build._target(src) != before


def test_build_all_reuses_libraries_until_a_header_changes(tree):
    _build.BUILD.mkdir()
    for src in tree.glob('*.cu'):
        _build._target(src).touch()
    assert _build.build_all() == {}                  # every library fresh: no nvcc
    (tree / 'common.cuh').write_text('#pragma once\n#define X 1\n')
    with pytest.raises(AssertionError, match='nvcc was called'):
        _build.build_all()
