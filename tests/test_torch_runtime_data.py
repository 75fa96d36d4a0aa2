'''The port's data layer and image files against the JAX package's:
synthetic images and the loader's batches, bitwise (the same epoch
permutations, drop_last and producer thread, with 1 and several workers);
the uint8 wire; the default transform, `AnimeFace` with its `min_year`
filter and the native batch decoder on a tree of PNG and JPEG files
written with PIL here (the port against JAX exactly, the native decoder
against PIL at the tolerances of tests/test_native_io.py); the synthetic
fallback; the refusal of a file dataset with no decoder; the sample
grid's PNG pixels.'''

import random
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image as pilImage

import animeface_tpu.dataset as j_dataset
import animeface_tpu.dataset._base as j_base
from animeface_tpu.dataset import native as j_native
from animeface_tpu.dataset.animeface import AnimeFace as JAnimeFace
from animeface_tpu.dataset.synthetic import SyntheticImage as JSynthetic
from animeface_tpu.parallel.mesh import dequantize_images
from animeface_tpu.utils import EasyDict, make_image_grid as j_grid, save_image as j_save

import animeface_tpu_torch.dataset as t_dataset
import animeface_tpu_torch.dataset._base as t_base
from animeface_tpu_torch.dataset import native as t_native
from animeface_tpu_torch.dataset.animeface import AnimeFace as TAnimeFace
from animeface_tpu_torch.dataset.synthetic import SyntheticImage as TSynthetic
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.utils import make_image_grid as t_grid, save_image as t_save


@pytest.mark.parametrize('size,seed', [(16, 0), (33, 7), (64, 123)])
def test_synthetic_images_bitwise(size, seed):
    j, t = JSynthetic(size, 6, seed), TSynthetic(size, 6, seed)
    assert len(j) == len(t) == 6
    for i in range(6):
        a, b = j[i], t[i]
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('workers', [1, 3])
@pytest.mark.parametrize('drop_last', [True, False])
@pytest.mark.parametrize('transfer', ['float32', 'uint8'])
def test_loader_batches_bitwise_over_two_epochs(workers, drop_last, transfer):
    kw = dict(batch_size=6, drop_last=drop_last, num_workers=workers, seed=5,
              transfer_dtype=transfer)
    j = j_base.DataLoader(JSynthetic(12, 20, 3), **kw)
    t = t_base.DataLoader(TSynthetic(12, 20, 3), **kw)
    assert len(j) == len(t) == (3 if drop_last else 4)
    for _ in range(2):
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) == len(t)
        for a, b in zip(jb, tb):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_loader_stops_its_producer_when_left():
    t = t_base.DataLoader(TSynthetic(8, 64, 0), 4, num_workers=2, prefetch=1)
    it = iter(t)
    next(it)
    it.close()        # joins the producer, which must not block on the full queue


def test_quantize_images_matches_jax():
    x = np.random.default_rng(0).uniform(-1.2, 1.2, (3, 5, 5, 3)).astype(np.float32)
    labels = np.arange(3, dtype=np.int32)
    for batch in (x, (x, labels)):
        got, want = t_base._quantize_images(batch), j_base._quantize_images(batch)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_accelerator_feeds_nchw_and_dequantizes_like_jax():
    x = np.random.default_rng(1).uniform(-1, 1, (4, 6, 5, 3)).astype(np.float32)
    q = j_base._quantize_images(x)
    accel = Accelerator('cpu', bf16=False)
    assert accel.compute_dtype == torch.float32 and accel.num_devices == 1
    assert Accelerator('cpu').compute_dtype == torch.bfloat16
    (a, b), = list(accel.iter_loader([(x, q)]))
    assert a.shape == b.shape == (4, 3, 6, 5) and a.is_contiguous()
    np.testing.assert_array_equal(a.permute(0, 2, 3, 1).numpy(), x)
    want = np.asarray(dequantize_images(q))
    # 1/127.5 may be folded into a multiply on one side: within an ulp of 1
    np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=2e-7)


def _write_tree(root):
    '''animefacedataset/images/ with PNG and JPEG faces of several sizes,
    named <i>_<year>: years before and after 2005.'''
    d = root / 'animefacedataset' / 'images'
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, (h, w, year, ext) in enumerate([(40, 40, 2004, 'png'), (48, 40, 2005, 'jpg'),
                                           (40, 56, 2010, 'png'), (37, 37, 2019, 'jpg'),
                                           (64, 48, 2001, 'jpg'), (40, 44, 2007, 'png')]):
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        pilImage.fromarray(arr).save(d / f'{i}_{year}.{ext}', quality=95)


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    _write_tree(tmp_path)
    monkeypatch.setattr(j_base, 'DATA_ROOT', str(tmp_path))
    monkeypatch.setattr(t_base, 'DATA_ROOT', str(tmp_path))
    return tmp_path


@pytest.mark.parametrize('min_year', [None, 2005])
def test_animeface_files_and_pil_path_match_jax(tree, min_year):
    j, t = JAnimeFace(24, min_year=min_year), TAnimeFace(24, min_year=min_year)
    assert j.images == t.images and len(t) == (6 if min_year is None else 4)
    for i in range(len(t)):
        random.seed(i)
        a = j[i]
        random.seed(i)
        b = t[i]
        assert b.shape == (24, 24, 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(not j_native.available(), reason='native lib not built')
def test_native_batch_matches_jax_and_pil(tree):
    t = TAnimeFace(24, min_year=None, transform=t_base.make_default_transform(24, hflip=False))
    j = JAnimeFace(24, min_year=None, transform=j_base.make_default_transform(24, hflip=False))
    assert t_native.available() and t.native_ok()
    idx = np.arange(len(t))
    got = t.load_native_batch(idx)
    np.testing.assert_array_equal(got, j.load_native_batch(idx))
    for i in idx:
        pil = t[i]
        err = np.abs(got[i] - pil)
        if t.images[i].endswith('.png'):
            assert err.max() <= 2.5 / 255. + 1e-6
        else:
            assert err.max() < 0.1 and err.mean() < 0.01
    # the random hflip mask comes from numpy's global generator on both sides
    flip_t = TAnimeFace(24, min_year=None)
    flip_j = JAnimeFace(24, min_year=None)
    np.random.seed(3)
    a = flip_t.load_native_batch(idx)
    np.random.seed(3)
    np.testing.assert_array_equal(a, flip_j.load_native_batch(idx))


def _args(root, **kw):
    return EasyDict(dict(image_size=24, batch_size=2, dataset='animeface', min_year=2005,
                         num_images=64, seed=4, data_root=str(root), synthetic_data=False), **kw)


def test_build_loader_on_files_matches_jax(tree):
    batches = []
    for module in (j_dataset, t_dataset):
        loader = module.build_loader(_args(tree), num_workers=1)
        np.random.seed(0)
        random.seed(0)
        batches.append(list(loader))
    assert len(batches[0]) == len(batches[1]) == 2
    for a, b in zip(*batches):
        np.testing.assert_array_equal(a, b)


def test_synthetic_fallback_warns():
    for module in (j_dataset, t_dataset):
        with pytest.warns(UserWarning, match='data root not found'):
            ds = module.build_dataset(_args('/nonexistent/animeface-root'))
        assert len(ds) == 64 and ds.image_size == 24
    args = _args('/nonexistent', synthetic_data=True)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        loader = t_dataset.build_loader(args)
    assert isinstance(loader.dataset, TSynthetic)
    np.testing.assert_array_equal(next(iter(loader)),
                                  next(iter(j_dataset.build_loader(args))))


def test_file_dataset_without_decoders_refused_at_build_loader(tree, monkeypatch):
    def no_pil():
        raise ImportError('PIL blocked')

    monkeypatch.setattr(t_base, 'pil_image', no_pil)
    monkeypatch.setattr(t_native, 'available', lambda: False)
    with pytest.raises(RuntimeError, match='native.*PIL'):
        t_dataset.build_loader(_args(tree))
    monkeypatch.setattr(t_native, 'available', lambda: True)
    assert len(t_dataset.build_loader(_args(tree))) == 2


@pytest.mark.parametrize('shape,nrow', [((5, 8, 6, 3), 8), ((7, 5, 5, 3), 3), ((4, 6, 6, 1), 2),
                                        ((6, 6, 3), 4)])
def test_png_grid_pixels_match_jax(tmp_path, shape, nrow):
    x = np.random.default_rng(2).uniform(-1.3, 1.3, shape).astype(np.float32)
    j_save(x, tmp_path / 'j.png', nrow=nrow)
    t_save(x, tmp_path / 't.png', nrow=nrow)
    a = np.asarray(pilImage.open(tmp_path / 'j.png'))
    b = np.asarray(pilImage.open(tmp_path / 't.png'))
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_grid(x, x[::-1], num_images=2),
                                  j_grid(x, x[::-1], num_images=2))


def test_jpg_written_with_pil_and_skipped_without(tmp_path, monkeypatch):
    x = np.zeros((2, 4, 4, 3), np.float32)
    t_save(x, tmp_path / 'a.jpg')
    assert (tmp_path / 'a.jpg').exists()
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.warns(UserWarning, match='PIL'):
        t_save(x, tmp_path / 'b.jpg')
    assert not (tmp_path / 'b.jpg').exists()
    t_save(x, tmp_path / 'c.png')
    assert (tmp_path / 'c.png').exists()
