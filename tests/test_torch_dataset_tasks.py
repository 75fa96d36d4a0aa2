'''The port's paired data tasks against the JAX package's: every
synthetic task bitwise for the same seed and index; the registry of every
task and dataset name; the file classes of every registry entry on a tree
of small PNG and JPEG files (the same lists and, with `random.seed` on
both sides, the same samples), the native batch paths of the celeba and
xdog tasks; the label encoders against sklearn's; the gray task's hue
jitter against PIL's bytes; the refusal of a file dataset that only PIL
decodes when PIL does not import. numpy and PIL only: no JAX compile.'''

import csv
import random
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image as pilImage
from sklearn.preprocessing import LabelEncoder as SkLabelEncoder
from sklearn.preprocessing import OneHotEncoder as SkOneHotEncoder

import animeface_tpu.dataset as j_dataset
import animeface_tpu.dataset._base as j_base
import animeface_tpu_torch.dataset as t_dataset
import animeface_tpu_torch.dataset._base as t_base
from animeface_tpu_torch.dataset import native as t_native

TASKS = ('image', 'celeba', 'sr', 'xdog', 'gray', 'label', 'onehot')
PAIRS = [(task, name) for task in TASKS for name in sorted(j_dataset._REGISTRY[task])]
SIZE = 16


def _args(root='/nonexistent', **kw):
    return SimpleNamespace(**dict(dict(
        image_size=SIZE, batch_size=2, dataset='animeface', min_year=2005, num_images=5,
        seed=3, scale=2, data_root=str(root), synthetic_data=False), **kw))


def _same(a, b, what=''):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize('task', TASKS)
def test_synthetic_task_bitwise(task):
    args = _args(synthetic_data=True, image_size=12)
    j, t = j_dataset.build_dataset(args, task), t_dataset.build_dataset(args, task)
    assert type(j).__name__ == type(t).__name__ and len(j) == len(t) == 5
    for i in range(len(t)):
        _same(j[i], t[i], f'{task}[{i}]')
    if task in ('label', 'onehot'):
        assert t.num_classes == j.num_classes == 10
        assert list(t.inverse_transform([3, 7])) == list(j.inverse_transform([3, 7]))


def test_synthetic_loader_pairs_bitwise():
    '''The collated pairs of the sr and xdog tasks over the JAX loader's
    permutation, through `build_loader`.'''
    args = _args(synthetic_data=True, image_size=12, num_images=6)
    for task in ('sr', 'xdog'):
        jb = list(j_dataset.build_loader(args, task, num_workers=1))
        tb = list(t_dataset.build_loader(args, task, num_workers=1))
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            _same(a, b, task)


@pytest.mark.parametrize('task', TASKS)
def test_registry_matches_jax(task):
    args = _args()
    assert sorted(t_dataset._REGISTRY[task]) == sorted(j_dataset._REGISTRY[task])
    for name, entry in j_dataset._REGISTRY[task].items():
        (jc, jkw), (tc, tkw) = entry(args), t_dataset._REGISTRY[task][name](args)
        assert (jc.__name__, jkw) == (tc.__name__, tkw), (task, name)


def test_unknown_task_and_dataset_raise_as_in_jax():
    for module in (j_dataset, t_dataset):
        with pytest.raises(KeyError):
            module.build_dataset(_args(synthetic_data=True), 'nope')
        with pytest.raises(KeyError, match='unsupported'):
            module.build_dataset(_args(root='/', dataset='aahq'), 'gray')


def _png(path, rng, h, w, mode='RGB'):
    path.parent.mkdir(parents=True, exist_ok=True)
    shape = (h, w, 3) if mode == 'RGB' else (h, w)
    pilImage.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(
        path, quality=95)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    '''Every family's layout: AnimeFace faces (PNG and JPEG, years around
    2005) with their line art and labels.csv, CelebA, Danbooru portraits
    with line art, Danbooru 2020 JPEGs in two folders, AAHQ.'''
    root = tmp_path_factory.mktemp('data')
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w, year, ext) in enumerate([(40, 40, 2004, 'png'), (48, 40, 2005, 'jpg'),
                                           (40, 56, 2010, 'png'), (37, 37, 2019, 'jpg'),
                                           (44, 40, 2007, 'png')]):
        name = f'{i}_{year}.{ext}'
        _png(root / 'animefacedataset' / 'images' / name, rng, h, w)
        _png(root / 'animefacedataset' / 'xdog' / name, rng, h, w, 'L')
        rows.append([str(root / 'animefacedataset' / 'images' / name),
                     ('blue', 'red', 'green')[i % 3]])
    with open(root / 'animefacedataset' / 'labels.csv', 'w', newline='',
              encoding='utf-8') as f:
        csv.writer(f).writerows(rows)
    for i in range(4):
        _png(root / 'celeba' / 'img_align_celeba' / f'{i:06d}.jpg', rng, 50, 42)
        _png(root / 'danbooru' / 'portraits' / 'portraits' / f'p{i}.png', rng, 40, 40)
        _png(root / 'danbooru' / 'portraits' / 'xdog' / f'p{i}.png', rng, 40, 40, 'L')
        _png(root / 'danbooru' / '2020' / f'{i % 2:04d}' / f'd{i}.jpg', rng, 52, 44)
        _png(root / 'aahq' / f'a{i}.png', rng, 36, 48)
    return root


@pytest.fixture()
def rooted(tree, monkeypatch):
    monkeypatch.setattr(j_base, 'DATA_ROOT', str(tree))
    monkeypatch.setattr(t_base, 'DATA_ROOT', str(tree))
    return tree


def _build_both(args, task):
    datasets = []
    for module in (j_dataset, t_dataset):
        random.seed(1)                     # the num_images shuffles
        datasets.append(module.build_dataset(args, task))
    return datasets


@pytest.mark.parametrize('task,name', PAIRS, ids=[f'{t}-{n}' for t, n in PAIRS])
def test_file_dataset_matches_jax(rooted, task, name):
    '''Each registry entry on the file tree: the same class, file lists and
    labels, and the same samples with the `random` module seeded alike (the
    flips, the SR crop's flip and the gray task's hue draw).'''
    args = _args(rooted, dataset=name, num_images=3)
    j, t = _build_both(args, task)
    assert type(j).__name__ == type(t).__name__ and len(j) == len(t) > 0
    for attr in ('images', 'images1', 'images2', 'xdogs'):
        assert getattr(j, attr, None) == getattr(t, attr, None), attr
    if task in ('label', 'onehot'):
        _same(j.labels, t.labels, 'labels')
        assert j.num_classes == t.num_classes == 3
        first = t.labels[0]
        _same(j.inverse_transform(first), t.inverse_transform(first), 'inverse')
    for i in range(len(t)):
        random.seed(10 + i)
        a = j[i]
        random.seed(10 + i)
        _same(a, t[i], f'{task}/{name}[{i}]')


def test_shuffle_xdog_matches_jax(rooted):
    j, t = _build_both(_args(rooted), 'xdog')
    for ds in (j, t):
        random.seed(5)
        ds.shuffle_xdog()
    assert j.xdogs == t.xdogs != sorted(t.xdogs)


@pytest.mark.skipif(not t_native.available(), reason='the native decode library does not load')
@pytest.mark.parametrize('task', ['celeba', 'xdog'])
def test_native_pair_batches_match_jax(rooted, task):
    '''The native batch path of the two-file tasks: the same batch as JAX's
    (the flip mask from numpy's global generator on both sides); the line
    art keeps one channel.'''
    j, t = _build_both(_args(rooted), task)
    assert t.native_ok() and j.native_ok()
    idx = np.arange(len(t))
    np.random.seed(2)
    a = j.load_native_batch(idx)
    np.random.seed(2)
    b = t.load_native_batch(idx)
    _same(a, b, task)
    assert b[1].shape[-1] == (1 if task == 'xdog' else 3)


def test_danbooru_auto_pair(rooted):
    '''`DanbooruAutoPair`: (transform(img), transform(pair(img))) through
    `__getitem__`, as JAX's, and never the native single-image batch.'''
    from animeface_tpu.dataset.danbooru import DanbooruAutoPair as J
    from animeface_tpu_torch.dataset.danbooru import DanbooruAutoPair as T

    def pair(img):
        return img.transpose(pilImage.FLIP_TOP_BOTTOM)
    j, t = J(SIZE, pair), T(SIZE, pair)
    assert j.images == t.images and not t.native_ok()
    for i in range(len(t)):
        random.seed(i)
        a = j[i]
        random.seed(i)
        _same(a, t[i], f'pair[{i}]')
    assert len(next(iter(t_base.DataLoader(t, 2, num_workers=1)))) == 2


@pytest.mark.parametrize('labels', [['b', 'a', 'c', 'a', 'b', 'b'], [3, 1, 2, 3, 3],
                                    ['only', 'only']], ids=['str', 'int', 'one'])
def test_label_encoders_match_sklearn(labels):
    y = np.array(labels)
    sk, ours = SkLabelEncoder(), t_base.LabelEncoder()
    _same(sk.fit_transform(y), ours.fit_transform(y), 'codes')
    _same(sk.classes_, ours.classes_, 'classes')
    codes = np.arange(len(sk.classes_))[::-1]
    _same(sk.inverse_transform(codes), ours.inverse_transform(codes), 'inverse')
    with pytest.raises(ValueError):
        ours.inverse_transform([len(sk.classes_)])

    col = y.reshape(-1, 1)
    sk1, ours1 = SkOneHotEncoder(), t_base.OneHotEncoder()
    _same(sk1.fit_transform(col).toarray(), ours1.fit_transform(col), 'onehot')
    _same(sk1.categories_[0], ours1.categories_[0], 'categories')
    row = np.eye(len(sk1.categories_[0]))[-1].reshape(1, -1)
    _same(sk1.inverse_transform(row), ours1.inverse_transform(row), 'onehot inverse')
    with pytest.raises(ValueError):
        ours1.inverse_transform(np.zeros_like(row))


def _pil_shift(rgb, delta):
    '''JAX `ImageGray._jitter_hue`'s arithmetic with an explicit delta.'''
    h, s, v = pilImage.fromarray(rgb, 'RGB').convert('HSV').split()
    h = h.point(lambda p: (p + int(round(delta * 255))) % 256)
    return np.asarray(pilImage.merge('HSV', (h, s, v)).convert('RGB'))


@pytest.mark.parametrize('delta', [-0.1, 0.0, 0.1])
def test_hue_shift_matches_pil(delta):
    '''400 random pixels and the gray and saturated corners, and PIL's own
    HSV bytes both ways.'''
    rng = np.random.default_rng(int(delta * 10) + 1)
    rgb = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
    rgb[0, :8] = [[0, 0, 0], [255, 255, 255], [7, 7, 7], [255, 0, 0], [0, 255, 0],
                  [0, 0, 255], [255, 255, 0], [1, 0, 0]]
    _same(t_base.rgb_to_hsv(rgb), np.asarray(pilImage.fromarray(rgb).convert('HSV')), 'hsv')
    _same(t_base.hsv_to_rgb(rgb),
          np.asarray(pilImage.fromarray(rgb, 'HSV').convert('RGB')), 'rgb')
    _same(t_base.shift_hue(rgb, delta), _pil_shift(rgb, delta), f'shift {delta}')


def test_gray_jitter_matches_jax():
    rgb = np.random.default_rng(9).integers(0, 256, (24, 24, 3), dtype=np.uint8)
    img = pilImage.fromarray(rgb)
    for seed in range(6):
        random.seed(seed)
        a = np.asarray(j_base.ImageGray._jitter_hue(img))
        random.seed(seed)
        _same(a, np.asarray(t_base.ImageGray._jitter_hue(img)), f'seed {seed}')


@pytest.mark.parametrize('task,name,native', [('sr', 'animeface', True),
                                              ('gray', 'danbooru', True),
                                              ('label', 'animeface', True),
                                              ('xdog', 'animeface', False)])
def test_pil_only_file_dataset_refused_without_pil(rooted, monkeypatch, task, name, native):
    '''Without PIL, a file dataset with no native path (sr, gray, label) is
    refused at `build_loader` even when the native library loads, naming
    its class; xdog only when neither decoder loads. The synthetic tasks
    need neither.'''
    def no_pil():
        raise ImportError('PIL blocked')

    monkeypatch.setattr(t_base, 'pil_image', no_pil)
    monkeypatch.setattr(t_native, 'available', lambda: native)
    args = _args(rooted, dataset=name, num_images=3)
    cls = type(t_dataset.build_dataset(args, task)).__name__
    with pytest.raises(RuntimeError, match=cls):
        t_dataset.build_loader(args, task)
    assert len(t_dataset.build_loader(_args(synthetic_data=True), task)) == 2
