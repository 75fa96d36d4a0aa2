'''PyTorch checkpoints of the metrics' trunks -> the `.npz` both packages read.

The port's copy of `tools/convert_inception_weights.py` and
`tools/convert_vgg_weights.py`. Run once on a machine that has the
checkpoint:

    python -m animeface_tpu_torch.convert_weights inception \
        pt_inception-2015-12-05.pth inception_fid.npz
    export ANIMEFACE_INCEPTION_WEIGHTS=/path/to/inception_fid.npz

    python -m animeface_tpu_torch.convert_weights vgg vgg16.pth vgg16.npz
    export ANIMEFACE_VGG_WEIGHTS=/path/to/vgg16.npz

`inception_npz` takes the pytorch-fid checkpoint, a torchvision
`inception_v3` state dict (fc and AuxLogits are dropped) or the state dict
of the port's `InceptionV3Features`, whose names are pytorch-fid's.
`vgg_npz` takes a torchvision VGG16 or VGG19 state dict. The keys mirror
the JAX package's flax module trees (kernels HWIO).
'''

from __future__ import annotations

import sys

import numpy as np

# conv layout per block (nnutils/loss/vgg.py)
_CFG = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, 'detach') else t)


def inception_npz(state_dict) -> dict:
    '''InceptionV3 state dict -> {'params/<path>/conv/kernel' HWIO,
    'params/<path>/bn/{scale,bias}', 'batch_stats/<path>/bn/{mean,var}'}.'''
    out = {}
    for key, tensor in state_dict.items():
        if key.startswith(('fc.', 'AuxLogits.')):
            continue
        val = _np(tensor)
        parts = key.split('.')
        if parts[-2] == 'conv' and parts[-1] == 'weight':
            out['params/' + '/'.join(parts[:-1]) + '/kernel'] = val.transpose(2, 3, 1, 0)
        elif parts[-2] == 'bn':
            base = '/'.join(parts[:-1])
            name = {'weight': f'params/{base}/scale', 'bias': f'params/{base}/bias',
                    'running_mean': f'batch_stats/{base}/mean',
                    'running_var': f'batch_stats/{base}/var'}.get(parts[-1])
            if name is not None:           # num_batches_tracked: dropped
                out[name] = val
    return out


def vgg_npz(state_dict) -> dict:
    '''torchvision VGG16/19 state dict -> {'conv{block}_{i}/kernel' HWIO,
    'conv{block}_{i}/bias', '__layers__'} (the classifier dropped).'''
    conv_keys = sorted(
        (k for k in state_dict
         if k.startswith('features') and k.endswith('.weight')
         and getattr(state_dict[k], 'ndim', 0) == 4),
        key=lambda k: int(k.split('.')[1]))
    layers = {13: 16, 16: 19}.get(len(conv_keys))
    if layers is None:
        raise ValueError(f'{len(conv_keys)} conv layers in features: not a VGG16 (13) or '
                         f'VGG19 (16) state dict')
    out = {'__layers__': np.int32(layers)}
    it = iter(conv_keys)
    for block, per_block in enumerate(_CFG[layers]):
        for i in range(per_block):
            wk = next(it)
            out[f'conv{block}_{i}/kernel'] = _np(state_dict[wk]).transpose(2, 3, 1, 0)
            out[f'conv{block}_{i}/bias'] = _np(state_dict[wk.replace('.weight', '.bias')])
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 3 or argv[0] not in ('inception', 'vgg'):
        print(__doc__)
        sys.exit(1)
    kind, src, dst = argv
    import torch
    # the pytorch-fid checkpoint is a pickled module, so it needs the full unpickler
    sd = torch.load(src, map_location='cpu', weights_only=kind == 'vgg')
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    if 'state_dict' in sd:
        sd = sd['state_dict']
    flat = (inception_npz if kind == 'inception' else vgg_npz)(sd)
    np.savez(dst, **flat)
    print(f'wrote {len(flat)} arrays -> {dst}')


if __name__ == '__main__':
    main()
