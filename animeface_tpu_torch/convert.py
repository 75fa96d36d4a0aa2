'''JAX package parameters -> the port's `state_dict`, for StyleGAN2 and
StyleGAN3 G and D, the CIPS G, and FastGAN's G and D.

Input: a flax params tree (nested dicts of numpy arrays, as
`jax.device_get(variables['params'])` gives). Output: a dict of float32
torch tensors for `Generator.load_state_dict` / `Discriminator.load_state_dict`.

Mapping (flax NHWC/HWIO -> torch NCHW/OIHW):
  dense kernel [in, out]       -> weight [out, in]
  conv kernel HWIO             -> weight OIHW
  const [1, 4, 4, S]           -> const [1, S, 4, 4]
  D's last-but-one dense kernel reads a flattened NHWC [4, 4, C] map; its
  rows are permuted to the NCHW flatten order [C, 4, 4].
The equalized-lr factor gain/sqrt(fan) is applied at run time on both sides,
so raw values carry over unchanged.

StyleGAN2 below; StyleGAN3 (`convert_stylegan3_generator`,
`convert_stylegan3_discriminator`), CIPS (`convert_cips_generator`; its D
is StyleGAN3's) and FastGAN (`convert_fastgan_generator`,
`convert_fastgan_discriminator`) after it.

Generator:                                 port
  map/ELRDense_i                           map.layers.i
  const                                    const
  synthesis/input                          synthesis.input
  synthesis/input_to_image/ModulatedConv_0 synthesis.input_to_image.conv
  synthesis/StyleBlock_i/ModulatedConv_j   synthesis.blocks.i.convs.j
  synthesis/ToImage_i/ModulatedConv_0      synthesis.to_images.i.conv
Discriminator:
  ELRConv_0                                from_rgb
  DBlock_i/ELRConv_j (j < last)            blocks.i.convs.j
  DBlock_i/ELRConv_<last> (the 1x1 skip)   blocks.i.skip
  ELRConv_1                                conv
  ELRDense_0 / ELRDense_1                  fc / out
'''

from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _dense(p, prefix, out):
    out[f'{prefix}.weight'] = _t(np.asarray(p['kernel']).T)
    if 'bias' in p:
        out[f'{prefix}.bias'] = _t(p['bias'])


def _conv(p, prefix, out):
    out[f'{prefix}.weight'] = _t(np.asarray(p['kernel']).transpose(3, 2, 0, 1))
    if 'bias' in p:
        out[f'{prefix}.bias'] = _t(p['bias'])


def _modconv(p, prefix, out):
    _conv(p, prefix, out)
    _dense(p['affine'], f'{prefix}.affine', out)


def _indexed(tree, name):
    '''Children `name_0, name_1, ...` in index order.'''
    keys = sorted((k for k in tree if k.startswith(name + '_')),
                  key=lambda k: int(k.rsplit('_', 1)[1]))
    return [tree[k] for k in keys]


def convert_generator(params) -> dict:
    out = {}
    for i, p in enumerate(_indexed(params['map'], 'ELRDense')):
        _dense(p, f'map.layers.{i}', out)
    out['const'] = _t(np.asarray(params['const']).transpose(0, 3, 1, 2))
    syn = params['synthesis']
    _modconv(syn['input'], 'synthesis.input', out)
    _modconv(syn['input_to_image']['ModulatedConv_0'],
             'synthesis.input_to_image.conv', out)
    for i, block in enumerate(_indexed(syn, 'StyleBlock')):
        for j, p in enumerate(_indexed(block, 'ModulatedConv')):
            _modconv(p, f'synthesis.blocks.{i}.convs.{j}', out)
    for i, to_image in enumerate(_indexed(syn, 'ToImage')):
        _modconv(to_image['ModulatedConv_0'], f'synthesis.to_images.{i}.conv', out)
    return out


def convert_discriminator(params) -> dict:
    out = {}
    convs = _indexed(params, 'ELRConv')
    _conv(convs[0], 'from_rgb', out)
    _conv(convs[1], 'conv', out)
    for i, block in enumerate(_indexed(params, 'DBlock')):
        bconvs = _indexed(block, 'ELRConv')
        for j, p in enumerate(bconvs[:-1]):
            _conv(p, f'blocks.{i}.convs.{j}', out)
        _conv(bconvs[-1], f'blocks.{i}.skip', out)
    fc, last = _indexed(params, 'ELRDense')
    k = np.asarray(fc['kernel'])                               # [4*4*C, out]
    C = k.shape[0] // 16
    k = k.reshape(4, 4, C, -1).transpose(2, 0, 1, 3).reshape(16 * C, -1)
    _dense(dict(fc, kernel=k), 'fc', out)
    _dense(last, 'out', out)
    return out


# ---------------------------------------------------------------- StyleGAN3
#
# Generator (`params` and `moments` collections):     port
#   map/Linear_i                                      map.layers.i
#   moments map/w_avg                                 map.w_avg
#   synthesis/input/{affine, weight}                  synthesis.input.{affine, weight}
#   moments synthesis/input/{freqs, phases}           synthesis.input.{freqs, phases}
#   synthesis/net_i/{affine, bias, conv}              synthesis.net.i.{affine, bias, conv}
#   moments synthesis/net_i/magnitude_ema             synthesis.net.i.magnitude_ema
# Discriminator:
#   ConvAct_0 / ConvAct_1                             from_rgb / conv
#   ResBlock_i/ConvAct_{0, 1, 2}                      blocks.i.{conv1, conv2, skip}
#   Linear_0 / Linear_1                               fc / out
# The port's D flattens its last map in the JAX (H, W, C) order, so the
# dense kernels carry over as they are.

def convert_stylegan3_generator(params, moments) -> dict:
    out = {}
    for i, p in enumerate(_indexed(params['map'], 'Linear')):
        _dense(p, f'map.layers.{i}', out)
    out['map.w_avg'] = _t(moments['map']['w_avg'])
    syn, syn_m = params['synthesis'], moments['synthesis']
    _dense(syn['input']['affine'], 'synthesis.input.affine', out)
    out['synthesis.input.weight'] = _t(syn['input']['weight'])
    out['synthesis.input.freqs'] = _t(syn_m['input']['freqs'])
    out['synthesis.input.phases'] = _t(syn_m['input']['phases'])
    for i, layer in enumerate(_indexed(syn, 'net')):
        prefix = f'synthesis.net.{i}'
        _dense(layer['affine'], f'{prefix}.affine', out)
        out[f'{prefix}.bias'] = _t(layer['bias'])
        _conv(layer['conv'], f'{prefix}.conv', out)
        out[f'{prefix}.magnitude_ema'] = _t(syn_m[f'net_{i}']['magnitude_ema'])
    return out


def convert_stylegan3_discriminator(params) -> dict:
    out = {}
    convs = _indexed(params, 'ConvAct')
    _conv(convs[0], 'from_rgb', out)
    _conv(convs[1], 'conv', out)
    for i, block in enumerate(_indexed(params, 'ResBlock')):
        for name, p in zip(('conv1', 'conv2', 'skip'), _indexed(block, 'ConvAct')):
            _conv(p, f'blocks.{i}.{name}', out)
    fc, last = _indexed(params, 'Linear')
    _dense(fc, 'fc', out)
    _dense(last, 'out', out)
    return out


# ---------------------------------------------------------------- CIPS
#
# Generator (`params` and `moments` collections):     port
#   Linear_i                                          map.layers.i
#   moments w_avg                                     map.w_avg
#   SynthesisInput_0/{b, constant}                    input.{b, constant}
#   StyleLayer_i/{ModulatedFC_0, bias}                layers.i.{fc, bias}
#   ModulatedFC_i                                     to_rgbs.i
# A ModulatedFC's weight keeps the JAX layout [in, out]; its affine is a
# dense layer.

def _modulated_fc(p, prefix, out):
    out[f'{prefix}.weight'] = _t(p['weight'])
    _dense(p['affine'], f'{prefix}.affine', out)


def convert_cips_generator(params, moments) -> dict:
    out = {}
    for i, p in enumerate(_indexed(params, 'Linear')):
        _dense(p, f'map.layers.{i}', out)
    out['map.w_avg'] = _t(moments['w_avg'])
    inp = params['SynthesisInput_0']
    _dense(inp['b'], 'input.b', out)
    out['input.constant'] = _t(inp['constant'])
    for i, layer in enumerate(_indexed(params, 'StyleLayer')):
        _modulated_fc(layer['ModulatedFC_0'], f'layers.{i}.fc', out)
        out[f'layers.{i}.bias'] = _t(layer['bias'])
    for i, p in enumerate(_indexed(params, 'ModulatedFC')):
        _modulated_fc(p, f'to_rgbs.{i}', out)
    return out


# ---------------------------------------------------------------- FastGAN
#
# Input: the flax variables {'params', 'batch_stats'}. A spectral-normalized
# layer (SNConv_i / SNDense_0) holds its Conv_0 or Dense_0 params, and in
# batch_stats SpectralNorm_0/{Conv_0,Dense_0}/kernel/u [1, out] (-> `u`
# [out]; sigma is recomputed every call and not kept). A BatchNorm Norm_i
# holds BatchNorm_0/{scale, bias} and the stats {mean, var}; an 'in' Norm
# holds nothing.
# Generator:                                          port
#   SNDense_0 / Norm_0                                input / input_norm
#   UpBlock_i/{SNConv_0, Norm_0}                      ups.i.{conv, norm}
#   SkipLayerExcitation_j/SNConv_{0, 1}               sles.j.{squeeze, excite}
#   SNConv_0                                          out
# Discriminator (k = max(init_downs, 1) stem convs):
#   SNConv_0..k-1 / Norm_0..k-2                       stem.i / stem_norms.i
#   ResBlock_i/{SNConv_0, Norm_0, SNConv_1, Norm_1, SNConv_2}
#                                                     blocks.i.{conv1, norm1, conv2, norm2, skip}
#   SNConv_k / Norm_{k-1} / SNConv_{k+1}              logits_conv / logits_norm / logits_out
#   decoder_{8,16}/{UpBlock_i, SNConv_0}              decoder_{8,16}.{ups.i, out}

def _sn_layer(p, s, prefix, out):
    name = 'Conv_0' if 'Conv_0' in p else 'Dense_0'
    k = np.asarray(p[name]['kernel'])
    out[f'{prefix}.weight'] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
    if 'bias' in p[name]:
        out[f'{prefix}.bias'] = _t(p[name]['bias'])
    out[f'{prefix}.u'] = _t(np.asarray(s['SpectralNorm_0'][f'{name}/kernel/u']).reshape(-1))


def _fastgan_norm(p, s, prefix, out):
    if p is None:                                   # 'in': no parameters
        return
    out[f'{prefix}.weight'] = _t(p['BatchNorm_0']['scale'])
    out[f'{prefix}.bias'] = _t(p['BatchNorm_0']['bias'])
    out[f'{prefix}.running_mean'] = _t(s['BatchNorm_0']['mean'])
    out[f'{prefix}.running_var'] = _t(s['BatchNorm_0']['var'])


def _fastgan_up(p, s, prefix, out):
    _sn_layer(p['SNConv_0'], s['SNConv_0'], f'{prefix}.conv', out)
    _fastgan_norm(p.get('Norm_0'), s.get('Norm_0'), f'{prefix}.norm', out)


def convert_fastgan_generator(variables) -> dict:
    p, s = variables['params'], variables['batch_stats']
    out = {}
    _sn_layer(p['SNDense_0'], s['SNDense_0'], 'input', out)
    _fastgan_norm(p.get('Norm_0'), s.get('Norm_0'), 'input_norm', out)
    for i, (pi, si) in enumerate(zip(_indexed(p, 'UpBlock'), _indexed(s, 'UpBlock'))):
        _fastgan_up(pi, si, f'ups.{i}', out)
    for j, (pj, sj) in enumerate(zip(_indexed(p, 'SkipLayerExcitation'),
                                     _indexed(s, 'SkipLayerExcitation'))):
        _sn_layer(pj['SNConv_0'], sj['SNConv_0'], f'sles.{j}.squeeze', out)
        _sn_layer(pj['SNConv_1'], sj['SNConv_1'], f'sles.{j}.excite', out)
    _sn_layer(p['SNConv_0'], s['SNConv_0'], 'out', out)
    return out


def convert_fastgan_discriminator(variables) -> dict:
    p, s = variables['params'], variables['batch_stats']
    out = {}
    convs, conv_stats = _indexed(p, 'SNConv'), _indexed(s, 'SNConv')
    norms, norm_stats = _indexed(p, 'Norm'), _indexed(s, 'Norm')
    k = len(convs) - 2
    for i in range(k):
        _sn_layer(convs[i], conv_stats[i], f'stem.{i}', out)
    for i in range(k - 1):
        _fastgan_norm(norms[i] if norms else None, norm_stats[i] if norms else None,
                      f'stem_norms.{i}', out)
    for i, (pb, sb) in enumerate(zip(_indexed(p, 'ResBlock'), _indexed(s, 'ResBlock'))):
        for name, j in (('conv1', 0), ('conv2', 1), ('skip', 2)):
            _sn_layer(pb[f'SNConv_{j}'], sb[f'SNConv_{j}'], f'blocks.{i}.{name}', out)
        for name, j in (('norm1', 0), ('norm2', 1)):
            _fastgan_norm(pb.get(f'Norm_{j}'), sb.get(f'Norm_{j}'), f'blocks.{i}.{name}', out)
    _sn_layer(convs[k], conv_stats[k], 'logits_conv', out)
    _fastgan_norm(norms[k - 1] if norms else None, norm_stats[k - 1] if norms else None,
                  'logits_norm', out)
    _sn_layer(convs[k + 1], conv_stats[k + 1], 'logits_out', out)
    for dec in ('decoder_8', 'decoder_16'):
        for i, (pu, su) in enumerate(zip(_indexed(p[dec], 'UpBlock'),
                                         _indexed(s[dec], 'UpBlock'))):
            _fastgan_up(pu, su, f'{dec}.ups.{i}', out)
        _sn_layer(p[dec]['SNConv_0'], s[dec]['SNConv_0'], f'{dec}.out', out)
    return out
