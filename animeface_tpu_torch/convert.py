'''JAX package parameters -> the port's `state_dict`, for StyleGAN2 and
StyleGAN3 G and D, the CIPS G, FastGAN's G and D, the G and D of DCGAN
(also WGAN's and WGAN-gp's) and GAN, PGGAN's and StyleGAN (v1)'s G and D,
the metrics' InceptionV3 and VGG trunks, BigGAN's (and SEBigGAN's) G and
D, the G and D of TransGAN, HiT, ConvNeXt and VAN, those of pix2pix,
SRGAN and ESRGAN (whose D is SRGAN's), those of NAFNet, Restormer
(whose D is NAFNet's), pix2pixHD and CycleGAN, and normalizations' G,
SPADE's G and E and SCFT's G and D (the Ds of the first two are SRGAN's).

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
`convert_fastgan_discriminator`), DCGAN (`convert_dcgan_generator`,
`convert_dcgan_discriminator`) and GAN (`convert_gan_generator`,
`convert_gan_discriminator`), PGGAN (`convert_pggan_generator`,
`convert_pggan_discriminator`), StyleGAN v1 (`convert_stylegan1_generator`,
`convert_stylegan1_discriminator`), InceptionV3 (`convert_inception`),
VGG (`convert_vgg`) and BigGAN (`convert_biggan_generator`,
`convert_biggan_discriminator`; SEBigGAN's too), the simple-GAN models
(`convert_{transgan,hit,convnext,van}_{generator,discriminator}`) and the
paired recipes (`convert_pix2pix_{generator,discriminator}`,
`convert_srgan_{generator,discriminator}`, `convert_esrgan_generator`)
and the line-art recipes (`convert_nafnet_{generator,discriminator}`,
`convert_restormer_generator`, `convert_pix2pixhd_{generator,
discriminator}`, `convert_cyclegan_{generator,discriminator}`), and
`convert_normalizations_generator`, `convert_spade_{generator,encoder}`
and `convert_scft_{generator,discriminator}` after it.

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
    _sn_named(p, s, 'Conv_0' if 'Conv_0' in p else 'Dense_0', 'SpectralNorm_0', prefix, out)


def _sn_named(p, s, name, sn, prefix, out):
    '''The conv or dense layer `name` of `p`, with the u of its spectral
    norm `sn` in `s` where there is one (none with use_sn=False).'''
    k = np.asarray(p[name]['kernel'])
    out[f'{prefix}.weight'] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
    if 'bias' in p[name]:
        out[f'{prefix}.bias'] = _t(p[name]['bias'])
    if s and sn in s:
        out[f'{prefix}.u'] = _t(np.asarray(s[sn][f'{name}/kernel/u']).reshape(-1))


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


# ---------------------------------------------------------------- DCGAN and GAN

def _batch_norm(p, s, prefix, out):
    out[f'{prefix}.weight'] = _t(p['scale'])
    out[f'{prefix}.bias'] = _t(p['bias'])
    out[f'{prefix}.running_mean'] = _t(s['mean'])
    out[f'{prefix}.running_var'] = _t(s['var'])


def convert_dcgan_generator(variables) -> dict:
    '''ConvTranspose_i -> convs.i, BatchNorm_i -> norms.i. flax's
    ConvTranspose does not flip its kernel: the HWIO kernel is flipped in
    H and W and laid out [in, out, kh, kw] for `F.conv_transpose2d`.'''
    p, s = variables['params'], variables['batch_stats']
    out = {}
    for i, pc in enumerate(_indexed(p, 'ConvTranspose')):
        out[f'convs.{i}.weight'] = _t(np.asarray(pc['kernel'])[::-1, ::-1].transpose(2, 3, 0, 1))
    for i, (pn, sn) in enumerate(zip(_indexed(p, 'BatchNorm'), _indexed(s, 'BatchNorm'))):
        _batch_norm(pn, sn, f'norms.{i}', out)
    return out


def convert_dcgan_discriminator(variables) -> dict:
    '''Conv_i -> convs.i, BatchNorm_i -> norms.i (the first conv has none).'''
    p, s = variables['params'], variables['batch_stats']
    out = {}
    for i, pc in enumerate(_indexed(p, 'Conv')):
        _conv(pc, f'convs.{i}', out)
    for i, (pn, sn) in enumerate(zip(_indexed(p, 'BatchNorm'), _indexed(s, 'BatchNorm'))):
        _batch_norm(pn, sn, f'norms.{i}', out)
    return out


def convert_gan_generator(variables, image_shape) -> dict:
    '''Dense_i -> layers.i, BatchNorm_i -> norms.i; the last Dense writes
    an NHWC image of `image_shape` (H, W, C), so its output features are
    permuted to the port's NCHW order.'''
    p, s = variables['params'], variables['batch_stats']
    H, W, C = image_shape
    out = {}
    dense = _indexed(p, 'Dense')
    for i, pd in enumerate(dense[:-1]):
        _dense(pd, f'layers.{i}', out)
    kernel = np.asarray(dense[-1]['kernel'])
    last = len(dense) - 1
    out[f'layers.{last}.weight'] = _t(
        kernel.reshape(-1, H, W, C).transpose(0, 3, 1, 2).reshape(kernel.shape[0], -1).T)
    out[f'layers.{last}.bias'] = _t(
        np.asarray(dense[-1]['bias']).reshape(H, W, C).transpose(2, 0, 1).reshape(-1))
    for i, (pn, sn) in enumerate(zip(_indexed(p, 'BatchNorm'), _indexed(s, 'BatchNorm'))):
        _batch_norm(pn, sn, f'norms.{i}', out)
    return out


def convert_gan_discriminator(params, image_shape) -> dict:
    '''Dense_i -> layers.i; the first Dense reads a flattened NHWC image of
    `image_shape` (H, W, C), so its input features are permuted to the
    port's NCHW flatten order.'''
    H, W, C = image_shape
    out = {}
    dense = _indexed(params, 'Dense')
    kernel = np.asarray(dense[0]['kernel'])
    out['layers.0.weight'] = _t(
        kernel.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(H * W * C, -1).T)
    out['layers.0.bias'] = _t(dense[0]['bias'])
    for i, pd in enumerate(dense[1:], start=1):
        _dense(pd, f'layers.{i}', out)
    return out


# ---------------------------------------------------------------- the metrics' trunks

def convert_inception(variables) -> dict:
    '''InceptionV3 variables ({'params', 'batch_stats'}, the layout of
    `tools/convert_inception_weights.py`'s .npz) -> `InceptionV3Features`'s
    state dict: every `<path>/conv` kernel HWIO -> `<path>.conv.weight`
    OIHW, every `<path>/bn` scale, bias, mean, var -> `<path>.bn.weight`,
    `.bias`, `.running_mean`, `.running_var`.'''
    out = {}

    def walk(p, s, prefix):
        for name, sub in p.items():
            path = f'{prefix}{name}'
            if name == 'conv':
                _conv(sub, path, out)
            elif name == 'bn':
                _batch_norm(sub, s[name], path, out)
            else:
                walk(sub, s[name], f'{path}.')

    walk(variables['params'], variables['batch_stats'], '')
    return out


def convert_vgg(params) -> dict:
    '''`VGGFeatures` params (conv{block}_{i}/{kernel HWIO, bias}) -> the
    port's `VGGFeatures` state dict (conv{block}_{i}.{weight OIHW, bias}).'''
    out = {}
    for name, p in params.items():
        _conv(p, name, out)
    return out


# -------------------------------------------------------- PGGAN and StyleGAN v1
#
# The runtime coefficients stay in the modules, so the port trains the raw
# parameters JAX trains. PGGAN generator:            port
#   block_d/ELRConv_i                                blocks.d.convs.i
#   block_0/kernel_t [4, 4, in, out], flipped in H   blocks.0.kernel_t [in, out, 4, 4]
#     and W (JAX's conv_transpose does not flip it,
#     F.conv_transpose2d does)
#   to_rgb_d                                         to_rgb.d
# StyleGAN v1 generator adds:
#   mapping/ELRDense_i                               mapping.layers.i
#   const [1, 4, 4, S]                               const [1, S, 4, 4]
#   block_d/LayerEpilogue_i/noise_scale              blocks.d.epilogues.i.noise_scale
#   block_d/LayerEpilogue_i/AdaIN_0/ELRDense_0       blocks.d.epilogues.i.adain.style
# Discriminator (both):
#   from_rgb_d                                       from_rgb.d
#   block_d/ELRConv_i                                blocks.d.convs.i

def _blocks(params):
    '''(d, params of block_<d>) for each block.'''
    for key, block in params.items():
        if key.startswith('block_'):
            yield int(key.rsplit('_', 1)[1]), block


def _progressive_heads(params, prefix, out):
    for key in params:
        if key.startswith(prefix + '_'):
            _conv(params[key], f'{prefix}.{int(key.rsplit("_", 1)[1])}', out)


def _progressive_convs(block, prefix, out):
    for i, p in enumerate(_indexed(block, 'ELRConv')):
        _conv(p, f'{prefix}.convs.{i}', out)


def convert_pggan_generator(params) -> dict:
    out = {}
    for d, block in _blocks(params):
        if 'kernel_t' in block:
            k = np.asarray(block['kernel_t'])[::-1, ::-1]             # [4, 4, in, out]
            out[f'blocks.{d}.kernel_t'] = _t(k.transpose(2, 3, 0, 1))
        _progressive_convs(block, f'blocks.{d}', out)
    _progressive_heads(params, 'to_rgb', out)
    return out


def convert_pggan_discriminator(params) -> dict:
    out = {}
    for d, block in _blocks(params):
        _progressive_convs(block, f'blocks.{d}', out)
    _progressive_heads(params, 'from_rgb', out)
    return out


def convert_stylegan1_generator(params) -> dict:
    out = {}
    for i, p in enumerate(_indexed(params['mapping'], 'ELRDense')):
        _dense(p, f'mapping.layers.{i}', out)
    out['const'] = _t(np.asarray(params['const']).transpose(0, 3, 1, 2))
    for d, block in _blocks(params):
        _progressive_convs(block, f'blocks.{d}', out)
        for i, epi in enumerate(_indexed(block, 'LayerEpilogue')):
            out[f'blocks.{d}.epilogues.{i}.noise_scale'] = _t(epi['noise_scale'])
            _dense(epi['AdaIN_0']['ELRDense_0'], f'blocks.{d}.epilogues.{i}.adain.style', out)
    _progressive_heads(params, 'to_rgb', out)
    return out


convert_stylegan1_discriminator = convert_pggan_discriminator


# ---------------------------------------------------------------- BigGAN and SEBigGAN
#
# Input: the flax variables {'params', 'batch_stats'}; a spectral norm's u as
# for FastGAN (absent with use_sn=False). flax names the submodules by
# creation order:
# Generator:                                           port
#   SNDense_0 / BatchNorm_0 / SNConv_0 / PReLU_0        fc / bn / out / act_fn
#   GBlock_i or GBlockDeep_i                            blocks.i
#   SelfAttention_0 | SqueezeExcitation_0 | LambdaLayer_0
#                                                       attention
# GBlock: ConditionalNorm_{0,1} -> cn1, cn2; SNConv_{0,1,2} -> skip, conv1,
#   conv2 (conv1, conv2 when there is no skip conv)
# GBlockDeep: ConditionalNorm_{0..3} -> cn1..cn4; SNConv_{0..3} -> conv1..conv4
# ConditionalNorm: SNDense_{0,1} -> gain, bias; BatchNorm_0 stats (mean, var)
#   -> running_mean, running_var ('in' holds none)
# Discriminator: SNConv_0 (deep only) -> blocks.0; DBlock_i or DBlockDeep_i
#   -> the blocks after it; SNDense_0 / PReLU_0 -> fc / act_fn
# DBlock: SNConv_{0,1,2} -> conv1, conv2, skip; DBlockDeep: SNConv_{0..4}
#   -> conv1..conv4, widen
# SelfAttention: SNConv_{0..3} -> theta, phi, g, out; gamma
# SqueezeExcitation: SNDense_{0,1} -> fc1, fc2
# LambdaLayer: SNConv_{0,1,2} -> q, k, v; BatchNorm_{0,1} -> q_bn, v_bn; pos_emb

_BIGGAN_LAYERS = {
    'GBlock': (('cn1', 'cn2'), ('conv1', 'conv2')),
    'GBlockDeep': (('cn1', 'cn2', 'cn3', 'cn4'), ('conv1', 'conv2', 'conv3', 'conv4')),
    'DBlock': ((), ('conv1', 'conv2', 'skip')),
    'DBlockDeep': ((), ('conv1', 'conv2', 'conv3', 'conv4', 'widen')),
}


def _biggan_act(p, prefix, out):
    if 'PReLU_0' in p:
        out[f'{prefix}act_fn.negative_slope'] = _t(p['PReLU_0']['negative_slope'])


def _biggan_cn(p, s, prefix, out):
    for k, dense in enumerate(('gain', 'bias')):
        _sn_layer(p[f'SNDense_{k}'], s.get(f'SNDense_{k}'), f'{prefix}.{dense}', out)
    if 'BatchNorm_0' in s:
        out[f'{prefix}.running_mean'] = _t(s['BatchNorm_0']['mean'])
        out[f'{prefix}.running_var'] = _t(s['BatchNorm_0']['var'])


def _biggan_block(kind, p, s, prefix, out):
    norms, convs = _BIGGAN_LAYERS[kind]
    names = sorted((k for k in p if k.startswith('SNConv_')), key=lambda k: int(k[7:]))
    if kind == 'GBlock' and len(names) == 3:
        convs = ('skip',) + convs
    for name, port in zip(names, convs):
        _sn_layer(p[name], s.get(name), f'{prefix}.{port}', out)
    for j, port in enumerate(norms):
        _biggan_cn(p[f'ConditionalNorm_{j}'], s.get(f'ConditionalNorm_{j}', {}),
                   f'{prefix}.{port}', out)
    _biggan_act(p, f'{prefix}.', out)


#: each attention module's spectral-normalized layers, in flax's order
_BIGGAN_ATTENTION = {'SelfAttention': ('SNConv', ('theta', 'phi', 'g', 'out')),
                     'SqueezeExcitation': ('SNDense', ('fc1', 'fc2')),
                     'LambdaLayer': ('SNConv', ('q', 'k', 'v'))}


def _biggan_attention(kind, p, s, prefix, out):
    layer, ports = _BIGGAN_ATTENTION[kind]
    for j, port in enumerate(ports):
        _sn_layer(p[f'{layer}_{j}'], s.get(f'{layer}_{j}'), f'{prefix}.{port}', out)
    if kind == 'SelfAttention':
        out[f'{prefix}.gamma'] = _t(p['gamma'])
    if kind == 'LambdaLayer':
        for j, port in enumerate(('q_bn', 'v_bn')):
            _batch_norm(p[f'BatchNorm_{j}'], s[f'BatchNorm_{j}'], f'{prefix}.{port}', out)
        out[f'{prefix}.pos_emb'] = _t(p['pos_emb'])


def _biggan_model_attention(p, s, out):
    for kind in _BIGGAN_ATTENTION:
        if f'{kind}_0' in p:
            _biggan_attention(kind, p[f'{kind}_0'], s.get(f'{kind}_0', {}), 'attention', out)


def _biggan_blocks(p, s, kinds, first, out):
    kind = next(k for k in kinds if f'{k}_0' in p)
    for i, pb in enumerate(_indexed(p, kind)):
        _biggan_block(kind, pb, s.get(f'{kind}_{i}', {}), f'blocks.{first + i}', out)


def convert_biggan_generator(variables) -> dict:
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    _sn_layer(p['SNDense_0'], s.get('SNDense_0'), 'fc', out)
    _biggan_blocks(p, s, ('GBlockDeep', 'GBlock'), 0, out)
    _biggan_model_attention(p, s, out)
    _batch_norm(p['BatchNorm_0'], s['BatchNorm_0'], 'bn', out)
    _sn_layer(p['SNConv_0'], s.get('SNConv_0'), 'out', out)
    _biggan_act(p, '', out)
    return out


def convert_biggan_discriminator(variables) -> dict:
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    deep = 'DBlockDeep_0' in p
    if deep:
        _sn_layer(p['SNConv_0'], s.get('SNConv_0'), 'blocks.0', out)
    _biggan_blocks(p, s, ('DBlockDeep', 'DBlock'), int(deep), out)
    _biggan_model_attention(p, s, out)
    _sn_layer(p['SNDense_0'], s.get('SNDense_0'), 'fc', out)
    _biggan_act(p, '', out)
    return out


# ---------------------------------------------------------------- the simple-GAN models
#
# TransGAN, HiT, ConvNeXt and VAN (`implementations/{TransGAN,HiT,ConvNeXt,
# VAN}/model.py`): flax names its children by type and creation order in
# each scope; LayerNorm's and GroupNorm's `scale` is the port's `weight`;
# raw parameters (position embeddings, the cls token, HiT's q/k/v/o,
# ConvNeXt's gamma, VAN's layer scales) carry over as they are.

def _norm(p, prefix, out):
    if p is None:                      # a norm without scale or bias ('in', 'bn')
        return
    out[f'{prefix}.weight'] = _t(p['scale'])
    out[f'{prefix}.bias'] = _t(p['bias'])


def _raw(p, name, key, out):
    out[key] = _t(p[name])


def _transgan_block(p, prefix, out):
    _norm(p['LayerNorm_0'], f'{prefix}.norm1', out)
    _dense(p['Attention_0']['Dense_0'], f'{prefix}.attn.qkv', out)
    _dense(p['Attention_0']['Dense_1'], f'{prefix}.attn.proj', out)
    _norm(p['LayerNorm_1'], f'{prefix}.norm2', out)
    _dense(p['Dense_0'], f'{prefix}.fc1', out)
    _dense(p['Dense_1'], f'{prefix}.fc2', out)


def convert_transgan_generator(params, depths) -> dict:
    '''EncoderBlock_k (numbered across stages) -> stages.i.j for `depths`
    blocks a stage; pos_embed_i -> pos_embeds.i; Dense_0 -> input; Conv_0
    -> to_image.'''
    out = {}
    _dense(params['Dense_0'], 'input', out)
    blocks = iter(_indexed(params, 'EncoderBlock'))
    for i, depth in enumerate(depths):
        _raw(params, f'pos_embed_{i}', f'pos_embeds.{i}', out)
        for j in range(depth):
            _transgan_block(next(blocks), f'stages.{i}.{j}', out)
    _conv(params['Conv_0'], 'to_image', out)
    return out


def convert_transgan_discriminator(params) -> dict:
    out = {}
    _conv(params['Conv_0'], 'patch', out)
    _raw(params, 'cls_token', 'cls_token', out)
    _raw(params, 'pos_embed', 'pos_embed', out)
    for k, pb in enumerate(_indexed(params, 'EncoderBlock')):
        _transgan_block(pb, f'blocks.{k}', out)
    _norm(params['LayerNorm_0'], 'norm', out)
    _dense(params['Dense_0'], 'head', out)
    return out


def _hit_stage(p, prefix, out):
    _raw(p, 'pos_embed', f'{prefix}.pos_embed', out)
    norms, mlps = _indexed(p, 'LayerNorm'), _indexed(p, 'MLP')
    attns = _indexed(p, 'MultiAxisAttention')
    _norm(norms[0], f'{prefix}.norm_q', out)
    for name, key in (('Dense_0', 'q'), ('Dense_1', 'kv'), ('Dense_2', 'out')):
        _dense(p['MultiQueryAttention_0'][name], f'{prefix}.cross.{key}', out)
    _norm(norms[1], f'{prefix}.norm_mlp', out)
    bases = [prefix] + [f'{prefix}.blocks.{k}' for k in range(len(mlps) - 1)]
    for base, mlp in zip(bases, mlps):
        for i, pd in enumerate(_indexed(mlp, 'Dense')):
            _dense(pd, f'{base}.mlp.fc{i + 1}', out)
    block_norms = iter(norms[2:])
    for k, base in enumerate(bases[1:]):
        if attns:
            _norm(next(block_norms), f'{base}.norm_attn', out)
            for key in ('q', 'k', 'v', 'o'):
                _raw(attns[k], key, f'{base}.attn.{key}', out)
        _norm(next(block_norms), f'{base}.norm_mlp', out)
    dense = _indexed(p, 'Dense')
    dim = np.shape(p['pos_embed'])[-1]
    if dense and np.shape(dense[0]['kernel'])[0] == dim:    # a high-res stage's RGB
        _dense(dense.pop(0), f'{prefix}.to_rgb', out)
    if dense:
        _dense(dense[0], f'{prefix}.proj', out)


def convert_hit_generator(params) -> dict:
    '''Dense_0 -> input, Dense_1 -> latent, z_pos_embed, Stage_i ->
    stages.i: LayerNorm_0 norm_q, MultiQueryAttention_0 cross (q, kv, out),
    LayerNorm_1 and MLP_0 the stage's MLP, then per block (multi-axis
    attention's LayerNorm and q/k/v/o,) LayerNorm and MLP_k; a high-res
    stage's Dense_0 to_rgb, the next Dense proj.'''
    out = {}
    _dense(params['Dense_0'], 'input', out)
    _dense(params['Dense_1'], 'latent', out)
    _raw(params, 'z_pos_embed', 'z_pos_embed', out)
    for i, ps in enumerate(_indexed(params, 'Stage')):
        _hit_stage(ps, f'stages.{i}', out)
    return out


def convert_hit_discriminator(params, bottom) -> dict:
    '''Conv_0 -> input; Conv_{1+3i}, Conv_{2+3i}, Conv_{3+3i} -> blocks.i.0-2;
    the last Conv -> conv; Dense_0 -> fc, its input rows permuted from the
    flattened NHWC [bottom, bottom, C] map to NCHW; Dense_1 -> head.'''
    out = {}
    convs = _indexed(params, 'Conv')
    _conv(convs[0], 'input', out)
    for i in range((len(convs) - 2) // 3):
        for j in range(3):
            _conv(convs[1 + 3 * i + j], f'blocks.{i}.{j}', out)
    _conv(convs[-1], 'conv', out)
    kernel = np.asarray(params['Dense_0']['kernel'])
    C = kernel.shape[0] // bottom ** 2
    out['fc.weight'] = _t(kernel.reshape(bottom, bottom, C, -1).transpose(2, 0, 1, 3)
                          .reshape(kernel.shape[0], -1).T)
    out['fc.bias'] = _t(params['Dense_0']['bias'])
    _dense(params['Dense_1'], 'head', out)
    return out


def _convnext_block(p, prefix, out, names):
    '''Conv_k -> `names[k]`; GroupNorm_k in creation order -> the norms the
    block has (`norm1`, `norm2`, `norm3`, or `norm` alone); gamma.'''
    for pc, name in zip(_indexed(p, 'Conv'), names):
        _conv(pc, f'{prefix}.{name}', out)
    norms = _indexed(p, 'GroupNorm')
    keys = ['norm'] if names[0] == 'dwconv' else ['norm1', 'norm2', 'norm3'][:len(norms)]
    for pn, key in zip(norms, keys):
        _norm(pn, f'{prefix}.{key}', out)
    _raw(p, 'gamma', f'{prefix}.gamma', out)


def convert_convnext_generator(params, blocks_per_scale) -> dict:
    '''Dense_0 -> input; per scale i GroupNorm_i -> stages.i.0 ('bn' has no
    parameters), Conv_i -> stages.i.1, ConvNextBlockFlex_k -> stages.i.{2..};
    the last GroupNorm (with 'convnext'/'fewnorm') -> out_norm, the last
    Conv -> out.'''
    out = {}
    _dense(params['Dense_0'], 'input', out)
    convs, norms = _indexed(params, 'Conv'), _indexed(params, 'GroupNorm')
    blocks = _indexed(params, 'ConvNextBlockFlex')
    for i, pc in enumerate(convs[:-1]):
        if norms:
            _norm(norms[i], f'stages.{i}.0', out)
        _conv(pc, f'stages.{i}.1', out)
        for j in range(blocks_per_scale):
            _convnext_block(blocks[i * blocks_per_scale + j], f'stages.{i}.{2 + j}', out,
                            ('conv1', 'conv2', 'conv3'))
    if len(norms) == len(convs):
        _norm(norms[-1], 'out_norm', out)
    _conv(convs[-1], 'out', out)
    return out


def convert_convnext_discriminator(params, depths) -> dict:
    '''Stage i (`depths[i]` blocks): stem Conv_0 then GroupNorm_0, or
    GroupNorm_i then Conv_i; its ConvNeXtBlocks; LayerNorm_0 -> norm;
    Dense_0 -> head.'''
    out = {}
    convs, norms = _indexed(params, 'Conv'), _indexed(params, 'GroupNorm')
    blocks = iter(_indexed(params, 'ConvNeXtBlock'))
    for i, depth in enumerate(depths):
        first, second = (('0', '1') if i == 0 else ('1', '0'))
        _conv(convs[i], f'stages.{i}.{first}', out)
        _norm(norms[i], f'stages.{i}.{second}', out)
        for j in range(depth):
            _convnext_block(next(blocks), f'stages.{i}.{2 + j}', out, ('dwconv', 'pw1', 'pw2'))
    _norm(params['LayerNorm_0'], 'norm', out)
    _dense(params['Dense_0'], 'head', out)
    return out


def _van_block(p, prefix, out):
    _raw(p, 'layer_scale1', f'{prefix}.layer_scale1', out)
    _raw(p, 'layer_scale2', f'{prefix}.layer_scale2', out)
    norms = _indexed(p, 'GroupNorm')
    for pn, key in zip(norms, ('norm1', 'norm2')):
        _norm(pn, f'{prefix}.{key}', out)
    for pc, key in zip(_indexed(p['AttentionModule_0'], 'Conv'),
                       ('conv0', 'conv_spatial', 'conv1')):
        _conv(pc, f'{prefix}.attn.{key}', out)
    for pc, key in zip(_indexed(p, 'Conv'), ('fc1', 'fc2')):
        _conv(pc, f'{prefix}.{key}', out)


def convert_van_generator(params, blocks_per_scale) -> dict:
    '''Dense_0 -> input; scale i: GroupNorm_{i-1} -> stages.i.0 (i > 0),
    Conv_i -> stages.i.1, Block_k -> stages.i.{2..}; the last GroupNorm ->
    out_norm, the last Conv -> out ('in' norms have no parameters).'''
    out = {}
    _dense(params['Dense_0'], 'input', out)
    convs, norms = _indexed(params, 'Conv'), _indexed(params, 'GroupNorm')
    blocks = _indexed(params, 'Block')
    for i, pc in enumerate(convs[:-1]):
        if i > 0 and norms:
            _norm(norms[i - 1], f'stages.{i}.0', out)
        _conv(pc, f'stages.{i}.1', out)
        for j in range(blocks_per_scale):
            _van_block(blocks[i * blocks_per_scale + j], f'stages.{i}.{2 + j}', out)
    if norms:
        _norm(norms[-1], 'out_norm', out)
    _conv(convs[-1], 'out', out)
    return out


def convert_van_discriminator(params, layers) -> dict:
    '''Stage i: Conv_i -> stages.i.0, GroupNorm_i -> stages.i.1, its Blocks;
    the last GroupNorm -> norm; Dense_0 -> head.'''
    out = {}
    convs, norms = _indexed(params, 'Conv'), _indexed(params, 'GroupNorm')
    blocks = iter(_indexed(params, 'Block'))
    for i, depth in enumerate(layers):
        _conv(convs[i], f'stages.{i}.0', out)
        if norms:
            _norm(norms[i], f'stages.{i}.1', out)
        for j in range(depth):
            _van_block(next(blocks), f'stages.{i}.{2 + j}', out)
    if norms:
        _norm(norms[-1], 'norm', out)
    _dense(params['Dense_0'], 'head', out)
    return out


# ---------------------------------------------------------------- pix2pix, SRGAN, ESRGAN
#
# pix2pix (`implementations/pix2pix/model.py`): G Down_i/{Conv_0, GroupNorm_0}
# -> downs.i.{conv, norm}, Up_i/{ConvTranspose_0, GroupNorm_0} ->
# ups.i.{conv, norm}, ConvTranspose_0 -> out; D Conv_i -> convs.i,
# GroupNorm_i -> norms.i. A ConvTranspose kernel is flipped in H and W
# (flax does not flip, PyTorch does) and laid out [in, out, kh, kw].
# SRGAN and ESRGAN (`implementations/{SRGAN,ESRGAN}/model.py`): each module
# keeps its children in lists in flax's creation order, so a flax name
# `<type>_i` is the port's `<list>.i` (`_SR_LISTS`); a MaybeSNConv carries
# its spectral norm's u (batch_stats), a BatchNorm ('bn') its running
# statistics.

def _conv_transpose(p, prefix, out):
    out[f'{prefix}.weight'] = _t(np.asarray(p['kernel'])[::-1, ::-1].transpose(2, 3, 0, 1))
    if 'bias' in p:
        out[f'{prefix}.bias'] = _t(p['bias'])


def convert_pix2pix_generator(params) -> dict:
    out = {}
    for kind, port, layer, convert in (('Down', 'downs', 'Conv_0', _conv),
                                       ('Up', 'ups', 'ConvTranspose_0', _conv_transpose)):
        for i, pb in enumerate(_indexed(params, kind)):
            convert(pb[layer], f'{port}.{i}.conv', out)
            _norm(pb.get('GroupNorm_0'), f'{port}.{i}.norm', out)
    _conv_transpose(params['ConvTranspose_0'], 'out', out)
    return out


def convert_pix2pix_discriminator(params) -> dict:
    out = {}
    for i, pc in enumerate(_indexed(params, 'Conv')):
        _conv(pc, f'convs.{i}', out)
    for i, pn in enumerate(_indexed(params, 'GroupNorm')):
        _norm(pn, f'norms.{i}', out)
    return out


_SR_LISTS = {'MaybeSNConv': 'convs', 'GroupNorm': 'norms', 'BatchNorm': 'norms', 'PReLU': 'acts',
             'ResBlock': 'blocks', 'RRDB': 'blocks', 'DenseBlock': 'dense',
             'SingleScaleDiscriminator': 'scales'}


def _sr_walk(p, s, prefix, out):
    for key, sub in p.items():
        kind, i = key.rsplit('_', 1)
        port, stats = f'{prefix}{_SR_LISTS[kind]}.{i}', s.get(key, {})
        if kind == 'MaybeSNConv':
            _sn_layer(sub, stats, port, out)
        elif kind == 'BatchNorm' and stats:
            _batch_norm(sub, stats, f'{port}.norm', out)
        elif kind in ('GroupNorm', 'BatchNorm'):
            _norm(sub, f'{port}.norm', out)
        elif kind == 'PReLU':
            out[f'{port}.prelu.negative_slope'] = _t(sub['negative_slope'])
        else:
            _sr_walk(sub, stats, f'{port}.', out)


def convert_srgan_generator(variables) -> dict:
    '''SRGAN's G from flax variables ({'params', 'batch_stats'}).'''
    out = {}
    _sr_walk(variables['params'], variables.get('batch_stats', {}), '', out)
    return out


convert_srgan_discriminator = convert_srgan_generator
convert_esrgan_generator = convert_srgan_generator


# ---------------------------------------------------------------- the line-art recipes
# NAFNet, Restormer, pix2pixHD and CycleGAN (`implementations/<recipe>/model.py`)
# keep their layers in lists in flax's creation order, so `<type>_i` is the
# port's `<list>.i` (`_LINE_ART_LISTS`), with a suffix where the port's
# layer wraps the flax one (pix2pixHD's `ConvBlock.conv`, CycleGAN's
# `ReflectConv.conv` and `Norm.norm`). A norm without parameters ('in' in
# NAFNet and pix2pixHD) has no entry on either side; a BatchNorm carries its
# running statistics, a ReflectConv its spectral norm's u (batch_stats). The
# scalar parameters (NAFNet's and Restormer's layer scales, Restormer's
# temperature) carry over as they are.

_LINE_ART_LISTS = {
    'nafnet': {'Conv': ('convs', ''), 'NAFBlock': ('blocks', ''), 'ConvBlock': ('conv', None),
               'GroupNorm': ('norms', ''), 'BatchNorm': ('norms', '')},
    'restormer': {'Conv': ('convs', ''), 'Block': ('blocks', ''), 'LayerNorm': ('norms', ''),
                  'MDTA': ('attn', None), 'GDFN': ('ff', None)},
    'pix2pixhd': {'Conv': ('convs', '.conv'), 'ResBlock': ('blocks', ''),
                  'ConvTranspose': ('ups', '.conv')},
    'cyclegan': {'ReflectConv': ('convs', '.conv'), 'GroupNorm': ('norms', '.norm'),
                 'BatchNorm': ('norms', '.norm'), 'ResBlock': ('blocks', '')},
}


def _line_art_walk(kind, p, s, prefix, out):
    for key, sub in p.items():
        if not isinstance(sub, dict):                      # a scalar parameter
            _raw(p, key, f'{prefix}{key}', out)
            continue
        flax_type, i = key.rsplit('_', 1)
        port, suffix = _LINE_ART_LISTS[kind][flax_type]
        port = f'{prefix}{port}' if suffix is None else f'{prefix}{port}.{i}{suffix}'
        stats = s.get(key, {})
        if flax_type == 'ConvTranspose':
            _conv_transpose(sub, port, out)
        elif flax_type == 'ReflectConv':
            _sn_layer(sub, stats, port, out)
        elif flax_type == 'BatchNorm' and stats:
            _batch_norm(sub, stats, port, out)
        elif flax_type in ('GroupNorm', 'LayerNorm', 'BatchNorm'):
            _norm(sub, port, out)
        elif flax_type == 'Conv':
            _conv(sub, port, out)
        else:
            _line_art_walk(kind, sub, stats, f'{port}.', out)


def _line_art(kind, variables, prefix=''):
    '''The port's state dict from flax `variables` ({'params', 'batch_stats'}
    or a params tree alone).'''
    p, s = ((variables['params'], variables.get('batch_stats', {})) if 'params' in variables
            else (variables, {}))
    out = {}
    _line_art_walk(kind, p, s, prefix, out)
    return out


def convert_nafnet_generator(params) -> dict:
    return _line_art('nafnet', params)


def convert_nafnet_discriminator(variables) -> dict:
    '''NAFNet's (and Restormer's) D from flax variables ({'params',
    'batch_stats'}: BatchNorm's running statistics).'''
    return _line_art('nafnet', variables)


def convert_restormer_generator(params) -> dict:
    return _line_art('restormer', params)


def convert_pix2pixhd_generator(params) -> dict:
    '''`global_g` and `local_g` from flax's G params.'''
    return {k: v for name in ('global_g', 'local_g')
            for k, v in _line_art('pix2pixhd', params[name], f'{name}.').items()}


def convert_pix2pixhd_discriminator(params) -> dict:
    '''`scale_i` -> `scales.i`: Conv_0-3 -> convs.j.conv, Conv_4 -> out.'''
    out = {}
    for i, scale in enumerate(_indexed(params, 'scale')):
        convs = _indexed(scale, 'Conv')
        for j, pc in enumerate(convs[:-1]):
            _conv(pc, f'scales.{i}.convs.{j}.conv', out)
        _conv(convs[-1], f'scales.{i}.out', out)
    return out


def convert_cyclegan_generator(variables, prefix='') -> dict:
    '''One G from flax variables ({'params', 'batch_stats'}: u); `prefix`
    names it in the recipe's module dict ('G_ab.', 'G_ba.').'''
    return _line_art('cyclegan', variables, prefix)


convert_cyclegan_discriminator = convert_cyclegan_generator


# ------------------------------------------------- normalizations, SPADE and SCFT
# Their port modules keep flax's layers in lists in creation order too:
# normalizations' `convs`, `norms` (Normalization_i) and `adanorms`
# (AdaptiveNormalization_i); SPADE's `blocks` (SPADEResBlock_i, each with
# `spades` and `convs`), E's `convs` and `norms`; SCFT's `blocks`
# (ResBlock_i), `dec` (the Generator's ConvBlock_i), the encoders' `blocks`
# and D's `convs` and `norms`. A norm without parameters ('in', or any
# norm without its affine terms) has no entry but BatchNorm's statistics.

def _indexed_keys(tree, name):
    '''(index, key) of the children `name_i` of `tree`, in index order.'''
    keys = [k for k in tree if k.startswith(name + '_') and k.rsplit('_', 1)[1].isdigit()]
    return sorted((int(k.rsplit('_', 1)[1]), k) for k in keys)


def _running(s, prefix, out):
    out[f'{prefix}.running_mean'] = _t(s['mean'])
    out[f'{prefix}.running_var'] = _t(s['var'])


def _normalization(p, s, prefix, out):
    '''normalizations' `Normalization` of any kind.'''
    _norm(p.get('BatchNorm_0'), f'{prefix}.bn', out)
    if 'BatchNorm_0' in s:
        _running(s['BatchNorm_0'], f'{prefix}.bn', out)
    if 'rho' in p:
        out[f'{prefix}.rho'] = _t(p['rho'])
    if 'Conv_0' in p:
        _conv(p['Conv_0'], f'{prefix}.conv', out)
    if 'gamma' in p:
        out[f'{prefix}.gamma'] = _t(np.asarray(p['gamma']).reshape(-1))
        out[f'{prefix}.beta'] = _t(np.asarray(p['beta']).reshape(-1))


def convert_normalizations_generator(variables) -> dict:
    '''normalizations' G from flax variables ({'params', 'batch_stats'}:
    BatchNorm's statistics with 'bn'). The style Dense reads the map
    flattened in H, W, C order on both sides, so its kernel only
    transposes.'''
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    for i, key in _indexed_keys(p, 'Conv'):
        _conv(p[key], f'convs.{i}', out)
    for i, key in _indexed_keys(p, 'Normalization'):
        _normalization(p[key], s.get(key, {}), f'norms.{i}', out)
    for i, key in _indexed_keys(p, 'AdaptiveNormalization'):
        _normalization(p[key].get('Normalization_0', {}),
                       s.get(key, {}).get('Normalization_0', {}), f'adanorms.{i}.norm', out)
        _dense(p[key]['Dense_0'], f'adanorms.{i}.dense', out)
        out[f'adanorms.{i}.affine_bias'] = _t(p[key]['affine_bias'])
    _dense(p['Dense_0'], 'dense', out)
    return out


def _stats_of(s, prefix, out):
    '''BatchNorm's statistics of a norm without affine terms, if any.'''
    if 'BatchNorm_0' in s:
        _running(s['BatchNorm_0'], prefix, out)


def convert_spade_generator(variables, prefix='') -> dict:
    '''SPADE's G from flax variables ({'params', 'batch_stats'}: u, the
    SPADE norms' statistics); `prefix` names it in the recipe's module dict
    ('G.').'''
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    _dense(p['Dense_0'], f'{prefix}dense', out)
    for i, key in _indexed_keys(p, 'SPADEResBlock'):
        blk, bs = p[key], s.get(key, {})
        for j, sk in _indexed_keys(blk, 'SPADE'):
            sp, ss = blk[sk], bs.get(sk, {})
            _stats_of(ss, f'{prefix}blocks.{i}.spades.{j}.norm.norm', out)
            for k, ck in _indexed_keys(sp, 'SNConv'):
                _sn_layer(sp[ck], ss.get(ck, {}), f'{prefix}blocks.{i}.spades.{j}.convs.{k}', out)
        for j, ck in _indexed_keys(blk, 'SNConv'):
            _sn_layer(blk[ck], bs.get(ck, {}), f'{prefix}blocks.{i}.convs.{j}', out)
    _sn_layer(p['SNConv_0'], s.get('SNConv_0', {}), f'{prefix}out', out)
    return out


def convert_spade_encoder(variables, prefix='') -> dict:
    '''SPADE's E from flax variables; `prefix` names it ('E.').'''
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    for i, key in _indexed_keys(p, 'SNConv'):
        _sn_layer(p[key], s.get(key, {}), f'{prefix}convs.{i}', out)
    for i, key in _indexed_keys(s, 'BatchNorm'):
        _running(s[key], f'{prefix}norms.{i}.norm', out)
    _dense(p['Dense_0'], f'{prefix}mu', out)
    _dense(p['Dense_1'], f'{prefix}logvar', out)
    return out


def _scft_norm(p, s, prefix, out):
    '''`get_normalization`'s parameters (and BatchNorm's statistics).'''
    for kind in ('BatchNorm_0', 'LayerNorm_0', 'GroupNorm_0'):
        if kind in p:
            _norm(p[kind], prefix, out)
        if kind in s:
            _running(s[kind], prefix, out)


def _scft_block(p, s, prefix, out):
    '''A ConvBlock: its (spectral-normalized) conv and its norm.'''
    _sn_layer(p, s, f'{prefix}.conv', out)
    _scft_norm(p, s, f'{prefix}.norm', out)


def convert_scft_generator(variables) -> dict:
    '''SCFT's G from flax variables ({'params', 'batch_stats'}: u).'''
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    for enc in ('ref_encoder', 'sketch_encoder'):
        for i, key in _indexed_keys(p[enc], 'ConvBlock'):
            _scft_block(p[enc][key], s.get(enc, {}).get(key, {}), f'{enc}.blocks.{i}', out)
    ps, ss = p['SCFT_0'], s.get('SCFT_0', {})
    _sn_named(ps, ss, 'Dense_0', 'SpectralNorm_0', 'scft.kv', out)
    _sn_named(ps, ss, 'Dense_1', 'SpectralNorm_1', 'scft.q', out)
    for i, key in _indexed_keys(p, 'ResBlock'):
        rp, rs = p[key], s.get(key, {})
        for j, ck in _indexed_keys(rp, 'ConvBlock'):
            _scft_block(rp[ck], rs.get(ck, {}), f'blocks.{i}.blocks.{j}', out)
        _sn_layer(rp, rs, f'blocks.{i}.conv', out)
        _scft_norm(rp, rs, f'blocks.{i}.norm', out)
    for i, key in _indexed_keys(p, 'ConvBlock'):
        _scft_block(p[key], s.get(key, {}), f'dec.{i}', out)
    _sn_layer(p, s, 'out', out)
    return out


def convert_scft_discriminator(variables) -> dict:
    '''SCFT's D from flax variables: Conv_k with SpectralNorm_k -> convs.k,
    the norms in order -> norms.j.'''
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    for k, key in _indexed_keys(p, 'Conv'):
        _sn_named(p, s, key, f'SpectralNorm_{k}', f'convs.{k}', out)
    for kind in ('BatchNorm', 'LayerNorm', 'GroupNorm'):
        for j, key in _indexed_keys(p, kind):
            _norm(p[key], f'norms.{j}', out)
            if key in s:
                _running(s[key], f'norms.{j}', out)
    return out
