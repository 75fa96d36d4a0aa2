'''ADA — adaptive discriminator augmentation, in PyTorch on NCHW batches.

Counterpart of `animeface_tpu/nnutils/ada.py`: the 18-knob `AugmentPipe`
(geometry, color, image-space filtering, noise, cutout, and the
`debug_percentile` mode that replaces every draw by a percentile), and the
adaptive-p controller (`ada_init_state`, `ada_update_p`, `ada_tick`).

Random draws come from the `torch.Generator` the caller passes (on the
images' device). Geometry runs one of two ways (`geom_impl`): 'exact' —
folded canvases and a per-pixel bilinear gather (the parity oracle);
'twopass' — `nnutils/ada_geometry.py`, whose fused branch is the CUDA
kernel pair. 'auto' picks twopass for CUDA tensors and exact for CPU ones.
The controller state is a dict of 0-dim tensors, updated without a host
sync (`torch.where` in place of `lax.cond`).
'''

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.ops import setup_filter, upfirdn2d, downsample2d

_WAVELETS = {
    'haar': [0.7071067811865476, 0.7071067811865476],
    'sym2': [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    'sym6': [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
             -0.048311742585633, 0.4910559419267466, 0.787641141030194,
             0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
             0.04472490177066578, 0.0017677118642428036, -0.007800708325034148],
}


def _wavelet(name: str) -> np.ndarray:
    return np.asarray(_WAVELETS[name])


# ---- homogeneous-matrix helpers, batched ----

def _eye(n, B, device):
    return torch.eye(n, device=device).expand(B, n, n).clone()


def translate2d_inv(tx, ty):
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2] = -tx
    m[:, 1, 2] = -ty
    return m


def scale2d_inv(sx, sy):
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0] = 1.0 / sx
    m[:, 1, 1] = 1.0 / sy
    return m


def rotate2d_inv(theta):
    theta = -theta
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(3, theta.shape[0], theta.device)
    m[:, 0, 0] = c
    m[:, 0, 1] = -s
    m[:, 1, 0] = s
    m[:, 1, 1] = c
    return m


def _translate3d(t):
    m = _eye(4, t.shape[0], t.device)
    m[:, 0, 3] = t
    m[:, 1, 3] = t
    m[:, 2, 3] = t
    return m


def _scale3d(s):
    m = _eye(4, s.shape[0], s.device)
    m[:, 0, 0] = s
    m[:, 1, 1] = s
    m[:, 2, 2] = s
    return m


def _rotate3d_axis(v, theta):
    '''Rotation by theta around the unit 3-vector v (homogeneous 4x4).'''
    vx, vy, vz = (float(a) for a in v)
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    rows = [
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c],
    ]
    m = _eye(4, theta.shape[0], theta.device)
    for i in range(3):
        for j in range(3):
            m[:, i, j] = rows[i][j]
    return m


def _erfinv(v: float) -> float:
    return float(torch.erfinv(torch.tensor(v, dtype=torch.float32)))


class AugmentPipe:
    '''18-knob augmentation pipeline. `pipe(images, p, generator)`.'''

    def __init__(self,
                 xflip=0, rotate90=0, xint=0, xint_max=0.125,
                 scale=0, rotate=0, aniso=0, xfrac=0, scale_std=0.2,
                 rotate_max=1, aniso_std=0.2, xfrac_std=0.125,
                 brightness=0, contrast=0, lumaflip=0, hue=0, saturation=0,
                 brightness_std=0.2, contrast_std=0.5, hue_max=1,
                 saturation_std=1,
                 imgfilter=0, imgfilter_bands=(1, 1, 1, 1), imgfilter_std=1,
                 noise=0, cutout=0, noise_std=0.1, cutout_size=0.5,
                 geom_impl='auto'):
        self.xflip, self.rotate90, self.xint = float(xflip), float(rotate90), float(xint)
        self.xint_max = float(xint_max)
        self.scale, self.rotate, self.aniso, self.xfrac = (
            float(scale), float(rotate), float(aniso), float(xfrac))
        self.scale_std, self.rotate_max = float(scale_std), float(rotate_max)
        self.aniso_std, self.xfrac_std = float(aniso_std), float(xfrac_std)
        self.brightness, self.contrast, self.lumaflip = (
            float(brightness), float(contrast), float(lumaflip))
        self.hue, self.saturation = float(hue), float(saturation)
        self.brightness_std, self.contrast_std = float(brightness_std), float(contrast_std)
        self.hue_max, self.saturation_std = float(hue_max), float(saturation_std)
        self.imgfilter = float(imgfilter)
        self.imgfilter_bands = list(imgfilter_bands)
        self.imgfilter_std = float(imgfilter_std)
        self.noise, self.cutout = float(noise), float(cutout)
        self.noise_std, self.cutout_size = float(noise_std), float(cutout_size)

        if geom_impl not in ('auto', 'exact', 'twopass'):
            raise ValueError(f'geom_impl must be auto, exact or twopass, not {geom_impl!r}')
        self.geom_impl = geom_impl
        if geom_impl != 'exact':
            from animeface_tpu_torch.nnutils.ada_geometry import derive_axis_kernel
            self._axis_kernel = derive_axis_kernel()

        self.Hz_geom = setup_filter(_wavelet('sym6'))

        # filter bank for image-space band amplification
        Hz_lo = _wavelet('sym2')
        Hz_hi = Hz_lo * ((-1) ** np.arange(Hz_lo.size))
        Hz_lo2 = np.convolve(Hz_lo, Hz_lo[::-1]) / 2
        Hz_hi2 = np.convolve(Hz_hi, Hz_hi[::-1]) / 2
        Hz_fbank = np.eye(4, 1)
        for i in range(1, Hz_fbank.shape[0]):
            Hz_fbank = np.dstack([Hz_fbank, np.zeros_like(Hz_fbank)]
                                 ).reshape(Hz_fbank.shape[0], -1)[:, :-1]
            Hz_fbank = scipy.signal.convolve(Hz_fbank, [Hz_lo2])
            Hz_fbank[i, (Hz_fbank.shape[1] - Hz_hi2.size) // 2:
                     (Hz_fbank.shape[1] + Hz_hi2.size) // 2] += Hz_hi2
        self.Hz_fbank = torch.as_tensor(Hz_fbank, dtype=torch.float32)

    def _static_margin(self, width: int, height: int) -> tuple[int, int, int, int]:
        '''Worst-case reflect margin from the enabled knob maxima.'''
        cx, cy = (width - 1) / 2, (height - 1) / 2
        radius = math.hypot(cx, cy) if self.rotate > 0 else max(cx, cy)
        grow = 1.0
        if self.scale > 0:
            grow *= 2 ** (3 * self.scale_std)
        if self.aniso > 0:
            grow *= 2 ** (3 * self.aniso_std)
        extent = radius * grow
        if self.xint > 0:
            extent += self.xint_max * max(width, height)
        if self.xfrac > 0:
            extent += 3 * self.xfrac_std * max(width, height)
        Hz_pad = self.Hz_geom.shape[0] // 4
        mx = int(np.clip(math.ceil(extent - cx + Hz_pad * 2), 0, width - 1))
        my = int(np.clip(math.ceil(extent - cy + Hz_pad * 2), 0, height - 1))
        return mx, mx, my, my

    def _geometry_enabled(self):
        return any(k > 0 for k in (self.xflip, self.rotate90, self.xint,
                                   self.scale, self.rotate, self.aniso, self.xfrac))

    def _color_enabled(self):
        return any(k > 0 for k in (self.brightness, self.contrast,
                                   self.lumaflip, self.hue, self.saturation))

    # ---- forward ----

    def __call__(self, images, p, generator=None, debug_percentile=None):
        '''Augment NCHW `images` at strength `p` (float or 0-dim tensor).
        `debug_percentile` in [0, 1] replaces every random draw by that
        percentile of its distribution (deterministic testing mode).'''
        assert images.ndim == 4, 'expected NCHW'
        B, C, H, W = images.shape
        dev = images.device
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        u = lambda shape=(): torch.rand((B,) + shape, generator=generator, device=dev)
        n = lambda shape=(): torch.randn((B,) + shape, generator=generator, device=dev)
        dbg = debug_percentile
        if dbg is not None:
            dbg = float(dbg)
            erfinv = _erfinv(dbg * 2 - 1)

        def D(value, debug_value):
            if dbg is None:
                return value
            return torch.full_like(value, debug_value)

        zero = torch.zeros((), device=dev)
        one = torch.ones((), device=dev)

        # ---- geometric: accumulate the inverse homography ----
        if self._geometry_enabled():
            G_inv = _eye(3, B, dev)
            if self.xflip > 0:
                i = torch.floor(u() * 2)
                i = torch.where(u() < self.xflip * p, i, zero)
                i = D(i, math.floor(dbg * 2) if dbg is not None else 0)
                G_inv = G_inv @ scale2d_inv(1 - 2 * i, torch.ones((B,), device=dev))
            if self.rotate90 > 0:
                i = torch.floor(u() * 4)
                i = torch.where(u() < self.rotate90 * p, i, zero)
                i = D(i, math.floor(dbg * 4) if dbg is not None else 0)
                G_inv = G_inv @ rotate2d_inv(-np.pi / 2 * i)
            if self.xint > 0:
                t = (u((2,)) * 2 - 1) * self.xint_max
                t = torch.where(u((1,)) < self.xint * p, t, zero)
                t = D(t, (dbg * 2 - 1) * self.xint_max if dbg is not None else 0)
                G_inv = G_inv @ translate2d_inv(torch.round(t[:, 0] * W),
                                                torch.round(t[:, 1] * H))
            if self.scale > 0:
                s = torch.exp2(n() * self.scale_std)
                s = torch.where(u() < self.scale * p, s, one)
                s = D(s, 2 ** (erfinv * self.scale_std) if dbg is not None else 1)
                G_inv = G_inv @ scale2d_inv(s, s)
            p_rot = 1 - torch.sqrt(torch.clamp(1 - self.rotate * p, 0, 1))
            if self.rotate > 0:
                theta = (u() * 2 - 1) * np.pi * self.rotate_max
                theta = torch.where(u() < p_rot, theta, zero)
                theta = D(theta, (dbg * 2 - 1) * np.pi * self.rotate_max
                          if dbg is not None else 0)
                G_inv = G_inv @ rotate2d_inv(-theta)
            if self.aniso > 0:
                s = torch.exp2(n() * self.aniso_std)
                s = torch.where(u() < self.aniso * p, s, one)
                s = D(s, 2 ** (erfinv * self.aniso_std) if dbg is not None else 1)
                G_inv = G_inv @ scale2d_inv(s, 1 / s)
            if self.rotate > 0:
                theta = (u() * 2 - 1) * np.pi * self.rotate_max
                theta = torch.where(u() < p_rot, theta, zero)
                theta = D(theta, 0.0)   # the reference zeroes the post-rotation
                G_inv = G_inv @ rotate2d_inv(-theta)
            if self.xfrac > 0:
                t = n((2,)) * self.xfrac_std
                t = torch.where(u((1,)) < self.xfrac * p, t, zero)
                t = D(t, erfinv * self.xfrac_std if dbg is not None else 0)
                G_inv = G_inv @ translate2d_inv(t[:, 0] * W, t[:, 1] * H)
            images = self._execute_geometry(images, G_inv)

        # ---- color: accumulate a 4x4 homogeneous color matrix ----
        if self._color_enabled():
            Cm = _eye(4, B, dev)
            v = torch.tensor([1., 1., 1., 0.], device=dev) / np.sqrt(3)
            if self.brightness > 0:
                b = n() * self.brightness_std
                b = torch.where(u() < self.brightness * p, b, zero)
                b = D(b, erfinv * self.brightness_std if dbg is not None else 0)
                Cm = _translate3d(b) @ Cm
            if self.contrast > 0:
                c = torch.exp2(n() * self.contrast_std)
                c = torch.where(u() < self.contrast * p, c, one)
                c = D(c, 2 ** (erfinv * self.contrast_std) if dbg is not None else 1)
                Cm = _scale3d(c) @ Cm
            if self.lumaflip > 0:
                i = torch.floor(u() * 2)
                i = torch.where(u() < self.lumaflip * p, i, zero)
                i = D(i, math.floor(dbg * 2) if dbg is not None else 0)
                house = torch.eye(4, device=dev) - 2 * torch.outer(v, v)
                Cm = torch.where(i[:, None, None] > 0, house[None] @ Cm, Cm)
            if self.hue > 0 and C > 1:
                theta = (u() * 2 - 1) * np.pi * self.hue_max
                theta = torch.where(u() < self.hue * p, theta, zero)
                theta = D(theta, (dbg * 2 - 1) * np.pi * self.hue_max
                          if dbg is not None else 0)
                Cm = _rotate3d_axis(np.ones(3) / np.sqrt(3), theta) @ Cm
            if self.saturation > 0 and C > 1:
                s = torch.exp2(n() * self.saturation_std)
                s = torch.where(u() < self.saturation * p, s, one)
                s = D(s, 2 ** (erfinv * self.saturation_std) if dbg is not None else 1)
                vv = torch.outer(v, v)
                sat = vv[None] + (torch.eye(4, device=dev)[None] - vv[None]) * s[:, None, None]
                Cm = sat @ Cm
            images = self._execute_color(images, Cm)

        # ---- image-space filtering (band amplification) ----
        if self.imgfilter > 0:
            images = self._execute_imgfilter(images, p, generator, dbg)

        # ---- corruptions ----
        if self.noise > 0:
            sigma = n().abs() * self.noise_std
            sigma = torch.where(u() < self.noise * p, sigma, zero)
            if dbg is not None:
                sigma = torch.full_like(sigma, _erfinv(dbg) * self.noise_std)
            images = images + torch.randn(images.shape, generator=generator, device=dev,
                                          dtype=images.dtype) \
                * sigma[:, None, None, None].to(images.dtype)
        if self.cutout > 0:
            size = torch.where(u((1,)) < self.cutout * p,
                               torch.tensor(self.cutout_size, device=dev), zero)
            center = u((2,))
            if dbg is not None:
                size = torch.full_like(size, self.cutout_size)
                center = torch.full_like(center, dbg)
            cx_ = torch.arange(W, device=dev).reshape(1, 1, W) + 0.5
            cy_ = torch.arange(H, device=dev).reshape(1, H, 1) + 0.5
            mask_x = (cx_ / W - center[:, 0, None, None]).abs() >= size[:, 0, None, None] / 2
            mask_y = (cy_ / H - center[:, 1, None, None]).abs() >= size[:, 0, None, None] / 2
            mask = (mask_x | mask_y).to(images.dtype)
            images = images * mask[:, None]
        return images

    # ---- execution stages ----

    def _resolved_geom_impl(self, device):
        if self.geom_impl != 'auto':
            return self.geom_impl
        return 'twopass' if device.type == 'cuda' else 'exact'

    def _execute_geometry(self, images, G_inv):
        if (self._resolved_geom_impl(images.device) == 'twopass'
                and images.shape[2] == images.shape[3]):
            from animeface_tpu_torch.nnutils.ada_geometry import twopass_warp
            half, support = self._axis_kernel
            return twopass_warp(images, G_inv, half, support)
        return self._execute_geometry_exact(images, G_inv)

    def _execute_geometry_exact(self, images, G_inv):
        '''Geometric warp via folded canvases (see the JAX twin): the
        reflect-padded 2x-upsampled canvas is represented by four upsampled
        CORE canvases (filter normal/flipped per axis); samples outside the
        core fold back (pixel-centre mirror) onto the matching canvas, and
        samples beyond the static margin read 0.'''
        B, C, H, W = images.shape
        in_dtype = images.dtype
        dev = images.device
        images = images.float()
        f = self.Hz_geom.to(dev)
        taps = int(f.shape[0])
        Hz_pad = taps // 4
        mx0, mx1, my0, my1 = self._static_margin(W, H)
        mx, my = mx0, my0

        e = taps // 2
        xe = F.pad(images, (e, e, e, e), mode='reflect')
        f_flip = f.flip(0)
        p0 = (taps + 1) // 2
        p1 = (taps - 2) // 2

        def up_x(z, fil):
            return upfirdn2d(z, fil[None, :], up=(2, 1), padding=(p0, p1, 0, 0), gain=2)

        def up_y(z, fil):
            return upfirdn2d(z, fil[:, None], up=(1, 2), padding=(0, 0, p0, p1), gain=2)

        ux_n, ux_f = up_x(xe, f), up_x(xe, f_flip)
        U = torch.stack([up_y(ux_n, f), up_y(ux_f, f),
                         up_y(ux_n, f_flip), up_y(ux_f, f_flip)], dim=1)
        U = U[:, :, :, 2 * e: 2 * e + 2 * H, 2 * e: 2 * e + 2 * W]   # [B,4,C,2H,2W]
        Sx, Sy = 2 * W, 2 * H

        full = lambda v: torch.full((B,), float(v), device=dev)
        G_inv = translate2d_inv(full(-(mx0 - mx1) / 2), full(-(my0 - my1) / 2)) @ G_inv.float()
        G_inv = scale2d_inv(full(0.5), full(0.5)) @ G_inv @ scale2d_inv(full(2.0), full(2.0))
        G_inv = translate2d_inv(full(0.5), full(0.5)) @ G_inv @ translate2d_inv(full(-0.5), full(-0.5))

        out_h = (H + Hz_pad * 2) * 2
        out_w = (W + Hz_pad * 2) * 2
        in_h = 2 * (H + my0 + my1)
        in_w = 2 * (W + mx0 + mx1)
        A = (scale2d_inv(full(in_w / 2.0), full(in_h / 2.0)) @ G_inv
             @ scale2d_inv(full(2.0 / out_w), full(2.0 / out_h)))

        ys = (2 * torch.arange(out_h, device=dev) + 1) / out_h - 1
        xs = (2 * torch.arange(out_w, device=dev) + 1) / out_w - 1
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)      # [h,w,3]
        mapped = torch.einsum('bij,hwj->bhwi', A[:, :2, :], coords)

        jx = (mapped[..., 0] + 1.0) * (in_w * 0.5) - 0.5 - 2 * mx
        jy = (mapped[..., 1] + 1.0) * (in_h * 0.5) - 0.5 - 2 * my

        def fold(ji, S, m):
            left = ji < 0
            right = ji > S - 1
            idx = torch.where(left, 1 - ji, torch.where(right, 2 * S - 3 - ji, ji))
            valid = (ji >= -2 * m) & (ji <= S - 1 + 2 * m)
            return idx, left | right, valid

        x0 = torch.floor(jx)
        y0 = torch.floor(jy)
        wx = (jx - x0)[..., None]
        wy = (jy - y0)[..., None]
        x0i, y0i = x0.long(), y0.long()
        batch = torch.arange(B, device=dev)[:, None, None]

        def corner(xi, yi):
            ix, fxp, vx = fold(xi, Sx, mx)
            iy, fyp, vy = fold(yi, Sy, my)
            c = fyp.long() * 2 + fxp.long()
            v = U[batch, c, :, iy.clamp(0, Sy - 1), ix.clamp(0, Sx - 1)]   # [B,h,w,C]
            return v * (vx & vy)[..., None].to(v.dtype)

        v00 = corner(x0i, y0i)
        v01 = corner(x0i + 1, y0i)
        v10 = corner(x0i, y0i + 1)
        v11 = corner(x0i + 1, y0i + 1)
        images = (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy
        images = downsample2d(images.permute(0, 3, 1, 2), f, down=2,
                              padding=-Hz_pad * 2, flip_filter=True)
        assert images.shape == (B, C, H, W), images.shape
        return images.to(in_dtype)

    def _execute_color(self, images, Cm):
        B, C, H, W = images.shape
        in_dtype = images.dtype
        x = images.float()
        Cm = Cm.float()
        if C == 3:
            out = torch.einsum('bij,bjhw->bihw', Cm[:, :3, :3], x) + Cm[:, :3, 3, None, None]
        elif C == 1:
            Cmean = Cm[:, :3, :].mean(dim=1)                          # [B, 4]
            out = x * Cmean[:, :3].sum(dim=1)[:, None, None, None] \
                + Cmean[:, 3][:, None, None, None]
        else:
            raise ValueError('images must be RGB or L')
        return out.to(in_dtype)

    def _execute_imgfilter(self, images, p, generator=None, dbg=None):
        B, C, H, W = images.shape
        in_dtype = images.dtype
        dev = images.device
        fbank = self.Hz_fbank.to(dev)
        num_bands = fbank.shape[0]
        expected_power = torch.tensor([10., 1., 1., 1.], device=dev) / 13
        g = torch.ones((B, num_bands), device=dev)
        for i, band_strength in enumerate(self.imgfilter_bands):
            t_i = torch.exp2(torch.randn((B,), generator=generator, device=dev)
                             * self.imgfilter_std)
            t_i = torch.where(
                torch.rand((B,), generator=generator, device=dev)
                < self.imgfilter * p * band_strength, t_i, torch.ones((), device=dev))
            if dbg is not None:
                t_i = torch.full_like(t_i, 2 ** (_erfinv(dbg * 2 - 1) * self.imgfilter_std)
                                      if band_strength > 0 else 1.0)
            t = torch.ones((B, num_bands), device=dev)
            t[:, i] = t_i
            t = t / torch.sqrt((expected_power * t * t).sum(dim=-1, keepdim=True))
            g = g * t

        Hz_prime = g @ fbank                                           # [B, taps]
        taps = Hz_prime.shape[1]
        pad = taps // 2
        x = F.pad(images.float(), (pad, pad, pad, pad), mode='reflect')
        x = x.reshape(1, B * C, x.shape[2], x.shape[3])
        fil = Hz_prime.repeat_interleave(C, dim=0)                     # [B*C, taps]
        x = F.conv2d(x, fil[:, None, None, :], groups=B * C)
        x = F.conv2d(x, fil[:, None, :, None], groups=B * C)
        return x.reshape(B, C, H, W).to(in_dtype)


DEFAULT_ADA_KNOBS = dict(
    xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
    brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)


def make_ada_pipe(**knobs) -> AugmentPipe:
    '''AugmentPipe with the reference ADA default knob set.'''
    return AugmentPipe(**(knobs or DEFAULT_ADA_KNOBS))


def ada_init_state(batch_size: int, interval: int = 4, target_kimg: int = 500,
                   threshold: float = 0.6, device=None):
    '''Controller state for the adaptive-p heuristic (0-dim tensors on
    `device`, default `cuda`).'''
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        p=torch.zeros((), **f32),
        signsum=torch.zeros((), **f32),
        count=torch.zeros((), **f32),
        num_iter=torch.zeros((), dtype=torch.int32, device=device),
        _interval=interval,
        _threshold=threshold,
        _p_delta=batch_size * interval / (target_kimg * 1000),
        _batch_size=batch_size,
    )


def _ada_advance(ada, signsum, count):
    '''Every `interval` iterations: adjust p from the accumulated sign
    statistic and reset the accumulators; hold p if no logits accumulated.'''
    num_iter = ada['num_iter'] + 1
    adjust = num_iter >= ada['_interval']
    signmean = signsum / torch.clamp(count, min=1.0)
    delta = torch.where(count > 0.0,
                        torch.sign(signmean - ada['_threshold']) * ada['_p_delta'],
                        torch.zeros_like(signmean))
    p_new = torch.clamp(ada['p'] + delta, 0.0, 1.0)
    return dict(ada,
                p=torch.where(adjust, p_new, ada['p']),
                signsum=torch.where(adjust, torch.zeros_like(signsum), signsum),
                count=torch.where(adjust, torch.zeros_like(count), count),
                num_iter=torch.where(adjust, torch.zeros_like(num_iter), num_iter))


def ada_update_p(ada, real_prob):
    '''Update from D(real) logits: every `interval` calls,
    p += sign(mean sign(D(real)) - threshold) * delta, clamped to [0, 1].'''
    signsum = ada['signsum'] + torch.sign(real_prob.float()).sum()
    count = ada['count'] + float(real_prob.numel())
    return _ada_advance(ada, signsum, count)


def ada_tick(ada):
    '''Advance the cadence on an iteration without adversarial D(real)
    logits (the R1 iterations of replace-loss lazy regularization).'''
    return _ada_advance(ada, ada['signsum'], ada['count'])
