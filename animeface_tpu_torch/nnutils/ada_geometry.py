'''Two-pass geometric warp of the ADA AugmentPipe, in PyTorch.

Counterpart of `animeface_tpu/nnutils/ada_geometry.py`. The affine map
factors into two per-line 1-D resamples (y, then x); each is a per-line
integer cyclic shift, a 2-tap fractional blend and a matmul with a banded
per-image kernel matrix M. The up2 -> bilinear -> down2 sandwich of the
exact path collapses along each axis into one derived interpolating kernel
K (support |t| < 6.5), measured from the exact path itself. Reflection comes
from a cyclic double canvas (period 2N - 2 of the pixel-centre mirror).
Rotations are first normalized into (-45, 45] degrees by an exact per-image
rot90/flip.

Execution: on a CUDA tensor both passes run in the hand-written kernel pair
(`ada_geometry_cuda.twopass_fused`) when N % 8 == 0 and We % 128 == 0, the
TPU kernel's gate (256px: We = 384). Every other square shape (128px:
We = 192) runs each pass through the hand-written line kernel pair
(`ada_geometry_cuda.linepass_fused`), as the TPU took its single-pass
kernel there. On a CPU tensor the dense formulation runs (gathers and
einsums), unless the caller asks for the kernel branch (`fused=True`),
whose wrappers then take their plain versions.
'''

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from animeface_tpu_torch.nnutils.ada_geometry_cuda import linepass_fused, twopass_fused


@functools.lru_cache(maxsize=1)
def derive_axis_kernel():
    '''Composite 1x kernel of (zero-insert up2 + FIR) -> hat -> (FIR + down2).

    Returns (half_values, support): K at the half-integer knots K(0.5 + n),
    n >= 0 (K is symmetric, interpolating: K(0) = 1, K(n) = 0, and
    piecewise linear between half-integer knots). Measured on the CPU from
    the exact geometry path by warping a delta image with pure integer and
    half-integer translations.
    '''
    from animeface_tpu_torch.nnutils.ada import AugmentPipe, translate2d_inv

    pipe = AugmentPipe(xint=1, geom_impl='exact')
    N = 33
    c = N // 2

    def row_for(t):
        G = translate2d_inv(torch.full((1,), float(t)), torch.zeros((1,)))
        x = torch.zeros((1, 1, N, N))
        x[0, 0, c, c] = 1.0
        return pipe._execute_geometry_exact(x, G)[0, 0, c, :].numpy()

    int_row = row_for(1.0)
    assert abs(int_row[c + 1] - 1.0) < 1e-5, int_row[c - 2:c + 3]
    assert np.abs(np.delete(int_row, c + 1)).max() < 1e-5

    half_row = row_for(0.5)                   # out[j] = K(j - (c + 0.5))
    vals = []
    n = 0
    while c + 1 + n < N:
        v = float(half_row[c + 1 + n])
        if abs(v) < 1e-7 and n > 0:
            break
        vals.append(v)
        n += 1
    for n, v in enumerate(vals):              # symmetry against the mirrored side
        assert abs(float(half_row[c - n]) - v) < 1e-5, (n, v)
    return tuple(vals), len(vals)             # K(t) = 0 for |t| >= support + 0.5


def eval_kernel(t, half_values, support):
    '''The piecewise-linear interpolating kernel at positions t.'''
    a = t.abs()
    k = torch.floor(a * 2.0).long()
    frac = a * 2.0 - k
    knots = [1.0]
    for h in half_values:
        knots.extend([float(h), 0.0])
    knots.append(0.0)
    table = torch.tensor(knots, dtype=torch.float32, device=t.device)
    k = k.clamp(0, len(knots) - 2)
    v = table[k] * (1.0 - frac) + table[k + 1] * frac
    return torch.where(a >= support + 0.5, torch.zeros_like(v), v)


def _dihedral_normalize(x, A, u):
    '''Fold reflections and 90-degree rotations of the sampling map into
    exact canvas ops, so that det(A') > 0 and A's polar angle lies in
    [-45, 45]: sampling x' with (A', u') equals sampling x with (A, u).
    x is [B, C, H, W].'''
    B, C, H, W = x.shape
    assert H == W, 'two-pass geometry expects square images'
    dev = x.device
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    flip = det < 0
    Fs = torch.where(flip[:, None, None],
                     torch.tensor([[-1.0, 0.0], [0.0, 1.0]], device=dev),
                     torch.eye(2, device=dev))
    A = Fs @ A
    u = torch.einsum('bij,bj->bi', Fs, u)

    theta = torch.atan2(A[:, 1, 0] - A[:, 0, 1], A[:, 0, 0] + A[:, 1, 1])
    k = torch.remainder(torch.round(theta / (np.pi / 2)).long(), 4)
    cs = torch.tensor([[1., 0.], [0., -1.], [-1., 0.], [0., 1.]], device=dev)
    c, s = cs[k, 0], cs[k, 1]
    Rm = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    A = Rm @ A
    u = torch.einsum('bij,bj->bi', Rm, u)

    # [transpose if k odd] then [row reverse] then [column reverse]
    odd = (k % 2) == 1
    x = torch.where(odd[:, None, None, None], x.transpose(2, 3), x)
    rev_r = torch.where(flip, (k == 2) | (k == 3), (k == 1) | (k == 2))
    rev_c = torch.where(flip, (k == 0) | (k == 3), (k == 2) | (k == 3))
    x = torch.where(rev_r[:, None, None, None], x.flip(2), x)
    x = torch.where(rev_c[:, None, None, None], x.flip(3), x)
    return x, A, u


def _cyclic_double(z, dim):
    '''One period of the pixel-centre mirror extension along `dim`:
    [z, reverse(z[1:-1])] (length N -> 2N - 2).'''
    n = z.shape[dim]
    return torch.cat([z, z.flip(dim).narrow(dim, 1, n - 2)], dim=dim)


def _pass_params(slope, shear, base, cols, out_len, P, half, support):
    '''Per-image line-pass parameters: integer cyclic shift (mod P, int32)
    and fractional blend per line, and the kernel matrix M [B, out_len, P]
    evaluated at the cyclic distance.'''
    cols = torch.as_tensor(np.asarray(cols, np.float32), device=slope.device)
    shear_term = shear[:, None] * cols[None, :]                     # [B, W]
    t = torch.floor(shear_term)
    frac = shear_term - t
    tint = torch.remainder(t.int(), P).int()
    o = torch.arange(out_len, dtype=torch.float32, device=slope.device)
    j = torch.arange(P, dtype=torch.float32, device=slope.device)
    q = slope[:, None] * o[None, :] + base[:, None]                # [B, out]
    dlt = q[:, :, None] - j[None, None, :]
    dlt = torch.remainder(dlt + P / 2.0, float(P)) - P / 2.0
    return tint, frac, eval_kernel(dlt, half, support)


def _line_pass(z, slope, shear, base, cols, out_len, half, support):
    '''Resample along axis 2 of z [B, C, N, W] at positions
    slope[b] * o + shear[b] * cols[w] + base[b], reading the mirror
    extension of z. Returns [B, C, out_len, W].'''
    B, C, N, W = z.shape
    P = 2 * N - 2
    z2 = _cyclic_double(z, 2)                                      # [B, C, P, W]
    tint, frac, M = _pass_params(slope, shear, base, cols, out_len, P, half, support)
    lines = torch.arange(P, device=z.device)
    idx = torch.remainder(lines[None, :, None] + tint[:, None, :].long(), P)
    z2 = z2.gather(2, idx[:, None].expand(B, C, P, W))
    f = frac.to(z.dtype)[:, None, None, :]
    z2 = z2 * (1 - f) + torch.roll(z2, -1, dims=2) * f
    return torch.einsum('boj,bcjw->bcow', M.to(z.dtype), z2)


def _line_pass_fused(z, slope, shear, base, cols, out_len, half, support):
    '''`_line_pass` through the line kernel pair, which reads z's mirror
    extension by index instead of a materialised double canvas.'''
    P = 2 * z.shape[2] - 2
    tint, frac, M = _pass_params(slope, shear, base, cols, out_len, P, half, support)
    return linepass_fused(z.contiguous(), tint, frac.to(z.dtype), M.to(z.dtype))


def _factorize(images, G_inv, support):
    '''Normalize the map, mirror-extend the columns and split the warp into
    its two line passes. Returns (x [B, C, N, We], We, pass-1 and pass-2
    (slope, shear, base, lines) tuples).'''
    B, C, H, W = images.shape
    assert H == W
    N = H
    ctr = (N - 1) / 2.0
    A = G_inv[:, :2, :2].float()
    u = G_inv[:, :2, 2].float()
    x, A, u = _dihedral_normalize(images, A, u)

    a, b, c, d = A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]
    a = torch.clamp(a, min=0.05)
    ux, uy = u[:, 0], u[:, 1]

    # mirror-extend the columns by E before pass 1 (border columns that
    # normalized rotations reach carry pass-1 content with the right shear)
    E = max(N // 4, support + 2)
    left = x[:, :, :, 1:E + 1].flip(3)
    right = x[:, :, :, W - E - 1:W - 1].flip(3)
    x = torch.cat([left, x, right], dim=3)
    We = W + 2 * E

    # pass 1 resamples y at the extended columns, pass 2 resamples x
    slope_y = (a * d - b * c) / a
    cols = np.arange(We, dtype=np.float32) - E - ctr
    base_y = (uy - c * ux / a) + ctr - slope_y * ctr
    rows = np.arange(N, dtype=np.float32) - ctr
    base_x = ux + ctr - a * ctr + E
    return x, We, (slope_y, c / a, base_y, cols), (a, b, base_x, rows)


def fused_inputs(images, G_inv, half, support):
    '''The two-pass kernels' arguments for one warp of NCHW `images`:
    (x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len), M zero-padded to a
    multiple of 8 columns, in the images' dtype.'''
    N = images.shape[2]
    x, We, pass1, pass2 = _factorize(images, G_inv, support)
    P1, P2 = 2 * N - 2, 2 * We - 2
    t1, f1, M1 = _pass_params(*pass1, N, P1, half, support)
    t2, f2, M2 = _pass_params(*pass2, N, P2, half, support)
    M1 = F.pad(M1, (0, -(-P1 // 8) * 8 - P1)).to(x.dtype)
    M2 = F.pad(M2, (0, -(-P2 // 8) * 8 - P2)).to(x.dtype)
    return x, t1, f1.to(x.dtype), M1, t2, f2.to(x.dtype), M2, P1, P2, We, N


def twopass_warp(images, G_inv, half=None, support=None, fused=None):
    '''Two-pass execution of the exact path's sampling semantics.

    images: [B, C, N, N]; G_inv: [B, 3, 3] inverse homography in the exact
    path's pixel convention (p_in = A (p_out - ctr) + ctr + u). `fused`
    picks the kernel branch (the two-pass pair where the shape passes its
    gate, else the line pair for each pass); None means: on a CUDA tensor.
    '''
    if half is None:
        half, support = derive_axis_kernel()
    N = images.shape[2]
    We = N + 2 * max(N // 4, support + 2)
    if fused is None:
        fused = images.device.type == 'cuda'
    if fused and not (N % 8 or We % 128):
        out = twopass_fused(*fused_inputs(images, G_inv, half, support))
        return out.transpose(2, 3).to(images.dtype)                # [B, C, rows, x]

    line = _line_pass_fused if fused else _line_pass
    x, We, pass1, pass2 = _factorize(images, G_inv, support)
    y1 = line(x, *pass1, N, half, support)                         # [B, C, N, We]
    out = line(y1.transpose(2, 3), *pass2, N, half, support)
    return out.transpose(2, 3).to(images.dtype)
