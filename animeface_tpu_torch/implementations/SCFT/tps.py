'''Thin-plate-spline warping of SCFT's reference images.

Counterpart of `animeface_tpu/implementations/SCFT/tps.py`: a 4x4 grid of
control points on [-0.9, 0.9]^2 moves by N(0, 1) * std offsets (an input
here: `draw_offsets`), and the TPS through them, solved per axis from the
(n + 3) x (n + 3) system A (the kernel U(r^2) = r^2 log(r^2 + 1e-6) / 2
between control points, the affine terms, 1e-6 on the diagonal), maps
every pixel centre of a [-1, 1] grid; the image is sampled there
bilinearly with zeros outside (`ops.grid_sample`).

A depends on the control points alone, and the displaced grid is linear in
the offsets: grid = points + W @ offsets, W = basis @ A^-1[:, :n] with the
basis (U to each control point, 1, x, y) of every pixel. `TPSWarp` solves
that once in float64 with numpy when it is built (cond(A) = 141.3 for the
4x4 grid), so a step does one small matmul and no solve on the device.
'''

from __future__ import annotations

import numpy as np
import torch

from animeface_tpu_torch.ops.grid_sample import grid_sample

GRID_POINTS = 4
STD = 0.05


def _u(r2):
    return r2 * 0.5 * np.log(r2 + 1e-6)


def tps_system(grid_points: int = GRID_POINTS):
    '''The control points [n, 2] (x, y) and A [(n + 3), (n + 3)], float64.'''
    n = grid_points * grid_points
    lin = np.linspace(-0.9, 0.9, grid_points)
    cy, cx = np.meshgrid(lin, lin, indexing='ij')
    ctrl = np.stack([cx.ravel(), cy.ravel()], axis=-1)
    K = _u(((ctrl[:, None] - ctrl[None, :]) ** 2).sum(-1))
    P = np.concatenate([np.ones((n, 1)), ctrl], axis=1)
    A = np.zeros((n + 3, n + 3))
    A[:n, :n], A[:n, n:], A[n:, :n] = K, P, P.T
    return ctrl, A + np.eye(n + 3) * 1e-6


class TPSWarp:
    '''The TPS warp of [B, C, height, width] images (module docstring), its
    matrices on `device`.'''

    def __init__(self, height: int, width: int, grid_points: int = GRID_POINTS, device=None):
        ctrl, A = tps_system(grid_points)
        n = len(ctrl)
        gy, gx = np.meshgrid(np.linspace(-1, 1, height), np.linspace(-1, 1, width),
                             indexing='ij')
        pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)                  # [HW, 2]
        basis = np.concatenate([_u(((pts[:, None] - ctrl[None, :]) ** 2).sum(-1)),
                                np.ones((len(pts), 1)), pts], axis=1)     # [HW, n + 3]
        warp = basis @ np.linalg.solve(A, np.eye(n + 3)[:, :n])           # [HW, n]
        self.points = torch.from_numpy(pts).to(device)
        self.warp = torch.from_numpy(warp).to(device)
        self.shape = (height, width)
        self.num_points = n

    def grid(self, offsets):
        '''The sampling grids [B, height, width, 2] for the control points'
        offsets [B, n, 2], in the offsets' dtype.'''
        dtype = offsets.dtype
        grid = self.points.to(dtype) + torch.einsum('pn,bnc->bpc', self.warp.to(dtype), offsets)
        return grid.reshape(offsets.shape[0], *self.shape, 2)

    def __call__(self, x, offsets):
        '''x [B, C, height, width] warped by the offsets' TPS.'''
        return grid_sample(x, self.grid(offsets.to(x.dtype)))


def draw_offsets(batch: int, generator: torch.Generator, grid_points: int = GRID_POINTS,
                 std: float = STD, dtype=torch.float32):
    '''The control points' offsets [batch, n, 2], N(0, 1) * std, from
    `generator` (on its device).'''
    n = grid_points * grid_points
    return torch.randn((batch, n, 2), generator=generator, dtype=dtype,
                       device=generator.device) * std
