"""Per-sample metrics on the device (``multimodal_fusion_fpn_tpu/metrics/
device.py``): hard Dice at a threshold with empty-empty -> 1, the BCE with
torch's -100 log clamp, and the Hausdorff distance and its 95th percentile
of two 2D masks (``:59-168``).

The Hausdorff distances follow the host path (``metrics/hausdorff.py``,
MedPy's definition): each mask's surface is the mask minus its binary
erosion with the connectivity structure (the image border counts as
surface); the directed distances are the distance from each surface pixel
to the nearest surface pixel of the other mask, scaled by the spacing; hd
is the larger directed maximum, hd95 the 95th percentile of both sets
together.  Instead of a distance transform, the nearest squared distance is
an exact separable min,
    min_q (dy2[py,qy] + dx2[px,qx] + inf*(1 - surf[qy,qx]))
  = min_qy (dy2[py,qy] + min_qx (dx2[px,qx] + inf*(1 - surf[qy,qx]))),
two dense reductions taken ``chunk`` rows at a time, so memory stays at
chunk*W*W; mins do not depend on the order, so the chunking changes no
value.  fp32 throughout, as the JAX function.

Under the space axis (``parallel.comm.sharded``) the hard Dice's sums and
the BCE's mean run over the space group: each sample's value is that of
its whole width.
"""

import torch

from multimodal_fusion_fpn_torch.parallel.comm import (all_reduce_sum,
                                                      space_group)


def dice_per_sample(pred: torch.Tensor, gt: torch.Tensor,
                    slice_idx: int = 0, threshold: float = 0.5
                    ) -> torch.Tensor:
    """Hard Dice@threshold per batch element; pred/gt (B, C, ...)."""
    n = pred.shape[0]
    p = (pred[:, slice_idx] > threshold).float().reshape(n, -1)
    g = (gt[:, slice_idx] > threshold).float().reshape(n, -1)
    num = (p * g).sum(dim=1)
    den = (p + g).sum(dim=1)
    group = space_group()
    if group is not None:
        num, den = all_reduce_sum(torch.stack([num, den]), group).unbind(0)
    return torch.where(den == 0.0, torch.ones_like(den),
                       2.0 * num / torch.clamp(den, min=1.0))


def bce_scalar(pred: torch.Tensor, gt: torch.Tensor,
               slice_idx: int = 0) -> torch.Tensor:
    """Mean BCE over the batch slice (one scalar)."""
    p = pred[:, slice_idx].reshape(-1)
    g = gt[:, slice_idx].reshape(-1).to(p.dtype)
    log_p = torch.clamp(torch.log(p), min=-100.0)
    log_1p = torch.clamp(torch.log1p(-p), min=-100.0)
    bce = -torch.mean(g * log_p + (1.0 - g) * log_1p)
    group = space_group()
    if group is not None:
        # the mean of the equal shards' means
        bce = all_reduce_sum(bce, group) / group.size
    return bce


_BIG = 1e12


def _surface(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """mask ^ binary_erosion(mask, structure, border_value=0), 2D."""
    m = mask.bool()
    if connectivity >= 2:
        offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    else:
        offs = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    eroded = m
    for dy, dx in offs:
        shifted = torch.roll(m, (dy, dx), dims=(0, 1))
        # the rows and columns rolled in lie outside the image
        if dy == 1:
            shifted[0, :] = False
        elif dy == -1:
            shifted[-1, :] = False
        if dx == 1:
            shifted[:, 0] = False
        elif dx == -1:
            shifted[:, -1] = False
        eroded = eroded & shifted
    return m & ~eroded


def _masked_min_dist2(surf_to: torch.Tensor, sy: torch.Tensor,
                      sx: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """d2[p]: the least anisotropic squared distance from pixel p to a
    surface pixel of ``surf_to``; (H, W) fp32 (module note)."""
    H, W = surf_to.shape
    dev = surf_to.device
    ix = torch.arange(W, dtype=torch.float32, device=dev)
    dx2 = torch.square((ix[:, None] - ix[None, :]) * sx)        # (Wp, Wq)
    pen = torch.where(surf_to, 0.0, _BIG).to(torch.float32)     # (Hq, Wq)
    # mincol[qy, px] = min_qx dx2[px, qx] + pen[qy, qx]
    mincol = torch.cat([
        torch.amin(dx2[None, :, :] + pen[r:r + chunk, None, :], dim=2)
        for r in range(0, H, chunk)])
    iy = torch.arange(H, dtype=torch.float32, device=dev)
    dy2 = torch.square((iy[:, None] - iy[None, :]) * sy)        # (Hp, Hq)
    # d2[py, px] = min_qy dy2[py, qy] + mincol[qy, px]
    return torch.cat([
        torch.amin(dy2[r:r + chunk, :, None] + mincol[None, :, :], dim=1)
        for r in range(0, H, chunk)])


def _percentile(values: torch.Tensor, valid: torch.Tensor,
                q: float) -> torch.Tensor:
    """numpy's linear-interpolation percentile of the valid values."""
    n = valid.sum()
    v, _ = torch.sort(torch.where(valid, values, torch.inf))
    rank = q / 100.0 * (n.to(torch.float32) - 1.0)
    lo, hi = torch.floor(rank), torch.ceil(rank)
    frac = rank - lo
    lo, hi = lo.long().clamp(min=0), hi.long().clamp(min=0)
    return v[lo] * (1.0 - frac) + v[hi] * frac


def hausdorff_device(result: torch.Tensor, reference: torch.Tensor,
                     spacing, connectivity: int = 1):
    """(hd, hd95) of two 2D binary masks, as fp32 0-dim tensors on the
    masks' device; NaN for both when either mask is empty.  ``spacing``:
    the (2,) voxel spacing (the caller passes ``spacing[[0, 2]]``, as the
    reference does)."""
    res, ref = result.bool(), reference.bool()
    sp = torch.as_tensor(spacing, dtype=torch.float32, device=res.device)
    s_res = _surface(res, connectivity)
    s_ref = _surface(ref, connectivity)
    d_to_ref = torch.sqrt(_masked_min_dist2(s_ref, sp[0], sp[1]))
    d_to_res = torch.sqrt(_masked_min_dist2(s_res, sp[0], sp[1]))
    v1, m1 = d_to_ref.reshape(-1), s_res.reshape(-1)
    v2, m2 = d_to_res.reshape(-1), s_ref.reshape(-1)
    hd = torch.maximum(torch.where(m1, v1, -torch.inf).max(),
                       torch.where(m2, v2, -torch.inf).max())
    hd95 = _percentile(torch.cat([v1, v2]), torch.cat([m1, m2]), 95.0)
    empty = (res.sum() == 0) | (ref.sum() == 0)
    nan = torch.full((), torch.nan, device=res.device)
    return torch.where(empty, nan, hd), torch.where(empty, nan, hd95)
