"""Masked statistics (mean, median, quantile) over tensors.

The JAX package's sort-and-index rules on a filled tensor, in PyTorch:
invalid elements are filled with the dtype's largest finite value before
the sort, the median is the LOWER middle element (index (n-1)//2 of the
sorted valid values, torch.nanmedian's rule), and a slice with no valid
element gives NaN.
"""
from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None,
                keepdims: bool = False) -> torch.Tensor:
    """Mean of x where mask. Zero valid elements -> NaN, as `x[mask].mean()`
    gives on an empty selection."""
    m = mask.to(x.dtype)
    if axis is None:
        num, den = (x * m).sum(), m.sum()
        if keepdims:
            num, den = num.reshape([1] * x.dim()), den.reshape([1] * x.dim())
    else:
        num = (x * m).sum(dim=axis, keepdim=keepdims)
        den = m.sum(dim=axis, keepdim=keepdims)
    return torch.where(den > 0, num / den.clamp(min=1e-8),
                       torch.full_like(num, float("nan")))


def _sorted_filled(x: torch.Tensor, mask: torch.Tensor, axis: int):
    big = torch.finfo(x.dtype).max
    filled = torch.where(mask, x, torch.full_like(x, big))
    return torch.sort(filled, dim=axis).values


def _take(srt: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.take_along_dim(srt, idx.unsqueeze(axis).long(),
                                dim=axis).squeeze(axis)


def masked_median(x: torch.Tensor, mask: torch.Tensor,
                  axis: int = -1) -> torch.Tensor:
    """Median of x where mask, along `axis` (torch.nanmedian semantics); a
    slice with zero valid elements gives NaN."""
    srt = _sorted_filled(x, mask, axis)
    n_valid = mask.sum(dim=axis).to(torch.int32)
    idx = ((n_valid - 1) // 2).clamp(min=0)
    med = _take(srt, idx, axis)
    return torch.where(n_valid > 0, med, torch.full_like(med, float("nan")))


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float,
                    axis: int = -1) -> torch.Tensor:
    """Linear-interpolated quantile of the masked values
    (torch.nanquantile); a slice with zero valid elements gives NaN."""
    srt = _sorted_filled(x, mask, axis)
    n_valid = mask.sum(dim=axis).to(torch.float32)
    pos = q * (n_valid - 1.0)
    lo = torch.floor(pos).clamp(min=0).to(torch.int32)
    hi = torch.ceil(pos).clamp(min=0).to(torch.int32)
    frac = (pos - lo.to(torch.float32)).to(x.dtype)
    v_lo, v_hi = _take(srt, lo, axis), _take(srt, hi, axis)
    out = v_lo + (v_hi - v_lo) * frac
    return torch.where(n_valid > 0, out, torch.full_like(out, float("nan")))
