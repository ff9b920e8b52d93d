"""Differentiable SSIM and the training loss (clm_gs_tpu/ops/ssim.py:25-121).

11x11 Gaussian window (sigma 1.5), per-channel blur with zero 'same'
padding, C1 = 0.01^2, C2 = 0.03^2, mean over all pixels. The separable blur is
written as shifted-slice sums, as in the reference, and not as a convolution:
cuDNN would run a float32 convolution in TF32, which keeps about three digits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WINDOW_SIZE = 11
SIGMA = 1.5
LAMBDA_DSSIM = 0.2


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64) - window_size // 2
    g = np.exp(-(xs**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur_sep(x, window_size: int):
    """Separable Gaussian blur of (C, H, W): 11-tap shifted-slice sums along
    H, then along W (tap order and f32 math as in the reference)."""
    w = _gaussian_window(window_size, SIGMA)
    half = window_size // 2
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, half, half))
    x = sum(float(w[k]) * xp[:, k : k + H, :] for k in range(window_size))
    xp = F.pad(x, (half, half))
    return sum(float(w[k]) * xp[:, :, k : k + W] for k in range(window_size))


def _ssim_map(img, gt, window_size: int):
    stacked = torch.cat([img, gt, img * img, gt * gt, img * gt], dim=0)
    c = img.shape[0]
    b = _blur_sep(stacked, window_size)
    mu1, mu2 = b[0:c], b[c : 2 * c]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = b[2 * c : 3 * c] - mu1_sq
    sigma2_sq = b[3 * c : 4 * c] - mu2_sq
    sigma12 = b[4 * c : 5 * c] - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def ssim(img, gt, window_size: int = WINDOW_SIZE):
    """img, gt: (3, H, W) in [0,1]. Returns scalar mean SSIM."""
    return torch.mean(_ssim_map(img, gt, window_size))


def l1_loss(img, gt):
    return torch.mean(torch.abs(img - gt))


def combined_loss(image, image_gt, lambda_dssim: float = LAMBDA_DSSIM):
    """(1-l) L1 + l (1 - SSIM), the training loss."""
    return (1.0 - lambda_dssim) * l1_loss(image, image_gt) + lambda_dssim * (
        1.0 - ssim(image, image_gt)
    )


def combined_loss_batch(images, gts, lambda_dssim: float = LAMBDA_DSSIM):
    """(B,) per-camera combined losses of a (B, 3, H, W) batch, one blur pass."""
    Bc, c, Hh, Ww = images.shape
    m = _ssim_map(
        images.reshape(Bc * c, Hh, Ww), gts.reshape(Bc * c, Hh, Ww), WINDOW_SIZE
    )
    ssim_b = torch.mean(m.reshape(Bc, c, Hh, Ww), dim=(1, 2, 3))
    l1_b = torch.mean(torch.abs(images - gts), dim=(1, 2, 3))
    return (1.0 - lambda_dssim) * l1_b + lambda_dssim * (1.0 - ssim_b)


def l1_loss_pixelwise_masked(img, gt, mask):
    """Masked L1: the mean of |img - gt| over the (H, W) mask's pixels."""
    diff = torch.abs(img - gt) * mask
    return torch.sum(diff) / torch.clamp_min(torch.sum(mask) * img.shape[0], 1.0)


def ssim_masked(img, gt, mask, window_size: int = WINDOW_SIZE):
    """Masked SSIM: the mean of the SSIM map over the mask's pixels."""
    m = _ssim_map(img, gt, window_size)
    return torch.sum(m * mask) / torch.clamp_min(torch.sum(mask) * img.shape[0], 1.0)


def pixelwise_l1_with_mask(img, gt, mask):
    """The (3, H, W) map of |img - gt|, zero outside the (H, W) mask."""
    return torch.abs(img - gt) * mask[None, :, :]


def pixelwise_ssim_with_mask(img, gt, mask, window_size: int = WINDOW_SIZE):
    """The per-pixel SSIM map, zero outside the (H, W) mask."""
    return _ssim_map(img, gt, window_size) * mask[None, :, :]
