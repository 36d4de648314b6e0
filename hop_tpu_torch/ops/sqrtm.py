"""Symmetric matrix square roots for the Fréchet distance, on the device
(port of hop_tpu/ops/sqrtm.py).

Replaces the reference's host round-trip through scipy.linalg.sqrtm
(reference model/EmbeddingSpaceEvaluator.py:576). The covariances are tiny
(32 x 32, or the expressive latent's width), so an eigendecomposition
(`torch.linalg.eigh`, a library call on matrices of that size) is exact
and cheap. Only eigenvalues and V diag(.) V^T are used, so the
eigenvectors' signs do not matter. f32, as hop_tpu's.
"""

from __future__ import annotations

import torch


def sqrtm_psd(mat: torch.Tensor) -> torch.Tensor:
    """Principal square root of a symmetric PSD matrix via eigh."""
    mat = 0.5 * (mat + mat.T)
    vals, vecs = torch.linalg.eigh(mat)
    vals = torch.sqrt(torch.clamp(vals, min=0.0))
    return (vecs * vals[None, :]) @ vecs.T


def trace_sqrtm_product(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """tr(sqrtm(sigma1 @ sigma2)) for symmetric PSD sigma1, sigma2.

    With A = sqrtm(sigma1), sqrtm(sigma1 sigma2) is similar to
    sqrtm(A sigma2 A), which is symmetric PSD: the same trace as scipy's
    general sqrtm of the (possibly non-symmetric) product, from two eigh
    calls.
    """
    a = sqrtm_psd(sigma1)
    inner = a @ sigma2 @ a
    inner = 0.5 * (inner + inner.T)
    vals = torch.linalg.eigvalsh(inner)
    return torch.sum(torch.sqrt(torch.clamp(vals, min=0.0)))


def frechet_distance(mu1: torch.Tensor, sigma1: torch.Tensor,
                     mu2: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """d^2 = ||mu1-mu2||^2 + tr(C1 + C2 - 2 sqrt(C1 C2)) (reference
    EmbeddingSpaceEvaluator.py:541-594, pytorch-fid's math), on the device."""
    diff = mu1 - mu2
    return (diff @ diff + torch.trace(sigma1) + torch.trace(sigma2)
            - 2.0 * trace_sqrtm_product(sigma1, sigma2))
