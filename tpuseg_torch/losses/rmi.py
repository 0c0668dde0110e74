"""Region Mutual Information loss in float32.

Port of ``tpuseg/losses/rmi.py:38-181`` (reference: loss/rmi.py,
loss/rmi_utils.py; RMI paper arXiv:1910.12037), with ``tpuseg``'s f32
formulation as it is:

  loss = 0.5 * BCE(logits, onehot(valid labels))
       + 0.5 * sum_c mean_b [ 0.5 * logdet(Sigma_y|p) / half_d ]

over d = r*r = 9 dimensional pixel-neighbourhood vectors after a 4x4
average-pool downsample, per class and image. The reference runs the
covariance / Cholesky chain in float64; ``tpuseg`` reformulated it for f32
(covariances at unit scale with the log-det compensated by ``d*log(N)``,
jitter floors ``a_pr = max(pos_alpha/N, 1e-4)`` and ``a_va = pos_alpha/N``,
a rescue refactorisation of matrices that are not positive definite), and
the port computes the same f32 result. A float64 variant would compute
something ``tpuseg`` does not (ROADMAP Queue 3).

``torch.linalg.cholesky`` raises on a matrix that is not positive definite
where ``jnp.linalg.cholesky`` returns NaN, so the factorisations use
``cholesky_ex`` and flag a matrix by its ``info`` or a non-finite factor.
Nothing here reads a device value on the host.

On bands (dp x sp, ``parallel/spatial.py``) the pooled rows do not split
evenly (a 1024-row crop pools to 257 rows, and the window of pooled row
128 straddles the band boundary at row 512). Each pooled row belongs to
the band holding its window's first row (the top band also takes the
window that starts in the padding); each neighbourhood vector to the
band of its first pooled row. A band pools the input rows those vectors
read, halo included, so the pooled rows next to a boundary are computed
from the same pixels as in one process. The ownership and the rows of
vectors count the image's true rows: a band's padding rows read as the
pool's padding past the image's bottom edge (zeros, -inf for the max
pool). The means and the three 9x9 covariances are sums over the sp
group, and the Cholesky chain then runs alike on every rank of the group
(``spatial``'s gradient convention).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpuseg_torch.ops import upcast
from tpuseg_torch.ops.resize import avg_pool2d, max_pool2d
from tpuseg_torch.parallel import global_sum, process_count, spatial

_CLIP_MIN = 1e-6      # post-sigmoid clip (reference: rmi.py:11)
_POS_ALPHA = 5e-4     # diagonal jitter for PD-ness (reference: rmi.py:12)


def _neighborhood_vectors(x: torch.Tensor, radius: int) -> torch.Tensor:
    """The r*r shifted views (reference map_get_pairs: rmi_utils.py:15-56).
    x (B, C, H, W) -> (B, C, r*r, (H-r+1)*(W-r+1))."""
    b, c, h, w = x.shape
    nh, nw = h - radius + 1, w - radius + 1
    v = torch.stack([x[:, :, y:y + nh, xx:xx + nw]
                     for y in range(radius) for xx in range(radius)], dim=2)
    return v.reshape(b, c, radius * radius, nh * nw)


def _pooled(onehot: torch.Tensor, probs: torch.Tensor, pool_size: int,
            pool_way: str, radius: int):
    """The pooled maps (NCHW, f32) whose neighbourhood vectors this rank
    sums, and the image's rows of vectors: on bands, the pooled rows of
    the band's own vectors (see the module docstring)."""
    pad = pool_size // 2 if pool_size > 1 else 0
    bands = spatial.active()
    if bands is None:
        if pool_size > 1:
            pool = avg_pool2d if pool_way == "avg" else max_pool2d
            onehot = pool(onehot, pool_size, pool_size, pad)
            probs = pool(probs, pool_size, pool_size, pad)
        return onehot, probs, onehot.shape[2] - radius + 1
    k = max(pool_size, 1)
    h = onehot.shape[2]
    total = spatial.global_height(onehot)
    n_rows = spatial.window_rows(total, k, k, pad) - radius + 1

    def owner(i):  # the band of pooled row i's first input row
        return min(max(k * i - pad, 0), total - 1) // h

    needs = []
    for b in range(bands.size):
        rows = [j for j in range(n_rows) if owner(j) == b]
        j0, j1 = (rows[0], rows[-1] + 1) if rows else (0, 0)
        # the input rows of pooled rows [j0, j1 + radius - 1)
        needs.append((k * j0 - pad, k * (j1 + radius - 1) - pad))
    both = spatial.gather_rows(torch.cat([onehot, probs], dim=1), needs)
    if pool_size > 1:
        if pool_way == "avg":
            both = F.avg_pool2d(both, k, k, (0, pad), count_include_pad=True)
        else:
            # rows past the image are the pool's padding
            lo, hi = needs[bands.index]
            rows = torch.arange(lo, hi, device=both.device).view(1, 1, -1, 1)
            both = F.max_pool2d(both.masked_fill(
                (rows < 0) | (rows >= total), float("-inf")), k, k, (0, pad))
    c = onehot.shape[1]
    return both[:, :c], both[:, c:], n_rows


def _safe_cholesky(m: torch.Tensor, eye: torch.Tensor, jitter: float,
                   rescue: float = 1e-2) -> torch.Tensor:
    """Cholesky factor of ``m + jitter*I``; a matrix whose first
    factorisation fails is refactored as ``m + rescue*I`` instead. The
    predicate carries no gradient, and the rescued INPUT is substituted
    before the differentiated factorisation, so no NaN reaches the
    backward pass (``tpuseg/losses/rmi.py:59-71``)."""
    a = m + eye * jitter
    with torch.no_grad():
        first, info = torch.linalg.cholesky_ex(a)
        bad = (info > 0) | ~torch.isfinite(first).all(dim=-1).all(dim=-1)
    a = torch.where(bad[..., None, None], m + eye * rescue, a)
    return torch.linalg.cholesky_ex(a).L


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Sum-reduced masked binary CE with logits (reference: rmi.py:103-114),
    as ``max(x, 0) - x*t + log(1 + exp(-|x|))``."""
    per = logits.clamp_min(0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    return (per * mask[..., None]).sum()


def rmi_loss(logits: torch.Tensor, labels: torch.Tensor,
             num_classes: int | None = None, ignore_label: int = 255,
             radius: int = 3, pool_size: int = 4, pool_way: str = "avg",
             weight_lambda: float = 0.5, do_rmi: bool = True,
             pos_alpha: float = _POS_ALPHA,
             data_parallel: bool = False) -> torch.Tensor:
    """RMI loss (reference forward_sigmoid: loss/rmi.py:82-134).

    logits (B, H, W, C), labels (B, H, W) int; pixels outside [0, C) are
    ignored. ``do_rmi=False`` returns only the BCE part (the aux loss,
    reference: ocrnet.py:302-308). With ``data_parallel`` the BCE divides
    by the global batch's valid pixels + 1, times the number of ranks
    (``losses/ce.py``); the RMI term, a mean over the batch, is averaged
    across ranks by DDP as it is."""
    num_classes = num_classes or logits.shape[-1]
    half_d = radius * radius
    logits = upcast(logits)
    labels = labels.long()

    valid = (labels >= 0) & (labels < num_classes)
    validf = valid.to(logits.dtype)
    onehot = F.one_hot(torch.where(valid, labels, torch.zeros_like(labels)),
                       num_classes).to(logits.dtype) * validf[..., None]
    world = process_count() if data_parallel else 1
    valid_pixels = validf.sum() if world == 1 else global_sum(validf.sum())
    bce = _bce_with_logits(logits, onehot, validf) * world / (
        valid_pixels + 1.0)
    if not do_rmi:
        return bce

    probs = torch.sigmoid(logits) * validf[..., None] + _CLIP_MIN
    # NCHW views for the pools (reference: rmi.py:148-163)
    onehot, probs = onehot.permute(0, 3, 1, 2), probs.permute(0, 3, 1, 2)
    if pool_way not in ("avg", "max"):
        raise ValueError(pool_way)
    onehot, probs, n_rows = _pooled(onehot, probs, pool_size, pool_way,
                                    radius)

    la = _neighborhood_vectors(onehot, radius).detach()   # (B, C, d, N)
    pr = _neighborhood_vectors(probs, radius)
    n = n_rows * (onehot.shape[-1] - radius + 1)          # the image's N
    inv_n = 1.0 / n
    if spatial.active() is None:
        la = la - la.mean(dim=3, keepdim=True)
        pr = pr - pr.mean(dim=3, keepdim=True)
    else:
        d = la.shape[2]
        means = spatial.band_sum(torch.cat(
            [la.sum(dim=3, keepdim=True), pr.sum(dim=3, keepdim=True)],
            dim=2)) * inv_n
        la, pr = la - means[:, :, :d], pr - means[:, :, d:]

    # unit-scale covariances: logdet(S + aI) = d*log(N) + logdet(S/N +
    # (a/N)I); tpuseg/losses/rmi.py:139-166 derives the jitter floors
    covs = torch.stack([la @ la.transpose(2, 3), pr @ pr.transpose(2, 3),
                        la @ pr.transpose(2, 3)])
    la_cov, pr_cov, la_pr_cov = spatial.band_sum(covs) * inv_n

    eye = torch.eye(half_d, dtype=logits.dtype, device=logits.device)
    a_pr = max(pos_alpha / n, 1e-4)
    a_va = pos_alpha / n
    chol_pr = _safe_cholesky(pr_cov, eye, a_pr)
    sol = torch.cholesky_solve(la_pr_cov.transpose(2, 3), chol_pr,
                               upper=False)
    appro_var = la_cov - la_pr_cov @ sol

    chol = _safe_cholesky(appro_var, eye, a_va)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.log(diag + 1e-8).sum(dim=-1) + half_d * math.log(n)

    rmi = ((0.5 * logdet).mean(dim=0) / float(half_d)).sum()
    # lambda_way=1 (reference: rmi.py:129-130)
    return weight_lambda * bce + (1.0 - weight_lambda) * rmi
