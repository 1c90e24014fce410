"""Null Space Gradient Descent (NSGD).

The port's counterpart of the JAX package's ``algorithms/nsgd.py`` (Wang
et al., SIGIR'18): MGD whose noise lies in the null space of the last
step's losing noises. The memory ``aux = {"bad_noise": [...]}`` holds, a
``jax_leaves()`` entry each, the R noises of the last step in the JAX
layout (a leading R axis, a Linear weight as ``[R, in, out]``), zero for
the rankers that won, so the checkpoints of both packages carry it
alike.

Each perturbed leaf's null basis comes from a masked Gram-Schmidt over
its ``[R, size]`` memory, then over the standard basis vectors ``e_0 ...
e_{2R-1}``: a vector is kept where its residual norm exceeds the
tolerance, by ``torch.where``, never by a branch on a device value. The
Gram-Schmidt runs in Gram space: on the ``[3R, 3R]`` float64 Gram matrix
of those vectors, for every perturbed leaf at once, and gives each basis vector as coefficients of the memory rows and the
``e_i``; one product a leaf then forms its noises. With ``k = min(R,
size)`` and r the memory rows kept (its rank), the first ``k - r`` kept
basis vectors span the null part, and each of the R noises is a
normalised random combination of them (one ``torch.randn`` of ``[R, k]``
a leaf, in leaf order, as the SVD's ``k`` right-singular vectors would
take). A leaf of one element is a random sign. The JAX package takes the
right-singular vectors of the SVD whose singular value is at most 1e-6; a
null space of dimension above 0 has no one basis (LAPACK, XLA and
cuSOLVER differ), so only the sampler's properties carry across
packages: at an all-zero memory the basis is ``e_0 ... e_{k-1}``, as
every SVD gives; each noise has unit norm and is orthogonal to the
stored rows; the span has dimension ``k - rank``. The step given its
noises is the same. The sampler is a fixed sequence of device ops with
no host read (cuSOLVER's SVD checks its convergence on the host), so a
window holds it as a CUDA graph.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ultra_pytorch_tpu_torch.algorithms.mgd import MGD
from ultra_pytorch_tpu_torch.models import base as model_base
from ultra_pytorch_tpu_torch.utils.registry import register

SV_TOL = 1e-6   # the JAX sampler's singular-value tolerance
# A Gram-Schmidt residual counts as zero at or below this share of its
# vector's norm (and at or below SV_TOL): a dependent float32 row keeps a
# residual near 1e-7 of its norm, an independent one most of it. The Gram
# matrix is float64 because float32 squared norms would blur residuals
# below ~3e-4 of the norm.
REL_TOL = 1e-4


def _gram(memories: List[torch.Tensor]) -> torch.Tensor:
    """``[P, 3R, 3R]`` float64: for each memory ``[R, D]`` the Gram matrix
    of its R rows and the standard basis vectors ``e_0 ... e_{2R-1}`` of
    its leaf; an ``e_i`` past the leaf's size is a zero vector."""
    R = memories[0].shape[0]
    top = []
    for m in memories:
        m = m.double()
        n_e = min(2 * R, m.shape[1])
        row = torch.cat([m @ m.t(), m[:, :n_e]], dim=1)
        top.append(row if n_e == 2 * R else F.pad(row, (0, 2 * R - n_e)))
    top = torch.stack(top)                                  # [P, R, 3R]
    eye = torch.eye(2 * R, dtype=top.dtype, device=top.device)
    lower = torch.cat([top[:, :, R:].mT,
                       eye.expand(len(memories), -1, -1)], dim=2)
    gram = torch.cat([top, lower], dim=1)
    for p, m in enumerate(memories):
        if m.shape[1] < 2 * R:   # a leaf of fewer than 2R elements
            gram[p, R + m.shape[1]:, R + m.shape[1]:] = 0.0
    return gram


def _masked_gram_schmidt(gram: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classical Gram-Schmidt in Gram space over the vectors whose Gram
    matrices are ``gram [P, n, n]``, in order, each orthogonalised against
    the vectors kept before it: (``[P, n, n]`` each kept vector's unit
    residual as coefficients of the n vectors, zero for the others;
    ``[P, n]`` bool whether its residual norm exceeds the tolerance). One
    pass does in float64: it loses orthogonality as eps times the squared
    condition, which the tolerance keeps below 1e8."""
    P, n, _ = gram.shape
    diag = torch.diagonal(gram, dim1=1, dim2=2)[..., None, None]
    tols = (REL_TOL ** 2 * diag).clamp_min(SV_TOL ** 2)    # squared norms
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    coef = torch.zeros_like(gram)
    kept = []
    for j in range(n):
        g = gram[:, :, j:j + 1]                            # gram @ e_j
        if j:   # c = e_j - sum_i <q_i, e_j> q_i over the kept q_i
            c = torch.baddbmm(eye[:, j:j + 1], coef.mT, coef @ g, alpha=-1)
            sq = c.mT @ (gram @ c)
        else:
            c, sq = eye[:, :1].expand(P, n, 1), g[:, :1]
        keep = sq > tols[:, j]
        torch.mul(c.mT, torch.where(keep, sq.rsqrt(), 0.0),
                  out=coef[:, j:j + 1])
        kept.append(keep)
    return coef, torch.cat(kept, dim=1)[:, :, 0]


def _null_coefficients(gram: torch.Tensor) -> torch.Tensor:
    """``[P, R, 3R]``: row s of leaf p the coefficients (over its memory
    rows and ``e_i``) of its s-th kept ``e_i`` residual while s < R -
    rank, else zero. A leaf of D < R elements keeps only D - rank
    residuals, so R - rank bounds every leaf."""
    R = gram.shape[1] // 3
    coef, kept = _masked_gram_schmidt(gram)
    rank = kept[:, :R].sum(dim=1)
    kept_e = kept[:, R:]
    order = torch.cumsum(kept_e.long(), dim=1)       # 1 for the first kept
    slot = torch.arange(1, R + 1, device=gram.device)[None, :, None]
    take = ((order[:, None, :] == slot) & kept_e[:, None, :]
            & (slot <= R - rank[:, None, None]))
    return take.to(gram.dtype) @ coef[:, R:]


def _combine(coef: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """``[rows, D]``: the combinations ``coef [rows, 3R]`` of the memory's
    rows ``[R, D]`` and the ``e_i``."""
    R, D = memory.shape
    n_e = min(2 * R, D)
    out = coef[:, :R] @ memory
    out[:, :n_e] += coef[:, R:R + n_e]
    return out


def null_basis(bad: torch.Tensor) -> torch.Tensor:
    """``[k, D]`` for a memory ``bad [R, D]``, ``k = min(R, D)``: its
    first ``k - rank`` rows an orthonormal basis of standard basis
    vectors' residuals orthogonal to the memory, the rest zero."""
    R, D = bad.shape
    coef = _null_coefficients(_gram([bad]))[0, :min(R, D)]
    return _combine(coef.to(bad.dtype), bad)


def null_space_samples(generator: torch.Generator,
                       memories: List[torch.Tensor]) -> List[torch.Tensor]:
    """For each memory ``[R, *shape]``, R unit noises of its shape in the
    null space of its rows (each normalised over the leaf). The normals
    are drawn a leaf at a time, in order; the bases of all leaves of more
    than one element come from one batched Gram-space Gram-Schmidt."""
    if not memories:
        return []
    R = memories[0].shape[0]
    normals = []
    for bad in memories:
        size = bad[0].numel()
        shape = bad.shape if size <= 1 else (R, min(R, size))
        normals.append(torch.randn(shape, generator=generator,
                                   device=bad.device))
    wide = [i for i, bad in enumerate(memories) if bad[0].numel() > 1]
    out = [n if i in wide else n / torch.sqrt((n * n).clamp_min(1e-12))
           for i, n in enumerate(normals)]
    if not wide:
        return out
    flat = [memories[i].reshape(R, -1) for i in wide]
    gram = _gram(flat)
    mix = torch.stack([normals[i] if normals[i].shape[1] == R
                       else F.pad(normals[i], (0, R - normals[i].shape[1]))
                       for i in wide]).double()
    coef = mix @ _null_coefficients(gram)                   # [P, R, 3R]
    sq = torch.sum((coef @ gram) * coef, dim=2, keepdim=True)
    coef = (coef * sq.clamp_min(1e-12).rsqrt()).to(flat[0].dtype)
    for p, (i, m) in enumerate(zip(wide, flat)):
        out[i] = _combine(coef[p], m).reshape(memories[i].shape)
    return out


def null_space_sample(generator: torch.Generator, bad: torch.Tensor
                      ) -> torch.Tensor:
    """R unit noises ``[R, *shape]`` in the null space of the memory
    ``bad [R, *shape]`` (each row normalised over the leaf)."""
    return null_space_samples(generator, [bad])[0]


def _jax_layout(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    """A leaf with a leading axis between the ranker's layout and JAX's
    (a transpose of the last two axes is its own inverse)."""
    return t.transpose(-1, -2).contiguous() if transposed else t


@register("algorithm", "NSGD", aliases=["ultra.learning_algorithm.NSGD"])
class NSGD(MGD):

    name = "nsgd"

    def init_state(self, generator):
        state = super().init_state(generator)
        R = self.ranker_num
        state.aux = {"bad_noise": [
            torch.zeros((R,) + (t.shape[::-1] if transposed else t.shape),
                        device=t.device)
            for t, transposed in state.params.jax_leaves()]}
        return state

    def sample_noises(self, state, generator):
        spec = model_base.noise_spec(state.params)
        sampled = iter(null_space_samples(generator, [
            bad for bad, noisy in zip(state.aux["bad_noise"], spec)
            if noisy]))
        return [_jax_layout(next(sampled), transposed) if noisy
                else torch.zeros((self.ranker_num,) + t.shape,
                                 device=t.device)
                for (t, transposed), noisy in zip(
                    state.params.jax_leaves(), spec)]

    def updated_aux(self, state, noises, win_totals):
        loser = (win_totals[1:] == 0).float()
        bad = []
        for (_, transposed), n in zip(state.params.jax_leaves(), noises):
            flags = loser.view((-1,) + (1,) * (n.dim() - 1))
            bad.append(_jax_layout(n, transposed) * flags)
        return {"bad_noise": bad}
