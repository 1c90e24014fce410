"""Null Space Gradient Descent (NSGD).

The port's counterpart of the JAX package's ``algorithms/nsgd.py`` (Wang
et al., SIGIR'18): MGD whose noise lies in the null space of the last
step's losing noises. The memory ``aux = {"bad_noise": [...]}`` holds, a
``jax_leaves()`` entry each, the R noises of the last step in the JAX
layout (a leading R axis, a Linear weight as ``[R, in, out]``), zero for
the rankers that won, so the checkpoints of both packages carry it
alike.

Each perturbed leaf is factored once a step (``torch.linalg.svd``,
``full_matrices=False``, of its ``[R, size]`` memory); the right-singular
vectors whose singular value is at most 1e-6 span the null space, and
each of the R noises is a normalised random combination of them (one
``torch.randn`` of ``[R, R]`` a leaf, in leaf order). A leaf of one
element is a random sign. Which basis spans a null space of dimension
above 0 is up to the SVD's implementation (LAPACK, XLA and cuSOLVER
differ), so only the sampler's properties carry across packages; the
step given its noises is the same.
"""

from __future__ import annotations

import torch

from ultra_pytorch_tpu_torch.algorithms.mgd import MGD
from ultra_pytorch_tpu_torch.models import base as model_base
from ultra_pytorch_tpu_torch.utils.registry import register

SV_TOL = 1e-6


def null_space_sample(generator: torch.Generator, bad: torch.Tensor
                      ) -> torch.Tensor:
    """R unit noises ``[R, *shape]`` in the null space of the memory
    ``bad [R, *shape]`` (each row normalised over the leaf)."""
    R = bad.shape[0]
    if bad[0].numel() <= 1:
        vec = torch.randn(bad.shape, generator=generator, device=bad.device)
    else:
        _, s, vh = torch.linalg.svd(bad.reshape(R, -1), full_matrices=False)
        null = vh * (s <= SV_TOL).to(vh.dtype)[:, None]
        n = torch.randn((R, s.shape[0]), generator=generator,
                        device=bad.device)
        vec = (n @ null).reshape(bad.shape)
    norm = torch.sqrt(torch.sum(vec.reshape(R, -1) ** 2, dim=1)
                      .clamp_min(1e-12))
    return vec / norm.view((R,) + (1,) * (vec.dim() - 1))


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
        noises = []
        for (t, transposed), noisy, bad in zip(
                state.params.jax_leaves(), model_base.noise_spec(
                    state.params), state.aux["bad_noise"]):
            if noisy:
                noises.append(_jax_layout(null_space_sample(generator, bad),
                                          transposed))
            else:
                noises.append(torch.zeros((self.ranker_num,) + t.shape,
                                          device=t.device))
        return noises

    def updated_aux(self, state, noises, win_totals):
        loser = (win_totals[1:] == 0).float()
        bad = []
        for (_, transposed), n in zip(state.params.jax_leaves(), noises):
            flags = loser.view((-1,) + (1,) * (n.dim() - 1))
            bad.append(_jax_layout(n, transposed) * flags)
        return {"bad_noise": bad}
