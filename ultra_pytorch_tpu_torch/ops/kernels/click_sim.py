"""K5: the PBM click sampler, a CUDA kernel for Hopper.

Port of the TPU kernel ``_kernel`` of ``ultra_pytorch_tpu/ops/pallas/
click_sim.py`` (entry ``pallas_sample_pbm_clicks``). The kernel
(``csrc/click_sim.cu``) draws one uniform per element with Philox4x32-10
written into the kernel and writes ``(u < probs) * mask``.

* :func:`pbm_clicks` is the wrapper: on a CPU tensor it runs
  :func:`pbm_clicks_reference`, the same Philox stream in int64 tensor ops
  (16-bit limbs for the 32 x 32 -> 64 products), so the kernel and its
  plain version give identical clicks; on a CUDA tensor it launches the
  kernel or raises.
* :func:`sample_pbm_clicks` is the feeds' entry: it draws the two key
  words from the caller's ``torch.Generator`` (on the labels' device, so
  no host round trip) and computes
  ``probs = exam^eta[min(pos, 9)] * click_prob[clip(grade)]``.
* :func:`clicks_from_uniform` is the comparison both versions share; the
  CPU tests feed it JAX's own uniforms.

Unlike the JAX feed, which used the jnp sampler off-TPU, the port has no
backend gate: ``use_pallas_click=true`` with PBM means K5 on CUDA and its
plain version on the CPU. With UBM or cascade both feeds sample with the
click model's own sampler.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ultra_pytorch_tpu_torch.ops.kernels import build

SOURCE = build.CSRC_DIR / "click_sim.cu"

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def clicks_from_uniform(probs: torch.Tensor, u: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """``(u < probs) * mask`` as float32 clicks."""
    return (u < probs).to(torch.float32) * mask


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product ``m * c`` for a
    constant ``m < 2^32`` and int64 ``c < 2^32``, without overflow."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    c_hi, c_lo = c >> 16, c & 0xFFFF
    p0 = m_lo * c_lo                 # < 2^32
    p1 = m_hi * c_lo + m_lo * c_hi   # < 2^33
    p2 = m_hi * c_hi                 # < 2^32
    mid = (p1 << 16) + p0            # < 2^50
    return (p2 + (mid >> 32)) & _MASK32, mid & _MASK32


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of int64 counters ``[n, 4]`` (words < 2^32) under the
    int64 key ``[2]``; returns ``[n, 4]`` int64 words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key[0], key[1]
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's n uniforms: counter i gives elements 4i .. 4i+3, each
    ``(word >> 8) * 2^-24``."""
    n_counters = (n + 3) // 4
    i = torch.arange(n_counters, dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(i)
    counter = torch.stack([i & _MASK32, i >> 32, zero, zero], dim=-1)
    words = philox4x32_10(counter, key.to(torch.int64)).reshape(-1)[:n]
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pbm_clicks_reference(probs: torch.Tensor, mask: torch.Tensor,
                         key: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5."""
    u = philox_uniform(key, probs.numel()).reshape(probs.shape)
    return clicks_from_uniform(probs, u, mask)


@functools.lru_cache(maxsize=None)
def _library():
    built = build.build_library("click_sim", [SOURCE])
    lib = ctypes.CDLL(str(built.path))
    ptr = ctypes.c_void_p
    lib.ultra_pbm_clicks.argtypes = [ptr] * 4 + [ctypes.c_longlong, ptr]
    lib.ultra_pbm_clicks.restype = ctypes.c_int
    lib.ultra_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ultra_cuda_error_string.restype = ctypes.c_char_p
    return lib, built


def build_kernel() -> build.BuiltLibrary:
    """Build (once per process) and load K5; returns the build record."""
    return _library()[1]


def pbm_clicks(probs: torch.Tensor, mask: torch.Tensor,
               key: torch.Tensor) -> torch.Tensor:
    """Clicks ``(u < probs) * mask`` with Philox uniforms under `key` (two
    int64 words < 2^32 on the probs' device)."""
    if probs.shape != mask.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != probs "
                         f"{tuple(probs.shape)}")
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError("key must be an int64 tensor of two words")
    if probs.device.type == "cpu":
        return pbm_clicks_reference(probs, mask, key)
    if probs.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {probs.device}")
    if mask.device != probs.device or key.device != probs.device:
        raise ValueError("probs, mask and key must share one device")
    probs = probs.float().contiguous()
    mask = mask.float().contiguous()
    key = key.contiguous()
    out = torch.empty_like(probs)
    if probs.numel():
        lib, _ = _library()
        with torch.cuda.device(probs.device):
            err = lib.ultra_pbm_clicks(
                probs.data_ptr(), mask.data_ptr(), key.data_ptr(),
                out.data_ptr(), probs.numel(),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K5 launch failed: "
                               f"{lib.ultra_cuda_error_string(err)} "
                               f"(CUDA error {err})")
        pbm_clicks.launches += 1
    return out


pbm_clicks.launches = 0  # kernel launches, for run-time evidence


def draw_key(generator: torch.Generator) -> torch.Tensor:
    """Two fresh 32-bit key words from `generator`, on its device."""
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=generator, device=generator.device)


def sample_pbm_clicks(model_params, generator: torch.Generator,
                      labels: torch.Tensor,
                      mask: torch.Tensor = None) -> torch.Tensor:
    """PBM clicks ``[..., L]`` through K5 (`model_params` is a
    ``sim.click_models.ClickModelParams``; a per-step eta ``[n]`` goes with
    labels ``[n, C, L]``)."""
    from ultra_pytorch_tpu_torch.sim.click_models import click_probs

    if model_params.model_name != "position_biased_model":
        raise ValueError("K5 samples PBM clicks only, got "
                         f"{model_params.model_name}")
    if mask is None:
        mask = torch.ones_like(labels)
    probs = click_probs(model_params, labels)
    return pbm_clicks(probs, mask.float(), draw_key(generator))
