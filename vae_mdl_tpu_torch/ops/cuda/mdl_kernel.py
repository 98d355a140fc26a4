"""Hand-written CUDA kernel: mixture-of-discretized-logistics log-prob forward.

Port of the Pallas forward kernels in ``vae_mdl_tpu/ops/pallas/mdl_kernel.py``
(``_forward``, ``_forward_bl``, ``_forward_bl_split``, ``_forward_bl_kgrid``):
one kernel, ``csrc/mdl_log_prob.cu``, that reads the head's output where it
lies. The source's header says what bounds it and how it is laid out.

- ``mdl_log_prob(x01, parameters)`` is the drop-in for
  ``distributions.mixture.mixture_log_prob``: CPU tensors take that plain
  version, CUDA tensors launch the kernel (``mdl_log_prob_cuda``), which
  raises on anything it does not take. There is no fallback between them.
- The library is built with ``nvcc`` for ``sm_90a`` at first use into
  ``vae_mdl_tpu_torch/_build/`` (keyed by a hash of the source and flags) and
  loaded with ``ctypes``; nothing is built or loaded at import.
- ``launches`` counts kernel launches; callers reset it to 0 and read it to
  show that a run went through the kernel.
- The backward kernel is not ported yet: differentiating through the kernel
  raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from vae_mdl_tpu_torch.distributions.mixture import mixture_log_prob

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE = _PACKAGE / "csrc" / "mdl_log_prob.cu"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fast math, no mul+add contraction: the kernel rounds as the plain
    # version's elementwise ops do (see the source's header)
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_MIX = 10

# kernel launches since the counter was last set to 0
launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the MoDL kernel is "
            "built from csrc/mdl_log_prob.cu with the CUDA toolkit")
    return path


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"mdl_log_prob-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this exact build exists; returns
    its path. The compiler's register/spill report goes beside it as
    ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _forward_fn():
    fn = ctypes.CDLL(str(build())).mdl_log_prob_forward
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_int64] * 13 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x01: torch.Tensor, parameters: torch.Tensor) -> None:
    if not (x01.is_cuda and parameters.is_cuda):
        raise ValueError(
            "the MoDL kernel takes CUDA tensors only; got x on "
            f"{x01.device} and parameters on {parameters.device}")
    if x01.device != parameters.device:
        raise ValueError(f"x on {x01.device}, parameters on {parameters.device}")
    if x01.dtype != torch.float32:
        raise TypeError(f"x must be float32 in [0, 1]; got {x01.dtype}")
    if parameters.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"parameters must be float32 or bfloat16; got {parameters.dtype}")
    if x01.dim() != 4 or x01.shape[-1] != 3:
        raise ValueError(f"x must be [B, H, W, 3]; got {tuple(x01.shape)}")
    if parameters.dim() != 5:
        raise ValueError(f"parameters must be [k, B, H, W, 10n]; got {tuple(parameters.shape)}")
    c = parameters.shape[-1]
    if c % 10 or not 1 <= c // 10 <= MAX_MIX:
        raise ValueError(f"parameters need 10 * n_mix channels, 1 <= n_mix <= {MAX_MIX}; got {c}")
    if tuple(parameters.shape[1:4]) != tuple(x01.shape[:3]):
        raise ValueError(
            f"parameters' [B, H, W] {tuple(parameters.shape[1:4])} do not "
            f"match x's {tuple(x01.shape[:3])}")


def _launch(x01: torch.Tensor, parameters: torch.Tensor) -> torch.Tensor:
    global launches
    _check(x01, parameters)
    k, b, h, w, c = parameters.shape
    out = torch.empty((k, b, h, w), device=parameters.device, dtype=torch.float32)
    if out.numel():
        with torch.cuda.device(parameters.device):
            err = _forward_fn()(
                x01.data_ptr(), parameters.data_ptr(), out.data_ptr(),
                int(parameters.dtype == torch.bfloat16), c // 10,
                k, b, h, w, *x01.stride(), *parameters.stride(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mdl_log_prob kernel launch failed: CUDA error {err}")
        launches += 1
    return out.unsqueeze(-1)


class _MDLLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x01, parameters):
        return _launch(x01, parameters)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the MoDL log-prob backward kernel is not ported yet (ROADMAP.md, "
            "Queue 2 item 1: the backward kernel covering K1b/K2b/K3b/K4b); "
            "use use_pallas=False to differentiate through the plain version")


def mdl_log_prob_cuda(x01: torch.Tensor, parameters: torch.Tensor) -> torch.Tensor:
    """The kernel: x ``[B, H, W, 3]`` float32 in [0, 1], parameters
    ``[k, B, H, W, 10n]`` float32 or bfloat16, any strides, on one CUDA
    device -> ``[k, B, H, W, 1]`` float32."""
    return _MDLLogProb.apply(x01, parameters)


def mdl_log_prob(x01: torch.Tensor, parameters: torch.Tensor) -> torch.Tensor:
    """Per-pixel MoDL log-prob ``[..., H, W, 1]``: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if x01.device.type == "cpu" and parameters.device.type == "cpu":
        return mixture_log_prob(x01, parameters.float())
    return mdl_log_prob_cuda(x01, parameters)
