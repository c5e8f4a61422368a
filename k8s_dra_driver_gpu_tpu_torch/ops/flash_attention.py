"""Flash-attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

``flash_attention`` computes what the TPU kernel ``_flash_kernel``
(k8s_dra_driver_gpu_tpu/ops/flash_attention.py:40-101) computes, in the
same ``[B, S, H, hd]`` / ``[B, S, K, hd]`` layout: causal or non-causal
GQA attention with an online softmax, scores in fp32 scaled after the
product, masked scores at -1e30, p cast to the input type before the P.V
product, the normaliser clamped at 1e-30, and optionally the logsumexp
``lse = m + log l`` (``[B, H, S]`` fp32) that a backward would need.

On a CUDA tensor the wrapper launches ``csrc/flash_fwd.cu`` (built for
sm_90a at first use) or raises; there is no fallback. On a CPU tensor it
computes ``flash_attention_reference``, the same function written as
plain tensor code, which the CPU tests hold against the JAX kernel in
interpret mode and which the card's smoke run holds the kernel against.

Bound on an H100 SXM at the serving shape (B=4, S=2048, H=32, K=8,
hd=128, causal, bf16): ~137 GFLOP at 989 TFLOP/s = 0.14 ms against
~168 MB of Q/K/V/O at 3.35 TB/s = 0.05 ms, so compute-bound. The kernel's
design (mma.sync tiles for bf16, scalar FMA for fp32, no load/compute
overlap yet) is described at the top of the CUDA source.

Training's backward kernels (``_flash_dq_kernel``, ``_flash_dkv_kernel``)
are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_Q_TILES = 65_535  # the grid's y extent; tiles are 32 rows or more


def _scale(hd: int) -> float:
    return 1.0 / hd ** 0.5


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q [B,S,H,hd] and k, v [B,S,K,hd]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"q heads ({H}) not a multiple of kv heads "
                         f"({k.shape[2]})")


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    causal: bool = True,
    with_lse: bool = False,
):
    """The kernel's function as plain tensor code: the whole score
    matrix at once instead of an online softmax over tiles."""
    _check_shapes(q, k, v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * _scale(hd)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskh->bkgqh", p.to(q.dtype).float(), v.float())
    out = (o / l_safe).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    out = out.to(q.dtype)
    if not with_lse:
        return out
    return out, (m + torch.log(l_safe)).reshape(B, H, S)


def _kernel() -> ctypes.CDLL:
    lib = _build.load("flash_fwd").lib
    if lib.flash_fwd.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # Every pointer and the stream as c_void_p: a bare Python int
        # would be passed as a 32-bit C int and cut the address.
        lib.flash_fwd.argtypes = (
            [ptr] * 5 + [i32] * 6 + [i64] * 12 + [i32, ctypes.c_float, ptr])
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    tensors = (q, k, v)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"flash kernel takes bf16 or fp32 q/k/v of one "
                         f"dtype; got {[str(t.dtype) for t in tensors]}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}; got {hd}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash kernel needs a contiguous head dim")
    if -(-q.shape[1] // 32) > _MAX_Q_TILES:
        raise ValueError(f"sequence length {q.shape[1]} too long for one launch")
    if q.dtype == torch.bfloat16:
        # The bf16 kernel stages rows with 16-byte loads.
        for t in tensors:
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError("bf16 flash kernel needs 16-byte aligned "
                                 "rows (pointer and strides)")


def flash_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    causal: bool = True,
    with_lse: bool = False,
):
    """Returns ``out`` [B, S, H, hd] in q's dtype, or ``(out, lse)`` with
    ``lse`` [B, H, S] fp32 when ``with_lse``.

    CUDA tensors launch the kernel (bf16 or fp32, head dim 64 or 128) and
    raise on anything it does not take; CPU tensors take the plain
    version. ``flash_attention.launches`` counts kernel launches.
    """
    _check_shapes(q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, with_lse)
    _check_cuda(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _kernel()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), _scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_error_string(err).decode())
    flash_attention.launches += 1
    return out if lse is None else (out, lse)


flash_attention.launches = 0
