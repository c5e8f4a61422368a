"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain PyTorch versions.

``flash_attention`` computes what the TPU kernel ``_flash_kernel``
(k8s_dra_driver_gpu_tpu/ops/flash_attention.py:40-101) computes, in the
same ``[B, S, H, hd]`` / ``[B, S, K, hd]`` layout: causal or non-causal
GQA attention with an online softmax, scores in fp32 scaled after the
product, masked scores at -1e30, p cast to the input type before the P.V
product, the normaliser clamped at 1e-30, and optionally the logsumexp
``lse = m + log l`` (``[B, H, S]`` fp32) that the backward needs.

It is differentiable: a ``torch.autograd.Function`` runs the with-lse
forward when an input needs a gradient (the forward-only kernel
otherwise, as ``_flash_attention_vjp`` does at :243-266), saves q, k, v,
out and lse, and its backward is ``flash_attention_bwd``: the dQ and
dK/dV kernels that replace ``_flash_dq_kernel`` (:104) and
``_flash_dkv_kernel`` (:157), rebuilding the probabilities from lse.
``bwd_impl="chunked"`` takes ``chunked_attention_bwd`` instead, the
reference's einsum recompute over q chunks (``_chunked_attention_bwd``,
:281), which keeps only q, k and v and is plain tensor code on any
device, as the reference writes it outside Pallas.

On a CUDA tensor each wrapper launches its kernel from ``csrc/``
(``flash_fwd.cu``, ``flash_bwd.cu``; built for sm_90a at first use) or
raises; there is no fallback. On a CPU tensor it computes the plain
version (``flash_attention_reference``, ``flash_attention_bwd_reference``),
the same function written as whole-matrix tensor code, which the CPU
tests hold against the JAX kernels in interpret mode and which the
card's smoke run holds the kernels against.

The launch geometry of the kernels (grids, threads, shared memory, and
the TMA tensor maps of bf16 operands or the element strides of fp32 ones)
is computed here, by ``fwd_plan`` and ``bwd_plan``, where the CPU tests
reach it, and handed to the C entries, which check it against the
kernels' tiling before they launch.

fp32 operands take the same arithmetic in fp32. The three kernels run
their products on the tensor cores in 3xTF32 (each operand split into two
TF32 values, three products; ~fp32 accuracy where plain TF32 would miss
the fp32 tolerance), with operands copied by cp.async.

Bound on an H100 SXM at the training shape (B=4, S=4096, H=16, K=8,
hd=128, causal, bf16): forward 4*hd FLOP per unmasked pair, 0.28 ms at
989 TFLOP/s; dQ 6*hd, 0.42 ms; dK/dV 8*hd, 0.56 ms; each moves ~0.2-0.3
GB (under 0.1 ms at 3.35 TB/s), so all three are compute-bound. The
kernels' designs are described at the top of their CUDA sources.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the C entries' dtype
_MAX_Q_TILES = 65_535  # the grid's y extent; tiles are 32 rows or more

# The forward kernels' tiling (csrc/flash_fwd.cu checks the launch
# geometry against it). bf16: 128 q rows a block in two consumer
# warpgroups and a producer warpgroup; 128-key K/V tiles in a two-stage
# ring, loaded by TMA in boxes 64 columns (128 bytes) wide with the
# 128-byte swizzle. fp32: 64 q rows a block of four warps, 64-key K/V
# tiles; shared rows padded to hd + 16 floats (Q, K) and hd + 4 (V).
FWD_BF16_BLOCK_M, FWD_BF16_BLOCK_N, FWD_BF16_STAGES = 128, 128, 2
FWD_BF16_THREADS = 384
FWD_F32_BLOCK_M, FWD_F32_BLOCK_N, FWD_F32_THREADS = 64, 64, 128
# The backward kernels' tiling (csrc/flash_bwd.cu checks it). bf16: two
# consumer warpgroups and a producer warpgroup a block. dQ: 128 q rows a
# block, K/V tiles of 64 keys in a three-stage ring. dK/dV: 128 keys a
# block, Q/dO tiles of 64 rows in a three-stage ring. Every TMA box is 64
# rows by 64 columns. fp32 dQ: 64 q rows a block of four warps, 32-key
# K/V tiles; shared rows of Q and K padded to hd + 4 floats, of dO and V
# to hd + 16. fp32 dK/dV: 32 keys a block of four warps (two pairs), Q/dO
# tiles of 32 rows; shared rows padded to hd + 4 floats.
BWD_DQ_BLOCK_M, BWD_DQ_BLOCK_N = 128, 64
BWD_DKV_BLOCK_N, BWD_DKV_BLOCK_M = 128, 64
BWD_STAGES, BWD_THREADS, BWD_BOX_ROWS = 3, 384, 64
BWD_DQ_F32_BLOCK_M, BWD_DQ_F32_BLOCK_N, BWD_DQ_F32_THREADS = 64, 32, 128
BWD_DKV_F32_BLOCK_N, BWD_DKV_F32_BLOCK_M, BWD_DKV_F32_THREADS = 32, 32, 128
TMA_BOX_COLS, TMA_SWIZZLE_BYTES = 64, 128
MAX_SMEM_BYTES = 232_448  # what one block may use on an H100
# q rows a chunk of ``chunked_attention_bwd``: the reference's default
# ``block_q``.
CHUNK_BLOCK_Q = 512
_TMA_MAX_STRIDE = 1 << 40  # TMA byte strides are multiples of 16 below it
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


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


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _causal_keep(S: int, device: torch.device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    causal: bool = True,
    with_lse: bool = False,
):
    """The forward kernel's function as plain tensor code: the whole
    score matrix at once instead of an online softmax over tiles."""
    _check_shapes(q, k, v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * _scale(hd)
    if causal:
        s = s.masked_fill(~_causal_keep(S, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskh->bkgqh", p.to(q.dtype).float(), v.float())
    out = (o / l_safe).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    out = out.to(q.dtype)
    if not with_lse:
        return out
    return out, (m + torch.log(l_safe)).reshape(B, H, S)


def _row_dot(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, [B, S, H, hd] -> [B, H, S]."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(
    q: torch.Tensor,    # [B, S, H, hd]
    k: torch.Tensor,    # [B, S, K, hd]
    v: torch.Tensor,    # [B, S, K, hd]
    out: torch.Tensor,  # [B, S, H, hd], the forward's output
    lse: torch.Tensor,  # [B, H, S] fp32, the forward's logsumexp
    do: torch.Tensor,   # [B, S, H, hd], the output's gradient
    causal: bool = True,
):
    """The backward kernels' function as plain tensor code, the whole
    score matrix at once, with their casts: p = exp(s - lse) from fp32
    scores, dS = p * (dO.V^T - D) in fp32, rounded to the input type
    before the dS.K and dS^T.Q products, p rounded to dO's type before
    P^T.dO. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    _check_shapes(q, k, v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = _scale(hd)
    qg = q.float().reshape(B, S, K, G, hd)
    dog = do.float().reshape(B, S, K, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(S, q.device), NEG_INF)
    p = torch.exp(s - lse.float().reshape(B, K, G, S, 1))
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    ds = p * (dp - _row_dot(do, out).reshape(B, K, G, S, 1))
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds.to(q.dtype).float(),
                      qg) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p.to(do.dtype).float(), dog)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """A TMA tensor map over one ``[B, S, heads, hd]`` operand, innermost
    dimension first, as ``cuTensorMapEncodeTiled`` takes it."""

    dims: tuple[int, int, int, int]     # (hd, heads, S, B)
    strides: tuple[int, int, int]       # bytes, of dims 1..3
    box: tuple[int, int, int, int]      # elements: (64, 1, rows, 1)
    swizzle: int                        # bytes

    def values(self) -> tuple[int, ...]:
        return (*self.dims, *self.strides, *self.box, self.swizzle)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """Launch geometry of one forward call: grid (x walks (b, h), y the
    q tiles), threads a block, dynamic shared-memory bytes, and the bf16
    kernel's tensor maps for q, k and v (none for fp32)."""

    grid: tuple[int, int]
    threads: int
    smem: int
    maps: tuple[TensorMap, ...]

    def packed(self):
        """The int64 array the C entry ``flash_fwd`` reads."""
        values = (*self.grid, self.threads, self.smem,
                  *(x for m in self.maps for x in m.values()))
        return (_I64 * len(values))(*values)


def fwd_smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory of one forward block."""
    if dtype == torch.bfloat16:
        # 1024 bytes of slack align the tiles to the 1024-byte swizzle
        # atom; Q, then the K and V ring; 8 bytes per mbarrier (Q, and a
        # full and an empty barrier for each K and V slot).
        tiles = (FWD_BF16_BLOCK_M * hd
                 + 2 * FWD_BF16_STAGES * FWD_BF16_BLOCK_N * hd)
        return 1024 + 2 * tiles + 8 * (1 + 4 * FWD_BF16_STAGES)
    # Q and a K tile with rows of hd + 16 floats, a V tile with rows of
    # hd + 4 (csrc/flash_fwd.cu: conflict-free fragment reads).
    bm, bn = FWD_F32_BLOCK_M, FWD_F32_BLOCK_N
    return 4 * ((bm + bn) * (hd + 16) + bn * (hd + 4))


def _tensor_map(t: torch.Tensor, rows: int) -> TensorMap:
    """The map of a [B, S, heads, hd] tensor read in boxes of ``rows``
    sequence positions by 64 columns. A dimension of size 1 is never
    stepped, so it gets the stride a packed tensor would have."""
    B, S, n, hd = t.shape
    elem = t.element_size()
    packed = (hd * elem, n * hd * elem, S * n * hd * elem)
    sizes = (n, S, B)
    own = tuple(st * elem for st in (t.stride(2), t.stride(1), t.stride(0)))
    strides = tuple(o if size > 1 else pk
                    for o, pk, size in zip(own, packed, sizes))
    return TensorMap(dims=(hd, n, S, B), strides=strides,
                     box=(TMA_BOX_COLS, 1, rows, 1),
                     swizzle=TMA_SWIZZLE_BYTES)


def fwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> FwdPlan:
    """The forward kernel's launch geometry for these operands (shapes,
    strides and dtype only; nothing is read)."""
    B, S, H, hd = q.shape
    if q.dtype == torch.bfloat16:
        bm = FWD_BF16_BLOCK_M
        maps = (_tensor_map(q, bm), _tensor_map(k, FWD_BF16_BLOCK_N),
                _tensor_map(v, FWD_BF16_BLOCK_N))
        threads = FWD_BF16_THREADS
    else:
        bm, maps, threads = FWD_F32_BLOCK_M, (), FWD_F32_THREADS
    return FwdPlan(grid=(B * H, -(-S // bm)), threads=threads,
                   smem=fwd_smem_bytes(q.dtype, hd), maps=maps)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """Launch geometry of one backward call: the dQ grid (x walks (b, h),
    y the q tiles, the last first), the dK/dV grid (x walks (b, kv-head),
    y the key tiles, the first first), each kernel's threads a block and
    dynamic shared-memory bytes, and what the kernels read q, k, v and dO
    through: bf16, their tensor maps; fp32, their element strides of dims
    (b, s, head), 12 values."""

    dq_grid: tuple[int, int]
    dkv_grid: tuple[int, int]
    dq_threads: int
    dkv_threads: int
    dq_smem: int
    dkv_smem: int
    maps: tuple[TensorMap, ...]
    strides: tuple[int, ...] = ()

    def packed(self):
        """The int64 array the C entries ``flash_bwd_dq`` and
        ``flash_bwd_dkv`` read."""
        values = (*self.dq_grid, *self.dkv_grid, self.dq_threads,
                  self.dkv_threads, self.dq_smem, self.dkv_smem,
                  *(x for m in self.maps for x in m.values()), *self.strides)
        return (_I64 * len(values))(*values)


def bwd_smem_bytes(hd: int, dtype: torch.dtype = torch.bfloat16
                   ) -> tuple[int, int]:
    """Dynamic shared memory of one (dQ, dK/dV) block. bf16, both: 1024
    bytes of slack to align the tiles to the swizzle atom. dQ: Q and dO, a
    ring of K and V tiles, barriers for Q/dO and a full and an empty one
    for each K and V slot. dK/dV: K and V, a ring of Q and dO tiles with
    each slot's lse and D (fp32), barriers for K/V and a full and an
    empty one a slot. fp32 dQ: Q and a K tile with rows of hd + 4 floats,
    dO and a V tile with rows of hd + 16. fp32 dK/dV: the K and V tile and
    two buffers of a Q and a dO tile (rows of hd + 4 floats) with the Q
    tile's lse and D, and the tiles its warp pairs swap (S^T and dP^T, 16
    keys by the tile's rows, two a pair)."""
    if dtype == torch.float32:
        dq = 4 * (BWD_DQ_F32_BLOCK_M + BWD_DQ_F32_BLOCK_N) * (2 * hd + 20)
        n, m = BWD_DKV_F32_BLOCK_N, BWD_DKV_F32_BLOCK_M
        return dq, 4 * ((2 * n + 4 * m) * (hd + 4) + 4 * m + 2 * 2 * 16 * m)
    st = BWD_STAGES
    dq = (1024 + 2 * hd * (2 * BWD_DQ_BLOCK_M + 2 * st * BWD_DQ_BLOCK_N)
          + 8 * (1 + 4 * st))
    dkv = (1024 + 2 * hd * (2 * BWD_DKV_BLOCK_N + 2 * st * BWD_DKV_BLOCK_M)
           + 4 * 2 * st * BWD_DKV_BLOCK_M + 8 * (1 + 2 * st))
    return dq, dkv


def bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor) -> BwdPlan:
    """The backward kernels' launch geometry for these operands (shapes,
    strides and dtype only; nothing is read)."""
    B, S, H, hd = q.shape
    dq_smem, dkv_smem = bwd_smem_bytes(hd, q.dtype)
    if q.dtype == torch.float32:
        return BwdPlan(
            dq_grid=(B * H, -(-S // BWD_DQ_F32_BLOCK_M)),
            dkv_grid=(B * k.shape[2], -(-S // BWD_DKV_F32_BLOCK_N)),
            dq_threads=BWD_DQ_F32_THREADS, dkv_threads=BWD_DKV_F32_THREADS,
            dq_smem=dq_smem, dkv_smem=dkv_smem, maps=(),
            strides=tuple(st for t in (q, k, v, do) for st in t.stride()[:3]))
    return BwdPlan(
        dq_grid=(B * H, -(-S // BWD_DQ_BLOCK_M)),
        dkv_grid=(B * k.shape[2], -(-S // BWD_DKV_BLOCK_N)),
        dq_threads=BWD_THREADS, dkv_threads=BWD_THREADS,
        dq_smem=dq_smem, dkv_smem=dkv_smem,
        maps=tuple(_tensor_map(t, BWD_BOX_ROWS) for t in (q, k, v, do)))


def _bind(lib: ctypes.CDLL, name: str, argtypes: list) -> None:
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _fwd_kernel() -> ctypes.CDLL:
    lib = _build.load("flash_fwd").lib
    # Every pointer and the stream as c_void_p: a bare Python int would
    # be passed as a 32-bit C int and cut the address.
    _bind(lib, "flash_fwd",
          [_PTR] * 5 + [_I32] * 6 + [_I64] * 12
          + [ctypes.POINTER(_I64), _I32, ctypes.c_float, _PTR])
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_kernel() -> ctypes.CDLL:
    lib = _build.load("flash_bwd").lib
    tail = ([_I32] * 6 + [ctypes.POINTER(_I64)] * 2
            + [_I32, ctypes.c_float, _PTR])
    _bind(lib, "flash_bwd_dq", [_PTR] * 7 + tail)
    _bind(lib, "flash_bwd_dkv", [_PTR] * 8 + tail)
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *rest: torch.Tensor):
    """Raise on anything the kernels (forward and backward) do not take.
    ``rest`` are further [B, S, heads, hd] operands (the backward's out
    and dO)."""
    tensors = (q, k, v, *rest)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors):
        raise ValueError(f"flash kernels take bf16 or fp32 q/k/v of one "
                         f"dtype; got {[str(t.dtype) for t in tensors]}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}; got {hd}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash kernel needs a contiguous head dim")
    if -(-q.shape[1] // 32) > _MAX_Q_TILES:
        raise ValueError(f"sequence length {q.shape[1]} too long for one launch")
    # bf16 operands are read through TMA tensor maps: 16-byte aligned
    # bases and byte strides below 2^40. fp32 operands are copied 16 bytes
    # at a time (cp.async): 16-byte aligned bases and rows. A dimension of
    # size 1 is never stepped.
    for t in tensors:
        elem = t.element_size()
        strides = [st for st, size in zip(t.stride()[:3], t.shape[:3])
                   if size > 1]
        if t.data_ptr() % 16 or any(
                elem * st % 16 or not 0 < elem * st < _TMA_MAX_STRIDE
                for st in strides):
            raise ValueError(f"{'bf16' if elem == 2 else 'fp32'} flash "
                             "kernel needs 16-byte aligned rows (pointer "
                             "and strides)")


def _flash_forward(q, k, v, causal: bool, with_lse: bool):
    """One forward: the kernel on CUDA tensors, the plain version on CPU
    tensors. Not differentiable by itself."""
    _check_shapes(q, k, v)
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal, with_lse)
    _check_cuda(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    geometry = fwd_plan(q, k, v).packed()
    lib = _fwd_kernel()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], geometry, int(causal), _scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_error_string(err).decode())
    flash_attention.launches += 1
    flash_attention.lse_launches += with_lse
    return out if lse is None else (out, lse)


def flash_attention_bwd(
    q: torch.Tensor,    # [B, S, H, hd]
    k: torch.Tensor,    # [B, S, K, hd]
    v: torch.Tensor,    # [B, S, K, hd]
    out: torch.Tensor,  # [B, S, H, hd]
    lse: torch.Tensor,  # [B, H, S] fp32
    do: torch.Tensor,   # [B, S, H, hd]
    causal: bool = True,
):
    """(dq, dk, dv) of flash attention from the forward's out and lse.

    CUDA tensors launch the dQ kernel and the dK/dV kernel (bf16 or fp32,
    head dim 64 or 128) and raise on anything they do not take; CPU tensors
    take ``flash_attention_bwd_reference``. D = rowsum(dO * O) is one
    plain fp32 reduction, as the JAX package leaves it outside Pallas.
    ``flash_attention_bwd.dq_launches`` and ``.dkv_launches`` count the
    kernel launches.
    """
    _check_shapes(q, k, v)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(do.shape)} "
                         f"must match q {tuple(q.shape)}")
    if _on_cpu(q, k, v, out, lse, do):
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    launch_dq, launch_dkv, grads = _bwd_launchers(q, k, v, out, lse, do,
                                                  causal)
    launch_dq()
    launch_dkv()
    return grads


def _bwd_launchers(q, k, v, out, lse, do, causal: bool):
    """The backward's two kernel launches on CUDA tensors, apart:
    ``(launch_dq, launch_dkv, (dq, dk, dv))``. Each launcher fills its
    outputs when called; ``flash_attention_bwd`` calls both once, and
    the smoke run times each alone."""
    do = do.contiguous()
    _check_cuda(q, k, v, out, do)
    B, S, H, hd = q.shape
    K = k.shape[2]
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be [B, H, S] fp32 on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    lse = lse.contiguous()
    dsum = _row_dot(do, out)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    out_strides = (_I64 * 9)(
        *(st for t in (dq, dk, dv) for st in t.stride()[:3]))
    geometry = bwd_plan(q, k, v, do).packed()
    lib = _bwd_kernel()
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dsum.data_ptr())
    tail = (_DTYPE_CODES[q.dtype], B, S, H, K, hd, out_strides, geometry,
            int(causal), _scale(hd))

    def launch(name: str, *outputs: torch.Tensor) -> None:
        with torch.cuda.device(q.device):
            err = getattr(lib, name)(
                *operands, *(t.data_ptr() for t in outputs), *tail,
                torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: "
                               + lib.flash_bwd_error_string(err).decode())

    def launch_dq() -> None:
        launch("flash_bwd_dq", dq)
        flash_attention_bwd.dq_launches += 1

    def launch_dkv() -> None:
        launch("flash_bwd_dkv", dk, dv)
        flash_attention_bwd.dkv_launches += 1

    return launch_dq, launch_dkv, (dq, dk, dv)


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


def chunked_attention_bwd(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    do: torch.Tensor,  # [B, S, H, hd]
    causal: bool = True,
    block_q: int = CHUNK_BLOCK_Q,
):
    """(dq, dk, dv) by einsum recompute, ``block_q`` q rows at a time:
    the reference's ``_chunked_attention_bwd`` (:281). Each chunk
    rebuilds its softmax from q and k (no out, no lse), so the transient
    is [B, H, block_q, S] instead of the whole score matrix. fp32 inside,
    masked scores at -1e30, ``dS = P * (dP - rowsum(dP * P))``; returns
    the gradients in the dtypes of q, k, v. Plain tensor code on any
    device."""
    _check_shapes(q, k, v)
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = _scale(hd)
    C = min(block_q, S)
    kf, vf = k.float(), v.float()
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dq_chunks = []
    k_pos = torch.arange(S, device=q.device)
    for q0 in range(0, S, C):
        qg = q[:, q0:q0 + C].float().reshape(B, -1, K, G, hd)
        gg = do[:, q0:q0 + C].float().reshape(B, -1, K, G, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
        if causal:
            q_pos = torch.arange(q0, q0 + qg.shape[1], device=q.device)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        dv += torch.einsum("bkgqs,bqkgh->bskh", p, gg)
        dp = torch.einsum("bqkgh,bskh->bkgqs", gg, vf)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq_chunks.append(
            torch.einsum("bkgqs,bskh->bqkgh", ds, kf).flatten(2, 3) * scale)
        dk += torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    dq = torch.cat(dq_chunks, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, needs_grad: bool,
                bwd_impl: str):
        ctx.causal, ctx.bwd_impl = causal, bwd_impl
        if not needs_grad:
            return _flash_forward(q, k, v, causal, with_lse=False)
        out, lse = _flash_forward(q, k, v, causal, with_lse=True)
        if bwd_impl == "chunked":
            # The chunked backward recomputes from q, k and v alone.
            ctx.save_for_backward(q, k, v)
        else:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        if ctx.bwd_impl == "chunked":
            dq, dk, dv = chunked_attention_bwd(*ctx.saved_tensors, do,
                                               ctx.causal)
        else:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                             ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    causal: bool = True,
    with_lse: bool = False,
    bwd_impl: str = "flash",
):
    """Returns ``out`` [B, S, H, hd] in q's dtype, differentiable in q,
    k and v; or, with ``with_lse``, ``(out, lse)`` with ``lse`` [B, H, S]
    fp32 and no gradient.

    CUDA tensors launch the kernels (bf16 or fp32, head dim 64 or 128)
    and raise on anything they do not take; CPU tensors take the plain
    versions through the same autograd wiring. ``bwd_impl`` is "flash"
    (the backward kernels) or "chunked" (``chunked_attention_bwd``).
    ``flash_attention.launches`` counts forward launches, of which
    ``flash_attention.lse_launches`` wrote lse.
    """
    if bwd_impl not in ("flash", "chunked"):
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}: want flash | "
                         "chunked")
    if with_lse:
        with torch.no_grad():  # as on the card, where the kernel records none
            return _flash_forward(q, k, v, causal, with_lse=True)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, needs_grad, bwd_impl)


flash_attention.launches = 0
flash_attention.lse_launches = 0
