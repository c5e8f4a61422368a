"""The forward kernel's launch geometry, computed in Python where the CPU
reaches it: TMA tensor maps (dims, byte strides, box, swizzle), grid,
threads and shared memory; the checks that refuse what TMA cannot take;
and the build hash over the shared CUDA headers. Shapes and strides only:
meta tensors, nothing allocated."""

import pytest
import torch

from k8s_dra_driver_gpu_tpu_torch.ops import _build
from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash

BF16 = torch.bfloat16


def _operands(layout, B, S, H, K, hd, dtype=BF16, device="meta"):
    """q, k, v in one of the layouts a caller may hand the kernel."""
    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    if layout == "contiguous":
        return tuple(empty(B, S, n, hd) for n in (H, K, K))
    if layout == "sliced heads":  # one fused QKV projection, cut by heads
        packed = empty(B, S, H + 2 * K, hd)
        return packed[:, :, :H], packed[:, :, H:H + K], packed[:, :, H + K:]
    if layout == "transposed view":  # head-major storage
        return tuple(empty(B, n, S, hd).transpose(1, 2) for n in (H, K, K))
    raise ValueError(layout)


def _expected_strides(layout, B, S, H, K, n, hd):
    """Byte strides of dims (heads, S, B) for an operand with n heads."""
    if layout == "contiguous":
        return (2 * hd, 2 * n * hd, 2 * S * n * hd)
    if layout == "sliced heads":
        width = H + 2 * K
        return (2 * hd, 2 * width * hd, 2 * S * width * hd)
    return (2 * S * hd, 2 * hd, 2 * n * S * hd)


@pytest.mark.parametrize("S", [100, 128, 1000])  # under, exactly, ragged
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("layout",
                         ["contiguous", "sliced heads", "transposed view"])
def test_bf16_plan(layout, hd, group, S):
    B, K = 2, 4
    H = K * group
    q, k, v = _operands(layout, B, S, H, K, hd)
    plan = pt_flash.fwd_plan(q, k, v)
    assert plan.grid == (B * H, -(-S // 128))
    assert plan.threads == 384
    assert plan.smem == pt_flash.fwd_smem_bytes(BF16, hd)
    for t, m, rows in zip((q, k, v), plan.maps, (128, 128, 128)):
        n = t.shape[2]
        assert m.dims == (hd, n, S, B)
        assert m.strides == _expected_strides(layout, B, S, H, K, n, hd)
        assert all(st % 16 == 0 for st in m.strides)
        # 64 bf16 = 128 bytes wide: a 128-wide head is two boxes.
        assert m.box == (64, 1, rows, 1) and m.swizzle == 128
    packed = list(plan.packed())
    assert packed[:4] == [*plan.grid, 384, plan.smem]
    assert len(packed) == 4 + 3 * 12
    assert packed[4:16] == [*plan.maps[0].dims, *plan.maps[0].strides,
                            *plan.maps[0].box, 128]


def test_size_one_dims_get_packed_strides():
    # B=1 and one kv head: those dims are never stepped, whatever their
    # stride; the map takes the packed one (a valid TMA stride).
    q = torch.empty_strided((1, 200, 4, 128), (7, 512, 128, 1), dtype=BF16,
                            device="meta")
    k = torch.empty_strided((1, 200, 1, 128), (3, 128, 5, 1), dtype=BF16,
                            device="meta")
    plan = pt_flash.fwd_plan(q, k, k)
    assert plan.maps[0].strides == (256, 1024, 200 * 1024)
    assert plan.maps[1].strides == (256, 256, 200 * 256)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_shared_memory_fits_a_block(dtype, hd):
    smem = pt_flash.fwd_smem_bytes(dtype, hd)
    assert 0 < smem <= pt_flash.MAX_SMEM_BYTES == 232_448
    if dtype == BF16:
        # Q 128 rows + a two-stage ring of K and V tiles of 128 keys,
        # 1024 bytes of alignment slack, nine 8-byte mbarriers.
        assert smem == 1024 + 2 * hd * (128 + 2 * 2 * 128) + 72
    if dtype == BF16 and hd == 128:
        assert smem - 1024 - 72 == 160 * 1024


def test_fp32_plan_has_no_tensor_maps():
    q, k, v = _operands("contiguous", 2, 1000, 8, 2, 64, dtype=torch.float32)
    plan = pt_flash.fwd_plan(q, k, v)
    assert plan.grid == (16, 16) and plan.threads == 128 and plan.maps == ()
    assert len(plan.packed()) == 4


def _aligned_bf16(shape, strides, offset=0):
    storage = torch.empty(8 + offset + sum((n - 1) * st for n, st in
                                           zip(shape, strides)) + 1,
                          dtype=BF16)
    base = 0
    while (storage.data_ptr() + 2 * base) % 16:
        base += 1
    return storage.as_strided(shape, strides, base + offset)


@pytest.mark.parametrize("layout",
                         ["contiguous", "sliced heads", "transposed view"])
def test_check_cuda_takes_tma_layouts(layout):
    q, k, v = _operands(layout, 2, 40, 4, 2, 64, device="cpu")
    pt_flash._check_cuda(q, k, v)


def test_check_cuda_refuses_what_tma_cannot_take():
    shape, strides = (1, 16, 2, 64), (2048, 128, 64, 1)
    ok = _aligned_bf16(shape, strides)
    pt_flash._check_cuda(ok, ok, ok)
    misaligned = _aligned_bf16(shape, strides, offset=1)  # base 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        pt_flash._check_cuda(misaligned, ok, ok)
    odd = _aligned_bf16((1, 16, 2, 64), (2048, 132, 64, 1))  # 264-byte rows
    with pytest.raises(ValueError, match="16-byte aligned"):
        pt_flash._check_cuda(ok, odd, ok)
    huge = torch.empty_strided((2, 16, 2, 64), (1 << 39, 128, 64, 1),
                               dtype=BF16, device="meta")  # 2^40 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        pt_flash._check_cuda(huge, huge, huge)
    # A size-1 dim's stride is never used: B=1 with any stride is taken.
    b1 = _aligned_bf16((1, 16, 2, 64), (3, 128, 64, 1))
    pt_flash._check_cuda(b1, b1, b1)


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "hopper.cuh"\n')
    header = tmp_path / "hopper.cuh"
    header.write_text("// v1\n")
    first = _build.source_digest("kern")
    assert _build.source_digest("kern") == first
    header.write_text("// v2\n")
    second = _build.source_digest("kern")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build.source_digest("kern") not in (first, second)


F32 = torch.float32


@pytest.mark.parametrize("S", [100, 128, 1000])  # under, exactly, ragged
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("layout",
                         ["contiguous", "sliced heads", "transposed view"])
def test_fp32_plan(layout, hd, group, S):
    # The 3xTF32 forward: a block of four warps per (b, h, 64 q rows); it
    # reads q, k, v through their element strides (no tensor maps).
    B, K = 2, 4
    H = K * group
    q, k, v = _operands(layout, B, S, H, K, hd, dtype=F32)
    plan = pt_flash.fwd_plan(q, k, v)
    assert plan.grid == (B * H, -(-S // 64))
    assert plan.threads == 128 and plan.maps == ()
    # Q and a 64-key K tile in rows of hd + 16 floats, a V tile in rows of
    # hd + 4; two blocks fit an SM (228 KB, 1 KB reserved a block).
    assert plan.smem == 4 * (128 * (hd + 16) + 64 * (hd + 4))
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    assert list(plan.packed()) == [*plan.grid, 128, plan.smem]


def _aligned(shape, strides, dtype, offset=0):
    """A strided view whose storage starts on a 16-byte boundary, then
    ``offset`` elements in."""
    storage = torch.empty(16 + offset + sum((n - 1) * st for n, st in
                                            zip(shape, strides)) + 1,
                          dtype=dtype)
    size = storage.element_size()
    base = 0
    while (storage.data_ptr() + size * base) % 16:
        base += 1
    return storage.as_strided(shape, strides, base + offset)


@pytest.mark.parametrize("layout",
                         ["contiguous", "sliced heads", "transposed view"])
def test_check_cuda_takes_fp32_layouts(layout):
    q, k, v = _operands(layout, 2, 40, 4, 2, 64, dtype=F32, device="cpu")
    pt_flash._check_cuda(q, k, v)


def test_check_cuda_refuses_what_cp_async_cannot_take():
    # fp32 rows are copied 16 bytes at a time: aligned bases and strides.
    shape, strides = (1, 16, 2, 64), (2048, 128, 64, 1)
    ok = _aligned(shape, strides, F32)
    pt_flash._check_cuda(ok, ok, ok)
    with pytest.raises(ValueError, match="fp32 flash kernel needs 16-byte"):
        pt_flash._check_cuda(_aligned(shape, strides, F32, offset=1), ok, ok)
    odd = _aligned(shape, (2048, 130, 64, 1), F32)  # 520-byte rows
    with pytest.raises(ValueError, match="fp32 flash kernel needs 16-byte"):
        pt_flash._check_cuda(ok, odd, ok)
    # A size-1 dim's stride is never used.
    b1 = _aligned(shape, (3, 128, 64, 1), F32)
    pt_flash._check_cuda(b1, b1, b1)
