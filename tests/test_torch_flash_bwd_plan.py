"""The backward kernels' launch geometry, computed in Python where the CPU
reaches it: the TMA tensor maps of q, k, v and dO (dims, byte strides,
box, swizzle), both kernels' grids and their order of tiles, threads and
shared memory. Shapes and strides only: meta tensors, nothing
allocated."""

import pytest
import torch

from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash

BF16 = torch.bfloat16


def _operands(layout, B, S, H, K, hd, dtype=BF16):
    """q, k, v and dO in one of the layouts a caller may hand the kernels
    (dO beside q: contiguous unless q is a head-major view)."""
    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    if layout == "contiguous":
        return tuple(empty(B, S, n, hd) for n in (H, K, K, H))
    if layout == "sliced heads":  # one fused QKV projection, cut by heads
        packed = empty(B, S, H + 2 * K, hd)
        return (packed[:, :, :H], packed[:, :, H:H + K],
                packed[:, :, H + K:], empty(B, S, H, hd))
    if layout == "transposed view":  # head-major storage
        return tuple(empty(B, n, S, hd).transpose(1, 2) for n in (H, K, K, H))
    raise ValueError(layout)


def _expected_strides(layout, S, H, K, n, hd, is_do):
    """Byte strides of dims (heads, S, B) for an operand with n heads."""
    if layout == "contiguous" or (layout == "sliced heads" and is_do):
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
def test_bwd_plan(layout, hd, group, S):
    B, K = 2, 4
    H = K * group
    operands = _operands(layout, B, S, H, K, hd)
    plan = pt_flash.bwd_plan(*operands)
    # dQ: a block per (b, q-head, 128 q rows); dK/dV: a block per (b,
    # kv-head, 128 keys).
    assert plan.dq_grid == (B * H, -(-S // 128))
    assert plan.dkv_grid == (B * K, -(-S // 128))
    assert plan.dq_threads == plan.dkv_threads == 384
    assert (plan.dq_smem, plan.dkv_smem) == pt_flash.bwd_smem_bytes(hd)
    assert len(plan.maps) == 4
    for i, (t, m) in enumerate(zip(operands, plan.maps)):
        n = t.shape[2]
        assert m.dims == (hd, n, S, B)
        assert m.strides == _expected_strides(layout, S, H, K, n, hd, i == 3)
        assert all(st % 16 == 0 for st in m.strides)
        # 64 bf16 = 128 bytes wide, 64 rows: a 128-row tile is two boxes,
        # a 128-wide head two panels.
        assert m.box == (64, 1, 64, 1) and m.swizzle == 128
    packed = list(plan.packed())
    assert packed[:8] == [*plan.dq_grid, *plan.dkv_grid, 384, 384,
                          plan.dq_smem, plan.dkv_smem]
    assert len(packed) == 8 + 4 * 12
    assert packed[8 + 3 * 12:] == [*plan.maps[3].dims, *plan.maps[3].strides,
                                   *plan.maps[3].box, 128]


def test_size_one_dims_get_packed_strides():
    # B=1 and one kv head: those dims are never stepped, whatever their
    # stride; the map takes the packed one (a valid TMA stride).
    q = torch.empty_strided((1, 200, 4, 128), (7, 512, 128, 1), dtype=BF16,
                            device="meta")
    k = torch.empty_strided((1, 200, 1, 128), (3, 128, 5, 1), dtype=BF16,
                            device="meta")
    plan = pt_flash.bwd_plan(q, k, k, q)
    assert plan.maps[0].strides == plan.maps[3].strides == (
        256, 1024, 200 * 1024)
    assert plan.maps[1].strides == plan.maps[2].strides == (
        256, 256, 200 * 256)


def _causal_pairs_by_block(S, rows, kernel):
    """Unmasked (q, key) pairs of each block along grid y, in launch
    order, as the kernels map block y to a tile of ``rows``: dQ's y walks
    q tiles from the last (q0 = (gridDim.y - 1 - y) * rows), dK/dV's key
    tiles from the first (k0 = y * rows)."""
    n = -(-S // rows)
    pairs = []
    for y in range(n):
        tile = n - 1 - y if kernel == "dq" else y
        lo, hi = tile * rows, min(S, (tile + 1) * rows)
        if kernel == "dq":  # rows q see keys 0..q
            pairs.append(sum(q + 1 for q in range(lo, hi)))
        else:  # keys k are seen by rows k..S-1
            pairs.append(sum(S - k for k in range(lo, hi)))
    return pairs


# S a multiple of the tile: with ragged S the partial tile is lighter than
# its full neighbour, and the order holds for the others.
@pytest.mark.parametrize("S", [128, 1024, 4096])
def test_grids_run_the_heaviest_causal_tiles_first(S):
    q = torch.empty(4, S, 16, 128, dtype=BF16, device="meta")
    k = torch.empty(4, S, 8, 128, dtype=BF16, device="meta")
    plan = pt_flash.bwd_plan(q, k, k, q)
    for kernel, grid in (("dq", plan.dq_grid), ("dkv", plan.dkv_grid)):
        pairs = _causal_pairs_by_block(S, 128, kernel)
        assert len(pairs) == grid[1]
        assert sum(pairs) == S * (S + 1) // 2  # every pair, once
        assert pairs == sorted(pairs, reverse=True), kernel
    assert plan.dq_grid[0] == 4 * 16 and plan.dkv_grid[0] == 4 * 8


@pytest.mark.parametrize("hd", [64, 128])
def test_shared_memory_fits_a_block(hd):
    dq, dkv = pt_flash.bwd_smem_bytes(hd)
    assert 0 < dq <= pt_flash.MAX_SMEM_BYTES == 232_448
    assert 0 < dkv <= pt_flash.MAX_SMEM_BYTES
    # dQ: Q and dO of 128 rows + a three-stage ring of K and V tiles of 64
    # keys; 1024 bytes of alignment slack, thirteen 8-byte mbarriers.
    assert dq == 1024 + 2 * hd * (2 * 128 + 3 * 2 * 64) + 104
    # dK/dV: K and V of 128 keys + a three-stage ring of Q and dO tiles of
    # 64 rows, each slot with 64 lse and 64 D values (fp32); slack, seven
    # mbarriers.
    assert dkv == 1024 + 2 * hd * (2 * 128 + 3 * 2 * 64) + 3 * 2 * 64 * 4 + 56
    if hd == 128:
        assert dq - 1024 - 104 == 160 * 1024
        assert dkv - 1024 - 56 == 161.5 * 1024


F32 = torch.float32


@pytest.mark.parametrize("S", [100, 128, 1000])  # under, exactly, ragged
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("layout",
                         ["contiguous", "sliced heads", "transposed view"])
def test_fp32_bwd_plan(layout, hd, group, S):
    # fp32: both kernels are 3xTF32 kernels of four warps. dQ: a block per
    # (b, q-head, 64 q rows); dK/dV: a block per (b, kv-head, 32 keys).
    # Both read q, k, v, dO through their element strides.
    B, K = 2, 4
    H = K * group
    operands = _operands(layout, B, S, H, K, hd, dtype=F32)
    plan = pt_flash.bwd_plan(*operands)
    assert plan.dq_grid == (B * H, -(-S // 64))
    assert plan.dkv_grid == (B * K, -(-S // 32))
    assert plan.dq_threads == plan.dkv_threads == 128
    assert (plan.dq_smem, plan.dkv_smem) == pt_flash.bwd_smem_bytes(hd, F32)
    assert plan.maps == ()
    assert plan.strides == tuple(st for t in operands for st in t.stride()[:3])
    packed = list(plan.packed())
    assert packed == [*plan.dq_grid, *plan.dkv_grid, 128, 128, plan.dq_smem,
                      plan.dkv_smem, *plan.strides]
    assert len(packed) == 8 + 12


@pytest.mark.parametrize("S", [100, 128, 1000])  # under, exactly, ragged
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("layout",
                         ["contiguous", "sliced heads", "transposed view"])
def test_fp32_dq_plan(layout, hd, group, S):
    # The fp32 dQ kernel's geometry, as csrc/flash_bwd.cu checks it: four
    # warps of 16 q rows, a block per (b, q-head, 64-row q tile), the q
    # tiles covering S once (the last one ragged), and shared memory for Q
    # and a 32-key K tile at rows of hd + 4 floats and dO and a V tile at
    # hd + 16, whatever the operands' layout.
    B, K = 2, 4
    H = K * group
    plan = pt_flash.bwd_plan(*_operands(layout, B, S, H, K, hd, dtype=F32))
    bm, bn = pt_flash.BWD_DQ_F32_BLOCK_M, pt_flash.BWD_DQ_F32_BLOCK_N
    assert (bm, bn, pt_flash.BWD_DQ_F32_THREADS) == (64, 32, 128)
    assert plan.dq_threads == 4 * 32 and bm == 16 * plan.dq_threads // 32
    assert plan.dq_grid[0] == B * H
    tiles = plan.dq_grid[1]
    assert (tiles - 1) * bm < S <= tiles * bm
    assert plan.dq_smem == 4 * (bm * (hd + 4) + bn * (hd + 4)
                                + bm * (hd + 16) + bn * (hd + 16))
    # Rows of every shared tile start 16-byte aligned (cp.async).
    assert (hd + 4) * 4 % 16 == 0 and (hd + 16) * 4 % 16 == 0


@pytest.mark.parametrize("hd", [64, 128])
def test_fp32_shared_memory_fits_two_blocks(hd):
    dq, dkv = pt_flash.bwd_smem_bytes(hd, F32)
    # dQ: Q and dO of 64 rows, a K and a V tile of 32 keys; Q and K at rows
    # of hd + 4 floats, dO and V at hd + 16.
    assert dq == 4 * (64 + 32) * ((hd + 4) + (hd + 16))
    # dK/dV: K and V of 32 keys, two buffers of Q and dO of 32 rows (rows
    # of hd + 4 floats) and of the Q tile's lse and D; the two warp pairs'
    # swapped tiles (16 keys x 32 rows, two a pair).
    assert dkv == 4 * ((2 * 32 + 4 * 32) * (hd + 4) + 4 * 32 + 4 * 16 * 32)
    # Both kernels run two blocks an SM (228 KB, 1 KB reserved a block).
    for smem in (dq, dkv):
        assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("hd,kb", [(64, 55.5), (128, 103.5)])
def test_fp32_dq_shared_memory_budget(hd, kb):
    # The kernel's comment states 103.5 KB at hd = 128: two blocks an SM
    # leave no room for a second K/V buffer (+35.3 KB) or a second copy of
    # K at a conflict-free stride (+16.5 KB).
    dq, _ = pt_flash.bwd_smem_bytes(hd, F32)
    assert dq == kb * 1024
    if hd == 128:
        second_buffer = 4 * 32 * ((hd + 4) + (hd + 16))
        second_k = 4 * 32 * (hd + 4)
        assert 2 * (dq + second_buffer + 1024) > 228 * 1024
        assert 2 * (dq + second_k + 1024) > 228 * 1024


@pytest.mark.parametrize("S", [128, 1024, 4096])
def test_fp32_dkv_grid_runs_the_heaviest_causal_tiles_first(S):
    q = torch.empty(4, S, 16, 128, dtype=F32, device="meta")
    k = torch.empty(4, S, 8, 128, dtype=F32, device="meta")
    plan = pt_flash.bwd_plan(q, k, k, q)
    pairs = _causal_pairs_by_block(S, 32, "dkv")
    assert len(pairs) == plan.dkv_grid[1]
    assert sum(pairs) == S * (S + 1) // 2
    assert pairs == sorted(pairs, reverse=True)


@pytest.mark.parametrize("S", [128, 1024, 4096, 1000])
def test_fp32_dq_grid_runs_the_heaviest_causal_tiles_first(S):
    # Block y takes q tile (tiles - 1 - y) of 64 rows: under the causal
    # mask the last tiles see the most keys and start first. With ragged S
    # the short last tile may be lighter than its neighbour; the rest keep
    # the order.
    q = torch.empty(4, S, 16, 128, dtype=F32, device="meta")
    k = torch.empty(4, S, 8, 128, dtype=F32, device="meta")
    plan = pt_flash.bwd_plan(q, k, k, q)
    pairs = _causal_pairs_by_block(S, 64, "dq")
    assert len(pairs) == plan.dq_grid[1]
    assert sum(pairs) == S * (S + 1) // 2
    full = pairs[1:] if S % 64 else pairs
    assert full == sorted(full, reverse=True)
