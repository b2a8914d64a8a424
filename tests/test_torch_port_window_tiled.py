"""Host-side planning of the tiled window-attention kernels (8 < ws ≤ 16).

The bf16 kernels for windows of 64 < N ≤ 256 tokens (``csrc/fused_window_attention.cu``'s
tiled forward, ``csrc/fused_window_attention_bwd.cu``'s dq and dkv kernels) take a grid of
(run of windows, head, run of 64 rows): block (x, h, z) walks windows [x·per, x·per + count)
in batch-row-major order for head h and rows (or keys) [64 z, 64 z + 64). The wrapper sizes
the runs so that one wave of blocks covers the call at the blocks an SM the kernels' shared
memory allows; the dq kernel's runs carry the bias gradient, whose partial sums
``dbias_part`` [runs, heads, N, N] a fixed-order sum adds. No JAX here: the kernels run only
on the card, and these are the numbers their launches are built from.
"""

import collections

import pytest
import torch

from visiondk_tpu_torch.ops import window_attention as W

SMS = 132  # an H100 SXM's streaming multiprocessors
BLOCK_SHARED_MAX = 232_448  # shared memory one block may take (227 KB)
SM_SHARED = 233_472  # an SM's shared memory (228 KB)
RESERVED = 1_024  # the runtime's own shared memory a block

# (batch, windows an image, heads, N, head_dim, windows a run): SwinV2-L
# (swinv2_large_window12to16_192to256 at 256², ws 16) at its train batch and its serving
# batch, ws 12 and ws 9 (N not a multiple of the 32-key groups), head dim 64 (one block an
# SM), and more blocks than a wave (one window a block)
CASES = [
    (32, 16, 6, 256, 32, 47),  # stage 0: 11 runs × 6 heads × 4 runs of rows = 264 blocks, two an SM
    (32, 4, 12, 256, 32, 26),  # stage 1: 5 runs × 12 heads × 4 = 240
    (32, 1, 24, 256, 32, 16),  # stage 2: 2 runs × 24 heads × 4 = 192
    (64, 16, 6, 256, 32, 94),  # stage 0 at bs 64: 11 runs
    (4, 4, 2, 144, 32, 1),  # ws 12: 3 runs of rows; 16 windows, one a block
    (8, 16, 4, 256, 64, 16),  # head dim 64: 8 runs × 4 heads × 4 = 128 blocks, one an SM
    (2, 4, 2, 81, 32, 1),  # ws 9: 2 runs of rows
    (1, 1, 600, 256, 32, 1),  # 2,400 blocks: one window a block
]


def walk(total: int, per_run: int, heads: int, n: int):
    """How many blocks take each (window, head, run of rows) as the kernels
    walk their grid, and each block's windows in the order it takes them."""
    runs = -(-total // per_run)
    taken, orders = collections.Counter(), []
    for x in range(runs):
        t0 = x * per_run
        windows = list(range(t0, min(t0 + per_run, total)))
        for h in range(heads):
            for z in range(-(-n // 64)):
                orders.append(windows)
                taken.update((t, h, z) for t in windows)
    return runs, taken, orders


def check_cover(total: int, per_run: int, heads: int, n: int, per_sm: int) -> int:
    runs, taken, orders = walk(total, per_run, heads, n)
    blocks = -(-n // 64)
    assert set(taken) == {(t, h, z) for t in range(total) for h in range(heads) for z in range(blocks)}
    assert set(taken.values()) == {1}  # every window of every head once, for every run of rows
    assert all(o and o == list(range(o[0], o[0] + len(o))) for o in orders)  # consecutive, in order
    assert runs * heads * blocks <= SMS * per_sm or per_run == 1  # one wave where the call allows it
    return runs


@pytest.mark.parametrize("batch,n_win,heads,n,head_dim,per_run", CASES)
def test_tiled_forward_runs_cover_every_window_once(batch, n_win, heads, n, head_dim, per_run):
    per = W.forward_windows_per_chunk(batch, n_win, heads, n, head_dim)
    assert per == per_run
    for masked in (False, True):  # the shift regions and the stash never change the blocks an SM
        for stash in (False, True):
            check_cover(batch * n_win, per, heads, n, W.tiled_blocks_per_sm("fwd", head_dim, masked, stash))


@pytest.mark.parametrize("recompute", [False, True], ids=["from_p", "recompute"])
@pytest.mark.parametrize("batch,n_win,heads,n,head_dim,per_run", CASES)
def test_tiled_backward_runs_and_dbias_partials(batch, n_win, heads, n, head_dim, per_run, recompute):
    """The dq and dkv kernels share the grid; dbias_part holds one partial a
    run, a head and an N x N bias."""
    per, part_shape = W.backward_plan(batch, n_win, heads, n, torch.bfloat16, recompute, head_dim)
    assert per == per_run
    for masked in (False, True):
        runs = check_cover(batch * n_win, per, heads, n, W.tiled_blocks_per_sm("dq", head_dim, masked, recompute))
    assert part_shape == (runs, heads, n, n)


def test_small_windows_keep_their_plans():
    """ws ≤ 8 (N ≤ 64) keeps the small-window bodies' runs and dbias_part."""
    assert W.backward_plan(80, 64, 4, 49, torch.bfloat16, False) == (52, (99, 4, 49, 49))
    assert W.backward_plan(80, 64, 4, 49, torch.float32, True) == (20, (256, 4, 49, 49))
    assert W.forward_windows_per_chunk(80, 64, 4, 49) == W.forward_windows_per_chunk(80, 64, 4) == 39


# Dynamic shared memory a block, as the kernels' occupancy entries reported it on an NVIDIA
# H100 80GB HBM3 (chip_smoke.py holds the wrapper's figures to the kernels' on every run):
# (kernel, head_dim, masked, variant) -> bytes
SHARED = {
    ("fwd", 32, False, False): 103_424, ("fwd", 32, True, True): 104_448,
    ("fwd", 64, False, True): 140_288, ("fwd", 64, True, False): 141_312,
    ("dq", 32, False, False): 103_424, ("dq", 32, False, True): 107_520, ("dq", 32, True, True): 108_544,
    ("dq", 64, False, False): 140_288, ("dq", 64, True, True): 149_504,
    ("dkv", 32, False, False): 75_776, ("dkv", 32, False, True): 110_592, ("dkv", 32, True, True): 111_616,
    ("dkv", 64, False, False): 112_640, ("dkv", 64, True, True): 152_576,
    # from P with the shift in the kernel: the unshifted variant's memory (the mask is in P)
    ("dq", 32, True, False): 103_424, ("dq", 64, True, False): 140_288,
    ("dkv", 32, True, False): 75_776, ("dkv", 64, True, False): 112_640,
}


@pytest.mark.parametrize("key", list(SHARED), ids=lambda k: "-".join(map(str, k)))
def test_tiled_shared_memory_fits_a_block_and_plans_its_blocks(key):
    kernel, head_dim, masked, variant = key
    bytes_ = W.tiled_smem_bytes(kernel, head_dim, masked, variant)
    assert bytes_ == SHARED[key]
    assert bytes_ <= BLOCK_SHARED_MAX
    per_sm = W.tiled_blocks_per_sm(kernel, head_dim, masked, variant)
    assert 1 <= per_sm <= 2 and per_sm * (bytes_ + RESERVED) <= SM_SHARED
    if head_dim <= 32:  # SwinV2's head dim: two blocks an SM, each the other's cover while it loads
        assert per_sm == 2


@pytest.mark.parametrize("n", [81, 100, 144, 196, 256])
def test_tiled_plans_depend_on_n_only_through_the_runs_of_rows(n):
    """Every tiled block takes 256 keys (past N zeros), so its shared memory
    is the same at every N; N sets only how many runs of 64 rows a window has."""
    assert W.tiled_row_blocks(n) == -(-n // 64)
    per = W.forward_windows_per_chunk(32, 16, 6, n)
    assert per == -(-512 // (SMS * 2 // (6 * W.tiled_row_blocks(n))))
    assert W.windows_per_chunk(32, 16, 6, torch.bfloat16, False, n) == per
