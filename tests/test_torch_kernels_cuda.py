"""The two CUDA kernels of heal_tpu_torch against their plain versions, on
the card. Marked ``cuda``: they skip where torch sees no GPU (a CUDA
kernel has no CPU or interpret mode). On a machine with one card:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerances, as in chip_smoke.py: f32 within a few ulps (summation order,
FMA contraction), bf16 within one bf16 ulp (both sides compute in f32 and
round once).
"""
import numpy as np
import pytest
import torch

from heal_tpu_torch.ops import pillar, shift_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = 1.0 + want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pillar_tables_kernel_matches_plain(dev, dtype):
    rng = np.random.RandomState(0)
    nx, ny, b, f = 16, 8, 3, 64
    stride, cells = nx * ny, nx * ny + 1
    ids = np.sort(rng.randint(0, cells, (b, 900)), 1)  # with drop buckets
    fi = (ids + np.arange(b)[:, None] * cells).reshape(-1).astype(np.int32)
    fi = np.concatenate([fi, np.full(40, b * cells, np.int32)])  # sentinel
    n = len(fi)
    u = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dev, dtype)
    g4 = torch.from_numpy(np.concatenate(
        [rng.randn(n, 3), rng.rand(n, 1) > 0.3], 1).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(7, f).astype(np.float32)).to(dev)
    grid = pillar.PillarGrid(nx, stride, cells, 0.4, 0.4, 0.2, 0.2, -1.0)
    fi_t = torch.from_numpy(fi).to(dev)
    before = pillar.pillar_tables.launches
    got = pillar.pillar_tables(u, g4, fi_t, w, grid, b)
    assert pillar.pillar_tables.launches == before + 1
    want = pillar.pillar_tables_plain(u, g4, fi_t, w, grid, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b * stride, f) and got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 65, 257])
def test_shift_kernel_matches_plain(dev, dtype, c):
    gen = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((3, 37, 41, c), generator=gen, device=dev).to(dtype)
    for fn, plain, n_shift in (
        (shift_rows.shift_rows, shift_rows.shift_rows_plain, 37),
        (shift_rows.shift_cols, shift_rows.shift_cols_plain, 41),
    ):
        s = (torch.rand((3, n_shift), generator=gen, device=dev) * 2 - 1) * 9
        s[:, :3] = torch.tensor([7.0, -7.0, 30.0], device=dev)  # bound, past
        got = fn(x, s, 7)
        want = plain(x, s, 7)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == dtype
        _close(got, want, dtype)


def test_kernels_raise_on_inputs_they_do_not_take(dev):
    x = torch.zeros((1, 4, 4, 2), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        shift_rows.shift_rows(x, torch.zeros((1, 4), device=dev), 2)
    x = torch.zeros((1, 4, 4, 2), device=dev)
    with pytest.raises(ValueError):
        shift_rows.shift_rows(x, torch.zeros((1, 5), device=dev), 2)
    grid = pillar.PillarGrid(2, 4, 5, 1.0, 1.0, 0.5, 0.5, 0.0)
    with pytest.raises(ValueError):
        pillar.pillar_tables(
            torch.zeros((3, 8), device=dev), torch.zeros((3, 4), device=dev),
            torch.zeros(3, dtype=torch.int64, device=dev),
            torch.zeros((7, 8), device=dev), grid, 1)
