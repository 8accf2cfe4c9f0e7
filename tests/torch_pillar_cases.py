"""Seeded edge cases of kernel 1 (pillar tables), shared by the CPU parity
tests (tests/test_torch_pillar.py: the port's plain versions against the
Pallas kernel in interpret mode) and the card's tests
(tests/test_torch_kernels_cuda.py: the CUDA kernel against its plain
version).

Every case is in the encoder's canvas-space convention (``stride`` =
nx*ny rows a sample, ``cells`` = stride + 1 ids with the drop bucket last)
with sorted table-space ids. The CUDA kernel tiles the canvas in blocks of
256 rows, so grids of 91 and 600 rows a sample put sample boundaries
inside tiles.
"""
import numpy as np

CASES = (
    "straddle",       # nx 13, ny 7: every tile spans several samples
    "straddle_f10",   # the same with F = 10 (no 16-byte rows)
    "empty_slot",     # a sample with no points at all
    "all_drop_slot",  # a sample whose points all fall in the drop bucket
    "sentinels",      # padding ids past batch*cells after the last sample
    "long_run",       # one pillar holding 5000 points
    "no_points",      # N = 0
)


def _ids(rng, n, cells):
    return np.sort(rng.randint(0, cells, n))


def make_case(name: str) -> dict:
    """The case's numpy inputs: fi (N,) int32 sorted, u (N, F) f32, g4
    (N, 4) f32 (w*local xyz, w with some w = 0), w1 / w2 (3, F), b_aff
    (F,), and the grid (nx, ny, batch, vx, vy, geom0 = pillar 0's center)."""
    rng = np.random.RandomState(CASES.index(name))
    nx, ny, batch, f = 30, 20, 3, 64  # 600 rows a sample
    if name.startswith("straddle"):
        nx, ny = 13, 7
        f = 10 if name == "straddle_f10" else 64
    cells = nx * ny + 1
    stride = nx * ny
    per = [_ids(rng, 400, cells) for _ in range(batch)]
    tail = np.zeros(0, np.int64)
    if name == "empty_slot":
        per[1] = per[1][:0]
    elif name == "all_drop_slot":
        per[1] = np.full(400, stride)
    elif name == "sentinels":
        tail = np.sort(batch * cells + rng.randint(0, 2 * cells, 60))
    elif name == "long_run":
        per[0] = np.sort(np.concatenate([per[0], np.full(5000, 37)]))
    elif name == "no_points":
        per = [p[:0] for p in per]
    fi = np.concatenate(
        [p + s * cells for s, p in enumerate(per)] + [tail]).astype(np.int32)
    n = fi.size
    return dict(
        fi=fi,
        u=rng.randn(n, f).astype(np.float32),
        g4=np.concatenate([rng.randn(n, 3), rng.rand(n, 1) > 0.2],
                          axis=1).astype(np.float32),
        w1=rng.randn(3, f).astype(np.float32),
        w2=rng.randn(3, f).astype(np.float32),
        b_aff=rng.randn(f).astype(np.float32),
        nx=nx, ny=ny, batch=batch, vx=0.4, vy=0.4, geom0=(0.2, 0.2, -1.0),
    )
