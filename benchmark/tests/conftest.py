"""Fixtures of the benchmark's tests. Whether a card is there is decided
inside the fixture, never at import or collection."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 and the kernels exist only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    import torch

    torch.set_num_threads(2)
