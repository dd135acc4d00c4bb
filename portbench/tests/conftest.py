import pytest


@pytest.fixture
def card():
    """The CUDA card; skips where there is none (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")
