"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips, with a reason, on a host without
CUDA; the ``cuda`` fixture decides at run time, never at import. On the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Integer weights whose partial sums stay below 2^24 must match exactly; float
weights within rtol=1e-5, atol=1e-3 (shared-memory atomics add in a
run-dependent order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.noc_segsum import (link_traffic,  # noqa: E402
                                            link_traffic_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


SHAPES = [(3, 500, 256), (1, 7, 16), (2, 130, 20), (4, 1024, 100),
          (256, 4340, 256), (16, 19888, 1024), (2, 4096, 20000)]


@pytest.mark.parametrize("B,K,n_links", SHAPES)
@pytest.mark.parametrize("kind", ["int", "float"])
def test_link_traffic_kernel_matches_plain(cuda, B, K, n_links, kind):
    rng = np.random.default_rng(B * 7 + K)
    ids = torch.as_tensor(rng.integers(0, n_links + 1, (B, K)),
                          dtype=torch.int32, device=cuda)
    w = (rng.integers(0, 16, (B, K)) if kind == "int" else rng.random((B, K)))
    w = torch.as_tensor(w, dtype=torch.float32, device=cuda)
    before = link_traffic.launches
    got = link_traffic(ids, w, n_links)
    torch.cuda.synchronize()
    assert link_traffic.launches == before + 1
    want = link_traffic_plain(ids, w, n_links)
    assert got.shape == (B, n_links) and got.dtype == torch.float32
    if kind == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_link_traffic_kernel_drops_padding_and_out_of_range(cuda):
    ids = torch.tensor([[16, 16, -1, 99, 3, 3]], dtype=torch.int32,
                       device=cuda)
    w = torch.ones(1, 6, device=cuda)
    out = link_traffic(ids, w, 16)
    torch.cuda.synchronize()
    expect = torch.zeros(1, 16, device=cuda)
    expect[0, 3] = 2.0
    assert torch.equal(out, expect)


def test_link_traffic_kernel_rejects_bad_inputs(cuda):
    ids = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    w = torch.ones(2, 8, device=cuda)
    with pytest.raises(TypeError):
        link_traffic(ids.long(), w, 4)
    with pytest.raises(TypeError):
        link_traffic(ids, w.double(), 4)
    with pytest.raises(ValueError):
        link_traffic(ids, w[:, :4], 4)
    with pytest.raises(ValueError):
        link_traffic(ids.t(), w.t(), 4)
    with pytest.raises(ValueError):
        link_traffic(ids, w.cpu(), 4)
