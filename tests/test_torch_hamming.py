"""The Hamming distance matrix: the port's plain version against the
reference's XLA expression and its Pallas kernel (interpret mode on the CPU),
bit for bit; the CUDA wrapper's input checks; and, on a CUDA GPU only, the
hand-written kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf_orb_slam_tpu.ops import matching as jmatching
from gf_orb_slam_tpu.ops.pallas_kernels import hamming_matrix_pallas
from gf_orb_slam_tpu_torch.io_utils.snapshot import to_tensor
from gf_orb_slam_tpu_torch.kernels import hamming
from gf_orb_slam_tpu_torch.ops import matching as tmatching

SHAPES = [(1, 1), (127, 129), (300, 800)]


def descriptors(rng, n):
    """(n, 8) uint32 words using all 32 bits, with bit 31 forced on in some."""
    d = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    d[::3, ::2] |= np.uint32(1 << 31)
    d[1::5] = np.uint32(0xFFFFFFFF)
    return d


@pytest.mark.parametrize("nq,nt", SHAPES)
def test_plain_matches_reference_and_pallas(rng, nq, nt):
    q, t = descriptors(rng, nq), descriptors(rng, nt)
    got = tmatching.hamming_matrix_torch(to_tensor(q, "cpu"), to_tensor(t, "cpu")).numpy()
    want_xla = np.asarray(jmatching.hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
    want_pallas = np.asarray(hamming_matrix_pallas(jnp.asarray(q), jnp.asarray(t)))
    assert got.dtype == np.int32 and got.shape == (nq, nt)
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)


def test_plain_matches_python_popcount(rng):
    q, t = descriptors(rng, 9), descriptors(rng, 7)
    want = np.array([[sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(qi, ti)) for ti in t] for qi in q])
    got = tmatching.hamming_matrix_torch(to_tensor(q, "cpu"), to_tensor(t, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def test_dispatch_on_cpu_uses_plain_version(rng):
    q, t = to_tensor(descriptors(rng, 20), "cpu"), to_tensor(descriptors(rng, 30), "cpu")
    before = hamming.LAUNCHES
    got = tmatching.hamming_matrix(q, t)
    assert hamming.LAUNCHES == before
    assert torch.equal(got, tmatching.hamming_matrix_torch(q, t))


@pytest.mark.parametrize(
    "make,exc,msg",
    [
        (lambda q: q.to(torch.int64), TypeError, "dtype"),
        (lambda q: q[:, :4].contiguous(), ValueError, "shape"),
        (lambda q: q.reshape(-1), ValueError, "shape"),
        (lambda q: q.t().contiguous().t(), ValueError, "contiguous"),
        (lambda q: q, ValueError, "CUDA"),
    ],
)
def test_wrapper_rejects_bad_inputs(rng, make, exc, msg):
    q = to_tensor(descriptors(rng, 8), "cpu")
    with pytest.raises(exc, match=msg):
        hamming.hamming_matrix_cuda(make(q), q)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nt", SHAPES + [(4096, 800), (1000, 777), (0, 8)])
def test_kernel_matches_plain_on_cuda(rng, nq, nt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    q = to_tensor(descriptors(rng, nq), "cuda")
    t = to_tensor(descriptors(rng, nt), "cuda")
    got = hamming.hamming_matrix_cuda(q, t)
    torch.cuda.synchronize()
    assert torch.equal(got, tmatching.hamming_matrix_torch(q, t))
