"""The Hamming distance matrix: the port's plain version against the
reference's XLA expression and its Pallas kernel (interpret mode on the CPU),
bit for bit; the AND-popcount identity the tensor-core kernel computes; its
launch configuration; the CUDA wrapper's input and `out=` checks; and, on a
CUDA GPU only, the hand-written kernel against the plain version."""

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
PATH_SHAPES = [(4096, 800), (800, 800), (1600, 800), (1600, 1600), (2048, 1600)]


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


def extreme_words(nq, nt):
    """All-zero and all-ones descriptors: distances 0 and 256 only."""
    q = np.zeros((nq, 8), np.uint32)
    q[1::2] = 0xFFFFFFFF
    t = np.zeros((nt, 8), np.uint32)
    t[::3] = 0xFFFFFFFF
    return q, t


def and_popc_distances(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """popc(q) + popc(t) − 2·popc(q AND t) with the plain SWAR popcount: the
    identity csrc/hamming.cu evaluates on the binary tensor cores."""
    pc = tmatching._popcount32
    pq = sum(pc(q[:, w]) for w in range(8))
    pt = sum(pc(t[:, w]) for w in range(8))
    both = sum(pc(q[:, w, None] & t[None, :, w]) for w in range(8))
    return pq[:, None] + pt[None, :] - 2 * both


@pytest.mark.parametrize("case", SHAPES + ["zero/ones"])
def test_and_popc_identity_matches_plain_reference_and_pallas(rng, case):
    q, t = extreme_words(70, 130) if case == "zero/ones" else (descriptors(rng, case[0]), descriptors(rng, case[1]))
    got = and_popc_distances(to_tensor(q, "cpu"), to_tensor(t, "cpu")).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tmatching.hamming_matrix_torch(to_tensor(q, "cpu"), to_tensor(t, "cpu")).numpy())
    np.testing.assert_array_equal(got, np.asarray(jmatching.hamming_matrix(jnp.asarray(q), jnp.asarray(t))))
    np.testing.assert_array_equal(got, np.asarray(hamming_matrix_pallas(jnp.asarray(q), jnp.asarray(t))))
    if case == "zero/ones":
        assert set(np.unique(got)) == {0, 256}


def covered(cfg: hamming.LaunchConfig, nq: int, nt: int) -> np.ndarray:
    """How many blocks of the launch write each output (the kernel's block
    (x, y) owns rows [y bm, y bm + bm) and columns [x bn, x bn + bn), clipped)."""
    count = np.zeros((nq, nt), np.int32)
    for y in range(cfg.grid_y):
        for x in range(cfg.grid_x):
            rows, cols = slice(y * cfg.bm, min(nq, (y + 1) * cfg.bm)), slice(x * cfg.bn, min(nt, (x + 1) * cfg.bn))
            assert rows.start < rows.stop and cols.start < cols.stop, "a block outside the matrix"
            count[rows, cols] += 1
    return count


@pytest.mark.parametrize("nq,nt", PATH_SHAPES + [(1000, 777), (1, 1), (65, 33), (129, 31), (31, 4097)])
def test_launch_config_covers_every_output_once(nq, nt):
    cfg = hamming.launch_config(nq, nt)
    assert (covered(cfg, nq, nt) == 1).all()
    assert cfg.smem_bytes <= 227 * 1024 and cfg.threads == 2 * cfg.bm <= 1024
    if (nq, nt) in PATH_SHAPES:
        assert cfg.blocks >= hamming.SMS


@pytest.mark.parametrize("rows", [-1, 0, 1, "3 tiles + 1"])
def test_launch_config_covers_tile_boundaries_once(rows):
    """The tile −1, exact and +1 in both dimensions, and three tiles + 1 rows
    by three tiles − 1 columns: the shapes chip_smoke.py checks on the card."""
    bm, bn = hamming.BM, hamming.BN
    nq = 3 * bm + 1 if rows == "3 tiles + 1" else bm + rows
    for nt in (bn - 1, bn, bn + 1, 3 * bn - 1):
        cfg = hamming.launch_config(nq, nt)
        assert (cfg.bm, cfg.bn) == (bm, bn)
        assert (covered(cfg, nq, nt) == 1).all()
        assert cfg.smem_bytes <= 48 * 1024  # no opt-in attribute needed


def test_launch_config_refuses_huge_grids():
    with pytest.raises(ValueError, match="grid"):
        hamming.launch_config(64 * 65536, 8)


def test_plain_matches_python_popcount(rng):
    q, t = descriptors(rng, 9), descriptors(rng, 7)
    want = np.array([[sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(qi, ti)) for ti in t] for qi in q])
    got = tmatching.hamming_matrix_torch(to_tensor(q, "cpu"), to_tensor(t, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def test_dispatch_on_cpu_uses_plain_version(rng):
    q, t = to_tensor(descriptors(rng, 20), "cpu"), to_tensor(descriptors(rng, 30), "cpu")
    before, by_shape = hamming.LAUNCHES, dict(hamming.LAUNCHES_BY_SHAPE)
    got = tmatching.hamming_matrix(q, t)
    assert hamming.LAUNCHES == before and hamming.LAUNCHES_BY_SHAPE == by_shape
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


@pytest.mark.parametrize(
    "make,exc,msg",
    [
        (lambda q, t: torch.empty((q.shape[0], t.shape[0]), dtype=torch.int64), TypeError, "out has dtype"),
        (lambda q, t: torch.empty((q.shape[0], t.shape[0] + 1), dtype=torch.int32), ValueError, "out has shape"),
        (lambda q, t: torch.empty((t.shape[0], q.shape[0]), dtype=torch.int32).t(), ValueError, "out is not contiguous"),
        (lambda q, t: torch.empty((q.shape[0], t.shape[0]), dtype=torch.int32, device="meta"), ValueError, "out is on meta"),
    ],
)
@pytest.mark.parametrize("wrapper", ["hamming_matrix_cuda", "hamming_matrix_simt_cuda"])
def test_wrapper_rejects_bad_out(rng, wrapper, make, exc, msg):
    q, t = to_tensor(descriptors(rng, 8), "cpu"), to_tensor(descriptors(rng, 5), "cpu")
    with pytest.raises(exc, match=msg):
        getattr(hamming, wrapper)(q, t, out=make(q, t))


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
