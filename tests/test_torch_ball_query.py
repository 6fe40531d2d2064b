"""The port's ball query against the JAX package's.

The plain torch version (what ``ops.neighbor.ball_query`` runs on CPU
tensors) must equal, int for int, the Pallas kernel in interpret mode, the
jnp version and the brute-force oracle, on the JAX tests' cases
(tests/test_exact_backprojection.py:20-59) plus k above every row's hit
count. The CUDA kernel is held against the plain version in the ``gpu``
test, which skips without a card. The JAX package is imported inside the
tests that compare with it, so that on a machine with a card and no JAX the
``gpu`` tests run alone:

    python -m pytest -m gpu --noconftest tests/test_torch_ball_query.py
"""

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.ops.neighbor import (
    ball_query,
    ball_query_brute,
    ball_query_reference,
)


def _case(name):
    """(q, c, ql, cl, k, radius, batch_chunk) of one named case."""
    rng = np.random.default_rng({"ragged": 1, "chunked": 2, "wide_k": 3, "full_rows": 4}
                                .get(name, 0))
    if name == "ragged":  # ql = 0 and cl = 1 rows included
        b, p, s = 4, 70, 260
        return (rng.uniform(-1, 1, (b, p, 3)).astype(np.float32),
                rng.uniform(-1, 1, (b, s, 3)).astype(np.float32),
                np.array([70, 33, 0, 64], np.int32), np.array([260, 100, 50, 1], np.int32),
                6, 0.4, 8)
    if name == "scan_order":  # first k by index, not the nearest k
        return (np.zeros((1, 1, 3), np.float32),
                np.array([[[0.3, 0, 0], [0.1, 0, 0], [0.2, 0, 0]]], np.float32),
                np.array([1], np.int32), np.array([3], np.int32), 2, 0.5, 8)
    if name == "chunked":  # b above the Pallas batch chunk
        b, p, s = 10, 16, 40
        return (rng.uniform(-1, 1, (b, p, 3)).astype(np.float32),
                rng.uniform(-1, 1, (b, s, 3)).astype(np.float32),
                np.full(b, p, np.int32), np.full(b, s, np.int32), 4, 0.5, 4)
    if name == "wide_k":  # k larger than any row's hit count
        return (rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32),
                rng.uniform(-1, 1, (2, 90, 3)).astype(np.float32),
                np.array([50, 20], np.int32), np.array([90, 90], np.int32), 64, 0.2, 8)
    if name == "full_rows":  # dense hits: rows fill and stop early
        return (rng.uniform(0, 0.2, (3, 40, 3)).astype(np.float32),
                rng.uniform(0, 0.2, (3, 600, 3)).astype(np.float32),
                np.array([40, 17, 33], np.int32), np.array([600, 300, 257], np.int32),
                20, 0.05, 8)
    raise KeyError(name)


CASES = ["ragged", "scan_order", "chunked", "wide_k", "full_rows"]


def _jax():
    """(jnp, the Pallas ball query, the jnp ball query, the JAX brute oracle)."""
    jnp = pytest.importorskip("jax.numpy")
    from maskclustering_tpu.ops.neighbor import ball_query as jax_ball_query
    from maskclustering_tpu.ops.neighbor import ball_query_brute as jax_brute
    from maskclustering_tpu.ops.pallas.ball_query import ball_query_pallas

    return jnp, ball_query_pallas, jax_ball_query, jax_brute


def _port(q, c, ql, cl, k, radius):
    return ball_query(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ql),
                      torch.from_numpy(cl), k=k, radius=radius)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_interpret(name):
    jnp, ball_query_pallas, _, _ = _jax()
    q, c, ql, cl, k, r, bc = _case(name)
    got = _port(q, c, ql, cl, k, r)
    assert got.dtype == torch.int32 and tuple(got.shape) == (q.shape[0], q.shape[1], k)
    want = np.asarray(ball_query_pallas(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ql),
                                        jnp.asarray(cl), k=k, radius=r, batch_chunk=bc,
                                        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jnp_and_brute(name):
    jnp, _, jax_ball_query, jax_ball_query_brute = _jax()
    q, c, ql, cl, k, r, _ = _case(name)
    got = _port(q, c, ql, cl, k, r).numpy()
    want = np.asarray(jax_ball_query(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ql),
                                     jnp.asarray(cl), k=k, radius=r))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_ball_query_brute(q, c, ql, cl, k, r))
    np.testing.assert_array_equal(got, ball_query_brute(q, c, ql, cl, k, r))


def test_scan_order_not_nearest():
    q, c, ql, cl, k, r, _ = _case("scan_order")
    np.testing.assert_array_equal(_port(q, c, ql, cl, k, r)[0, 0].numpy(), [0, 1])


def test_plain_chunking_does_not_change_the_answer(monkeypatch):
    # a distance block of a few rows forces many query chunks
    import maskclustering_tpu_torch.ops.neighbor as nb

    q, c, ql, cl, k, r, _ = _case("ragged")
    whole = _port(q, c, ql, cl, k, r)
    monkeypatch.setattr(nb, "_REFERENCE_BLOCK", 3 * q.shape[0] * c.shape[1])
    np.testing.assert_array_equal(_port(q, c, ql, cl, k, r).numpy(), whole.numpy())


def test_cuda_wrapper_refuses_cpu_tensors():
    from maskclustering_tpu_torch.ops.cuda import ball_query_cuda

    q, c, ql, cl, k, r, _ = _case("scan_order")
    with pytest.raises(ValueError, match="CUDA"):
        ball_query_cuda(*map(torch.from_numpy, (q, c, ql, cl)), k=k, radius=r)


def test_dispatch_refuses_other_devices():
    q = torch.zeros((1, 1, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ball_query(q, q, torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA ball-query kernel needs a CUDA card")
    from maskclustering_tpu_torch.ops.cuda import LAUNCHES

    q, c, ql, cl, k, r, _ = _case(name)
    dev = torch.device("cuda", 0)
    args = [torch.from_numpy(a).to(dev) for a in (q, c, ql, cl)]
    before = LAUNCHES.counts["ball_query"]
    got = ball_query(*args, k=k, radius=r)
    torch.cuda.synchronize()
    assert LAUNCHES.counts["ball_query"] == before + 1
    want = ball_query_reference(*args, k=k, radius=r)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), ball_query_brute(q, c, ql, cl, k, r))
