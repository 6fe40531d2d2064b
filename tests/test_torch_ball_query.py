"""The port's ball query against the JAX package's.

The plain torch version (what ``ops.neighbor.ball_query`` runs on CPU
tensors) must equal, int for int, the Pallas kernel in interpret mode, the
jnp version and the brute-force oracle, on the cases of
``ops/neighbor_cases.py``: the JAX tests' cases
(tests/test_exact_backprojection.py:20-59), k above every row's hit count,
and cases aimed at the CUDA kernel's warp steps, rows per warp and block,
tiles and bulk copies. The CUDA kernel is held against the plain version on
the same cases in the ``gpu`` tests, which skip without a card. The JAX
package is imported inside the tests that compare with it, so that on a
machine with a card and no JAX the ``gpu`` tests run alone:

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
from maskclustering_tpu_torch.ops.neighbor_cases import BALL_QUERY_CASES, ball_query_case

# one intra-op thread: the suite runs in parallel worker processes, where
# torch's CPU thread pool oversubscribes the cores and each of the many
# small ops waits at a barrier for descheduled threads
torch.set_num_threads(1)


def _case(name):
    """(q, c, ql, cl, k, radius, batch_chunk) of one named case."""
    return (*ball_query_case(name), 4 if name == "chunked" else 8)


CASES = list(BALL_QUERY_CASES)


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


def test_bulk_copy_ready_pads_s_to_a_multiple_of_4():
    from maskclustering_tpu_torch.ops.cuda import bulk_copy_ready

    c = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    cl = torch.tensor([9, 4], dtype=torch.int32)
    padded, padded_cl = bulk_copy_ready(c, cl)
    assert tuple(padded.shape) == (2, 8, 3)
    assert torch.equal(padded[:, :6], c) and not padded[:, 6:].any()
    assert padded_cl.tolist() == [6, 4]  # no candidate past the old S becomes valid
    aligned = torch.zeros((2, 8, 3))
    assert bulk_copy_ready(aligned, cl)[0] is aligned


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


@pytest.mark.gpu
def test_cuda_kernel_takes_misaligned_candidates():
    # a contiguous view 4 bytes into its storage: the bulk copies need 16
    if not torch.cuda.is_available():
        pytest.skip("the CUDA ball-query kernel needs a CUDA card")
    q, c, ql, cl, k, r, _ = _case("ragged")
    dev = torch.device("cuda", 0)
    flat = torch.zeros(c.size + 1, dtype=torch.float32, device=dev)
    flat[1:] = torch.from_numpy(c.reshape(-1)).to(dev)
    shifted = flat[1:].view(c.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    args = [torch.from_numpy(q).to(dev), shifted, torch.from_numpy(ql).to(dev),
            torch.from_numpy(cl).to(dev)]
    got = ball_query(*args, k=k, radius=r)
    assert torch.equal(got, ball_query_reference(*args, k=k, radius=r))
