"""The collective-matmul overlap (``tpudml_torch.parallel.overlap``) on the
CPU.

JAX's own parity test of it (``tests/test_mfu_fusion.py::
test_tp_overlap_matmul_value_and_grad_parity``) fails in the reference, so
the port's primitive is held against the plain form it replaces,
``all_reduce(x @ w)`` (the differentiable ``_ReplicatedSum`` of the
product), as ROADMAP.md asks: at world 2 and 4 over gloo
(``tests/torch_dist_worker.py``'s ``overlap`` suite, a loss of
sum(sin(·)) of the product), over the whole group in 4 chunks and, at
world 4, over the model group of {data 2, model 2} in 2 chunks; value and
both gradients at rtol 1e-5 of each element and of the largest |element|
(the same f32 products, the row chunks reduced apart; BLAS sums a chunk's
product in another order than the whole one's, and cos(·) carries that
into the gradients, 2.2e-6 on elements near 0 of a dX whose largest is
~4). Its rejections: a group of one rank (JAX's capability
row ``tp_overlap_needs_model_axis``), rows the chunks do not divide,
chunks < 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_worker  # noqa: E402
from tpudml_torch.capabilities import TABLE, CompositionError  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.parallel import OVERLAP_CHUNKS, tp_overlap_matmul  # noqa: E402


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    return request.param, torch_dist_worker.spawn("overlap", tmp_path_factory.mktemp("overlap"),
                                                  request.param)


def test_overlap_equals_the_plain_all_reduce(ranks):
    world, got = ranks
    for r in got:
        assert set(r) - {"rows_error"} == ({"world", "fsdp_tp"} if world == 4 else {"world"})
        for name in set(r) - {"rows_error"}:
            for a, b, what in zip(r[name]["overlap"], r[name]["plain"], ("value", "dx", "dw")):
                scale = float(b.abs().max())
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-5 * scale, err_msg=f"{name} {what}")
    # the sum is replicated: every rank of a group holds the same value
    assert all(torch.equal(r["world"]["overlap"][0], got[0]["world"]["overlap"][0])
               for r in got)


def test_overlap_rejects_rows_the_chunks_do_not_divide(ranks):
    _, got = ranks
    assert all("rows 6 must divide by chunks 4" in r["rows_error"] for r in got)


def test_overlap_rejects_a_one_rank_group(tmp_path):
    assert OVERLAP_CHUNKS == 4
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        with pytest.raises(CompositionError, match="tp_overlap"):
            tp_overlap_matmul(torch.ones(4, 8), torch.ones(8, 4))
        assert TABLE["tp_overlap_needs_model_axis"].when({"tp_overlap": True,
                                                          "mesh": {"model": 1}})
        with pytest.raises(ValueError, match="chunks must be >= 1"):
            tp_overlap_matmul(torch.ones(4, 8), torch.ones(8, 4), chunks=0)
