"""The port's ``DataParallel`` against ``tpudml``'s, on the CPU.

Two processes over gloo (``tests/torch_dist_worker.py``, spawned once for
the module) train the port's engine; the JAX engine runs in this process
on a 2-device CPU mesh (``tests/conftest.py`` provisions 8). Both start
from the JAX parameters (carried with ``lm_params_from_tpudml``) and see
the same global batches from ``synthetic_lm``. The model is a tiny
``TransformerLM`` (V=63, so head.bias and tok_embed take reducescatter's
mean fallback; d=32, H=4, L=2, T=16, RoPE, fused add+LN), the global
batch 4 (2 rows a replica).

Tolerances (f32): losses rtol 1e-5; parameters after three GD steps, and
after one Adam update from carried state, rtol 1e-4 / atol 1e-6
(``GRAD_TOL`` of ``tests/test_torch_train.py``). At world 1 the port's
engine equals its single-card step bitwise.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tpudml.capabilities import TABLE as JAX_TABLE  # noqa: E402
from tpudml.comm.timing import collective_wire_bytes as jax_wire_bytes  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import Adam as JaxAdam  # noqa: E402
from tpudml.optim import GradientDescent as JaxGD  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml_torch.capabilities import TABLE, CompositionError  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.optim import Adam, GradientDescent  # noqa: E402
from tpudml_torch.parallel import DataParallel, shard_rows  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    TrainState, make_lm_fused_train_step, make_train_step,
)

CFG = dict(vocab_size=63, embed_dim=32, num_heads=4, num_layers=2, max_len=16, rope=True)
B, T, WORLD = 4, 16, 2
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
GD_LR = 0.1
# name -> engine knobs; all GD, 3 steps.
CASES = {
    "allreduce": dict(aggregation="allreduce"),
    "allgather": dict(aggregation="allgather"),
    "reducescatter": dict(aggregation="reducescatter"),
    "fused_xent_scores": dict(fused_xent=True, save_scores=True),
    "fused_xent_lean": dict(fused_xent=True, save_scores=False),
    "flash_attn": dict(flash_attn=True),
}


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _batches(n, seed):
    seqs = synthetic_lm(4 * B, T, CFG["vocab_size"], seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = seqs[rng.integers(0, len(seqs), size=B)]
        out.append((batch[:, :-1], batch[:, 1:]))
    return out


def _jax_run(engine_kw, opt, batches, seed, warm=()):
    """(initial params, initial opt state, per-step losses and accuracies,
    final params) of JAX DataParallel on a 2-device mesh; ``warm`` batches
    train first (the carried state)."""
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    dp = JaxDP(JaxLM(**CFG, fused_ln=True), opt, mesh, stacked_batches=False, **engine_kw)
    ts = dp.create_state(seed_key(seed))
    step = dp.make_train_step()
    for tokens, labels in warm:
        ts, _ = step(ts, tokens, labels)
    params, opt_state = _np(ts.params), _np(ts.opt_state)
    losses, accs = [], []
    for tokens, labels in batches:
        ts, m = step(ts, tokens, labels)
        losses.append(float(m["loss"]))
        if "accuracy" in m:
            accs.append(float(m["accuracy"]))
    return params, opt_state, losses, accs, _np(ts.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs here, the port's on two gloo ranks: {case: (jax, [rank0, rank1])}."""
    job = tmp_path_factory.mktemp("dp")
    batches = {"gd": _batches(3, seed=1), "adam": _batches(3, seed=2)}
    specs, want = {}, {}
    for i, (name, engine_kw) in enumerate(CASES.items()):
        params, _, losses, accs, final = _jax_run(engine_kw, JaxGD(lr=GD_LR),
                                                  batches["gd"], seed=i)
        want[name] = dict(losses=losses, accs=accs, params=lm_params_from_tpudml(final))
        specs[name] = dict(model=dict(CFG, fused_ln=True), engine=engine_kw,
                           params=lm_params_from_tpudml(params), opt="gd", lr=GD_LR,
                           batches="gd")
    params, opt_state, losses, _, final = _jax_run(
        {}, JaxAdam(lr=0.01), batches["adam"][2:], seed=9, warm=batches["adam"][:2])
    want["adam"] = dict(losses=losses, params=lm_params_from_tpudml(final))
    specs["adam"] = dict(model=dict(CFG, fused_ln=True), engine={},
                         params=lm_params_from_tpudml(params), adam_state=opt_state,
                         opt="adam", lr=0.01, batches="adam3")
    batches["adam3"] = batches["adam"][2:]
    torch.save({"specs": specs, "batches": batches}, job / "cases.pt")
    return want, torch_dist_worker.spawn("dp", job, WORLD)


def _close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_matches_jax(runs, case):
    """Each aggregator, the fused head in both modes and flash_attn: three
    GD steps of the 2-rank port against JAX's 2-device engine."""
    want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[case]["losses"], want[case]["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[case]["accs"], want[case]["accs"], atol=1e-6)
        _close(got[case]["params"], want[case]["params"], **GRAD_TOL)
    for name, p in ranks[0][case]["params"].items():  # the replicas agree
        assert torch.equal(p, ranks[1][case]["params"][name]), name


def test_one_adam_update_from_carried_state_matches_jax(runs):
    """JAX trains two Adam steps; its parameters and state carry across and
    one more DP step must agree."""
    want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got["adam"]["losses"], want["adam"]["losses"],
                                   rtol=LOSS_RTOL)
        _close(got["adam"]["params"], want["adam"]["params"], **GRAD_TOL)
        assert got["adam"]["opt_state"]["t"] == 3


def test_split_step_matches_fused_and_counts_comm(runs):
    """measure_comm: the fused step's losses and parameters, one timed span
    a step, and the ring-model bytes JAX's split step charges (one psum of
    the parameters' bytes a step)."""
    _, ranks = runs
    for got in ranks:
        assert got["split"]["losses"] == got["allreduce"]["losses"]
        for name, p in got["split"]["params"].items():
            assert torch.equal(p, got["allreduce"]["params"][name]), name
        assert got["split"]["comm_calls"] == 3
        assert all(s > 0 for s in got["split"]["comm_s"])
        assert got["allreduce"]["comm_calls"] == 0  # the fused step times nothing
        nbytes = sum(p.numel() * 4 for p in got["split"]["params"].values())
        assert got["split"]["comm_bytes"] == 3 * jax_wire_bytes("psum", nbytes, WORLD)


def test_straggler_delays_the_healthy_rank(runs):
    """bottleneck_rank=1, 0.2 s: rank 0 waits in every collective."""
    _, ranks = runs
    healthy = ranks[0]["straggler"]
    assert healthy["comm_calls"] == 3
    assert min(healthy["comm_s"]) >= 0.1, healthy["comm_s"]
    assert ranks[0]["straggler"]["losses"] == ranks[0]["split"]["losses"]


def test_broadcast_params_restores_agreement(runs):
    _, ranks = runs
    before0, before1 = ranks[0]["broadcast"]["before"], ranks[1]["broadcast"]["before"]
    assert all(not torch.equal(before0[n], before1[n]) for n in before0)
    for got in ranks:
        for name, p in got["broadcast"]["after"].items():
            assert torch.equal(p, before0[name]), name


def test_shard_batch_at_world_two(runs):
    """Rank r gets rows [r·B, (r+1)·B) of an LM batch (never taken for the
    stacked form), its replica of the stacked form, and the JAX error for
    an indivisible batch."""
    _, ranks = runs
    tokens = torch.arange(WORLD * 16).reshape(WORLD, 16)
    for r, got in enumerate(ranks):
        assert torch.equal(got["shard"]["x"], tokens[r:r + 1])
        assert got["shard"]["x"].dtype == torch.int64
        assert torch.equal(got["shard"]["stacked"], tokens[r:r + 1])
        assert "not divisible by the 2-way data group" in got["shard"]["indivisible"]


@pytest.mark.parametrize("fused_xent", [False, True], ids=["materialized", "fused_xent"])
def test_world1_equals_single_card_step_bitwise(tmp_path, fused_xent):
    """A one-rank gloo group: three steps of the engine equal the port's
    single-card step bit for bit (the mean over one rank is exact)."""
    def model():
        return TransformerLM(**CFG, impl="flash", fused_ln=True, device="cpu",
                             generator=torch.Generator().manual_seed(3))

    batches = _batches(3, seed=4)
    single = model()
    opt = Adam(lr=0.01)
    step = (make_lm_fused_train_step(single, opt, save_scores=True) if fused_xent
            else make_train_step(single, opt))
    ts = TrainState.create(single, opt)
    want = []
    for tokens, labels in batches:
        ts, m = step(ts, tokens, labels)
        want.append(m["loss"].item())

    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu"):
        dp_model = model()
        dp = DataParallel(dp_model, Adam(lr=0.01), fused_xent=fused_xent,
                          save_scores=True if fused_xent else None)
        ts = dp.create_state()
        step = dp.make_train_step()
        got = []
        for tokens, labels in batches:
            ts, m = step(ts, tokens, labels)
            got.append(m["loss"].item())
    assert got == want
    for (name, p), q in zip(dp_model.named_parameters(), single.parameters()):
        assert torch.equal(p, q), name


def _tiny(impl="full"):
    return TransformerLM(**CFG, impl=impl, device="cpu")


def test_capability_rows_match_jax():
    for key, cap in TABLE.items():
        assert cap.message == JAX_TABLE[key].message, key


@pytest.mark.parametrize("key,kw", [
    ("save_scores_needs_fused_xent", dict(save_scores=True)),
    ("dp_fused_xent_split_step", dict(fused_xent=True, measure_comm=True)),
    ("dp_fused_xent_split_step", dict(fused_xent=True, loss=lambda lg, lb: lg.mean())),
    ("zero1_overlap_needs_zero1", dict(zero1_overlap=True)),
    ("zero1_replaces_aggregation", dict(zero1=True, aggregation="allgather")),
    ("zero1_overlap_needs_accum", dict(zero1=True, zero1_overlap=True)),
    ("zero1_overlap_measure_comm", dict(zero1=True, zero1_overlap=True, accum_steps=2,
                                        measure_comm=True)),
    ("train_flash_attn_dense", dict(flash_attn=True)),
])
def test_constructor_rejections_use_the_jax_wording(key, kw):
    model = _tiny("flash" if key == "train_flash_attn_dense" else "full")
    with pytest.raises(CompositionError, match=re.escape(JAX_TABLE[key].message)):
        DataParallel(model, GradientDescent(), **kw)
    assert model.impl == ("flash" if key == "train_flash_attn_dense" else "full")


@pytest.mark.parametrize("kw,match", [
    (dict(zero1=True), "item 7"),
    (dict(zero1=True, zero1_overlap=True, accum_steps=2), "item 7"),
    (dict(zero1=True, sentinel=True), "item 7"),
    (dict(zero1=True, obs=True), "item 7"),
])
def test_unported_knobs_name_their_item(kw, match, tmp_path):
    """ZeRO-1 (item 7, ported since: ``tests/test_torch_zero1.py``) builds,
    also beside the sentinel, which sits inside the ZeRO1 wrapper, and the
    flight recorder."""
    from tpudml_torch.optim import ZeRO1
    from tpudml_torch.resilience import GradSentinel, find_sentinel

    assert match == "item 7"
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu"):
        dp = DataParallel(_tiny(), GradientDescent(), flash_attn=True, **kw)
    assert isinstance(dp.optimizer, ZeRO1) and dp.zero1
    if kw.get("sentinel"):
        assert isinstance(dp.optimizer.base, GradSentinel)
        assert find_sentinel(dp.optimizer) is dp.sentinel
    assert (dp.tracer is not None) == bool(kw.get("obs"))


def test_needs_a_process_group_and_the_devices_backend(tmp_path):
    model = _tiny()
    with pytest.raises(RuntimeError, match="process group"):
        DataParallel(model, GradientDescent(), flash_attn=True)
    assert model.impl == "full"  # a refused engine leaves the model as it was
    with pytest.raises(ValueError, match="unknown aggregation"):
        DataParallel(model, GradientDescent(), aggregation="ring-of-power")
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu"), pytest.raises(RuntimeError, match="needs a nccl group"):
        DataParallel(model, GradientDescent(), device="cuda")


def test_shard_rows_follow_jax():
    """tests/test_dp.py's shard_batch cases at world 8."""
    world = 8
    tokens = np.ones((world, 16), np.int32)
    x, y = shard_rows(tokens, tokens, world, 0, None)
    assert x.shape == (1, 16) and y.shape == (1, 16)  # not mistaken for stacked
    images = np.arange(world * 2 * 4, dtype=np.float32).reshape(world, 2, 2, 2)
    labels = np.zeros((world, 2), np.int32)
    x, y = shard_rows(images, labels, world, 3, None)  # inferred stacked
    np.testing.assert_array_equal(x.numpy(), images[3])
    x, _ = shard_rows(np.ones((world, 2, 16)), np.ones((world, 2, 16)), world, 1, True)
    assert x.shape == (2, 16)
    x, _ = shard_rows(images, labels, world, 0, False)
    assert x.shape == (1, 2, 2, 2)
    with pytest.raises(ValueError, match="stacked batch leading dim"):
        shard_rows(np.ones((world * 2, 2, 16)), np.ones((world * 2, 2)), world, 0, True)
    with pytest.raises(ValueError, match="not divisible"):
        shard_rows(np.ones((world + 1, 16)), np.ones((world + 1, 16)), world, 0, None)
