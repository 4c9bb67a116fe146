"""ZeRO-1 (``tpudml_torch.optim.ZeRO1``, ``DataParallel(zero1=...)``) against
``tpudml``'s, on the CPU.

At world 2 over gloo (``tests/torch_dist_worker.py``'s ``zero1`` suite)
against JAX's ``DataParallel`` on 2 CPU devices, from the same LeNet
parameters and global batches (``tests/test_zero1.py``'s cases but the
pipelines' stacked one, which is ROADMAP item 7d):

- ZeRO-1 with SGD momentum matches JAX's ZeRO-1, also with
  ``accum_steps=2``, with a global-norm clip over Adam (its norm summed
  over the disjoint chunks) and in the overlap variant (parameter chunks
  in the state, gathered at the next step's start); with Adam it gives
  JAX's losses and the port's replicated engine's parameters (a mean of
  two is exact either way);
- the split step (``measure_comm``) times the weight-update exchange once
  a step and trains as the fused one;
- each rank holds 1/N of the optimizer state (the moments' bytes within
  20% of half the replicated engine's: the padding);
- the sentinel inside the wrapper skips a NaN step as JAX's does, naming
  the same leaf;
- a ZeRO-1 state through the sharded store: restored bitwise into a fresh
  engine, and JAX restores the port's file into its own ZeRO-1 state
  (the ranks' chunks are its flat-padded moments);
- task2 ``--zero1`` at world 2: both ranks report the same accuracy.

In one process: the wrapper's layout and guards. Tolerances (f32):
losses rtol 1e-5, parameters ``GRAD_TOL`` (rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from tpudml import resilience as jres  # noqa: E402
from tpudml.checkpoint import restore_sharded_checkpoint as jax_restore_sharded  # noqa: E402
from tpudml.checkpoint import save_sharded_checkpoint as jax_save_sharded  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import LeNet as JaxLeNet  # noqa: E402
from tpudml.optim import Adam as JaxAdam  # noqa: E402
from tpudml.optim import ClipByGlobalNorm as JaxClip  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_classification  # noqa: E402
from tpudml_torch.interop import sequential_params_from_tpudml  # noqa: E402
from tpudml_torch.models import LeNet  # noqa: E402
from tpudml_torch.optim import Adam, ClipByGlobalNorm, ZeRO1, with_stacked  # noqa: E402
from tpudml_torch.parallel import DataParallel  # noqa: E402
from tpudml_torch.resilience import corrupt_microbatch  # noqa: E402

WORLD, GLOBAL, STEPS = 2, 32, 3
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax(opt, batches, **kw):
    mesh = make_mesh(MeshConfig({"data": WORLD}), jax.devices()[:WORLD])
    dp = JaxDP(JaxLeNet(), opt, mesh, stacked_batches=False, **kw)
    ts = dp.create_state(seed_key(0))
    step = dp.make_train_step()
    losses = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    out = {"losses": losses, "params": sequential_params_from_tpudml(_np(dp.gather_params(ts)))}
    if kw.get("sentinel"):
        out["stats"] = jres.sentinel_stats(ts.opt_state)
        out["names"] = jres.param_leaf_names(dp.gather_params(ts))
    return out, dp, ts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("zero1")
    x, y = synthetic_classification(GLOBAL, (28, 28, 1), 10, seed=7)
    x, y = np.asarray(x), np.asarray(y)
    xbad = corrupt_microbatch(x, "nan", seed=1)
    b = [(x, y)] * STEPS
    want = {
        "adam": _jax(JaxAdam(lr=1e-2), b, zero1=True)[0],
        "sgd": _jax(JaxSgd(lr=1e-2, momentum=0.9), b, zero1=True)[0],
        "accum": _jax(JaxSgd(lr=1e-2, momentum=0.9), b, zero1=True, accum_steps=2)[0],
        "clip": _jax(JaxClip(JaxAdam(lr=1e-3), max_norm=0.05), b, zero1=True)[0],
        "overlap": _jax(JaxSgd(lr=1e-2, momentum=0.9), b, zero1=True, zero1_overlap=True,
                        accum_steps=2)[0],
        "sentinel": _jax(JaxSgd(lr=1e-2, momentum=0.9), [b[0], (xbad, y), b[0]], zero1=True,
                         sentinel=True)[0],
    }
    _, jdp, jts = _jax(JaxAdam(lr=1e-3), [], zero1=True)
    _, _, jts1 = _jax(JaxAdam(lr=1e-3), b[:1], zero1=True)
    jax_save_sharded(job / "jax_zero1", jts1, step=1)
    want["order"] = {"ts": jts1, "opt": _np(jts1.opt_state)}
    params, _ = JaxLeNet().init(seed_key(0))
    torch.save({"lenet": sequential_params_from_tpudml(_np(params)), "x": x, "y": y,
                "xbad": xbad}, job / "cases.pt")
    return want, torch_dist_worker.spawn("zero1", job, WORLD), job, jts


def _close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), err_msg=n, **(tol or GRAD_TOL))


@pytest.mark.parametrize("case", ["sgd", "accum", "clip", "overlap"])
def test_zero1_matches_jax_at_world_2(runs, case):
    want, ranks, *_ = runs
    for got in ranks:
        np.testing.assert_allclose(got[case]["losses"], want[case]["losses"], rtol=LOSS_RTOL)
        _close(got[case]["params"], want[case]["params"])
    for n, t in ranks[0][case]["params"].items():
        assert torch.equal(t, ranks[1][case]["params"][n]), n


def test_zero1_equals_the_replicated_engine(runs):
    """Adam at lr 1e-2: the losses JAX's ZeRO-1 gives, and the parameters of
    the port's replicated engine (JAX's test's tolerance; Adam turns a
    gradient element that rounds across 0 in one f32 implementation into
    a step of ±lr, so its parameters are held to the port's own twin, and
    to JAX's with SGD above)."""
    want, ranks, *_ = runs
    for got in ranks:
        np.testing.assert_allclose(got["adam"]["losses"], want["adam"]["losses"],
                                   rtol=LOSS_RTOL)
        assert got["adam"]["losses"] == got["adam_rep"]["losses"]
        _close(got["adam"]["params"], got["adam_rep"]["params"], rtol=1e-5, atol=1e-6)


def test_split_step_times_the_exchange_and_trains_as_fused(runs):
    """One comm span a step; the losses of a fused ZeRO-1 run at the same
    settings (its first two steps)."""
    _, ranks, *_ = runs
    for got in ranks:
        assert got["split"]["comm_calls"] == STEPS and got["adam"]["comm_calls"] == 0
        np.testing.assert_allclose(got["split"]["losses"][:2], got["ckpt_run_losses"],
                                   rtol=LOSS_RTOL)


def test_opt_state_is_one_over_n_per_rank(runs):
    _, ranks, *_ = runs
    for got in ranks:
        z, r = got["adam"]["opt_bytes"], got["adam_rep"]["opt_bytes"]
        assert r / WORLD * 0.8 < z < r / WORLD * 1.2, (z, r)


def test_sentinel_inside_zero1_skips_as_jax(runs):
    want, ranks, *_ = runs
    w = want["sentinel"]
    for got in ranks:
        s = got["sentinel"]
        assert s["stats"]["skips"] == w["stats"]["skips"] == 1
        assert s["names"][s["stats"]["bad_leaf"]] == w["names"][w["stats"]["bad_leaf"]]
        assert np.isnan(s["losses"][1]) and np.isfinite(s["losses"][2])
        _close(s["params"], w["params"])


def test_zero1_state_through_the_sharded_store(runs):
    """Restored bitwise by the port at world 2; JAX restores the port's file
    into its own ZeRO-1 state: each moment the ranks' chunks in order."""
    _, ranks, job, jts = runs
    for got in ranks:
        assert got["ckpt"]["roundtrip"]
    restored = jax_restore_sharded(job / "zero1_ckpt" / "step_2", jts)
    assert int(restored.step) == 2
    m = sequential_params_from_tpudml(_np(restored.opt_state["m"]))
    for n, t in m.items():
        want = torch.cat([ranks[0]["ckpt"]["m"][n], ranks[1]["ckpt"]["m"][n]])
        assert torch.equal(t.reshape(-1), want), n


@pytest.mark.parametrize("moment", ["m", "v"])
def test_zero1_conv_moments_are_jax_s_through_the_sharded_store(runs, moment):
    """One Adam step of ZeRO-1 LeNet at world 2, its state through the
    sharded store both ways: JAX restores the port's file to its own run's
    moments (a conv kernel's raveled in JAX's HWIO order, not the port's
    OIHW), and the port restores JAX's file into chunks equal to its own."""
    want, ranks, job, _ = runs
    restored = jax_restore_sharded(job / "zero1_order" / "step_1", want["order"]["ts"])
    got = sequential_params_from_tpudml(_np(restored.opt_state[moment]))
    ref = sequential_params_from_tpudml(want["order"]["opt"][moment])
    convs = {n for n, p in LeNet(device="cpu").named_parameters() if p.dim() == 4}
    assert convs and convs <= set(ref)
    _close(got, ref)
    for n in ref:  # v is ~1e-9 here, under GRAD_TOL's atol: also hold each leaf to its scale
        _close({n: got[n]}, {n: ref[n]}, rtol=1e-4, atol=1e-4 * float(ref[n].abs().max()))
    for rank in ranks:
        own = rank["order"]["own"][moment]
        _close(rank["order"]["from_jax"][moment], own)
        for n, t in own.items():
            _close({n: rank["order"]["from_jax"][moment][n]}, {n: t}, rtol=1e-4,
                   atol=1e-4 * float(t.abs().max()))


def test_task2_zero1_at_world_2(runs):
    _, ranks, *_ = runs
    accs = {got["task2"]["test_accuracy"] for got in ranks}
    assert len(accs) == 1 and all(got["task2"]["world"] == WORLD for got in ranks)


# ------------------------------------------------------------ one process


def test_zero1_init_flattens_to_padded_chunks():
    """JAX's layout: [world·ceil(n/world)] per leaf; a rank's state holds its
    chunk of it (rank 0 of 4 here, no group)."""
    opt = ZeRO1(Adam(lr=1e-3), axis_name="data", world=4)
    params = {"w": torch.ones(3, 5), "b": torch.ones(6)}
    flat = opt.flatten_params(params)
    assert flat["w"].shape == (16,) and flat["b"].shape == (8,)
    state = opt.init(params)
    assert state["m"]["w"].shape == (4,) and state["m"]["b"].shape == (2,)
    assert state["t"] == 0
    assert opt.init_spec({"w": (None, None)}) == {"w": ("data",)}


def test_zero1_guards(tmp_path):
    model = LeNet(device="cpu")
    opt = Adam(lr=1e-3)
    with pytest.raises(ValueError, match="world"):
        ZeRO1(opt, axis_name="data")
    clipped = ZeRO1(ClipByGlobalNorm(Adam(lr=1e-3), max_norm=1.0), axis_name="data", world=2)
    with pytest.raises(ValueError, match="stacked"):
        with_stacked(clipped, lambda name: True)
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        with pytest.raises(ValueError, match="zero1=True"):
            DataParallel(model, ZeRO1(opt, axis_name="data", world=1))
        with pytest.raises(ValueError, match="does not match"):
            DataParallel(model, ZeRO1(opt, axis_name="data", world=4), zero1=True)
        dp = DataParallel(model, opt, zero1=True, zero1_overlap=True, accum_steps=2)
        with pytest.raises(ValueError, match="create_state"):
            dp.make_train_step()
        ts = dp.create_state()
        with pytest.raises(ValueError, match="zero1_overlap"):
            dp.broadcast_params(ts)
        with pytest.raises(ValueError, match="zero1_overlap"):
            dp.placement("opt", "layer0.kernel", (150,))
