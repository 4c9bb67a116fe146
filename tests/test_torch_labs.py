"""The lab tasks' pieces and entries against ``tpudml``, on the CPU: the
keys and parameter paths (``core/prng.py``, ``core/pytree.py``),
``ReferenceAdam`` and the learning-rate schedules over five steps, an
N-step task1 trajectory (LeNet, the reference Adam, batch 16), the
accuracy metric, ``MetricsWriter.add_scalars``, the Model API (sink
against eager against JAX's facade, ``LossMonitor``, its validation,
``group=`` at world 1), and the four lab CLIs end to end on
``--device cpu`` on the synthetic set, held to the JAX tests' floors
(``tests/test_task1.py``, ``test_task2.py``, ``test_task3.py``). task1
runs its JAX test's settings; task2 and task3 run task2's reference lr
0.01 and momentum 0.9 at batch 32 for three epochs: at world 1 the JAX
tests' lr 0.05 sits on LeNet's stability edge (the port's run diverges to
chance at batches 8 and 64 and converges at 32).

Tolerances (f32): losses rtol 1e-5; parameters and optimizer state after
updates ``GRAD_TOL`` (rtol 1e-4, atol 1e-6); schedule values rtol 1e-6
(f32 arithmetic in both, cos from two libraries). The task1 trajectory
also holds every ReLU's sign equal to JAX's at each step: an input that
rounds to the other side of 0 moves a gradient past GRAD_TOL in any two
f32 implementations, and the seed is one without such an input.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import tpudml.optim as jopt  # noqa: E402
from tpudml.api import Model as JaxModel  # noqa: E402
from tpudml.core.pytree import path_names as jax_path_names  # noqa: E402
from tpudml.models import ForwardMLP as JaxMLP  # noqa: E402
from tpudml.models import LeNet as JaxLeNet  # noqa: E402
from tpudml.nn.losses import accuracy as jax_accuracy  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import make_train_step as jax_make_train_step  # noqa: E402
from tpudml_torch import optim  # noqa: E402
from tpudml_torch.api import LossMonitor, Model  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.core.prng import Key, fold_in_epoch, key_for_step, seed_key  # noqa: E402
from tpudml_torch.core.pytree import key_name, path_names  # noqa: E402
from tpudml_torch.data import ArrayDataset, DataLoader, synthetic_classification  # noqa: E402
from tpudml_torch.interop import sequential_params_from_tpudml  # noqa: E402
from tpudml_torch.metrics import MetricsWriter  # noqa: E402
from tpudml_torch.models import ForwardMLP, LeNet  # noqa: E402
from tpudml_torch.nn.losses import accuracy  # noqa: E402
from tpudml_torch.tasks import task1, task1_mlp, task2, task3  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step, params_of  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tiny tensors (several test
    workers share the machine's cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _state_np(tree) -> dict:
    return {k: v.numpy() for k, v in sequential_params_from_tpudml(_np(tree)).items()}


def _close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


# ------------------------------------------------------------------ keys


def test_keys_are_deterministic_and_their_paths_distinct():
    k = seed_key(7)
    a = torch.rand(5, generator=key_for_step(k, 3).generator())
    assert torch.equal(a, torch.rand(5, generator=k.fold_in(3).generator()))
    assert fold_in_epoch(k, 2) == k.fold_in(2)
    assert k.fold_in(-1) == k.fold_in(2**32 - 1)  # data is uint32, as JAX's
    draws = {tuple(torch.rand(4, generator=key.generator()).tolist())
             for key in (k, k.fold_in(0), k.fold_in(1), k.split(2, 0), k.split(2, 1),
                         seed_key(8), k.fold_in(0).fold_in(1), k.fold_in(1).fold_in(0))}
    assert len(draws) == 8
    with pytest.raises(ValueError, match="split index"):
        k.split(2, 2)
    assert Key(7, (("fold", 5),)) == k.fold_in(5)


def test_path_names_match_jax():
    tree = {"block0": {"moe": {"experts": {"w1": 1}}, "ln1": [2, 3]}}
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    for p in paths:
        assert path_names(p) == jax_path_names(p)
    assert path_names("block0.moe.experts.w1") == ("block0", "moe", "experts", "w1")
    assert key_name("ln1") == "ln1" and key_name(3) == 3


# ------------------------------------------------------------ optimizers


def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return ({"w": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=(3,)).astype(np.float32)},
            [{"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": (rng.normal(size=(3,)) * 1e-3).astype(np.float32)} for _ in range(5)])


def _five_updates(port_opt, jax_opt, seed=0):
    p0, grads = _param_tree(seed)
    jp, js = p0, jax_opt.init(p0)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    ts = port_opt.init(tp)
    for g in grads:
        jp, js = jax_opt.update(g, js, jp)
        tp, ts = port_opt.update({n: torch.from_numpy(v) for n, v in g.items()}, ts, tp)
    _close({n: v.numpy() for n, v in tp.items()}, _np(jp), **GRAD_TOL)
    return ts, js


def test_reference_adam_five_updates_match_jax():
    ts, js = _five_updates(optim.ReferenceAdam(lr=0.01), jopt.ReferenceAdam(lr=0.01))
    assert set(ts) == {"m", "v"}
    for k in ("m", "v"):
        _close({n: v.numpy() for n, v in ts[k].items()}, _np(js[k]), **GRAD_TOL)
    assert type(optim.make_optimizer("adam_ref", 0.1)) is optim.ReferenceAdam


SCHEDULES = [("constant", (0.1,)), ("cosine_decay", (0.1, 4, 0.2)),
             ("linear_warmup", (0.1, 3)), ("warmup_cosine", (0.1, 2, 6, 0.1)),
             ("step_decay", (0.1, 2, 0.5))]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_and_scheduled_sgd_match_jax(name, args):
    port, ref = getattr(optim, name)(*args), getattr(jopt, name)(*args)
    np.testing.assert_allclose([port(t) for t in range(6)],
                               [float(ref(jnp.int32(t))) for t in range(6)], rtol=1e-6)
    ts, js = _five_updates(optim.Scheduled(optim.Sgd(momentum=0.9), port),
                           jopt.Scheduled(jopt.Sgd(momentum=0.9), ref), seed=1)
    assert ts["t"] == int(js["t"]) == 5
    np.testing.assert_allclose(
        optim.Scheduled(optim.Sgd(), port).current_lr(ts),
        float(jopt.Scheduled(jopt.Sgd(), ref).current_lr(js)), rtol=1e-6)


def test_scheduled_rejects_a_base_without_lr():
    with pytest.raises(ValueError, match="'lr' field"):
        optim.Scheduled(optim.ClipByGlobalNorm(optim.Sgd()), optim.constant(0.1))


# --------------------------------------------------------------- task1


def test_accuracy_matches_jax_with_tied_logits():
    rng = np.random.default_rng(4)
    logits = rng.integers(0, 3, size=(64, 10)).astype(np.float32)  # many tied rows
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    got = accuracy(torch.from_numpy(logits), torch.from_numpy(labels).long()).item()
    assert got == float(jax_accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def _relu_recorder(masks):
    relu = jax.nn.relu

    def recording(x):
        jax.debug.callback(lambda v: masks.append(np.asarray(v) > 0), x, ordered=True)
        return relu(x)

    return recording


TRAJ_STEPS, TRAJ_SEED = 5, 0


def test_task1_trajectory_matches_jax(monkeypatch):
    """Five steps of task1's step (LeNet, ReferenceAdam lr 1e-3, batch 16,
    with the dropout key of ``train_loop``): losses, accuracies, every
    ReLU's sign, and the parameters after the last update."""
    jmasks, tmasks = [], []
    monkeypatch.setattr(jax.nn, "relu", _relu_recorder(jmasks))
    jm = JaxLeNet()  # its Activations capture the recording relu
    monkeypatch.undo()
    jts = JaxTrainState.create(jm, jopt.ReferenceAdam(lr=1e-3), jax.random.key(TRAJ_SEED))
    tm = LeNet(device="cpu")
    tm.load_state_dict(sequential_params_from_tpudml(_np(jts.params)))
    relu = torch.nn.functional.relu
    for i in (1, 4, 8):
        getattr(tm, f"layer{i}").fn = lambda x: (tmasks.append((x > 0).permute(
            0, 2, 3, 1).numpy() if x.dim() == 4 else (x > 0).numpy()), relu(x))[1]
    root = seed_key(TRAJ_SEED).fold_in(0x0D0)
    jstep = jax_make_train_step(jm, jopt.ReferenceAdam(lr=1e-3),
                                rng_root=jax.random.fold_in(jax.random.key(TRAJ_SEED), 0x0D0))
    opt = optim.ReferenceAdam(lr=1e-3)
    ts, step = TrainState.create(tm, opt), make_train_step(tm, opt, rng_root=root)
    x, y = synthetic_classification(16 * TRAJ_STEPS, (28, 28, 1), 10, seed=5)
    for i in range(TRAJ_STEPS):
        rows = slice(16 * i, 16 * (i + 1))
        jts, jmet = jstep(jts, jnp.asarray(x[rows]), jnp.asarray(y[rows]))
        jax.effects_barrier()
        ts, met = step(ts, x[rows], y[rows])
        flips = [int((a != b).sum()) for a, b in zip(tmasks[-3:], jmasks[-3:])]
        assert len(jmasks) == len(tmasks) == 3 * (i + 1) and not any(flips), (i, flips)
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=LOSS_RTOL)
        assert met["accuracy"].item() == float(jmet["accuracy"])
    _close({n: p.detach().numpy() for n, p in params_of(tm).items()}, _state_np(jts.params),
           **GRAD_TOL)


def test_add_scalars_writes_each_in_order(tmp_path):
    with MetricsWriter(tmp_path) as w:
        w.add_scalars({"b": 2.0, "a": float("nan"), "c": 3}, step=4)
    recs = [json.loads(line) for line in (w.run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in recs] == [("b", 2.0, 4), ("a", None, 4),
                                                                  ("c", 3.0, 4)]
    assert recs[1]["finite"] is False


# ------------------------------------------------------------ Model API


HIDDEN = (32, 16)


def _mlp_loader(n, batch, seed):
    return DataLoader(ArrayDataset(*synthetic_classification(n, (28, 28, 1), 10, seed=seed,
                                                             proto_seed=100)), batch)


def _port_mlp(jax_params):
    tm = ForwardMLP(hidden=HIDDEN, device="cpu")
    tm.load_state_dict(sequential_params_from_tpudml(_np(jax_params)))
    return tm


def test_model_api_sink_eager_and_jax_agree(capsys):
    """Two epochs of the facade: sink and eager mode equal each other
    bitwise and JAX's facade at the f32 contract, and eval gives JAX's
    ``{"Accuracy", "Loss"}``."""
    train, test = _mlp_loader(96, 16, 0), _mlp_loader(48, 16, 1)
    jmodel = JaxModel(JaxMLP(hidden=HIDDEN), optimizer=jopt.make_optimizer("sgd", 0.05, 0.9),
                      metrics={"Accuracy", "loss"}, seed=3)
    p0 = jmodel.state.params
    runs = {}
    for sink in (True, False):
        m = Model(_port_mlp(p0), optimizer=optim.make_optimizer("sgd", 0.05, 0.9),
                  metrics={"Accuracy", "loss"}, seed=3)
        m.train(2, train, callbacks=[LossMonitor(3)], dataset_sink_mode=sink)
        runs[sink] = (m, capsys.readouterr().out)
    jmodel.train(2, train)
    (sink, sink_out), (eager, eager_out) = runs[True], runs[False]
    assert sink_out == eager_out and sink_out.count("step: ") == 4  # steps 3, 6, 9, 12
    assert sink.state.step == eager.state.step == 12 and sink.train_time_s > 0
    for (n, a), b in zip(params_of(sink.network).items(), params_of(eager.network).values()):
        assert torch.equal(a, b), n
    _close({n: p.detach().numpy() for n, p in params_of(sink.network).items()},
           _state_np(jmodel.state.params), **GRAD_TOL)
    got, want = sink.eval(test), jmodel.eval(test)
    assert set(got) == set(want) == {"Accuracy", "Loss"}
    assert got["Accuracy"] == want["Accuracy"]
    np.testing.assert_allclose(got["Loss"], want["Loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(sink.predict(test.dataset.images[:4]).numpy(),
                               np.asarray(jmodel.predict(test.dataset.images[:4])), rtol=1e-5,
                               atol=1e-6)


def test_model_api_validation_and_world1_group(tmp_path):
    net = ForwardMLP(hidden=HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="needs an optimizer"):
        Model(net)
    with pytest.raises(ValueError, match="unknown metrics"):
        Model(net, optimizer=optim.Sgd(), metrics={"f1"})
    train = _mlp_loader(64, 16, 2)

    def fresh():
        return ForwardMLP(hidden=HIDDEN, device="cpu",
                          generator=torch.Generator().manual_seed(9))

    single = Model(fresh(), optimizer=optim.Sgd(lr=0.05), seed=1).train(1, train)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store"),
                       device="cpu") as group:
        dp = Model(fresh(), optimizer=optim.Sgd(lr=0.05), seed=1, group=group)
        with pytest.raises(ValueError, match="single-device"):
            dp.train(1, train, dataset_sink_mode=False)
        dp.train(1, train)
    assert dp.state.step == single.state.step == 4
    for (n, a), b in zip(params_of(dp.network).items(), params_of(single.network).values()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------- CLIs


def _run(module, tmp_path, *flags):
    return module.main(["--device", "cpu", "--dataset", "synthetic", "--log_dir",
                        str(tmp_path / "logs"), *flags])


def test_task1_cli_end_to_end(tmp_path, capsys):
    """tests/test_task1.py's smoke run: lr 1e-3, batch 64, one epoch."""
    m = _run(task1, tmp_path, "--lr", "1e-3", "--batch_size", "64", "--log_every", "5")
    out = capsys.readouterr().out
    assert m["test_accuracy"] > 0.5 and m["loss"] < 2.3 and m["steps"] == 4096 // 64
    assert "Test accuracy" in out and "epoch 0 iter 5:" in out
    assert task1.reference_defaults().optimizer == "adam_ref"
    np.testing.assert_allclose(task1.reference_defaults().lr, 5e-4 * 200 ** 0.5)


def test_task1_mlp_cli_end_to_end(tmp_path, capsys):
    m = _run(task1_mlp, tmp_path, "--epochs", "2", "--optimizer", "adam", "--lr", "0.002",
             "--log_every", "50")
    out = capsys.readouterr().out
    assert m["test_accuracy"] > 0.5 and m["steps"] == 2 * (4096 // 32)
    assert "step: 50, loss is" in out and "'Accuracy'" in out


@pytest.mark.parametrize("flags,floor", [
    (["--aggregation", "allreduce"], 0.5), (["--aggregation", "allgather"], 0.5),
    (["--aggregation", "reducescatter"], 0.5),
    (["--measure_comm", "--bottleneck_rank", "0", "--bottleneck_delay_s", "0.01"], 0.4),
])
def test_task2_cli_end_to_end(tmp_path, capsys, flags, floor):
    """The reference settings (lr 0.01, momentum 0.9, batch 32) for three
    epochs at world 1, each aggregation and the comm-timed split step."""
    m = _run(task2, tmp_path, "--epochs", "3", "--log_every", "0", *flags)
    assert m["world"] == 1 and m["test_accuracy"] > floor and m["loss"] < 2.3
    if "--measure_comm" in flags:
        assert m["comm_time_s"] > 0 and "Total communication time" in capsys.readouterr().out
    else:
        assert "comm_time_s" not in m


@pytest.mark.parametrize("division", ["partition", "sampling"])
def test_task3_cli_end_to_end(tmp_path, division):
    """Each division at task2's reference lr and momentum, three epochs."""
    m = _run(task3, tmp_path, "--epochs", "3", "--lr", "0.01", "--momentum", "0.9",
             "--log_every", "0", "--division", division)
    assert m["world"] == 1 and m["test_accuracy"] > 0.5
    assert task3.reference_defaults().lr == 0.001


@pytest.mark.parametrize("flag,item", [(["--zero1"], "item 7"), (["--plan", "p.json"], "item 10"),
                                       (["--zero1", "--obs", "--ckpt_dir", "ck"], "item 7")])
def test_lab_clis_keep_unported_flags_raising(tmp_path, flag, item):
    """``--plan`` (item 10) raises in both entries; ``--zero1`` (item 7,
    ported since) runs: task2 shards its optimizer state (one epoch here),
    task1 takes no engine and ignores it, as JAX's task1 does."""
    flag = [str(tmp_path / f) if f == "ck" else f for f in flag]
    for module in (task1, task2):
        if item == "item 10":
            with pytest.raises(NotImplementedError, match=item):
                _run(module, tmp_path, *flag)
            continue
        m = _run(module, tmp_path, *flag, "--epochs", "1", "--log_every", "0")
        assert m["test_accuracy"] >= 0.0 and m["steps"] > 0


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be shown")


@pytest.mark.parametrize("module", [task1, task1_mlp, task2, task3],
                         ids=["task1", "task1_mlp", "task2", "task3"])
def test_lab_clis_ask_for_the_card_by_default(no_card, tmp_path, module):
    """Without ``--device`` an entry asks for the card and raises before any
    work (no metrics written)."""
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--dataset", "synthetic", "--log_dir", str(tmp_path)])
    assert not list(tmp_path.rglob("metrics.jsonl"))
