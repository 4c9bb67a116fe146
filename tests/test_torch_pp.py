"""GPipe on the port (``tpudml_torch.parallel.pp``) against
``tpudml.parallel.pp``, on the CPU.

- four stages over gloo (``tests/torch_dist_worker.py``'s ``pp`` suite,
  spawned once at world 4) from the parameters JAX's ``create_state``
  drew, carried across by ``interop.pipeline_state_from_tpudml``: the
  forward at M = 1, 2, 8 and 16 equal to JAX's ``sequential_forward``
  (``tests/test_pp.py:47``); one step at M = 8 and a five-step trajectory
  at M = 4 against JAX's GPipe; ``remat`` against the plain schedule; a
  ``ClipByGlobalNorm`` (``tests/test_pp.py:146``) with the replicated
  prologue and epilogue bitwise alike on every rank; transformer blocks
  with ``fused_ln`` against JAX's and against the unfused blocks
  (``tests/test_fused_compose.py:393``). Each rank holds its ``[1, ...]``
  row of the stage leaves. Each tick's bytes on the wire are at most one
  micro-batch activation, what JAX's ppermute ships every tick;
- the open stage shifts ``shift_next`` / ``shift_prev`` at world 4
  against ``lax.ppermute`` with the open permutation, their gradients
  against its transpose, and their byte counter;
- ExpertParallel's ``make_forward`` at world 4 against JAX's;
- at world 1 in this process: ``TransformerEmbed`` and ``TransformerHead``
  against JAX's; a one-stage pipeline at one micro-batch trains bitwise as
  ``TransformerLM(num_layers=1)`` (GPipe and 1F1B, the flash and fused
  add+LN trunk); the rejections with JAX's wording (a stateful block,
  dropout under GPipe, a batch the micro-batches do not divide, a bad
  ``batch_axis``, a ZeRO1 without one).

Tolerances (f32): the forward rtol 2e-5 / atol 2e-6 (JAX's test's); losses
rtol 1e-5; parameters after one update ``GRAD_TOL`` (rtol 1e-4, atol
1e-6); the five-step trajectory rtol 1e-3 / atol 1e-5 (JAX's own
trajectory test's, momentum carrying the first steps' rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerBlock as JaxBlock  # noqa: E402
from tpudml.models import TransformerEmbed as JaxEmbed  # noqa: E402
from tpudml.models import TransformerHead as JaxHead  # noqa: E402
from tpudml.nn import Activation as JaxActivation  # noqa: E402
from tpudml.nn import Dense as JaxDense  # noqa: E402
from tpudml.nn import Flatten as JaxFlatten  # noqa: E402
from tpudml.nn import MoELayer as JaxMoE  # noqa: E402
from tpudml.nn import Sequential as JaxSequential  # noqa: E402
from tpudml.optim import ClipByGlobalNorm as JaxClip  # noqa: E402
from tpudml.optim import Sgd as JaxSgd  # noqa: E402
from tpudml.optim import make_optimizer  # noqa: E402
from tpudml.parallel.ep import ExpertParallel as JaxEP  # noqa: E402
from tpudml.parallel.pp import GPipe as JaxGPipe  # noqa: E402
from tpudml.parallel.sharding import shard_map_fn  # noqa: E402
from tpudml_torch.capabilities import CompositionError  # noqa: E402
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_classification, synthetic_lm  # noqa: E402
from tpudml_torch.models import (  # noqa: E402
    TransformerBlock, TransformerEmbed, TransformerHead, TransformerLM,
)
from tpudml_torch.nn import Activation, BatchNorm, Dense, Sequential  # noqa: E402
from tpudml_torch.optim import Adam, Sgd, ZeRO1  # noqa: E402
from tpudml_torch.parallel import GPipe, Interleaved1F1B, OneFOneB  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step  # noqa: E402

STAGES, WIDTH, BATCH = 4, 32, 16
LOSS_RTOL = 1e-5
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-3, atol=1e-5)
SGD = ("sgd", 0.05, 0.9)
# The fused_ln case: a tiny LM trunk, one block a stage.
LM_V, LM_D, LM_H, LM_T = 32, 16, 4, 8


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshConfig(axes), jax.devices()[:n])


def _jax_pipe(n_mb, opt, **kw):
    block = JaxSequential((JaxDense(WIDTH, WIDTH), JaxActivation(jax.nn.relu)))
    return JaxGPipe(block, n_microbatches=n_mb, mesh=_mesh({"stage": STAGES}), optimizer=opt,
                    prologue=JaxDense(16, WIDTH), epilogue=JaxDense(WIDTH, 10), **kw)


def _jax_train(pipe, key, batches):
    ts = pipe.create_state(seed_key(key))
    params0 = _np(ts.params)
    step = pipe.make_train_step()
    losses = []
    for x, y in batches:
        ts, m = step(ts, x, y)
        losses.append(float(m["loss"]))
    return params0, losses, _flat(_np(ts.params))


def _spec(n_mb, params, batches=(), **kw):
    return dict(engine="gpipe", block={"kind": "mlp", "width": WIDTH}, prologue=(16, WIDTH),
                epilogue=(WIDTH, 10), M=n_mb, mesh={"stage": STAGES}, opt=SGD, params=params,
                batches=list(batches), **kw)


def _classifier(axis_name=None):
    return JaxSequential((JaxFlatten(), JaxDense(28 * 28, 16), JaxActivation(jax.nn.relu),
                          JaxMoE(16, 8, mlp_ratio=2, capacity_factor=8.0, axis_name=axis_name),
                          JaxDense(16, 10)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, 16)).astype(np.float32)
    y = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def runs(tmp_path_factory, batch):
    x, y = batch
    job = tmp_path_factory.mktemp("pp")
    want, cases = {}, {}
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    # The forward at each micro-batch count, from one draw.
    pipe = _jax_pipe(1, opt)
    params = pipe.init_params(seed_key(0))
    want["sequential"] = np.asarray(pipe.sequential_forward(params, jnp.asarray(x)))
    for m in (1, 2, 8, 16):
        cases[f"fwd{m}"] = _spec(m, _np(params), forward_x=x)
    # One step at M = 8; five at M = 4; remat; a clip.
    p0, want["step"], want["step_params"] = _jax_train(_jax_pipe(8, opt), 1, [(x, y)])
    cases["step"] = _spec(8, p0, [(x, y)])
    p0, want["traj"], want["traj_params"] = _jax_train(_jax_pipe(4, opt), 2, [(x, y)] * 5)
    cases["traj"] = _spec(4, p0, [(x, y)] * 5)
    cases["remat"] = _spec(4, p0, [(x, y)] * 5, remat=True)
    clip = JaxClip(JaxSgd(lr=0.1), max_norm=1e-2)
    p0, want["clip"], want["clip_params"] = _jax_train(_jax_pipe(8, clip), 2, [(x, y)] * 3)
    cases["clip"] = dict(_spec(8, p0, [(x, y)] * 3), opt=("sgd", 0.1), clip=1e-2)
    # Transformer blocks with the fused ln2 junction, and without.
    seqs = synthetic_lm(8, LM_T, LM_V, seed=3)
    tokens = [(seqs[:, :-1], seqs[:, 1:])] * 2
    for fused in (True, False):
        jp = JaxGPipe(JaxBlock(LM_D, LM_H, fused_ln=fused), n_microbatches=2,
                      mesh=_mesh({"stage": STAGES}), optimizer=make_optimizer("sgd", 0.05),
                      prologue=JaxEmbed(LM_V, LM_D, LM_T), epilogue=JaxHead(LM_D, LM_V))
        p0, want[f"lm{fused}"], want[f"lm{fused}_params"] = _jax_train(jp, 5, tokens)
        cases[f"lm{fused}"] = dict(
            engine="gpipe", M=2, mesh={"stage": STAGES}, opt=("sgd", 0.05), params=p0,
            batches=tokens, prologue=("embed", LM_V, LM_D, LM_T), epilogue=("head", LM_D, LM_V),
            block={"kind": "transformer", "args": dict(embed_dim=LM_D, num_heads=LM_H,
                                                        fused_ln=fused)})
    # The open shifts: JAX's ppermute of each rank's values.
    want["shift"] = {}
    for name, perm in (("next", [(i, i + 1) for i in range(3)]),
                       ("prev", [(i + 1, i) for i in range(3)])):
        fn = shard_map_fn(lambda v, perm=perm: lax.ppermute(v, "stage", perm),
                          _mesh({"stage": 4}), in_specs=P("stage"), out_specs=P("stage"))
        want["shift"][name] = fn
    # ExpertParallel's forward.
    images, _ = synthetic_classification(64, (28, 28, 1), 10, seed=4)
    ep = JaxEP(_classifier("expert"), JaxSgd(lr=0.1), _mesh({"expert": 4}))
    ts = ep.create_state(seed_key(3))
    want["ep_forward"] = np.asarray(ep.make_forward()(ts.params, jnp.asarray(images)))
    ep_spec = dict(classifier=(16, 8, 28 * 28), params=_np(ts.params), opt_state=(),
                   opt="sgd", lr=0.1, engine={"mesh": {"expert": 4}}, x=images)
    torch.save({"pp": cases, "ep_forward": ep_spec}, job / "cases.pt")
    return want, torch_dist_worker.spawn("pp", job, 4)


def _close(got: dict, want: dict, tol):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w, err_msg=n, **tol)


# ------------------------------------------------------------- world 4


@pytest.mark.parametrize("n_mb", [1, 2, 8, 16])
def test_forward_matches_sequential(runs, n_mb):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"fwd{n_mb}"]["forward"].numpy(), want["sequential"],
                                   **FWD_TOL)


def test_each_rank_holds_its_stage_row(runs):
    """Rank s holds row s of the stage leaves, and its momentum is shaped
    as what it holds."""
    _, ranks = runs
    for i, r in enumerate(ranks):
        assert r["step"]["stage"] == i
        assert r["step"]["local"] == {"prologue.kernel": (16, WIDTH), "prologue.bias": (WIDTH,),
                                      "stages.layer0.kernel": (1, WIDTH, WIDTH),
                                      "stages.layer0.bias": (1, WIDTH),
                                      "epilogue.kernel": (WIDTH, 10), "epilogue.bias": (10,)}
        assert r["step"]["opt_local"] == r["step"]["local"]


def test_train_step_matches_jax(runs):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["step"]["losses"], want["step"], rtol=LOSS_RTOL)
        _close(r["step"]["params"], want["step_params"], GRAD_TOL)


def test_training_trajectory_matches_jax_and_descends(runs):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["traj"]["losses"], want["traj"], rtol=LOSS_RTOL)
        _close(r["traj"]["params"], want["traj_params"], TRAJ_TOL)
        assert r["traj"]["losses"][-1] < r["traj"]["losses"][0]


def test_remat_matches_plain_and_jax(runs):
    """Five steps with every tick's block recomputed in the backward: the
    plain schedule's run bit for bit, and so JAX's."""
    want, ranks = runs
    for r in ranks:
        assert r["remat"]["losses"] == r["traj"]["losses"]
        for n, t in r["traj"]["params"].items():
            assert torch.equal(r["remat"]["params"][n], t), n
        np.testing.assert_allclose(r["remat"]["losses"], want["traj"], rtol=LOSS_RTOL)
        _close(r["remat"]["params"], want["traj_params"], TRAJ_TOL)


def test_clip_keeps_replicas_synced_and_matches_jax(runs):
    """The clip's norm sums the stage rows' squares over the stage group:
    every rank takes JAX's scale, and the prologue and epilogue stay
    bitwise alike on every rank."""
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["clip"]["losses"], want["clip"], rtol=LOSS_RTOL)
        _close(r["clip"]["params"], want["clip_params"], TRAJ_TOL)
        for n, t in ranks[0]["clip"]["replicated"].items():
            assert torch.equal(r["clip"]["replicated"][n], t), n


def test_fused_ln_blocks_match_jax_and_unfused(runs):
    want, ranks = runs
    for r in ranks:
        for fused in (True, False):
            np.testing.assert_allclose(r[f"lm{fused}"]["losses"], want[f"lm{fused}"],
                                       rtol=LOSS_RTOL)
            _close(r[f"lm{fused}"]["params"], want[f"lm{fused}_params"], GRAD_TOL)
        np.testing.assert_allclose(r["lmTrue"]["losses"], r["lmFalse"]["losses"],
                                   rtol=LOSS_RTOL)


def test_bytes_a_tick_at_most_jax(runs):
    """JAX's ring ppermutes one micro-batch activation every tick (forward
    and its transpose); the port sends only live ones, never more."""
    _, ranks = runs
    act = BATCH // 8 * WIDTH * 4
    for i, r in enumerate(ranks):
        ticks = r["step"]["tick_bytes"][0]
        assert len(ticks) == 2 * (8 + STAGES - 1)
        assert max(ticks) <= act
        # Stage s sends 8 activations forward (not the last) and 8
        # cotangents back (not the first).
        assert sum(ticks) == act * 8 * ((i < STAGES - 1) + (i > 0))


def test_open_shifts_match_ppermute(runs):
    want, ranks = runs
    xs = {name: np.concatenate([r["shift"][name]["x"].numpy() for r in ranks])
          for name in ("next", "prev")}
    for name, back in (("next", "prev"), ("prev", "next")):
        got = np.concatenate([r["shift"][name]["y"].numpy() for r in ranks])
        np.testing.assert_array_equal(got, np.asarray(want["shift"][name](xs[name])))
        cots = np.concatenate([r["shift"][name]["cot"].numpy() for r in ranks])
        grads = np.concatenate([r["shift"][name]["grad"].numpy() for r in ranks])
        np.testing.assert_array_equal(grads, np.asarray(want["shift"][back](cots)))
    for i, r in enumerate(ranks):  # 3x5 f32 = 60 bytes, each way
        assert r["shift"]["next"]["bytes"] == [60 * (i < 3), 60 * (i > 0)]
        assert r["shift"]["prev"]["bytes"] == [60 * (i > 0), 60 * (i < 3)]


def test_ep_make_forward_matches_jax(runs):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["ep_forward"].numpy(), want["ep_forward"], **FWD_TOL)


# ------------------------------------------------------------- world 1


@pytest.fixture
def group(tmp_path):
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store",
                                         num_processes=1), device="cpu"):
        yield


def test_embed_and_head_match_jax():
    params, _ = JaxEmbed(LM_V, LM_D, LM_T).init(seed_key(0))
    head_params, _ = JaxHead(LM_D, LM_V).init(seed_key(1))
    tokens = synthetic_lm(4, LM_T - 1, LM_V, seed=2)
    want = JaxEmbed(LM_V, LM_D, LM_T)(params, jnp.asarray(tokens))
    embed = TransformerEmbed(LM_V, LM_D, LM_T)
    embed.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    got = embed(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    head = TransformerHead(LM_D, LM_V)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in _flat(_np(head_params)).items()})
    for fused in (False, True):
        head.fused_ln = fused
        h = np.asarray(want)
        np.testing.assert_allclose(head(torch.from_numpy(h)).detach().numpy(),
                                   np.asarray(JaxHead(LM_D, LM_V)(head_params, want)),
                                   rtol=1e-5, atol=1e-6)
    rope = TransformerEmbed(LM_V, LM_D, LM_T, use_pos_embed=False)
    assert [n for n, _ in rope.named_parameters()] == ["tok_embed"]
    with pytest.raises(ValueError, match="exceeds max_len"):
        embed(torch.zeros(1, LM_T + 1, dtype=torch.long))


@pytest.mark.parametrize("cls", [GPipe, OneFOneB])
def test_one_stage_pipeline_is_the_one_block_lm_bitwise(group, cls):
    """One stage, one micro-batch: the same ops on the same rows as
    ``TransformerLM(num_layers=1)`` (flash attention, fused add+LN), so
    three Adam steps give the same losses and parameters bit for bit."""
    cfg = dict(vocab_size=LM_V, embed_dim=LM_D, num_heads=LM_H, num_layers=1,
               max_len=LM_T, rope=True, impl="flash", fused_ln=True)
    lm = TransformerLM(**cfg, device="cpu")
    pipe = cls(lambda g: TransformerBlock(LM_D, LM_H, impl="flash", rope=True, fused_ln=True,
                                          generator=g),
               1, optimizer=Adam(lr=1e-2),
               prologue=TransformerEmbed(LM_V, LM_D, LM_T, use_pos_embed=False),
               epilogue=TransformerHead(LM_D, LM_V, fused_ln=True), device="cpu")
    ts = pipe.create_state(0)
    with torch.no_grad():
        for n, p in ts.model.named_parameters():
            part, name = n.split(".", 1)
            src = lm.get_parameter(name if part != "stages" else f"block0.{name}")
            p.copy_(src if part != "stages" else src[None])
    seqs = synthetic_lm(8, LM_T, LM_V, seed=1)
    step, lm_step = pipe.make_train_step(), make_train_step(lm, Adam(lr=1e-2))
    lm_ts = TrainState.create(lm, Adam(lr=1e-2))
    for _ in range(3):
        ts, m = step(ts, seqs[:, :-1], seqs[:, 1:])
        lm_ts, lm_m = lm_step(lm_ts, seqs[:, :-1], seqs[:, 1:])
        assert float(m["loss"]) == float(lm_m["loss"])
    for n, p in ts.model.named_parameters():
        part, name = n.split(".", 1)
        want = lm.get_parameter(name if part != "stages" else f"block0.{name}")
        assert torch.equal(p[0] if part == "stages" else p, want), n


def _mlp(g):
    return Sequential((Dense(WIDTH, WIDTH, generator=g), Activation()))


@pytest.mark.parametrize("cls,kw", [(GPipe, {}), (OneFOneB, {}),
                                    (Interleaved1F1B, {"v_chunks": 3})],
                         ids=["gpipe", "1f1b", "interleaved"])
def test_forward_is_the_sequential_forward_at_world_1(group, batch, cls, kw):
    """The port's own oracle: ``make_forward`` on the engine's parameters
    equals ``sequential_forward`` on ``gather_params``'s whole leaves (the
    V·S blocks in virtual-stage order)."""
    pipe = cls(_mlp, 4, optimizer=Sgd(lr=0.1), prologue=Dense(16, WIDTH),
               epilogue=Dense(WIDTH, 10), **kw)
    pipe.create_state(3)
    full = pipe.gather_params()
    assert full["stages.layer0.kernel"].shape == ((1, 3, WIDTH, WIDTH) if kw else
                                                  (1, WIDTH, WIDTH))
    torch.testing.assert_close(pipe.make_forward()(batch[0]),
                               pipe.sequential_forward(full, batch[0]), rtol=1e-6, atol=1e-7)


def test_obs_adds_the_span_and_step_stats(group, batch):
    """``obs=True``: one ``train_step`` span a step and the StepStats of the
    step in the metrics, its gradient norm the stage rows' and the
    replicated leaves' (at one stage, the plain norm of every gradient)."""
    from tpudml_torch.obs.stepstats import grad_normsq

    pipe = GPipe(_mlp, 2, optimizer=Sgd(lr=0.1), prologue=Dense(16, WIDTH),
                 epilogue=Dense(WIDTH, 10), obs=True)
    ts = pipe.create_state(0)
    grads, _ = pipe.grads(*batch)
    _, m = pipe.make_train_step()(ts, *batch)
    stats = m["step_stats"].to_scalars()
    np.testing.assert_allclose(stats["grad_norm"], float(grad_normsq(grads).sqrt()), rtol=1e-6)
    assert stats["loss"] == float(m["loss"])
    assert [(e.name, e.cat) for e in pipe.tracer.events] == [("train_step", "step")]


def test_rejections_keep_jax_wording(group, batch):
    with pytest.raises(ValueError, match="stateless"):
        GPipe(lambda g: BatchNorm(WIDTH), 2, optimizer=Sgd(lr=0.1),
              device="cpu").init_params(0)
    block = (lambda g: TransformerBlock(32, 4, dropout=0.1, generator=g))
    with pytest.raises(CompositionError, match="do not support dropout.*OneFOneB"):
        GPipe(block, 2, optimizer=Sgd(lr=0.1), device="cpu").init_params(0)
    with pytest.raises(ValueError, match="rng_root"):
        OneFOneB(block, 2, optimizer=Sgd(lr=0.1), device="cpu").init_params(0)
    with pytest.raises(ValueError, match="batch_axis"):
        GPipe(_mlp, 2, mesh={"data": 2, "stage": 4}, optimizer=Sgd(lr=0.1),
              batch_axis="nope", device="cpu")
    with pytest.raises(CompositionError, match="needs a data axis"):
        GPipe(_mlp, 2, optimizer=ZeRO1(base=Sgd(lr=0.1), axis_name="data", world=1),
              device="cpu")
    pipe = GPipe(_mlp, 3, optimizer=Sgd(lr=0.1), prologue=Dense(16, WIDTH),
                 epilogue=Dense(WIDTH, 10))
    pipe.create_state(0)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pipe.make_forward()(batch[0])
