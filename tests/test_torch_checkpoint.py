"""The port's checkpoint store (``tpudml_torch.checkpoint``) against
``tpudml.checkpoint``, on the CPU.

- a bitwise round trip of f32, bf16, f16 and int leaves, and the same
  manifest (format 2, the bf16 descriptor, every CRC-32) as JAX writes for
  the same values;
- a TrainState checkpoint written by JAX (an LM under Adam, LeNet under
  SGD momentum with its HWIO conv kernels, a DataParallel state with the
  sentinel's counters) restores into the port's state, every tensor
  bitwise equal to ``interop``'s conversion; one the port wrote passes
  JAX's ``verify_checkpoint``, and JAX's ``restore_checkpoint`` reads back
  the same arrays;
- each vandal of ``tpudml_torch.resilience`` (JAX's seeds) is detected,
  and ``restore_latest_valid`` falls back to the step JAX's does, on the
  port's files and on JAX's;
- retention, the async write (its snapshot and its error) and structure
  mismatches;
- the kill / vandalize / resume drill of
  ``tests/test_ckpt_resilience.py::test_kill_resume_parity_bit_exact`` on
  the port's LeNet, bitwise.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml import checkpoint as jckpt  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.models import LeNet as JaxLeNet  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import make_optimizer as jax_optimizer  # noqa: E402
from tpudml.parallel.dp import DataParallel as JaxDP  # noqa: E402
from tpudml.resilience import vandalize as jax_vandalize  # noqa: E402
from tpudml.train import TrainState as JaxTS  # noqa: E402
from tpudml.train import make_train_step as jax_step  # noqa: E402
from tpudml_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptError, CheckpointHook, CheckpointManager, latest_checkpoint,
    restore_checkpoint, restore_latest_valid, save_checkpoint, verify_checkpoint,
)
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.interop import (  # noqa: E402
    adam_state_from_tpudml, lm_params_from_tpudml, sequential_params_from_tpudml,
    sgd_state_from_tpudml,
)
from tpudml_torch.models import LeNet, TransformerLM  # noqa: E402
from tpudml_torch.optim import make_optimizer  # noqa: E402
from tpudml_torch.parallel import DataParallel  # noqa: E402
from tpudml_torch.resilience import VANDALS, vandalize  # noqa: E402
from tpudml_torch.train import TrainState, make_train_step, train_loop  # noqa: E402

KINDS = sorted(VANDALS)
LM = dict(vocab_size=16, embed_dim=16, num_heads=2, num_layers=1, max_len=8, rope=True)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _tree(tag: float):
    """The port's form of JAX's ``_tree`` (test_ckpt_resilience.py)."""
    return {"w": torch.full((64, 8), tag, dtype=torch.float32),
            "b": torch.arange(32, dtype=torch.bfloat16) + tag,
            "n": torch.tensor(int(tag), dtype=torch.int32)}


def _jax_tree(tag: float):
    return {"w": jnp.full((64, 8), tag, jnp.float32),
            "b": jnp.arange(32, dtype=jnp.bfloat16) + jnp.bfloat16(tag),
            "n": jnp.int32(tag)}


def _zeros(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _assert_tree(got, tag):
    want = _tree(tag)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


# --------------------------------------------------------------- encoding


def test_round_trip_bitwise_and_manifest_equals_jax(tmp_path):
    tree = dict(_tree(3), h=torch.linspace(-3, 3, 9, dtype=torch.float16),
                i=torch.arange(-4, 4, dtype=torch.int64), z=np.arange(5, dtype=np.uint8))
    path = save_checkpoint(tmp_path / "port", tree, 3, metadata={"k": 1})
    got = restore_checkpoint(path, {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                                        else np.zeros_like(v)) for k, v in tree.items()})
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            np.testing.assert_array_equal(got[k], v)
    jtree = dict(_jax_tree(3), h=jnp.linspace(-3, 3, 9, dtype=jnp.float16),
                 i=np.arange(-4, 4, dtype=np.int64), z=np.arange(5, dtype=np.uint8))
    jpath = jckpt.save_checkpoint(tmp_path / "jax", jtree, 3, metadata={"k": 1})
    assert _manifest(path) == _manifest(jpath)
    assert verify_checkpoint(jpath) == 3 and jckpt.verify_checkpoint(path) == 3


def test_bf16_leaves_cross_both_ways(tmp_path):
    jpath = jckpt.save_checkpoint(tmp_path / "jax", _jax_tree(5), 5)
    got = restore_checkpoint(jpath, _zeros(_tree(0)))
    _assert_tree(got, 5)
    path = save_checkpoint(tmp_path / "port", _tree(5), 5)
    back = jckpt.restore_checkpoint(path, jax.tree.map(jnp.zeros_like, _jax_tree(0)))
    for k, v in _jax_tree(5).items():
        assert np.asarray(back[k]).dtype == np.asarray(v).dtype
        assert np.asarray(back[k]).tobytes() == np.asarray(v).tobytes(), k


# ------------------------------------------------------ TrainState interop


def _lm_batch():
    x = np.random.default_rng(0).integers(0, LM["vocab_size"], (2, 9))
    return x[:, :-1], x[:, 1:]


def test_jax_lm_adam_state_restores_into_the_port(tmp_path):
    jm = JaxLM(**LM)
    opt = jax_optimizer("adam", 1e-2)
    jts = JaxTS.create(jm, opt, jax.random.key(0))
    step = jax_step(jm, opt)
    for _ in range(2):
        jts, _ = step(jts, *_lm_batch())
    jckpt.save_checkpoint(tmp_path, jts, 2)
    model = TransformerLM(**LM, device="cpu")
    ts = TrainState.create(model, make_optimizer("adam", 1e-2))
    assert restore_checkpoint(tmp_path / "step_2", ts) is ts
    want = lm_params_from_tpudml(_np(jts.params))
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n
    adam = adam_state_from_tpudml(_np(jts.opt_state))
    for k in ("m", "v"):
        for n, t in adam[k].items():
            assert torch.equal(ts.opt_state[k][n], t), (k, n)
    assert ts.opt_state["t"] == 2 and ts.step == 2


def test_port_lm_state_passes_jax_verify_and_restore(tmp_path):
    model = TransformerLM(**LM, device="cpu", generator=torch.Generator().manual_seed(1))
    opt = make_optimizer("adam", 1e-2)
    ts = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    for _ in range(3):
        ts, _ = step(ts, *_lm_batch())
    path = save_checkpoint(tmp_path, ts, ts.step)
    assert jckpt.verify_checkpoint(path) == 3
    template = JaxTS.create(JaxLM(**LM), jax_optimizer("adam", 1e-2), jax.random.key(9))
    back = jckpt.restore_checkpoint(path, template)
    assert int(back.step) == 3 and int(back.opt_state["t"]) == 3
    params = lm_params_from_tpudml(_np(back.params))
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
    adam = adam_state_from_tpudml(_np(back.opt_state))
    for n in adam["v"]:
        assert torch.equal(ts.opt_state["v"][n], adam["v"][n]), n


def test_lenet_sgd_momentum_conv_layout_both_ways(tmp_path):
    jopt = jax_optimizer("sgd", 0.01, 0.9)
    jts = JaxTS.create(JaxLeNet(), jopt, jax.random.key(1))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    jts, _ = jax_step(JaxLeNet(), jopt)(jts, x, y)
    jckpt.save_checkpoint(tmp_path / "jax", jts, 1)
    model = LeNet(device="cpu")
    ts = TrainState.create(model, make_optimizer("sgd", 0.01, 0.9))
    restore_checkpoint(tmp_path / "jax" / "step_1", ts)
    want = sequential_params_from_tpudml(_np(jts.params))
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n
    buf = sgd_state_from_tpudml(_np(jts.opt_state))
    for n, t in buf.items():
        assert torch.equal(ts.opt_state[n], t), n
    path = save_checkpoint(tmp_path / "port", ts, 1)
    back = jckpt.restore_checkpoint(path, JaxTS.create(JaxLeNet(), jopt, jax.random.key(7)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dp_sentinel_state_crosses_both_ways(tmp_path):
    """JAX's DataParallel(sentinel=True) state (the counters after a
    skipped step) restores into the port's, and back."""
    mesh = make_mesh(MeshConfig({"data": 1}), jax.devices()[:1])
    jdp = JaxDP(JaxLM(**LM), jax_optimizer("adam", 1e-2), mesh, stacked_batches=False,
                sentinel=True)
    jts = jdp.create_state(jax.random.key(3))
    step = jdp.make_train_step()
    for _ in range(2):
        jts, _ = step(jts, *_lm_batch())
    jts = jax.tree.map(jnp.asarray, jts)
    jckpt.save_checkpoint(tmp_path / "jax", jts, 2)
    with process_group(DistributedConfig(coordinator_address=f"file://{tmp_path}/store",
                                         num_processes=1), device="cpu"):
        model = TransformerLM(**LM, device="cpu")
        dp = DataParallel(model, make_optimizer("adam", 1e-2), stacked_batches=False,
                          sentinel=True)
        ts = dp.create_state()
        restore_checkpoint(tmp_path / "jax" / "step_2", ts)
        st = ts.opt_state
        jst = _np(jts.opt_state)
        for k in ("skips", "consecutive", "good_steps", "norm_ema", "bad_leaf"):
            assert st[k].dtype == torch.from_numpy(jst[k]).dtype
            assert torch.equal(st[k], torch.from_numpy(jst[k])), k
        assert int(st["base"]["t"]) == 2 and ts.step == 2
        adam = adam_state_from_tpudml(jst["base"])
        for n, t in adam["m"].items():
            assert torch.equal(st["base"]["m"][n], t), n
        path = save_checkpoint(tmp_path / "port", ts, 2)
    back = jckpt.restore_checkpoint(path, jts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ vandals


@pytest.mark.parametrize("kind", KINDS)
def test_vandal_detected_and_fallback_as_jax(tmp_path, kind, capsys):
    for s in (1, 2):
        save_checkpoint(tmp_path / "port", _tree(s), s)
        jckpt.save_checkpoint(tmp_path / "jax", _jax_tree(s), s)
    vandalize(str(tmp_path / "port"), kind, seed=3)
    jax_vandalize(str(tmp_path / "jax"), kind, seed=3)
    for d in ("port", "jax"):
        with pytest.raises((CheckpointCorruptError, OSError)):
            verify_checkpoint(tmp_path / d / "step_2")
        with pytest.raises((jckpt.CheckpointCorruptError, OSError)):
            jckpt.verify_checkpoint(tmp_path / d / "step_2")
        _assert_tree(restore_latest_valid(tmp_path / d, _zeros(_tree(0))), 1)
        jout = jckpt.restore_latest_valid(tmp_path / d,
                                          jax.tree.map(jnp.zeros_like, _jax_tree(0)))
        assert int(jout["n"]) == 1
    assert "skipping invalid" in capsys.readouterr().err


def test_no_valid_checkpoint_raises_and_empty_passes_through(tmp_path):
    assert restore_latest_valid(tmp_path, "target") == "target"
    save_checkpoint(tmp_path, _tree(1), 1)
    save_checkpoint(tmp_path, _tree(2), 2)
    vandalize(str(tmp_path), "bitflip", step=1)
    vandalize(str(tmp_path), "partial", step=2)
    with pytest.raises(CheckpointCorruptError, match="step_1") as exc:
        restore_latest_valid(tmp_path, _zeros(_tree(0)))
    assert "step_2" in str(exc.value)


# ------------------------------------------------- manager, async, errors


def test_retention_spares_the_only_valid_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    for s in (1, 2, 3):
        mgr.save(_tree(s), s)
    vandalize(str(tmp_path), "bitflip", step=2)
    vandalize(str(tmp_path), "partial", step=3)
    mgr.keep = 1
    mgr._prune()
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert "step_3" in kept and "step_1" in kept and "step_2" not in kept
    _assert_tree(restore_latest_valid(tmp_path, _zeros(_tree(0))), 1)
    mgr = CheckpointManager(tmp_path / "roll", keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(_tree(s), s)
    assert sorted(p.name for p in (tmp_path / "roll").iterdir()) == ["step_3", "step_4"]
    assert mgr.latest_step() == 4 and latest_checkpoint(tmp_path / "roll").endswith("step_4")


def test_async_write_snapshots_before_returning_and_surfaces_its_error(tmp_path):
    tree = _tree(4)
    mgr = CheckpointManager(tmp_path / "a", async_write=True)
    mgr.save(tree, 4)
    tree["w"].add_(100.0)  # the next step updates in place
    mgr.wait()
    _assert_tree(mgr.restore_latest(_zeros(_tree(0))), 4)
    (tmp_path / "file").write_text("not a directory")
    bad = CheckpointManager(tmp_path / "file", async_write=True)
    bad.save(_tree(1), 1)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error surfaced once


def test_structure_shape_and_dtype_mismatch(tmp_path):
    path = save_checkpoint(tmp_path, _tree(1), 1)
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(path, {"w": torch.zeros(64, 8)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, dict(_zeros(_tree(0)), w=torch.zeros(8, 64)))
    model = TransformerLM(**LM, device="cpu")
    ts = TrainState.create(model, make_optimizer("adam", 1e-2))
    p = save_checkpoint(tmp_path / "ts", ts, 0)
    half = TransformerLM(**LM, device="cpu").to(torch.float16)
    ts16 = TrainState.create(half, make_optimizer("adam", 1e-2))
    before = {n: t.clone() for n, t in half.named_parameters()}
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(p, ts16)
    assert all(torch.equal(t, before[n]) for n, t in half.named_parameters())
    with pytest.raises(ValueError, match="every_n_steps"):
        CheckpointHook(CheckpointManager(tmp_path), every_n_steps=0)


# ------------------------------------------------- kill -> resume parity


class _Loader:
    """Deterministic epoch-reshuffled loader with ``set_epoch``/``len``."""

    def __init__(self, x, y, batch):
        self.x, self.y, self.batch, self.epoch = x, y, batch, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.x) // self.batch

    def __iter__(self):
        order = np.random.default_rng(100 + self.epoch).permutation(len(self.x))
        for i in range(len(self)):
            sl = order[i * self.batch: (i + 1) * self.batch]
            yield self.x[sl], self.y[sl]


class _KillAt(Exception):
    pass


def test_kill_resume_parity_bit_exact(tmp_path):
    """Rolling saves every 2 steps, killed at step 9 (mid epoch 2), the
    newest checkpoint (step 8) torn: the restore walks back to step 6 and
    the resumed run's parameters and moments equal an uninterrupted
    run's bitwise."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(24, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(24,)).astype(np.int32)

    def lenet():
        return LeNet(device="cpu", generator=torch.Generator().manual_seed(0))

    opt = make_optimizer("adam", 1e-3)
    ref = lenet()
    ts_ref, _ = train_loop(ref, opt, _Loader(x, y, 4), 2, log_every=0)

    def kill(*, step, **_):
        if step == 9:
            raise _KillAt(str(step))

    mgr = CheckpointManager(tmp_path, keep=5)
    with pytest.raises(_KillAt):
        train_loop(lenet(), opt, _Loader(x, y, 4), 2, log_every=0,
                   hooks=[CheckpointHook(mgr, every_n_steps=2), kill])
    vandalize(str(tmp_path), "truncate")  # step_8 is a torn write
    fresh = LeNet(device="cpu", generator=torch.Generator().manual_seed(99))
    ts = mgr.restore_latest(TrainState.create(fresh, opt))
    assert ts.step == 6
    ts_res, _ = train_loop(fresh, opt, _Loader(x, y, 4), 2, log_every=0, state=ts)
    assert ts_res.step == ts_ref.step == 12
    for (n, a), b in zip(ref.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n, t in ts_ref.opt_state[k].items():
            assert torch.equal(t, ts_res.opt_state[k][n]), (k, n)
