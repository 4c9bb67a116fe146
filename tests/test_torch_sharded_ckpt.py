"""The sharded store (``tpudml_torch.checkpoint.sharded``) against
``tpudml.checkpoint.sharded``, on the CPU.

``tests/test_sharded_ckpt.py``'s cases but FSDP's (ROADMAP item 7c):

- a tensor-parallel GSPMD state (the small LM, Adam, one step) saved at
  world 2 over gloo (``tests/torch_dist_worker.py``'s ``sharded`` suite)
  and restored bitwise into a fresh engine's state, and an EP state
  likewise;
- a replicated tree is written once; an incomplete checkpoint and a
  structure mismatch are rejected; a corrupt shard fails its CRC, and
  ``restore_latest_valid_sharded`` walks past it;
- each package restores the other's file at another process count: the
  ranks restore JAX's (one process, two devices) into their blocks; JAX
  (one process) and the port at world 1 restore the ranks' (two
  processes); every leaf bitwise;
- task5 ``--parallel ep --ckpt_dir`` at world 2 writes what JAX's task5
  writes (the same leaves, shapes and dtypes: whole experts), and a
  resume from its step-2 checkpoint ends bitwise on the uninterrupted
  run's step-4 state and losses.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import torch_dist_worker  # noqa: E402
from tasks import task5_longcontext as jax_task5  # noqa: E402
from tpudml.checkpoint import restore_sharded_checkpoint as jax_restore  # noqa: E402
from tpudml.checkpoint import save_sharded_checkpoint as jax_save  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import Adam as JaxAdam  # noqa: E402
from tpudml.parallel import mp as jmp  # noqa: E402
from tpudml_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptError, restore_latest_valid_sharded, restore_sharded_checkpoint,
    save_sharded_checkpoint, verify_sharded_checkpoint,
)
from tpudml_torch.core import DistributedConfig, process_group  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.optim import Adam  # noqa: E402
from tpudml_torch.parallel import GSPMDParallel, tensor_parallel_rules  # noqa: E402

LM = dict(vocab_size=32, embed_dim=32, num_heads=4, num_layers=1, max_len=8)
TASK5 = ["--parallel", "ep", "--vocab", "32", "--embed_dim", "32", "--num_heads", "4",
         "--num_layers", "2", "--seq_len", "16", "--batch_size", "4", "--lr", "0.01",
         "--steps", "4", "--ckpt_every", "2", "--log_every", "1", "--moe_experts", "4"]


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_tp(n_devices: int):
    mesh = make_mesh(MeshConfig({"model": n_devices}), jax.devices()[:n_devices])
    return jmp.GSPMDParallel(JaxLM(**LM), JaxAdam(lr=1e-3), mesh,
                             rule=jmp.tensor_parallel_rules("model"), axis_name="model")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("sharded")
    seqs = synthetic_lm(4, LM["max_len"], LM["vocab_size"], seed=3)
    tokens, labels = seqs[:, :-1], seqs[:, 1:]
    tp = _jax_tp(2)
    ts = tp.create_state(seed_key(0))
    ts, _ = tp.make_train_step()(ts, tokens, labels)
    jax_save(job / "jax_tp", ts, step=3)
    lm0, _ = JaxLM(**LM).init(seed_key(0))
    rng = np.random.default_rng(4)
    torch.save({"lm": dict(LM), "lm_state": lm_params_from_tpudml(_np(lm0)),
                "tokens": tokens, "labels": labels,
                "jax_tp_params": _np(ts.params), "jax_tp_opt": _np(ts.opt_state),
                "ep_x": rng.normal(size=(8, 4, 4)).astype(np.float32),
                "ep_y": rng.integers(0, 4, size=(8,)).astype(np.int64),
                "task5": TASK5 + ["--device", "cpu"]}, job / "cases.pt")
    jax_task5.main(TASK5 + ["--n_devices", "2", "--ckpt_dir", str(job / "jax_ep"),
                            "--log_dir", str(job / "jax_logs")])
    return torch_dist_worker.spawn("sharded", job, 2), job


def test_tp_sharded_roundtrip_at_world_2(runs):
    ranks, job = runs
    for got in ranks:
        assert got["roundtrip"] and got["verified_step"] == 1
    assert sorted(os.listdir(job / "port_tp" / "step_1")) == [
        "manifest_p0.json", "manifest_p1.json", "shards_p0.npz", "shards_p1.npz"]


def test_ep_expert_shards_roundtrip(runs):
    ranks, _ = runs
    assert all(got["ep_roundtrip"] for got in ranks)


def test_each_package_restores_the_others_file(runs, tmp_path):
    """JAX's one-process file into the ranks' blocks (in the suite); the
    ranks' two-process file into JAX at one process and four devices, and
    into the port at world 1: the ranks' state, bitwise."""
    ranks, job = runs
    assert all(got["from_jax"] for got in ranks)
    full = ranks[0]["full"]
    tp = _jax_tp(4)
    restored = jax_restore(job / "port_tp" / "step_1", tp.create_state(seed_key(9)))
    assert int(restored.step) == 1
    for n, t in lm_params_from_tpudml(_np(restored.params)).items():
        assert torch.equal(t, full[n]), n
    for n, t in lm_params_from_tpudml(_np(restored.opt_state["m"])).items():
        assert torch.equal(t, ranks[0]["m_full"][n]), n
    cfg = DistributedConfig(coordinator_address=f"file://{tmp_path}/store")
    with process_group(cfg, device="cpu"):
        model = TransformerLM(**LM, device="cpu", generator=torch.Generator().manual_seed(5))
        mp = GSPMDParallel(model, Adam(lr=1e-3), rule=tensor_parallel_rules("model"),
                           axis_name="model")
        ts = mp.create_state()
        restore_sharded_checkpoint(job / "port_tp" / "step_1", ts, placement=mp.placement)
        assert ts.step == 1
        for n, p in model.named_parameters():
            assert torch.equal(p, full[n]), n


def test_task5_ep_checkpoint_is_jax_layout_and_resumes_bitwise(runs):
    ranks, job = runs
    for got in ranks:
        assert got["b"]["final_loss"] == got["a"]["final_loss"]

    def layout(step_dir):
        man = json.loads((step_dir / "manifest.json").read_text())
        with np.load(step_dir / "leaves.npz") as data:
            return man["num_leaves"], [(data[k].shape, data[k].dtype) for k in sorted(data.files)]

    assert layout(job / "ref" / "step_4") == layout(job / "jax_ep" / "step_4")
    with np.load(job / "ref" / "step_4" / "leaves.npz") as a, \
            np.load(job / "run" / "step_4" / "leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


# ------------------------------------------------------------ one process


def test_replicated_state_written_once(tmp_path):
    tree = {"w": torch.arange(16.0).reshape(4, 4), "n": np.int32(7)}
    path = save_sharded_checkpoint(tmp_path, tree, step=0)
    assert os.path.basename(path) == "step_0"
    with np.load(os.path.join(path, "shards_p0.npz")) as data:
        assert len(data.files) == 2
    back = restore_sharded_checkpoint(path, {"w": torch.zeros(4, 4), "n": np.int32(0)})
    assert torch.equal(back["w"], tree["w"]) and int(back["n"]) == 7
    # JAX reads the port's file, and the port JAX's.
    want = jax_restore(path, {"w": jnp.zeros((4, 4)), "n": jnp.int32(0)})
    np.testing.assert_array_equal(np.asarray(want["w"]), tree["w"].numpy())
    jpath = jax_save(tmp_path / "jax", {"w": jnp.arange(16.0).reshape(4, 4)}, step=1)
    assert torch.equal(restore_sharded_checkpoint(jpath, {"w": torch.zeros(4, 4)})["w"],
                       tree["w"])


def test_incomplete_checkpoint_rejected(tmp_path):
    path = save_sharded_checkpoint(tmp_path, {"w": torch.ones(4)}, step=0)
    mpath = os.path.join(path, "manifest_p0.json")
    m = json.load(open(mpath))
    m["num_processes"] = 2
    json.dump(m, open(mpath, "w"))
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        restore_sharded_checkpoint(path, {"w": torch.ones(4)})


def test_structure_mismatch_rejected(tmp_path):
    path = save_sharded_checkpoint(tmp_path, {"a": torch.ones(3)}, step=0)
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_sharded_checkpoint(path, {"a": torch.ones(3), "b": torch.ones(2)})


def test_corrupt_shard_fails_its_crc_and_latest_valid_walks_past(tmp_path):
    save_sharded_checkpoint(tmp_path, {"w": torch.arange(64.0)}, step=1)
    path = save_sharded_checkpoint(tmp_path, {"w": torch.arange(64.0) + 1}, step=2)
    npz = os.path.join(path, "shards_p0.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[len(raw) // 2] ^= 0xFF  # inside the stored array
    open(npz, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        verify_sharded_checkpoint(path)
    back = restore_latest_valid_sharded(tmp_path, {"w": torch.zeros(64)})
    assert torch.equal(back["w"], torch.arange(64.0))
    assert restore_latest_valid_sharded(tmp_path / "none", {"w": 1}) == {"w": 1}
