"""task5 ``--parallel fsdp`` and ``--parallel tp`` of the port against JAX's
task5, and FSDP states through the sharded store, on the CPU.

- At world 2 over gloo (``tests/torch_dist_worker.py``'s ``mp_cli``
  suite), the port's task5 (``--attn flash --fused_ln --rope``, Adam, 4
  steps) from JAX's initial parameters: every step's loss equals JAX's
  task5 engine's on two CPU devices with the same flags, for ``fsdp``
  and ``tp``, plain and with ``--fused_xent`` (the vocab-sharded head;
  JAX's on its sharded reference) and ``--sentinel`` (no step skipped:
  the same losses).
- ``--ckpt_dir`` under both at world 2 writes what JAX's task5 writes
  (the same leaves, shapes and dtypes: whole parameters and moments),
  and a resume from the step-2 checkpoint ends on the uninterrupted
  run's step-4 files bitwise.
- ``tests/test_sharded_ckpt.py``'s FSDP case: an FSDP state (the small
  LM, Adam, one step; parameters and moments 1/W a rank) saved by both
  ranks, restored into a fresh engine's state bitwise, and the next step
  of each equal; JAX's FSDP at one process and four devices restores the
  ranks' file (every leaf bitwise the gathered state).

Tolerances: losses rtol 1e-5 (f32; the sums in another order than XLA's).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tasks import task5_longcontext as jax_task5  # noqa: E402
from tpudml.checkpoint import restore_sharded_checkpoint as jax_restore  # noqa: E402
from tpudml.core.config import MeshConfig  # noqa: E402
from tpudml.core.dist import make_mesh  # noqa: E402
from tpudml.core.prng import seed_key  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import Adam as JaxAdam  # noqa: E402
from tpudml.parallel.fsdp import FSDP as JaxFSDP  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402

TASK5 = ["--vocab", "32", "--embed_dim", "32", "--num_heads", "4", "--num_layers", "2",
         "--seq_len", "16", "--batch_size", "4", "--lr", "0.01", "--steps", "4",
         "--log_every", "0", "--attn", "flash", "--fused_ln", "--rope"]
RUNS = {f"{par}{tag}": ["--parallel", par, *extra]
        for par in ("fsdp", "tp")
        for tag, extra in (("", []), ("_fused", ["--fused_xent"]),
                           ("_sentinel", ["--sentinel"]))}
LM = dict(vocab_size=32, embed_dim=32, num_heads=4, num_layers=1, max_len=8)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_losses(flags: list[str], tmp) -> tuple[list[float], dict]:
    """JAX's task5 engine on two CPU devices, stepped over the batches its
    run draws; with its initial parameters."""
    args = jax_task5.parse_args(flags + ["--log_dir", str(tmp)])
    ts, step = jax_task5.build_engine(args, jax.devices()[:2])
    params0 = _np(ts.params)
    seqs = synthetic_lm(args.batch_size * 4, args.seq_len, args.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    losses = []
    for _ in range(args.steps):
        batch = seqs[rng.integers(0, len(seqs), size=args.batch_size)]
        ts, m = step(ts, batch[:, :-1], batch[:, 1:])
        losses.append(float(m["loss"]))
    return losses, params0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("mp_cli")
    want, state = {}, None
    for name, extra in RUNS.items():
        want[name], params0 = _jax_losses(TASK5 + extra, job)
        state = state or lm_params_from_tpudml(params0)  # seed_key(0): the same each run
    for par in ("fsdp", "tp"):
        jax_task5.main(TASK5 + ["--parallel", par, "--n_devices", "2", "--ckpt_every", "2",
                                "--ckpt_dir", str(job / f"jax_{par}"),
                                "--log_dir", str(job / "jax_logs")])
    lm0, _ = JaxLM(**LM).init(seed_key(0))
    seqs = synthetic_lm(4, LM["max_len"], LM["vocab_size"], seed=3)
    torch.save({"task5": TASK5 + ["--device", "cpu"], "runs": RUNS, "task5_state": state,
                "lm": dict(LM), "lm_state": lm_params_from_tpudml(_np(lm0)),
                "tokens": seqs[:, :-1], "labels": seqs[:, 1:]}, job / "cases.pt")
    return want, torch_dist_worker.spawn("mp_cli", job, 2), job


@pytest.mark.parametrize("name", list(RUNS))
def test_task5_matches_jax_task5_at_world_2(runs, name):
    want, ranks, _ = runs
    for got in ranks:
        out, losses = got[name]
        assert out["devices"] == 2
        np.testing.assert_allclose(losses, want[name], rtol=1e-5)
        assert out["final_loss"] == losses[-1]
    if name.endswith("_sentinel"):  # no step skipped: the plain run's losses
        assert ranks[0][name][1] == ranks[0][name.removesuffix("_sentinel")][1]


@pytest.mark.parametrize("par", ["fsdp", "tp"])
def test_task5_checkpoint_is_jax_layout_and_resumes_bitwise(runs, par):
    _, ranks, job = runs
    for got in ranks:
        assert got[f"{par}_b"]["final_loss"] == got[f"{par}_a"]["final_loss"]

    def layout(step_dir):
        man = json.loads((step_dir / "manifest.json").read_text())
        with np.load(step_dir / "leaves.npz") as data:
            return man["num_leaves"], [(data[k].shape, data[k].dtype) for k in sorted(data.files)]

    assert layout(job / f"{par}_ref" / "step_4") == layout(job / f"jax_{par}" / "step_4")
    with np.load(job / f"{par}_ref" / "step_4" / "leaves.npz") as a, \
            np.load(job / f"{par}_run" / "step_4" / "leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_fsdp_state_through_the_sharded_store(runs):
    _, ranks, job = runs
    for got in ranks:
        assert got["fsdp_roundtrip"] and got["fsdp_resumed_equal"]
        a, b = got["fsdp_resumed_losses"]
        assert a == b
    mesh = make_mesh(MeshConfig({"data": 4}), jax.devices()[:4])
    eng = JaxFSDP(JaxLM(**LM), JaxAdam(lr=1e-3), mesh)
    restored = jax_restore(job / "port_fsdp" / "step_1", eng.create_state(seed_key(9)))
    assert int(restored.step) == 1
    for n, t in lm_params_from_tpudml(_np(restored.params)).items():
        assert torch.equal(t, ranks[0]["fsdp_full"][n]), n
    for n, t in lm_params_from_tpudml(_np(restored.opt_state["m"])).items():
        assert torch.equal(t, ranks[0]["fsdp_m_full"][n]), n
