"""task5 ``--parallel pp`` of the port against JAX's task5, on the CPU.

At world 2 over gloo (``tests/torch_dist_worker.py``'s ``pp_cli`` suite,
spawned once), from JAX's initial parameters:

- task5 (``--attn flash --fused_ln --rope``, Adam, 4 steps, one block a
  stage) with ``--schedule gpipe``, ``1f1b --dropout 0.1`` (every mask
  JAX's ``bernoulli`` at the key rebuilt from the port key's fold path:
  step, stage, micro-batch, the branch's salt), ``interleaved`` and
  ``gpipe --sentinel`` (no step skipped: gpipe's losses, bitwise): every
  step's loss equals JAX's task5 engine's on two CPU devices;
- ``--ckpt_dir`` under gpipe writes JAX's leaves (the stages gathered to
  ``[S, ...]``: the same leaves, shapes and dtypes as JAX's task5's
  checkpoint), and a resume from the step-2 checkpoint ends on the
  uninterrupted run's step-4 files bitwise;

(task4's pipelines: ``tests/test_torch_pp_task4.py``.) Tolerances: losses
rtol 1e-5 (f32; the sums in another order than XLA's).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tasks import task5_longcontext as jax_task5  # noqa: E402
from tpudml_torch.core.prng import Key  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402

BASE = ["--vocab", "32", "--embed_dim", "32", "--num_heads", "4", "--seq_len", "16",
        "--batch_size", "8", "--lr", "0.01", "--steps", "4", "--log_every", "0",
        "--attn", "flash", "--fused_ln", "--rope", "--parallel", "pp"]
RUNS = {"gpipe": ["--schedule", "gpipe"],
        "1f1b_dropout": ["--schedule", "1f1b", "--dropout", "0.1"],
        "interleaved": ["--schedule", "interleaved"],
        "gpipe_sentinel": ["--schedule", "gpipe", "--sentinel"]}


def jax_key(key: Key):
    k = jax.random.key(key.seed)
    for entry in key.path:
        if entry[0] == "fold":
            k = jax.random.fold_in(k, np.uint32(entry[1]))
        else:
            k = jax.random.split(k, entry[1])[entry[2]]
    return k


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_losses(flags, tmp, n=2):
    args = jax_task5.parse_args(BASE + flags + ["--log_dir", str(tmp)])
    ts, step = jax_task5.build_engine(args, jax.devices()[:n])
    params0 = _np(ts.params)
    seqs = synthetic_lm(args.batch_size * 4, args.seq_len, args.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    losses = []
    for _ in range(args.steps):
        batch = seqs[rng.integers(0, len(seqs), size=args.batch_size)]
        ts, m = step(ts, batch[:, :-1], batch[:, 1:])
        losses.append(float(m["loss"]))
    return losses, params0


def _masks(steps=4, stages=2, micro=4, rate=0.1):
    """JAX's masks at every key the port's 1F1B run folds: task5's root
    ``seed ^ 0xD0``, the step, the stage, the micro-batch, the salt."""
    out = {}
    for step in range(steps):
        for s in range(stages):
            for m in range(micro):
                for salt in (1, 2):
                    key = Key(0 ^ 0xD0).fold_in(step).fold_in(s).fold_in(m).fold_in(salt)
                    out[key.path] = np.array(jax.random.bernoulli(
                        jax_key(key), 1.0 - rate, (8 // micro, 16, 32)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("pp_cli")
    want, states = {}, {}
    for name, flags in RUNS.items():
        if name != "gpipe_sentinel":  # no step skipped: gpipe's losses
            want[name], states[name] = _jax_losses(flags, job)
    want["gpipe_sentinel"], states["gpipe_sentinel"] = want["gpipe"], states["gpipe"]
    jax_task5.main(BASE + ["--schedule", "gpipe", "--n_devices", "2", "--ckpt_every", "2",
                           "--ckpt_dir", str(job / "jax_ckpt"), "--log_dir", str(job / "jl")])
    torch.save({"base": BASE + ["--device", "cpu"], "task5": RUNS, "states": states,
                "masks": _masks(), "ckpt": "gpipe"}, job / "cases.pt")
    return want, torch_dist_worker.spawn("pp_cli", job, 2), job


@pytest.mark.parametrize("name", list(RUNS))
def test_task5_pp_matches_jax_task5_at_world_2(runs, name):
    want, ranks, _ = runs
    for got in ranks:
        np.testing.assert_allclose(got[name]["losses"], want[name], rtol=1e-5)
        assert got[name]["final_loss"] == got[name]["losses"][-1]
    if name == "gpipe_sentinel":
        assert ranks[0][name]["losses"] == ranks[0]["gpipe"]["losses"]


def test_task5_pp_checkpoint_is_jax_layout_and_resumes_bitwise(runs):
    _, ranks, job = runs
    for got in ranks:
        assert got["ckpt_b"]["final_loss"] == got["ckpt_a"]["final_loss"]

    def layout(step_dir):
        man = json.loads((step_dir / "manifest.json").read_text())
        with np.load(step_dir / "leaves.npz") as data:
            return man["num_leaves"], [(data[k].shape, data[k].dtype) for k in sorted(data.files)]

    assert layout(job / "ref" / "step_4") == layout(job / "jax_ckpt" / "step_4")
    with np.load(job / "ref" / "step_4" / "leaves.npz") as a, \
            np.load(job / "run" / "step_4" / "leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)

