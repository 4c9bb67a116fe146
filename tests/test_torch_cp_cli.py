"""task5 ``--parallel cp`` of the port against JAX's task5, on the CPU.

At world 2 over gloo (``tests/torch_dist_worker.py``'s ``cp_cli`` suite,
spawned once), from JAX's initial parameters, four Adam steps of task5's
row stream at ``--seq_len 16`` (``--fused_ln --rope``): ``--attn ring``,
ring ``--cp_layout striped``, ``--attn ulysses``, ring ``--fused_xent``
(the saved-scores head on each shard), ring ``--dropout 0.1`` (every mask
JAX's ``bernoulli`` at the key rebuilt from the port key's fold path:
step, seq index, block, salt) and ring ``--moe_experts 4`` (the MoE
blocks route each shard's tokens, α = 0.01): every step's loss equals
JAX's task5 engine's on two CPU devices within rtol 1e-5 (f32, sums in
another order than XLA's). In-process: the rejections keep JAX's words.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker  # noqa: E402
from tasks import task5_longcontext as jax_task5  # noqa: E402
from tpudml_torch.core.prng import Key  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.tasks import task5_longcontext as task5  # noqa: E402

BASE = ["--vocab", "32", "--embed_dim", "32", "--num_heads", "4", "--num_layers", "2",
        "--seq_len", "16", "--batch_size", "8", "--lr", "0.01", "--steps", "4",
        "--log_every", "0", "--fused_ln", "--rope", "--parallel", "cp"]
RUNS = {"ring": ["--attn", "ring"],
        "ring_striped": ["--attn", "ring", "--cp_layout", "striped"],
        "ulysses": ["--attn", "ulysses"],
        "ring_fused_xent": ["--attn", "ring", "--fused_xent"],
        "ring_dropout": ["--attn", "ring", "--dropout", "0.1"],
        "ring_moe": ["--attn", "ring", "--moe_experts", "4"]}


def jax_key(key: Key):
    k = jax.random.key(key.seed)
    for entry in key.path:
        if entry[0] == "fold":
            k = jax.random.fold_in(k, np.uint32(entry[1]))
        else:
            k = jax.random.split(k, entry[1])[entry[2]]
    return k


def _jax_losses(flags, tmp, n=2):
    args = jax_task5.parse_args(BASE + flags + ["--log_dir", str(tmp)])
    ts, step = jax_task5.build_engine(args, jax.devices()[:n])
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), jax.device_get(ts.params))
    seqs = synthetic_lm(args.batch_size * 4, args.seq_len, args.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    losses = []
    for _ in range(args.steps):
        batch = seqs[rng.integers(0, len(seqs), size=args.batch_size)]
        ts, m = step(ts, batch[:, :-1], batch[:, 1:])
        losses.append(float(m["loss"]))
    return losses, lm_params_from_tpudml(params0)


def _masks(steps=4, world=2, layers=2, rate=0.1):
    """JAX's masks at every key the port's cp run folds: task5's root
    ``seed ^ 0xD0``, the step, the seq index, the block, the salt; each a
    shard's [B, T/W, d]."""
    out = {}
    for step in range(steps):
        for idx in range(world):
            for i in range(layers):
                for salt in (1, 2):
                    key = Key(0 ^ 0xD0).fold_in(step).fold_in(idx).fold_in(i).fold_in(salt)
                    out[key.path] = np.array(jax.random.bernoulli(
                        jax_key(key), 1.0 - rate, (8, 16 // world, 32)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = tmp_path_factory.mktemp("cp_cli")
    want, states = {}, {}
    for name, flags in RUNS.items():
        want[name], states[name] = _jax_losses(flags, job)
    torch.save({"base": BASE + ["--device", "cpu"], "runs": RUNS, "states": states,
                "masks": _masks()}, job / "cases.pt")
    return want, torch_dist_worker.spawn("cp_cli", job, 2)


@pytest.mark.parametrize("name", list(RUNS))
def test_task5_cp_matches_jax_task5_at_world_2(runs, name):
    want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[name]["losses"], want[name], rtol=1e-5)
        assert got[name]["final_loss"] == got[name]["losses"][-1]


@pytest.mark.parametrize("flags,match", [
    (["--parallel", "dp", "--attn", "ring"], "--attn ring requires --parallel cp"),
    (["--cp_layout", "striped"], "--cp_layout striped requires --parallel cp"),
    (["--parallel", "cp", "--attn", "ulysses", "--cp_layout", "striped"],
     "--cp_layout striped requires --attn ring"),
    (["--parallel", "cp", "--attn", "flash"], "cp needs --attn ring|ulysses"),
    (["--parallel", "cp", "--sentinel"], "--sentinel composes with --parallel dp/fsdp/tp/pp, "
     "not 'cp'"),
])
def test_task5_cp_rejections_keep_jax_s_words(tmp_path, flags, match):
    argv = BASE[:-2] + flags + ["--device", "cpu", "--log_dir", str(tmp_path)]
    match = re.escape(match)
    with pytest.raises(ValueError, match=match):
        task5.main(argv)
    with pytest.raises(ValueError, match=match):
        jax_task5.build_engine(jax_task5.parse_args(argv[:-4] + ["--log_dir", str(tmp_path)]),
                               jax.devices()[:2])
