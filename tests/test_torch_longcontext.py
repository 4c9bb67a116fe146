"""The long-context training path on the lean fused-xent head, against
JAX's task5 engine, on the CPU.

The port's ``task5_longcontext --attn flash --rope --fused_xent
--fused_xent_lean`` (``--fused_ln`` off and on) at a tiny config, where
its kernels run their plain versions, against ``tasks/task5_longcontext.py``
built with the same flags (``save_scores=False``; on the CPU its flash
attention, fused add+LN and fused head dispatch to their reference math).
The port's model takes the JAX engine's initial parameters
(``lm_params_from_tpudml``); the batch is the first one both entry points
draw (``synthetic_lm(4·B, T, V, seed)`` rows by
``np.random.default_rng(seed)``).

Tolerances (f32): loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6
(``tests/test_torch_train.py``'s: sums over T, d and the embedding rows
in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tasks import task5_longcontext as jax_task5  # noqa: E402
from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.train import make_lm_fused_loss_fn as jax_fused_loss_fn  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.tasks import task5_longcontext as task5  # noqa: E402
from tpudml_torch.train import make_lm_fused_loss_fn, params_of  # noqa: E402

V, D, H, L, T, B = 32, 32, 4, 2, 16, 4
FLAGS = ["--vocab", str(V), "--embed_dim", str(D), "--num_heads", str(H),
         "--num_layers", str(L), "--seq_len", str(T), "--batch_size", str(B),
         "--lr", "0.01", "--attn", "flash", "--rope", "--fused_xent",
         "--fused_xent_lean", "--steps", "1"]
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _first_batch(seed=0):
    seqs = synthetic_lm(B * 4, T, V, seed=seed)
    rows = np.random.default_rng(seed).integers(0, len(seqs), size=B)
    batch = seqs[rows]
    return batch[:, :-1], batch[:, 1:]


@pytest.mark.parametrize("fused_ln", [False, True], ids=["plain_ln", "fused_ln"])
def test_lean_step1_matches_jax_task5_engine(tmp_path, fused_ln):
    flags = FLAGS + (["--fused_ln"] if fused_ln else [])
    jargs = jax_task5.parse_args(flags + ["--log_dir", str(tmp_path)])
    jts, jstep = jax_task5.build_engine(jargs, jax.devices()[:1])
    assert jargs._save_scores is False
    targs = task5.parse_args(flags + ["--device", "cpu", "--log_dir", str(tmp_path)])
    tts, tstep = task5.build_engine(targs, torch.device("cpu"))
    assert targs._save_scores is False
    tts.model.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, jts.params)))
    tokens, labels = _first_batch()

    # JAX: the gradients of the loss its engine differentiates, then its step.
    jm = JaxLM(vocab_size=V, embed_dim=D, num_heads=H, num_layers=L, max_len=T,
               rope=True, fused_ln=fused_ln, impl="flash")
    jloss_fn = jax_fused_loss_fn(jm, save_scores=False)
    jgrads = jax.grad(lambda p: jloss_fn(p, jts.model_state, jnp.asarray(tokens),
                                         jnp.asarray(labels))[0])(jts.params)
    jgrads = lm_params_from_tpudml(jax.tree.map(np.asarray, jgrads))
    _, jmetrics = jstep(jts, jnp.asarray(tokens), jnp.asarray(labels))
    want = float(jmetrics["loss"])

    # The port: the same through its engine's loss and step.
    params = params_of(tts.model)
    loss, _ = make_lm_fused_loss_fn(tts.model, save_scores=targs._save_scores)(
        torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _, tmetrics = tstep(tts, tokens, labels)
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["loss"]), want, rtol=1e-5)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)

