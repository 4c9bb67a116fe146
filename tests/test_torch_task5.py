"""The port's training entry point ``tpudml_torch.tasks.task5_longcontext``
on the CPU: a few steps at a tiny size, the fused linear-xent head in its
saved-scores, lean and auto modes and its flag validation, the flags that
are not ported, and the card being required unless the caller asks for
the CPU. ``--parallel fsdp`` and ``tp`` at world 1 (equal to ``single``,
with the sentinel, the fused head and a checkpoint; world 2:
``tests/test_torch_mp_cli.py``). ``--parallel dp`` at world 1 in this process (equal to
``--parallel single``) and at world 2 over gloo
(``tests/torch_dist_worker.py``: both ranks end at the same loss). (The lean step against JAX's task5 engine:
``tests/test_torch_longcontext.py``.) Also the MoE LM (``--moe_experts``):
its loss and every gradient, the Switch aux term at α = 0.01 included,
against ``tpudml``'s training step on the same parameters, in f32 (loss
rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, as
``tests/test_torch_flagship.py``) and in bf16 compute, and a CPU run of the
task with the dropless ragged dispatch. In bf16 the loss keeps the
flagship's rtol 1e-3. The experts' relu and the top-1 routing are
discontinuous: a router margin that bf16 rounding moves across a tie moves
a whole token. So the bf16 test runs at a seed where the port's top-1
choices equal JAX's in every layer, asserts that they do, and asserts that
the router runs in f32 on bf16 tokens while the experts run in bf16. Each
of the port's bf16 gradients then lies within the flagship's 5e-2 (of max
|f32 gradient|) of JAX's bf16 gradient or within its 3e-2 of the f32
gradient. The first bound alone fails where XLA sums over the rows in bf16
(JAX's head bias lies 11% of max from f32, the port's 0.4%), the second
alone where both bf16 runs share one rounding error (the attention
kernels, 7% from f32 in both and 1.4% from each other).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from tpudml.models import TransformerLM as JaxLM  # noqa: E402
from tpudml.optim import AdamW as JaxAdamW  # noqa: E402
from tpudml.train import TrainState as JaxTrainState  # noqa: E402
from tpudml.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from tpudml.train import make_train_step_body as jax_step_body  # noqa: E402
from tpudml.train import resolve_aux_loss_weight as jax_aux_weight  # noqa: E402
from tpudml_torch.data import synthetic_lm  # noqa: E402
from tpudml_torch.interop import lm_params_from_tpudml  # noqa: E402
from tpudml_torch.models import TransformerLM  # noqa: E402
from tpudml_torch.optim import AdamW  # noqa: E402
from tpudml_torch.tasks import task5_longcontext as task5  # noqa: E402
from tpudml_torch.train import (  # noqa: E402
    TrainState, make_loss_fn, make_train_step_body, params_of,
)

TINY = ["--vocab", "32", "--embed_dim", "32", "--num_heads", "4",
        "--num_layers", "2", "--seq_len", "16", "--batch_size", "4",
        "--lr", "0.01"]


@pytest.mark.parametrize("extra", [[], ["--attn", "flash", "--fused_ln", "--rope"],
                                   ["--attn", "flash", "--num_kv_heads", "2"]],
                         ids=["full", "flash_fused_rope", "flash_gqa"])
def test_cli_trains_on_cpu(tmp_path, capsys, extra):
    out = task5.main(TINY + extra + ["--device", "cpu", "--steps", "12",
                                     "--log_every", "6", "--log_dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "tokens/sec, final loss" in text and "step 12: loss" in text
    assert out["device"] == "cpu" and out["steps_run"] == 12
    assert out["tokens_per_sec"] > 0
    assert out["final_loss"] < 3.4  # below ln(32): it learns the successor map
    assert list(tmp_path.rglob("metrics.jsonl"))


def test_flash_fused_and_plain_runs_agree(tmp_path):
    """Same seed, same batches: the kernel configuration and the plain one
    end at the same loss (their plain versions on the CPU)."""
    common = TINY + ["--device", "cpu", "--steps", "6", "--log_every", "0",
                     "--rope", "--log_dir", str(tmp_path)]
    plain = task5.main(common)
    fused = task5.main(common + ["--attn", "flash", "--fused_ln"])
    assert fused["final_loss"] == pytest.approx(plain["final_loss"], rel=1e-4)


def test_target_loss_stops_early(tmp_path):
    out = task5.main(TINY + ["--device", "cpu", "--steps", "200", "--log_every", "0",
                             "--lr", "0.02", "--target_loss", "1.0",
                             "--log_dir", str(tmp_path)])
    assert out["target_reached_at"] is not None and out["steps_run"] < 200
    assert out["final_loss"] <= 1.0


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be shown")


def test_card_is_the_default_device(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        task5.main(TINY + ["--steps", "1", "--log_dir", str(tmp_path)])
    assert not list(tmp_path.rglob("metrics.jsonl"))  # raised before any work


@pytest.mark.parametrize("flags", [
    ["--parallel", "cp"],
    ["--parallel", "cp", "--ckpt_dir", "ck"],
])
def test_unported_flags_raise(tmp_path, flags):
    """``--parallel cp`` (which raised before it was ported) alone builds a
    one-rank gloo group and trains the ring trunk to the single-device
    loss, also with ``--ckpt_dir`` (the replicated state, JAX's leaves);
    ``--sentinel`` under cp raises JAX's ValueError. World 2 against JAX's
    task5: ``tests/test_torch_cp_cli.py``."""
    flags = [str(tmp_path / f) if f == "ck" else f for f in flags]
    common = TINY + ["--device", "cpu", "--steps", "3", "--log_every", "0",
                     "--log_dir", str(tmp_path)]
    got = task5.main(common + flags)
    want = task5.main(common + ["--attn", "full"])
    assert got["devices"] == 1 and got["final_loss"] == pytest.approx(want["final_loss"],
                                                                       rel=1e-5)
    if "--ckpt_dir" in flags:
        assert (tmp_path / "ck" / "step_3").is_dir()
    with pytest.raises(ValueError, match="--sentinel composes with --parallel dp/fsdp/tp/pp"):
        task5.main(common + flags + ["--sentinel"])


@pytest.mark.parametrize("flags", [
    ["--parallel", "pp"],
    ["--parallel", "pp", "--sentinel"],
    ["--parallel", "pp", "--schedule", "1f1b", "--dropout", "0.1"],
    ["--parallel", "pp", "--schedule", "interleaved", "--ckpt_dir", "ck"],
    ["--parallel", "pp", "--remat", "--microbatches", "2"],
], ids=["gpipe", "gpipe_sentinel", "1f1b_dropout", "interleaved_ckpt", "gpipe_remat"])
def test_pp_runs_with_the_host_flags(tmp_path, capsys, flags):
    """``--parallel pp`` (which raised before it was ported) alone builds a
    one-rank gloo group: one stage, ``--num_layers`` ignored (one block;
    two under interleaved), and it learns; with the sentinel and a
    checkpoint at the end holding JAX's leaves (the stages ``[1, ...]``).
    GPipe with and without ``--remat`` and the sentinel end on one loss.
    World 2 against JAX's task5: ``tests/test_torch_pp_cli.py``."""
    flags = [str(tmp_path / f) if f == "ck" else f for f in flags]
    common = TINY + ["--device", "cpu", "--steps", "6", "--log_every", "0", "--attn",
                     "flash", "--fused_ln", "--rope", "--log_dir", str(tmp_path)]
    out = task5.main(common + flags)
    assert "[pp/flash/cpu] 1 device(s)" in capsys.readouterr().out
    assert out["devices"] == 1 and np.isfinite(out["final_loss"]) and out["final_loss"] < 3.4
    if "--ckpt_dir" in flags:
        with np.load(tmp_path / "ck" / "step_6" / "leaves.npz") as data:
            shapes = {data[k].shape for k in data.files}
        assert (1, 2, 32, 128) in shapes  # fc1 kernel: [S, V, d, 4d]
    if flags in (["--parallel", "pp", "--sentinel"],
                 ["--parallel", "pp", "--remat", "--microbatches", "2"]):
        gpipe = task5.main(common + ["--parallel", "pp"] + (
            ["--microbatches", "2"] if "--remat" in flags else []))
        assert out["final_loss"] == gpipe["final_loss"]


@pytest.mark.parametrize("flags,match", [
    (["--parallel", "pp", "--dropout", "0.1"], "need --schedule 1f1b or interleaved"),
    (["--parallel", "pp", "--moe_experts", "4"], "does not support --moe_experts"),
    (["--parallel", "pp", "--fused_xent"], "does not compose with --parallel pp"),
    (["--parallel", "pp", "--pp_data", "2"], "--pp_data 2 must be >= 1 and divide"),
])
def test_pp_rejections_keep_jax_wording(tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        task5.main(TINY + flags + ["--device", "cpu", "--steps", "1",
                                   "--log_dir", str(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--parallel", "fsdp", "--sentinel"],
    ["--parallel", "fsdp"],
    ["--parallel", "tp"],
    ["--parallel", "tp", "--ckpt_dir", "ck"],
    ["--parallel", "fsdp", "--fused_xent", "--fused_xent_lean"],
    ["--parallel", "tp", "--fused_xent", "--sentinel"],
], ids=["fsdp_sentinel", "fsdp", "tp", "tp_ckpt", "fsdp_fused_lean", "tp_fused_sentinel"])
def test_fsdp_and_tp_run_with_the_host_flags(tmp_path, capsys, flags):
    """``--parallel fsdp`` and ``tp`` (which raised before they were ported)
    alone build a one-rank gloo group; each run equals ``--parallel
    single``'s, the fused head's too (a one-rank merge is exact), with the
    sentinel and a checkpoint at the end (JAX's leaves)."""
    flags = [str(tmp_path / f) if f == "ck" else f for f in flags]
    common = TINY + ["--device", "cpu", "--steps", "6", "--log_every", "0", "--attn",
                     "flash", "--fused_ln", "--rope", "--log_dir", str(tmp_path)]
    fused = [f for f in flags if f.startswith("--fused")]
    single = task5.main(common + fused)
    out = task5.main(common + flags)
    assert f"[{flags[1]}/flash/cpu] 1 device(s)" in capsys.readouterr().out
    assert out["devices"] == 1 and out["final_loss"] == single["final_loss"]
    if "--ckpt_dir" in flags:
        assert (tmp_path / "ck" / "step_6" / "leaves.npz").is_file()


def test_dp_at_world_one_equals_single(tmp_path, capsys):
    """``--parallel dp`` alone builds a one-rank gloo group; its run equals
    ``--parallel single``'s (the mean over one rank is exact)."""
    common = TINY + ["--device", "cpu", "--steps", "6", "--log_every", "3", "--attn",
                     "flash", "--fused_ln", "--rope", "--log_dir", str(tmp_path)]
    single = task5.main(common)
    dp = task5.main(common + ["--parallel", "dp", "--n_devices", "1"])
    assert "[dp/flash/cpu] 1 device(s)" in capsys.readouterr().out
    assert dp["devices"] == 1 and dp["final_loss"] == single["final_loss"]
    with pytest.raises(ValueError, match="--n_devices 2 != the 1 processes"):
        task5.main(common + ["--parallel", "dp", "--n_devices", "2"])


def test_dp_at_world_two_over_gloo(tmp_path):
    """Two processes (tests/torch_dist_worker.py, suite task5) run
    ``--parallel dp --fused_xent`` on one global batch stream: both report
    the same final loss, and it learns."""
    import torch_dist_worker

    ranks = torch_dist_worker.spawn("task5", tmp_path / "job")
    assert [r["devices"] for r in ranks] == [2, 2]
    assert ranks[0]["final_loss"] == ranks[1]["final_loss"] < 3.4
    assert list((tmp_path / "job" / "logs0").rglob("metrics.jsonl"))
    assert not (tmp_path / "job" / "logs1").exists()  # only rank 0 writes


@pytest.mark.parametrize("flags", [["--attn", "ring"], ["--cp_layout", "striped"]])
def test_cp_only_flags_need_cp(tmp_path, flags):
    with pytest.raises(ValueError, match="--parallel cp"):
        task5.main(TINY + flags + ["--device", "cpu", "--steps", "1",
                                   "--log_dir", str(tmp_path)])


MODE_FLAGS = ("--fused_xent_scores", "--fused_xent_lean")


@pytest.mark.parametrize("extra", [[], ["--fused_xent_scores"], ["--fused_xent_lean"],
                                   ["--attn", "flash", "--fused_ln"]],
                         ids=["auto", "scores", "lean", "flash_fused_ln"])
def test_fused_xent_step1_loss_matches_standard(tmp_path, extra):
    """One step from the same seed: the fused head's loss is the standard
    path's (materialized logits + softmax_cross_entropy), f32 rtol 1e-5."""
    common = TINY + ["--device", "cpu", "--steps", "1", "--log_every", "0", "--rope",
                     "--log_dir", str(tmp_path)]
    common += [f for f in extra if f not in MODE_FLAGS]
    standard = task5.main(common)
    fused = task5.main(common + ["--fused_xent"] + [f for f in extra if f in MODE_FLAGS])
    assert fused["final_loss"] == pytest.approx(standard["final_loss"], rel=1e-5)


def test_fused_xent_trains_on_cpu(tmp_path):
    out = task5.main(TINY + ["--device", "cpu", "--steps", "12", "--log_every", "6",
                             "--fused_xent", "--fused_xent_scores", "--rope",
                             "--log_dir", str(tmp_path)])
    assert out["final_loss"] < 3.4  # below ln(32)


def test_fused_xent_lean_trains_on_cpu(tmp_path, capsys):
    """--fused_xent_lean trains (the lean head's plain versions on the CPU)
    and logs, step by step, the losses of the --fused_xent_scores run from
    the same seed: the two backward modes give the same gradients from the
    same f32 scores."""
    common = TINY + ["--device", "cpu", "--steps", "12", "--log_every", "1",
                     "--fused_xent", "--rope", "--log_dir", str(tmp_path)]
    final, logs = {}, {}
    for mode in ("--fused_xent_lean", "--fused_xent_scores"):
        capsys.readouterr()
        final[mode] = task5.main(common + [mode])["final_loss"]
        logs[mode] = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("step ")]
    assert final["--fused_xent_lean"] < 3.4  # below ln(32)
    assert len(logs["--fused_xent_lean"]) == 12
    assert logs["--fused_xent_lean"] == logs["--fused_xent_scores"]
    assert final["--fused_xent_lean"] == final["--fused_xent_scores"]


def test_fused_xent_auto_mode_reaches_lean(tmp_path, monkeypatch):
    """--fused_xent alone resolves as linear_cross_entropy's save_s=None:
    with the auto budget lowered below this run's padded f32 scores
    (B·T = 64 rows × 128 padded vocab columns), every step takes the lean
    backward; at the real budget the same run keeps its scores."""
    from tpudml_torch.ops import xent_kernel as txk

    lean_calls = []
    real = txk.xent_dx_lean
    monkeypatch.setattr(txk, "xent_dx_lean",
                        lambda *a: lean_calls.append(1) or real(*a))
    args = TINY + ["--device", "cpu", "--steps", "3", "--log_every", "0",
                   "--fused_xent", "--log_dir", str(tmp_path)]
    task5.main(args)
    assert lean_calls == []
    monkeypatch.setattr(txk, "SAVE_S_AUTO_MAX_BYTES", 64 * 128 * 4 - 1)
    task5.main(args)
    assert lean_calls == [1, 1, 1]


@pytest.mark.parametrize("flags,match", [
    (["--fused_xent_scores"], "require --fused_xent"),
    (["--fused_xent_lean"], "require --fused_xent"),
    (["--fused_xent", "--fused_xent_scores", "--fused_xent_lean"], "exclusive"),
])
def test_fused_xent_flag_validation(tmp_path, flags, match):
    """As the JAX entry point: the mode flags need --fused_xent and exclude
    each other."""
    with pytest.raises(ValueError, match=match):
        task5.main(TINY + flags + ["--device", "cpu", "--steps", "1",
                                   "--log_dir", str(tmp_path)])


def test_moe_cli_trains_on_cpu(tmp_path, capsys):
    """--moe_experts 4 --moe_dispatch ragged: the dropless MoE LM trains
    through the grouped-dW backward's plain version."""
    out = task5.main(TINY + ["--attn", "flash", "--fused_ln", "--rope", "--moe_experts", "4",
                             "--moe_dispatch", "ragged", "--device", "cpu", "--steps", "12",
                             "--log_every", "6", "--log_dir", str(tmp_path)])
    assert "step 12: loss" in capsys.readouterr().out
    assert out["final_loss"] < 3.4  # below ln(32): it learns the successor map


MOE_CFG = dict(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2, max_len=32,
               rope=True, impl="flash", fused_ln=True, moe_experts=4)
MOE_B = 8  # 256 tokens
MOE_DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _moe_pair(dispatch, dtype, seed=0):
    jdt, tdt = MOE_DTYPES[dtype]
    jm = JaxLM(**MOE_CFG, moe_dispatch=dispatch, compute_dtype=jdt)
    params, state = jm.init(jax.random.key(seed))
    tm = TransformerLM(**MOE_CFG, moe_dispatch=dispatch, compute_dtype=tdt, device="cpu")
    tm.load_state_dict(lm_params_from_tpudml(jax.tree.map(np.asarray, params)))
    return jm, params, state, tm


def _moe_batch():
    seqs = synthetic_lm(MOE_B, MOE_CFG["max_len"], MOE_CFG["vocab_size"], seed=1)
    return seqs[:, :-1], seqs[:, 1:]


def _jax_moe_grads(jm, params, state, tokens, labels):
    """The loss and gradients of JAX's make_train_step_body: its loss_fn
    with the resolved aux weight."""
    fn = jax_make_loss_fn(jm, aux_loss_weight=jax_aux_weight(jm, None))
    (loss, _), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params, state, jnp.asarray(tokens), jnp.asarray(labels))
    return float(loss), lm_params_from_tpudml(jax.tree.map(np.asarray, grads))


def _port_moe_grads(tm, tokens, labels):
    loss, _ = make_loss_fn(tm)(torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    p = params_of(tm)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), {n: g.float() for n, g in zip(p, grads)}


@pytest.mark.parametrize("dispatch", ["gather", "ragged"])
def test_moe_lm_loss_and_grads_match_jax_f32(dispatch):
    jm, params, state, tm = _moe_pair(dispatch, "f32")
    assert jax_aux_weight(jm, None) == 1e-2
    tokens, labels = _moe_batch()
    want, wgrads = _jax_moe_grads(jm, params, state, tokens, labels)
    got, grads = _port_moe_grads(tm, tokens, labels)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(grads) == set(wgrads)
    assert any(".moe.router." in n for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), wgrads[name].numpy(), err_msg=name,
                                   rtol=1e-4, atol=1e-6)
    # Without the aux term the router's gradient changes: α = 0.01 is in.
    loss0, _ = make_loss_fn(tm, aux_loss_weight=0.0)(
        torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    np.testing.assert_allclose(got - loss0.item(), 1e-2 * tm.aux_loss.item(), rtol=1e-4)


class _TopKRecorder:
    """Stands in for ``jax.lax`` inside ``tpudml.nn.moe``: records each MoE
    layer's top-k choices, in trace order (= layer order), through a debug
    callback."""

    def __init__(self):
        self.choices = {}
        self._layers = 0

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def top_k(self, x, k):
        vals, idx = jax.lax.top_k(x, k)
        layer = self._layers
        self._layers += 1
        jax.debug.callback(lambda a: self.choices.__setitem__(layer, np.asarray(a)), idx)
        return vals, idx


MOE_BF16_SEED = 2  # no top-1 choice differs between the port and JAX here (asserted)


@pytest.mark.parametrize("dispatch", ["gather", "ragged"])
def test_moe_lm_loss_and_grads_match_jax_bf16(dispatch, monkeypatch):
    import tpudml.nn.moe as jax_moe
    from tpudml_torch.nn.moe import MoELayer

    jm, params, state, tm = _moe_pair(dispatch, "bf16", seed=MOE_BF16_SEED)
    jm32, _, _, _ = _moe_pair(dispatch, "f32", seed=MOE_BF16_SEED)
    tokens, labels = _moe_batch()
    recorder = _TopKRecorder()
    monkeypatch.setattr(jax_moe, "lax", recorder)
    jax.jit(jax_make_loss_fn(jm, aux_loss_weight=jax_aux_weight(jm, None)))(
        params, state, jnp.asarray(tokens), jnp.asarray(labels))
    jax.effects_barrier()
    monkeypatch.setattr(jax_moe, "lax", jax.lax)
    want, wgrads = _jax_moe_grads(jm, params, state, tokens, labels)
    _, f32_grads = _jax_moe_grads(jm32, params, state, tokens, labels)

    routes, outs = [], []
    route = MoELayer._route

    def recording_route(self, toks):
        probs, topv, topi = route(self, toks)
        routes.append((toks.dtype, probs.dtype, topi.numpy()))
        return probs, topv, topi

    monkeypatch.setattr(MoELayer, "_route", recording_route)
    for layer in (tm.block0.moe, tm.block1.moe):
        layer.register_forward_hook(lambda m, i, o: outs.append((i[0].dtype, o[0].dtype)))
    got, grads = _port_moe_grads(tm, tokens, labels)

    assert tm.block0.moe.router.kernel.dtype == torch.float32
    assert len(routes) == len(recorder.choices) == MOE_CFG["num_layers"]
    for layer, (tok_dtype, prob_dtype, topi) in enumerate(routes):
        assert (tok_dtype, prob_dtype) == (torch.bfloat16, torch.float32)  # router in f32
        np.testing.assert_array_equal(topi, recorder.choices[layer], err_msg=f"layer {layer}")
    assert outs == [(torch.bfloat16, torch.bfloat16)] * MOE_CFG["num_layers"]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for name, g in grads.items():
        scale = f32_grads[name].abs().max().item()
        err_jax = (g - wgrads[name]).abs().max().item() / scale
        err_f32 = (g - f32_grads[name]).abs().max().item() / scale
        assert err_jax <= 5e-2 or err_f32 <= 3e-2, (name, err_jax, err_f32)


def test_moe_train_step_body_matches_jax():
    """Three AdamW steps of make_train_step_body on the ragged (grouped-dW)
    MoE LM: the losses agree with JAX's (f32, rtol 1e-5)."""
    jm, params, state, tm = _moe_pair("ragged", "f32", seed=2)
    jopt = JaxAdamW(lr=3e-4)
    jts = JaxTrainState(params=params, model_state=state, opt_state=jopt.init(params),
                        step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_step_body(jm, jopt))
    opt = AdamW(lr=3e-4)
    ts, step = TrainState.create(tm, opt), make_train_step_body(tm, opt)
    tokens, labels = _moe_batch()
    for _ in range(3):
        jts, jmetrics = jstep(jts, jnp.asarray(tokens), jnp.asarray(labels))
        ts, metrics = step(ts, torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
