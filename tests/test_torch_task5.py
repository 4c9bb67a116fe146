"""The port's training entry point ``tpudml_torch.tasks.task5_longcontext``
on the CPU: a few steps at a tiny size, the fused linear-xent head in its
saved-scores, lean and auto modes and its flag validation, the flags that
are not ported, and the card being required unless the caller asks for
the CPU. (The lean step against JAX's task5 engine:
``tests/test_torch_longcontext.py``.)
"""

import pytest

torch = pytest.importorskip("torch")

from tpudml_torch.tasks import task5_longcontext as task5  # noqa: E402

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


@pytest.mark.parametrize("flags,match", [
    (["--parallel", "dp"], "item 5"),
    (["--parallel", "fsdp"], "item 7"),
    (["--parallel", "tp"], "item 7"),
    (["--parallel", "pp"], "item 7"),
    (["--parallel", "cp"], "item 8"),
    (["--parallel", "ep"], "item 9"),
    (["--moe_experts", "4"], "item 9"),
    (["--dropout", "0.1"], "item 3"),
    (["--sentinel"], "item 6"),
    (["--ckpt_dir", "ck"], "item 6"),
])
def test_unported_flags_raise(tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        task5.main(TINY + flags + ["--device", "cpu", "--steps", "1",
                                   "--log_dir", str(tmp_path)])


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
