"""The port's training entry point ``tpudml_torch.tasks.task5_longcontext``
on the CPU: a few steps at a tiny size, the flags that are not ported,
and the card being required unless the caller asks for the CPU.
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
    (["--fused_xent"], "item 2b"),
    (["--fused_xent", "--fused_xent_scores"], "item 2b"),
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
