"""The port's hillclimb tool (``repro_torch.launch.hillclimb``) vs the
JAX package's, and the remat modes it compares.

  * the variant table: JAX's one-card variants with the same knobs; its
    layout and ``p_bf16`` variants are not ported and are unknown names;
  * ``variant_flags`` / ``run_variant`` restore ``flags.REMAT_MODE`` and
    ``CE_MODE`` when the block raises;
  * on a smoke config on the CPU the three remat modes give the same loss
    and gradients bit for bit (remat changes what is stored, not the
    arithmetic);
  * ``measure`` runs on the card by default and raises without one; on
    the CPU (``device="cpu"``) it runs and reports its fit and steps.
"""
import pytest
import torch

from repro.launch import hillclimb as JHC
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import hillclimb as HC
from repro_torch.models import flags
from repro_torch.models import transformer as M
from repro_torch.models.config import ShapeConfig
from repro_torch.train.step import lm_loss

torch.set_num_threads(1)
SHAPE = ShapeConfig("train cut", 32, 2, "train")


def test_variant_table():
    one_card = {k: v for k, v in JHC.VARIANTS.items()
                if "rules" not in v and not v.get("p_bf16")}
    assert HC.VARIANTS == one_card
    layouts = {k for k, v in JHC.VARIANTS.items()
               if "rules" in v and not v.get("p_bf16")}
    assert layouts and not layouts & set(HC.VARIANTS)
    assert not any("bf16" in k for k in HC.VARIANTS)
    with pytest.raises(KeyError):
        HC.run_variant("tinyllama_1_1b", "train_4k", "pure_dp")


def test_flags_are_restored_when_a_variant_raises(monkeypatch):
    def boom(*a, **kw):
        assert (flags.REMAT_MODE, flags.CE_MODE) == ("dots", "dense")
        raise RuntimeError("boom")
    monkeypatch.setattr(HC, "roofline_cell", boom)
    with pytest.raises(RuntimeError, match="boom"):
        HC.run_variant("tinyllama_1_1b", "train_4k", "remat_dots")
    assert (flags.REMAT_MODE, flags.CE_MODE) == ("full", "dense")
    with pytest.raises(ValueError):
        with HC.variant_flags("none", "chunked"):
            assert (flags.REMAT_MODE, flags.CE_MODE) == ("none", "chunked")
            raise ValueError
    assert (flags.REMAT_MODE, flags.CE_MODE) == ("full", "dense")


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "llama4_scout_17b_a16e"])
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    cfg = get_smoke_config(arch)
    model = M.make_trainable(M.init_params(
        cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu"))
    batch = batch_for_step(cfg, SHAPE, 0, DataConfig(0), "cpu")
    got = {}
    for remat in ("full", "dots", "none"):
        with HC.variant_flags(remat):
            M.zero_grads(model)
            loss, _ = lm_loss(model, batch, cfg)
            loss.backward()
            got[remat] = (loss.detach(), [p.grad.clone() for p in
                                          model.parameters()])
    for remat in ("dots", "none"):
        assert torch.equal(got[remat][0], got["full"][0])
        assert all(torch.equal(a, b) for a, b in zip(got[remat][1],
                                                     got["full"][1]))


def test_measure_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HC.measure(get_smoke_config("tinyllama_1_1b"), SHAPE)


def test_measure_on_the_cpu():
    cfg = get_smoke_config("tinyllama_1_1b")
    runs = {remat: HC.measure(cfg, SHAPE, remat=remat, n_micro=2, steps=1,
                              device="cpu")
            for remat in ("full", "none")}
    for remat, r in runs.items():
        assert r["fits"] and len(r["losses"]) == 2
        assert r["device_ms"] is None and r["peak_bytes"] is None
        assert r["launches_per_step"] == [{}]      # the plain attention
        assert r["tokens_per_s"] > 0
    assert runs["full"]["losses"] == runs["none"]["losses"]
    for r in runs.values():
        fit = r["fit_bytes"]
        assert fit["peak"] == fit["argument"] + fit["temp"] > fit["argument"]
    assert runs["none"]["counted_flops"] < runs["full"]["counted_flops"]
    assert (flags.REMAT_MODE, flags.CE_MODE) == ("full", "dense")


def test_cli_counts_and_skips_layout_variants(capsys):
    assert HC.main(["--arch", "tinyllama_1_1b", "--shape", "train_4k",
                    "--batch", "2", "--seq", "64",
                    "--variants", "remat_none,no_fsdp,pure_dp"]) == 0
    out = capsys.readouterr().out
    assert "[OK  ] remat_none" in out
    # JAX's layout variants are unknown names here: reported, not run.
    assert "[ERR ] no_fsdp                KeyError" in out
    assert "[ERR ] pure_dp                KeyError" in out
    assert HC.main(["--arch", "tinyllama_1_1b", "--shape", "long_500k",
                    "--variants", "baseline"]) == 0
    assert "[SKIP] baseline" in capsys.readouterr().out
