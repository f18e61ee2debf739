"""The port's hillclimb tool (``repro_torch.launch.hillclimb``) vs the
JAX package's, and the remat modes it compares.

  * the variant table: JAX's variants with the same names and knobs, its
    ``p_bf16`` ones included (the meta count of ``p_bf16`` is the
    baseline's: p never leaves the kernels' registers); the layout
    variants are counted on the 16 x 16 mesh's fake group (in a
    subprocess: one process holds one default group) and ``--measure``
    refuses them;
  * ``variant_flags`` / ``run_variant`` restore ``flags.REMAT_MODE``,
    ``CE_MODE`` and ``ATTN_P_BF16`` when the block raises;
  * on a smoke config on the CPU the three remat modes give the same loss
    and gradients bit for bit (remat changes what is stored, not the
    arithmetic);
  * ``measure`` runs on the card by default and raises without one; on
    the CPU (``device="cpu"``) it runs and reports its fit and steps.
"""
import os
import subprocess
import sys
from pathlib import Path

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
ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("train cut", 32, 2, "train")


def test_variant_table():
    assert HC.VARIANTS == JHC.VARIANTS
    assert {k for k, v in HC.VARIANTS.items() if v.get("p_bf16")} == {
        "p_bf16", "ce+pbf16", "pure_dp+none+ce+pbf16"}
    assert {k for k in HC.VARIANTS if HC.is_layout(k)} == {
        k for k, v in JHC.VARIANTS.items() if "rules" in v}
    seen = []

    def count(*a, **kw):
        seen.append(flags.ATTN_P_BF16)
        return {"hlo_flops": 1.0}
    import unittest.mock
    with unittest.mock.patch.object(HC, "roofline_cell", count):
        r = HC.run_variant("tinyllama_1_1b", "train_4k", "p_bf16")
    assert r["variant"] == "p_bf16" and seen == [True]
    assert flags.ATTN_P_BF16 is False


def test_flags_are_restored_when_a_variant_raises(monkeypatch):
    def boom(*a, **kw):
        assert (flags.REMAT_MODE, flags.CE_MODE) == ("dots", "dense")
        raise RuntimeError("boom")
    monkeypatch.setattr(HC, "roofline_cell", boom)
    with pytest.raises(RuntimeError, match="boom"):
        HC.run_variant("tinyllama_1_1b", "train_4k", "remat_dots")
    assert (flags.REMAT_MODE, flags.CE_MODE) == ("full", "dense")

    def boom_p(*a, **kw):
        assert (flags.CE_MODE, flags.ATTN_P_BF16) == ("chunked", True)
        raise RuntimeError("boom")
    monkeypatch.setattr(HC, "roofline_cell", boom_p)
    with pytest.raises(RuntimeError, match="boom"):
        HC.run_variant("tinyllama_1_1b", "train_4k", "ce+pbf16")
    assert (flags.CE_MODE, flags.ATTN_P_BF16) == ("dense", False)
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
    code = ("from repro_torch.launch import hillclimb as HC; "
            "HC.main(['--arch', 'tinyllama_1_1b', '--shape', 'train_4k', "
            "'--batch', '2', '--seq', '64', "
            "'--variants', 'remat_none,no_fsdp,pure_dp'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "[OK  ] remat_none             1 " in out
    # JAX's layout variants, counted on the 16x16 mesh's fake group.
    assert "[OK  ] no_fsdp                16x16 " in out
    assert "[OK  ] pure_dp                16x16 " in out
    # --measure runs one-card variants only.
    assert HC.main(["--arch", "tinyllama_1_1b", "--shape", "train_4k",
                    "--smoke", "--measure", "--device", "cpu",
                    "--variants", "no_fsdp"]) == 0
    assert "[ERR ] no_fsdp                ValueError" in (
        capsys.readouterr().out)
    assert HC.main(["--arch", "tinyllama_1_1b", "--shape", "long_500k",
                    "--variants", "baseline"]) == 0
    assert "[SKIP] baseline" in capsys.readouterr().out
