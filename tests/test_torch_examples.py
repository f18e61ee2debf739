"""The port's ``examples/`` scripts (``repro_torch.examples``) against the
JAX package's, on the CPU at small sizes.

Each port script's body is a function whose sizes are parameters; the JAX
scripts take no size argument but ``paper_eval`` (``--scale``), so where
a JAX script fixes its size in its source (``quickstart``'s 5% trace,
``sweep_on_device``'s ``SCALE``) the test runs that source with the size
replaced, and ``serve_with_grmu`` is held to the JAX modules it calls
(``PlacementService`` on the same flash crowd and ladder).  The placement
numbers are decisions, so the printed lines must be equal, character for
character (the sweep's first line names the engine, so it is left out).
``serve_with_grmu`` runs with an SLO no batch breaches, since a tier
switch depends on the host's timing.  ``train_lm`` takes 2 steps from
JAX's initial weights (written by JAX's checkpointer at step 0 under
``tmp_path``, which the port restores) beside the JAX script's 2 steps,
run as written under ``jax.disable_jit()`` (the model is bf16; jitted on
the CPU, XLA skips bf16 roundings, tests/test_torch_train.py): its loss
lines within that file's LOSS_RTOL (1e-5) plus half the last printed
digit.  Each script's ``main`` runs on the card
unless given ``--device cpu``.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import (paper_eval, quickstart, serve_with_grmu,
                                  sweep_on_device, train_lm)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5


def _printed(fn, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def _jax_script(name: str, replace=(), argv=()) -> str:
    """The JAX script examples/<name>.py run as __main__ (its source with
    ``replace``'s substitutions, each made exactly once) -> its stdout."""
    src = (ROOT / "examples" / f"{name}.py").read_text()
    for old, new in replace:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    buf, old_argv = io.StringIO(), sys.argv
    sys.argv = [name, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            try:
                exec(compile(src, name, "exec"), {"__name__": "__main__"})
            except SystemExit as e:     # train_lm: sys.exit(main())
                assert not e.code, e.code
    finally:
        sys.argv = old_argv
    return buf.getvalue()


def test_quickstart_prints_the_jax_scripts_lines():
    want = _jax_script("quickstart", [("TraceConfig(scale=0.05,",
                                       "TraceConfig(scale=0.02,")])
    got = _printed(quickstart.run, scale=0.02, device="cpu")
    assert got == want


def test_paper_eval_prints_the_jax_scripts_lines():
    want = _jax_script("paper_eval", argv=["--scale", "0.02", "--seed", "1"])
    got = _printed(paper_eval.run, scale=0.02, seed=1, device="cpu")
    assert got == want
    assert "--- headline vs paper ---" in got


def test_sweep_on_device_prints_the_jax_scripts_numbers():
    want = _jax_script("sweep_on_device", [("SCALE = 0.15", "SCALE = 0.03")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = sweep_on_device.run(scale=0.03, device="cpu")
    got = buf.getvalue()
    assert got.splitlines()[1:] == want.splitlines()[1:]
    assert out["sequential"] == out["device"]


def test_serve_with_grmu_decides_as_the_jax_service():
    from repro.core import batched as JB
    from repro.core.bucketing import pad_events as jpad
    from repro.serve import PlacementService as JService
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import requests_from_trace as jrequests
    from repro.workload.flashcrowd import FlashCrowdConfig as JFC
    from repro.workload.flashcrowd import generate_flash_crowd as jflash
    size = dict(n_vms=120, n_gpus=8, horizon_hours=24.0, seed=0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = serve_with_grmu.run(**size, slo_s=1e9, device="cpu")
    events = jflash(JFC(**size))
    reqs, horizon = jrequests(events)
    svc = JService.for_trace(events, JServeConfig(
        tiers=("GRMU", "FF"), micro_batch=32, slo_s=1e9))
    for r in reqs:
        while not svc.submit(r):
            svc.drain(max_batches=1)
    svc.drain()
    svc.flush(horizon)
    st = svc.stats()
    assert (got["decisions"], got["accepted"], got["switches"]) == (
        st["decisions"], st["accepted"], st["switches"]) == (
        st["decisions"], st["accepted"], 0)
    assert got["tier"] == svc.tier_name == "GRMU"
    assert got["accepted_ids"] == svc.accepted_ids()
    want_offline = list(JB.replay(jpad(events), JB.GRMU).accepted_ids)
    assert got["online_equals_offline"] is True
    assert svc.accepted_ids() == want_offline
    assert "online == offline: True" in buf.getvalue()


def _losses(text: str):
    return [(int(s), float(v)) for s, v in
            re.findall(r"\[train\] step=(\d+) loss=([0-9.]+)", text)]


def test_train_lm_loss_lines_equal_the_jax_script(tmp_path):
    import jax
    from repro.configs import get_smoke_config as jget_smoke
    from repro.launch import checkpoint as JCK
    from repro.models import transformer as JM
    from repro.train import optimizer as JO
    with jax.disable_jit():     # bf16 as written (test_torch_train.py)
        want = _jax_script("train_lm", argv=[
            "--steps", "2", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "jax")])
    # The JAX launcher's initial weights (seed 0), as its step-0
    # checkpoint, which the port's driver resumes from.
    jp = JM.init_params(jget_smoke("stablelm-3b"), jax.random.PRNGKey(0))
    JCK.save(str(tmp_path / "port"), 0, {"p": jp, "o": JO.adamw_init(jp)})
    got = _printed(train_lm.run, steps=2, batch=2, seq=32,
                   ckpt_dir=str(tmp_path / "port"), device="cpu")
    assert "[train] resumed from step 0" in got and "[train] done" in got
    assert (tmp_path / "port").exists() and any((tmp_path / "port").iterdir())
    w, g = _losses(want), _losses(got)
    assert [s for s, _ in w] == [s for s, _ in g] == [0, 1]
    for (_, a), (_, b) in zip(g, w):
        assert abs(a - b) <= LOSS_RTOL * abs(b) + 5e-5, (a, b)


@pytest.mark.parametrize("mod", [quickstart, paper_eval, serve_with_grmu,
                                 sweep_on_device, train_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_scripts_run_on_the_card_by_default(mod):
    """Without a card, each script's main refuses to run (it does not
    fall back to the CPU) and names --device cpu's way out; its source
    names the JAX script it ports."""
    name = mod.__name__.rsplit(".", 1)[-1]
    assert Path(mod.__file__).read_text().startswith(
        f"# Port of examples/{name}.py\n")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--steps", "1"] if mod is train_lm else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
