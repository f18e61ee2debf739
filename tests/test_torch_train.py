"""The port's training path against the JAX package, on the CPU.

The same weights (a JAX ``init_params`` tree carried across with
``params_from_numpy``) and the same batches (each package's own
``batch_for_step``, which draw the same numpy numbers) go through both:

  * ``data.pipeline.batch_for_step`` equals JAX's for every family, token
    for token (Whisper's bf16 frames bit for bit, Qwen2-VL's
    ``mrope_positions``);
  * ``train.optimizer.adamw_update`` equals JAX's on random trees of bf16
    and float32 leaves, with clipping on and off, inside and after the
    warm-up, over three steps;
  * ``train.step.lm_loss``: the loss and every gradient leaf against
    ``jax.value_and_grad(lm_loss)``, in float32 for every family (the
    moe and mla_moe families with their aux term, the vlm family with
    position ids that differ per M-RoPE axis), with the dense and the
    chunked cross entropy (``flags.CE_MODE``), and in bfloat16 against JAX
    as written (``jax.disable_jit()``, one operation at a time: jitted on
    the CPU XLA skips bf16 roundings the code does);
  * the train step with ``n_micro=2`` against JAX's ``lax.scan``: loss,
    aux, grad norm, AdamW's moments and the parameters after two steps;
  * a port of ``tests/test_archs.py::test_train_step_smoke`` for all ten
    smoke configs, and of ``tests/test_framework.py::
    test_train_resume_is_deterministic``; a JAX checkpoint of the train
    state restored into the port and continued two steps equals JAX
    continuing, and JAX restores the port's checkpoint to the bit;
  * ``python -m repro_torch.launch.train --smoke --device cpu`` end to end,
    killed after three steps and resumed.

Tolerances.  float32: the loss within 1e-5 relative; each gradient leaf,
and the moments, within GRAD_TOL of the leaf's max |want| (1e-4; measured
at most 5.3e-5 over the families but Whisper's, 7.4e-4, whose smoke
decoder's forward already differs from JAX's by 1.2e-5 relative in
float32, the encdec slice's own F32_TOL (1e-4, 1e-3) in
test_torch_encdec.py, and so 2e-3 there).  The first AdamW steps move a
parameter by about lr * sign(g), so a gradient entry near 0 can flip its
update between two summation orders: the parameters are compared where
|m| exceeds 1e-2 of its max, within 0.05 lr (``_jax_state_vs_port``).  bfloat16 op by op: the loss within
1e-5 relative (measured 8e-8) and the gradients within BF16_GRAD_TOL
(relative L2 0.03, max 0.06 of max |want|; measured at most 0.016 and
0.028 over three seeds) of JAX as written: the two backward passes round
to bf16 at other places.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as JP
from repro.launch import checkpoint as JCK
from repro.models import flags as JF
from repro.models import transformer as JM
from repro.models.config import ShapeConfig as JShapeConfig
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data import pipeline as P
from repro_torch.launch import checkpoint as CK
from repro_torch.launch import train as LT
from repro_torch.models import convert, flags
from repro_torch.models import transformer as M
from repro_torch.models.config import ShapeConfig
from repro_torch.train import optimizer as O
from repro_torch.train import step as S

torch.set_num_threads(1)

ARCH = "tinyllama_1_1b"
SHAPE = ShapeConfig("t", 32, 2, "train")
JSHAPE = JShapeConfig("t", 32, 2, "train")
GRAD_TOL = {"whisper_base": 2e-3}
GRAD_TOL_DEFAULT = 1e-4
LOSS_RTOL = 1e-5
BF16_GRAD_TOL = (0.03, 0.06)
PARAM_KEEP, PARAM_ATOL = 1e-2, 0.05
# Four steps (two of JAX, two after the restore) accumulate more: the
# moments within 3 GRAD_TOL (measured 2.1e-4 on m).
CONTINUED_TOL = 3e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _named(tree, prefix=""):
    """{dotted name: leaf} of a nested dict (JAX or port)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _close_leaf(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err} > {tol} of max |want| {scale}"


def _close_tree(got, want, tol, what=""):
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for name in got:
        _close_leaf(got[name], want[name], tol, what + name)


def _models(arch, seed=0, dtype=jnp.float32):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed), dtype)
    model = M.make_trainable(convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return cfg, jcfg, jp, model


def _batches(cfg, jcfg, step=3, f32_frames=False):
    """(JAX batch, port batch) of ``step``.  ``f32_frames``: Whisper's
    frames given to both as float32 (the port's ``lm_loss`` feeds them at
    the model's dtype)."""
    jb = dict(JP.batch_for_step(jcfg, JSHAPE, step))
    b = P.batch_for_step(cfg, SHAPE, step, device="cpu")
    if f32_frames and "frames" in jb:
        jb["frames"] = jb["frames"].astype(jnp.float32)
        b["frames"] = b["frames"].float()
    return jb, b


def _port_grads(model, batch, cfg):
    M.zero_grads(model)
    loss_t, (loss, aux) = S.lm_loss(model, batch, cfg)
    loss_t.backward()
    return loss_t.detach(), aux.detach(), M.stacked_grads(model)


def _jax_grads(jp, jb, jcfg):
    (loss_t, (_, aux)), g = jax.value_and_grad(JS.lm_loss, has_aux=True)(
        jp, jb, jcfg)
    return loss_t, aux, g


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_for_step_equals_jax(arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    for step in (0, 7):
        want = JP.batch_for_step(jcfg, JSHAPE, step)
        got = P.batch_for_step(cfg, SHAPE, step, device="cpu")
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            g = got[key]
            assert str(g.dtype) == "torch." + w.dtype.name, key
            np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))


def test_batch_for_step_is_deterministic_and_aligned():
    cfg = get_smoke_config(ARCH)
    shape = ShapeConfig("t", 16, 2, "train")
    b1 = P.batch_for_step(cfg, shape, 7, device="cpu")
    b2 = P.batch_for_step(cfg, shape, 7, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = P.batch_for_step(cfg, shape, 8, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < cfg.vocab
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    it = P.stream(cfg, shape, start_step=7, device="cpu")
    assert torch.equal(next(it)["tokens"], b1["tokens"])
    assert torch.equal(next(it)["tokens"], b3["tokens"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _random_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal((7,)).astype(np.float32),
                    "stack": rng.standard_normal((3, 4, 2))
                    .astype(np.float32)}}


@pytest.mark.parametrize("clip", (0.5, 1e6), ids=("clipped", "unclipped"))
@pytest.mark.parametrize("warmup", (1, 5))
def test_adamw_update_equals_jax(clip, warmup):
    """Three steps on a tree of float32 and bf16 leaves: parameters, m, v,
    the step and the grad norm equal JAX's (float32 within 1e-6 relative:
    the grad norm sums in another order, so the clip scale can differ by
    an ulp; the moments within 1e-6 of their max |want|; bf16 leaves
    within one bf16 ulp)."""
    rng = np.random.default_rng(0)
    bf16 = {"w"}                        # the bf16 leaves
    init = _random_tree(rng)
    jparams = jax.tree.map(jnp.asarray, init)
    jparams["w"] = jparams["w"].astype(jnp.bfloat16)
    params = O.tree_map(torch.from_numpy, init)
    params["w"] = params["w"].to(torch.bfloat16)
    jcfg = JO.AdamWConfig(clip_norm=clip, warmup_steps=warmup)
    cfg = O.AdamWConfig(clip_norm=clip, warmup_steps=warmup)
    jopt, opt = JO.adamw_init(jparams), O.adamw_init(params)
    for _ in range(3):
        g_np = _random_tree(rng)
        jg = jax.tree.map(jnp.asarray, g_np)
        jg["w"] = jg["w"].astype(jnp.bfloat16)
        g = O.tree_map(torch.from_numpy, g_np)
        g["w"] = g["w"].to(torch.bfloat16)
        jparams, jopt, jn = JO.adamw_update(jcfg, jg, jopt, jparams)
        opt, gn = O.adamw_update(cfg, g, opt, params)
        np.testing.assert_allclose(float(gn), float(jn), rtol=2e-7)
        assert int(opt.step) == int(jopt.step) and opt.step.dtype == \
            torch.int32
        for name, p in _named(params).items():
            want = _named(jparams)[name]
            assert str(p.dtype) == "torch." + want.dtype.name
            rtol = 2.0 ** -8 if name in bf16 else 1e-6
            np.testing.assert_allclose(_np(p), _np(want), rtol=rtol,
                                       atol=1e-7)
        for mine, theirs in ((opt.m, jopt.m), (opt.v, jopt.v)):
            for name, x in _named(mine).items():
                assert x.dtype == torch.float32
                _close_leaf(x, _named(theirs)[name], 1e-6, name)


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------

def _vlm_positions(b, jb):
    """Position ids that differ per M-RoPE axis, in both batches."""
    B, S = b["tokens"].shape
    rng = np.random.default_rng(5)
    pos = np.sort(rng.integers(0, 4 * S, size=(3, B, S)), axis=-1).astype(
        np.int32)
    jb["mrope_positions"] = jnp.asarray(pos)
    b["mrope_positions"] = torch.from_numpy(pos)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_grads_equal_jax_f32(arch):
    cfg, jcfg, jp, model = _models(arch)
    jb, b = _batches(cfg, jcfg, f32_frames=True)
    if cfg.family == "vlm":
        _vlm_positions(b, jb)
    loss, aux, grads = _port_grads(model, b, cfg)
    jloss, jaux, jgrads = _jax_grads(jp, jb, jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL,
                               atol=1e-6)
    if cfg.moe is not None:
        assert float(aux) > 0
    _close_tree(grads, jgrads, GRAD_TOL.get(arch, GRAD_TOL_DEFAULT))


@pytest.mark.parametrize("arch", (ARCH, "llama4_scout_17b_a16e"))
def test_lm_loss_and_grads_equal_jax_bf16_op_by_op(arch):
    cfg, jcfg, jp, model = _models(arch, dtype=jnp.bfloat16)
    jb, b = _batches(cfg, jcfg)
    loss, aux, grads = _port_grads(model, b, cfg)
    with jax.disable_jit():
        jloss, jaux, jgrads = _jax_grads(jp, jb, jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)
    l2, elem = BF16_GRAD_TOL
    got, want = _named(grads), _named(jgrads)
    for name, g in got.items():
        assert g.dtype == torch.bfloat16, name
        g, w = _np(g), _np(want[name])
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= l2, (name, rel)
        _close_leaf(g, w, elem, name)


@pytest.fixture
def chunked_ce():
    """Both packages' CE_MODE set to "chunked" for one test."""
    old = (flags.CE_MODE, JF.CE_MODE)
    flags.CE_MODE = JF.CE_MODE = "chunked"
    yield
    flags.CE_MODE, JF.CE_MODE = old


@pytest.mark.parametrize("arch", (ARCH, "llama4_scout_17b_a16e"))
def test_chunked_ce_loss_and_grads_equal_jax(arch, chunked_ce):
    cfg, jcfg, jp, model = _models(arch)
    jb, b = _batches(cfg, jcfg)
    loss, _, grads = _port_grads(model, b, cfg)
    jloss, _, jgrads = _jax_grads(jp, jb, jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _close_tree(grads, jgrads, GRAD_TOL_DEFAULT)


@pytest.mark.parametrize("tied", (True, False))
def test_chunked_cross_entropy_equals_jax_over_padded_chunks(tied):
    """Chunks of 100 over a vocab of 256 (the last one padded), a mask:
    the value and its gradients as JAX's, and the dense CE's."""
    rng = np.random.default_rng(6)
    B, T, D, V = 2, 8, 16, 256
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    w = rng.standard_normal((V, D) if tied else (D, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)

    def jf(h, w):
        return JS.chunked_cross_entropy(h, w, jnp.asarray(labels), tied=tied,
                                        chunk=100, mask=jnp.asarray(mask))
    jv, (jh, jw) = jax.value_and_grad(jf, argnums=(0, 1))(h, w)
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    v = S.chunked_cross_entropy(th, tw, torch.from_numpy(labels), tied=tied,
                                chunk=100, mask=torch.from_numpy(mask))
    v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    _close_leaf(th.grad, jh, 1e-6, "hidden")
    _close_leaf(tw.grad, jw, 1e-6, "weight")
    logits = th @ (tw.T if tied else tw)
    dense = S.cross_entropy(logits, torch.from_numpy(labels),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(float(dense), float(v), rtol=1e-6)


@pytest.mark.parametrize("mode", ("dots", "none"))
def test_remat_modes_give_full_remat_grads(mode, monkeypatch):
    cfg, jcfg, _, model = _models(ARCH)
    _, b = _batches(cfg, jcfg)
    _, _, want = _port_grads(model, b, cfg)
    want = O.tree_map(torch.clone, want)
    monkeypatch.setattr(flags, "REMAT_MODE", mode)
    _, _, got = _port_grads(model, b, cfg)
    for name, g in _named(got).items():
        np.testing.assert_allclose(_np(g), _np(_named(want)[name]), rtol=0,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _jax_state_vs_port(jp, jopt, model, opt, tol, what, lr=3e-4):
    """Moments within ``tol`` of max |want|; parameters within PARAM_ATOL
    * lr where |m| is above PARAM_KEEP of its max (an update is lr * m_hat
    / sqrt(v_hat), about lr * sign(g) in the first steps, so an entry's
    error grows as |m| nears the moments' tolerance; measured at most
    0.022 lr)."""
    _close_tree(opt.m, jopt.m, tol, what + " m ")
    _close_tree(opt.v, jopt.v, tol, what + " v ")
    want_p, want_m = _named(jp), _named(jopt.m)
    for name, p in _named(M.stacked_params(model)).items():
        m = _np(want_m[name])
        keep = np.abs(m) > PARAM_KEEP * np.abs(m).max()
        np.testing.assert_allclose(_np(p)[keep], _np(want_p[name])[keep],
                                   rtol=0, atol=PARAM_ATOL * lr,
                                   err_msg=name)


def test_train_step_n_micro_2_equals_jax_scan():
    cfg, jcfg, jp, model = _models(ARCH)
    opt_cfg = O.AdamWConfig(warmup_steps=2)
    step = S.make_train_step(cfg, opt_cfg, n_micro=2)
    jstep = jax.jit(JS.make_train_step(jcfg, JO.AdamWConfig(warmup_steps=2),
                                       n_micro=2))
    opt, jopt = O.adamw_init(M.stacked_params(model)), JO.adamw_init(jp)
    for s in range(2):
        jb, b = _batches(cfg, jcfg, step=s)
        opt, met = step(model, opt, b)
        jp, jopt, jmet = jstep(jp, jopt, jb)
        assert all(v.dim() == 0 for v in met.values())
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=key)
        assert int(opt.step) == int(jopt.step) == s + 1
        _jax_state_vs_port(jp, jopt, model, opt, GRAD_TOL_DEFAULT,
                           f"step {s}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    """Port of tests/test_archs.py::test_train_step_smoke: one step of each
    smoke config in bf16 (the registry's train kind) is finite and moves
    the parameters; the layer parameters stay views of the stacked
    tree."""
    from repro_torch.models import registry
    cfg = get_smoke_config(arch)
    model = M.make_trainable(M.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    tree = M.stacked_params(model)
    before = {n: t.clone() for n, t in _named(tree).items()}
    opt = O.adamw_init(tree)
    step = S.make_train_step(cfg, O.AdamWConfig(warmup_steps=1))
    opt, met = step(model, opt, P.batch_for_step(cfg, SHAPE, 0,
                                                 device="cpu"))
    loss = float(met["loss"])
    assert np.isfinite(loss) and loss > 0, (arch, loss)
    assert int(opt.step) == 1
    delta = sum(float((t.float() - before[n].float()).abs().sum())
                for n, t in _named(tree).items())
    assert delta > 0, arch
    stack = "dec_layers" if cfg.family == "encdec" else "layers"
    layer = getattr(model, stack)[1]
    first = next(n for n in _named(tree) if n.startswith(stack + "."))
    p = layer.get_parameter(first.split(".", 1)[1])
    assert p.requires_grad and torch.equal(p, _named(tree)[first][1])
    assert p.data_ptr() == _named(tree)[first][1].data_ptr()
    # the registry's train kind is this step
    reg = registry.make_step(cfg, registry.SHAPES["train_4k"], device="cpu")
    opt, met2 = reg(model, opt, P.batch_for_step(cfg, SHAPE, 1,
                                                 device="cpu"))
    assert int(opt.step) == 2 and np.isfinite(float(met2["loss"]))


def test_train_resume_is_deterministic(tmp_path):
    """Port of tests/test_framework.py::test_train_resume_is_deterministic:
    kill-and-resume gives the parameters of an uninterrupted run."""
    cfg = get_smoke_config(ARCH)
    shape = ShapeConfig("t", 32, 2, "train")
    step_fn = S.make_train_step(cfg, O.AdamWConfig(warmup_steps=2))

    def fresh():
        model = M.make_trainable(M.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        return model, O.adamw_init(M.stacked_params(model))

    m1, o1 = fresh()
    for s in range(4):
        o1, _ = step_fn(m1, o1, P.batch_for_step(cfg, shape, s,
                                                 device="cpu"))
    m2, o2 = fresh()
    for s in range(2):
        o2, _ = step_fn(m2, o2, P.batch_for_step(cfg, shape, s,
                                                 device="cpu"))
    CK.save(str(tmp_path), 2, LT.train_state(m2, o2))
    m3, o3 = fresh()
    start, o3 = LT.restore(str(tmp_path), m3, o3)
    assert start == 2
    for s in range(start, 4):
        o3, _ = step_fn(m3, o3, P.batch_for_step(cfg, shape, s,
                                                 device="cpu"))
    for a, b in zip(O.tree_leaves(M.stacked_params(m1)),
                    O.tree_leaves(M.stacked_params(m3))):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_jax_train_checkpoint_continues_in_the_port(tmp_path):
    """JAX trains two steps and checkpoints {"p", "o"}; the port restores
    it and both continue two steps: the same losses, moments and
    parameters (float32)."""
    cfg, jcfg, jp, model = _models(ARCH)
    opt_cfg, jopt_cfg = (O.AdamWConfig(warmup_steps=2),
                         JO.AdamWConfig(warmup_steps=2))
    jstep = jax.jit(JS.make_train_step(jcfg, jopt_cfg))
    jopt = JO.adamw_init(jp)
    for s in range(2):
        jp, jopt, _ = jstep(jp, jopt, JP.batch_for_step(jcfg, JSHAPE, s))
    JCK.save(str(tmp_path), 2, {"p": jp, "o": jopt})
    start, opt = LT.restore(str(tmp_path), model,
                            O.adamw_init(M.stacked_params(model)))
    assert start == 2 and int(opt.step) == 2
    _close_tree(M.stacked_params(model), jp, 0.0, "restored p ")
    _close_tree(opt.m, jopt.m, 0.0, "restored m ")
    step = S.make_train_step(cfg, opt_cfg)
    for s in range(2, 4):
        opt, met = step(model, opt, P.batch_for_step(cfg, SHAPE, s,
                                                     device="cpu"))
        jp, jopt, jmet = jstep(jp, jopt, JP.batch_for_step(jcfg, JSHAPE, s))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
    _jax_state_vs_port(jp, jopt, model, opt, CONTINUED_TOL, "continued")


def test_port_train_checkpoint_restores_in_jax(tmp_path):
    cfg, jcfg, jp, model = _models(ARCH)
    opt = O.adamw_init(M.stacked_params(model))
    step = S.make_train_step(cfg, O.AdamWConfig(warmup_steps=2))
    for s in range(2):
        opt, _ = step(model, opt, P.batch_for_step(cfg, SHAPE, s,
                                                   device="cpu"))
    CK.save(str(tmp_path), 2, LT.train_state(model, opt))
    like = {"p": jp, "o": JO.adamw_init(jp)}
    start, tree = JCK.restore_latest(str(tmp_path), like)
    assert start == 2 and int(tree["o"].step) == 2
    _close_tree(tree["p"], M.stacked_params(model), 0.0, "p ")
    _close_tree(tree["o"].m, opt.m, 0.0, "m ")
    _close_tree(tree["o"].v, opt.v, 0.0, "v ")
    jstep = JS.make_train_step(jcfg, JO.AdamWConfig(warmup_steps=2))
    _, _, met = jstep(tree["p"], tree["o"],
                      JP.batch_for_step(jcfg, JSHAPE, 2))
    assert np.isfinite(float(met["loss"]))


def test_abstract_train_state_matches_the_model():
    from repro_torch.models import registry
    cfg = get_smoke_config(ARCH)
    params, opt = registry.abstract_train_state(cfg)
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    want = _named(M.stacked_params(model))
    got = _named(params)
    assert {n: (tuple(t.shape), t.dtype) for n, t in got.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in want.items()}
    assert all(t.device.type == "meta" for t in got.values())
    assert opt.step.dtype == torch.int32 and opt.step.shape == ()
    assert all(t.dtype == torch.float32 for t in _named(opt.m).values())


def test_launch_train_smoke_cpu_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", ck, "--log-every", "1"]
    assert LT.main(argv + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] step=")]
    assert len(lines) == 3 and "tok/s=" in lines[0]
    assert "[train] done" in out
    assert CK.available_steps(ck) == [3]
    assert LT.main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out
    assert "[train] step=3 " in out and CK.available_steps(ck) == [3, 4]
    assert os.path.exists(os.path.join(ck, "LATEST"))
