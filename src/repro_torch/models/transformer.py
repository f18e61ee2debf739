# Port of repro/models/transformer.py (the JAX package): every family (dense, vlm, moe, mla_moe, encdec, rwkv6, hybrid).
"""Decoder LM and Whisper's encoder-decoder: embedding, pre-norm layers,
final norm.

``Transformer`` holds the parameters under the JAX tree's names
(``embedding``, ``layers.{i}.{ln1,attn,ln2,ffn}.*``, ``final_norm.scale``,
``lm_head`` when embeddings are untied; for ``encdec``
``enc_layers.{i}.*``, ``dec_layers.{i}.{ln1,attn,ln_x,xattn,ln2,ffn}.*``
and ``enc_norm.scale`` in place of ``layers``; for ``rwkv6``
``layers.{i}.{ln1,ln2,tm,cm}.*``; for ``hybrid`` ``layers.{i}.{ln1,mamba}.*``
and the unstacked ``shared.{ln1,attn,ln2,ffn}.*``).  The JAX package stacks
each layer leaf with a leading layers axis and scans over it; the port
keeps a ``ModuleList`` and loops.  ``forward``, ``encode``, ``logits_fn``
and ``lm_forward`` take the module.  The stacked tree itself is kept on the
model (:func:`stacked_params`): its layer parameters are views of its
tensors, so the optimizer updates the tree in place and the layers see it.
For training, :func:`make_trainable` turns every parameter trainable, and
under grad each layer body is rematerialised through ``flags.remat_wrap``
(``remat=True``, as in JAX); serving runs under ``inference_mode`` and
never reaches it.  The ``vlm`` family (Qwen2-VL) is the
dense decoder with M-RoPE over (3, B, S) positions; ``moe`` (Llama-4
Scout) has a routed MoE as each layer's FFN and sums its aux loss over
layers; ``mla_moe`` (DeepSeek-V2) is the moe family with Multi-head
Latent Attention (``L.MLA``, ``attn.{wq_a,q_norm,wq_b,wkv_a,kv_norm,
wkv_b,wo}``) in place of GQA; ``encdec`` (Whisper, frontend stubbed)
runs a bidirectional encoder over frame embeddings and a decoder with
cross attention to it; ``rwkv6`` (RWKV-6) has time-mix and channel-mix
layers, each prefill
starting from zero carries; ``hybrid`` (Zamba2) runs its Mamba-2 layers in
groups of ``shared_attn_period``, the weight-shared attention + SwiGLU
block (sliding window ``cfg.sliding_window``) before each group, through
:func:`hybrid_forward`.  As in JAX, :func:`forward` on a hybrid config runs
the Mamba-2 layers alone; :func:`lm_forward` and the serving prefill take
``hybrid_forward``.  A family the port does not know raises and points at
ROADMAP.md.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, is_dtensor, resolve_device
from . import flags
from . import layers as L
from . import ssm as S
from .config import ModelConfig
from .params import P, axes_tree, init_tree

f32 = torch.float32


FAMILIES = ("dense", "vlm", "moe", "mla_moe", "encdec", "rwkv6", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported (the port "
            f"runs the families {FAMILIES}); see ROADMAP.md, Queue 2")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """One decoder layer (pre-norm)."""
    check_family(cfg)
    if cfg.family == "rwkv6":
        return {
            "ln1": L.rmsnorm_spec(cfg.d_model),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            **S.rwkv6_spec(cfg),
        }
    if cfg.family == "hybrid":
        return {
            "ln1": L.rmsnorm_spec(cfg.d_model),
            "mamba": S.mamba2_spec(cfg),
        }
    spec: Dict[str, Any] = {"ln1": L.rmsnorm_spec(cfg.d_model),
                            "ln2": L.rmsnorm_spec(cfg.d_model)}
    if cfg.family == "mla_moe":
        spec["attn"] = L.mla_spec(cfg)
    else:
        spec["attn"] = L.attention_spec(cfg)
    if cfg.moe is not None:
        spec["ffn"] = L.moe_spec(cfg)
    else:
        spec["ffn"] = L.mlp_spec(cfg.d_model, cfg.d_ff)
    return spec


def shared_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """Zamba2's weight-shared attention+MLP block."""
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "ffn": L.mlp_spec(cfg.d_model, cfg.d_ff),
    }


def encoder_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "ffn": L.mlp_spec(cfg.d_model, cfg.d_ff),
    }


def decoder_xattn_layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "ln_x": L.rmsnorm_spec(cfg.d_model),
        "xattn": L.attention_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "ffn": L.mlp_spec(cfg.d_model, cfg.d_ff),
    }


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "embedding": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=1.0),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    if cfg.family == "encdec":
        spec["enc_layers"] = encoder_layer_spec(cfg)      # stacked below
        spec["dec_layers"] = decoder_xattn_layer_spec(cfg)
        spec["enc_norm"] = L.rmsnorm_spec(cfg.d_model)
    else:
        spec["layers"] = layer_spec(cfg)
    if cfg.family == "hybrid":
        spec["shared"] = shared_block_spec(cfg)     # not stacked
    return spec


def _stack_spec(spec, n):
    """Add a leading 'layers' axis to every leaf of a per-layer spec."""
    if isinstance(spec, P):
        return P((n,) + spec.shape, ("layers",) + spec.axes, spec.init,
                 spec.scale)
    return {k: _stack_spec(v, n) for k, v in spec.items()}


def stacked_model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec = model_spec(cfg)
    if cfg.family == "encdec":
        spec["enc_layers"] = _stack_spec(spec["enc_layers"],
                                         cfg.n_enc_layers)
        spec["dec_layers"] = _stack_spec(spec["dec_layers"], cfg.n_layers)
    else:
        spec["layers"] = _stack_spec(spec["layers"], cfg.n_layers)
    return spec


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The stacked tree's logical axes (``launch.sharding`` maps them)."""
    return axes_tree(stacked_model_spec(cfg))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """One pre-norm layer's blocks: ``ln1``, ``attn`` (an ``L.Attention``,
    or ``L.MLA`` with ``mla``), ``ln2``, ``ffn`` (a SwiGLU, or with ``moe``
    an ``L.MoE``).  Whisper's encoder layers and Zamba2's shared block have
    the same blocks, with GQA and a SwiGLU."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, moe=False,
                 mla=False):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = (L.MLA if mla else L.Attention)(cfg, device=device,
                                                    dtype=dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ffn = (L.MoE(cfg, device=device, dtype=dtype) if moe else
                    L.SwiGLU(cfg.d_model, cfg.d_ff, device=device,
                             dtype=dtype))


class DecoderXAttnLayer(nn.Module):
    """Whisper's decoder layer: ``ln1``, ``attn`` (causal self attention),
    ``ln_x``, ``xattn`` (cross attention to the encoder), ``ln2``,
    ``ffn``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = L.Attention(cfg, device=device, dtype=dtype)
        self.ln_x = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.xattn = L.Attention(cfg, device=device, dtype=dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class RWKVLayer(nn.Module):
    """An RWKV-6 layer: ``ln1``, ``tm`` (time-mix), ``ln2``, ``cm``
    (channel-mix)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.tm = S.RWKVTimeMix(cfg, device=device, dtype=dtype)
        self.cm = S.RWKVChannelMix(cfg, device=device, dtype=dtype)


class MambaLayer(nn.Module):
    """A Zamba2 backbone layer: ``ln1``, ``mamba`` (Mamba-2)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mamba = S.Mamba2(cfg, device=device, dtype=dtype)


def _layer(cfg: ModelConfig, **kw) -> nn.Module:
    if cfg.family == "rwkv6":
        return RWKVLayer(cfg, **kw)
    if cfg.family == "hybrid":
        return MambaLayer(cfg, **kw)
    return DecoderLayer(cfg, moe=cfg.moe is not None,
                        mla=cfg.family == "mla_moe", **kw)


class Transformer(nn.Module):
    """The model's parameters, allocated uninitialized on ``device``
    (None: the CUDA device); fill them with :func:`init_params` or
    :func:`repro_torch.models.convert.params_from_numpy`.  An encdec
    model holds ``enc_layers``, ``dec_layers`` and ``enc_norm`` in place
    of ``layers``; a hybrid one also holds ``shared``, Zamba2's
    weight-shared block."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.embedding = L._param((cfg.vocab, cfg.d_model), device, dtype)
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, **kw) for _ in range(cfg.n_enc_layers))
            self.dec_layers = nn.ModuleList(
                DecoderXAttnLayer(cfg, **kw) for _ in range(cfg.n_layers))
            self.enc_norm = L.RMSNorm(cfg.d_model, **kw)
        else:
            self.layers = nn.ModuleList(
                _layer(cfg, **kw) for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = DecoderLayer(cfg, **kw)
        self.final_norm = L.RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.vocab), device, dtype)


def _leaves(tree: Dict[str, Any], prefix: str = ""):
    """(dotted name, tensor) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


# The stacked trees' layer stacks: leaves under these carry a leading
# layers axis.
STACKS = ("layers", "enc_layers", "dec_layers")


def load_stacked(model: Transformer, tree: Dict[str, Any]) -> Transformer:
    """Set ``model``'s parameters from a tree shaped like
    ``stacked_model_spec`` (leaves under ``STACKS`` carry a leading layers
    axis, split here into the ``ModuleList``; an MoE's expert stacks are
    then (E, d, f) a layer).  Each tensor must already have the
    parameter's device and dtype; a layer's parameter is a view of the
    stacked tensor (no copy), and ``tree`` is kept as ``model.stacked``
    (:func:`stacked_params`).  Builds no reference cycle, so a model is
    freed as soon as its last reference goes."""
    params = dict(model.named_parameters())
    todo = []
    for name, v in _leaves(tree):
        stack, _, rest = name.partition(".")
        if stack in STACKS:
            n = len(getattr(model, stack, ()))
            if v.shape[0] != n:
                raise ValueError(f"{name}: {v.shape[0]} layers, model "
                                 f"has {n} in {stack}")
            todo += [(f"{stack}.{i}.{rest}", v[i]) for i in range(n)]
        else:
            todo.append((name, v))
    for name, t in todo:
        old = params.get(name)
        if old is None:
            raise KeyError(f"{name}: not a parameter of the model")
        if tuple(t.shape) != tuple(old.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, model "
                             f"wants {tuple(old.shape)}")
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, nn.Parameter(t, requires_grad=False))
    missing = sorted(set(params) - {name for name, _ in todo})
    if missing:
        raise KeyError(f"tree lacks parameters {missing}")
    model.stacked = tree
    return model


def stacked_params(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the stacked tree ``load_stacked`` took
    (JAX's parameter tree): the tensors its layer parameters are views of,
    so an in-place update of a leaf updates every layer."""
    tree = getattr(model, "stacked", None)
    if tree is None:
        raise ValueError("the model was not loaded through load_stacked")
    return tree


class Unsharded:
    """A read-only view of a module of DTensor parameters for a step on a
    mesh: each parameter read through it is first gathered over the mesh
    axes that are not ``flags.HEAD_AXES`` (ZeRO-3 / FSDP's all-gather of
    the data-parallel shards; its backward reduce-scatters the gradient),
    so DTensor shards products and norms on the activations' batch, as
    GSPMD does for JAX's FSDP layout, and never gathers the activations
    to meet a weight's ``embed`` shard.  A read happens where the code
    reads the weight, so a rematerialised layer gathers again in its
    recompute.  Submodules come back as views, methods and other
    attributes as the module's own."""

    def __init__(self, module):
        object.__setattr__(self, "_module", module)

    def __getattr__(self, name):
        v = getattr(self._module, name)
        if isinstance(v, nn.Module):
            return Unsharded(v)
        if isinstance(v, nn.Parameter) and is_dtensor(v):
            return _gather_fsdp(v)
        return v

    def __iter__(self):
        return (Unsharded(m) for m in self._module)

    def __len__(self):
        return len(self._module)

    def __getitem__(self, i):
        return Unsharded(self._module[i])


def _gather_fsdp(p):
    from torch.distributed.tensor import Replicate
    names = p.device_mesh.mesh_dim_names
    tp = flags.HEAD_AXES
    tp = (tp,) if isinstance(tp, str) else tuple(tp or ())
    want = [pl if names[m] in tp else Replicate()
            for m, pl in enumerate(p.placements)]
    if want == list(p.placements):
        return p
    return p.redistribute(p.device_mesh, want)


def unsharded(model):
    """``model`` read through :class:`Unsharded` where its parameters are
    DTensors; else ``model``."""
    if isinstance(model, Unsharded) or not is_dtensor(model.embedding):
        return model
    return Unsharded(model)


def embed(model, tokens: torch.Tensor) -> torch.Tensor:
    """``model.embedding[tokens]``.  On DTensors the lookup runs on the
    local shards (``local_map``): each rank gathers the rows of its vocab
    shard and zeros the rest, a Partial sum over the vocab's axes (the
    vocab-parallel embedding), its gradient Partial over the batch's axes.
    DTensor's own rule for the index goes through ``index_put`` in the
    backward, which some PyTorch releases cannot place."""
    w = model.embedding
    if not is_dtensor(w):
        return w[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    tp = tokens.placements
    w_pl = [Shard(0) if (p.is_shard(0) and not tp[m].is_shard(0))
            else Replicate() for m, p in enumerate(w.placements)]
    idx, n = 0, 1
    for m, p in enumerate(w_pl):
        if p.is_shard(0):
            idx, n = idx * mesh.size(m) + mesh.get_local_rank(m), (
                n * mesh.size(m))
    rows = w.shape[0] // n
    out_pl = [Shard(0) if t.is_shard(0) else
              (Partial() if p.is_shard(0) else Replicate())
              for t, p in zip(tp, w_pl)]
    grad_pl = [Partial() if t.is_shard(0) else p for t, p in zip(tp, w_pl)]

    def lookup(w_loc, tok):
        local = tok - idx * rows
        inside = (local >= 0) & (local < rows)
        got = w_loc[local.clamp(0, rows - 1)]
        return torch.where(inside[..., None], got,
                           torch.zeros((), dtype=got.dtype,
                                       device=got.device))
    return local_map(lookup, out_placements=out_pl,
                     in_placements=(w_pl, tp), in_grad_placements=(
                         grad_pl, tp), device_mesh=mesh,
                     redistribute_inputs=True)(w, tokens)


def make_trainable(model: Transformer) -> Transformer:
    """Every parameter ``requires_grad_(True)`` (each layer's parameter
    stays a view of its stacked tensor)."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def zero_grads(model: Transformer) -> None:
    for p in model.parameters():
        p.grad = None


def stacked_grads(model: Transformer) -> Dict[str, Any]:
    """The parameters' ``.grad`` as a tree shaped like
    :func:`stacked_params` (each stack's layer gradients stacked; a
    parameter the loss did not reach has a zero gradient, as in JAX)."""
    params = dict(model.named_parameters())

    def grad(name):
        p = params[name]
        return p.grad if p.grad is not None else torch.zeros_like(p)

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            name = prefix + k
            if isinstance(v, dict):
                out[k] = walk(v, name + ".")
                continue
            stack, _, rest = name.partition(".")
            if stack in STACKS:
                out[k] = torch.stack([grad(f"{stack}.{i}.{rest}")
                                      for i in range(v.shape[0])])
            else:
                out[k] = grad(name)
        return out
    return walk(stacked_params(model), "")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Transformer:
    """A ``Transformer`` with the JAX package's random init (std rule of
    ``params.init_tree`` on the stacked spec), drawn from ``generator``."""
    device = resolve_device(device)
    tree = init_tree(stacked_model_spec(cfg), generator, dtype, device)
    return load_stacked(Transformer(cfg, device="meta", dtype=dtype), tree)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _positions(cfg: ModelConfig, batch: int, seq: int,
               mrope_positions: Optional[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The vlm family's (3, B, S) ``mrope_positions`` where given, else
    (B, S) text positions: M-RoPE with three equal axes is plain RoPE."""
    if cfg.mrope and mrope_positions is not None:
        return mrope_positions                  # (3, B, S) from frontend stub
    return torch.arange(seq, device=device)[None].expand(batch, seq)


def _decoder_layer_fwd(cfg: ModelConfig, layer: nn.Module, x, positions):
    """One pre-norm decoder layer; returns (x, aux): the MoE's aux loss,
    else None.  An RWKV layer starts from zero carries and state, as in
    JAX; a hybrid config's layer is its Mamba-2 block alone.  The residual
    stream is pinned on the batch axes (``flags.constrain``)."""
    x = flags.constrain(x, "batch", None, None)
    if cfg.family == "rwkv6":
        st = S.rwkv6_init_state(cfg, x.shape[0], x.device)
        h, _, _ = S.rwkv6_time_mix_scan(
            layer.tm, L.rmsnorm(layer.ln1.scale, x), cfg, st["tm_x"],
            st["tm_state"])
        x = x + h
        h, _ = S.rwkv6_channel_mix(
            layer.cm, L.rmsnorm(layer.ln2.scale, x), st["cm_x"])
        return x + h, None
    if cfg.family == "hybrid":
        return _mamba_layer_fwd(cfg, layer, x), None
    attend = L.mla_apply if cfg.family == "mla_moe" else L.attention_apply
    h = attend(layer.attn, L.rmsnorm(layer.ln1.scale, x), cfg, positions)
    x = x + h
    h_in = L.rmsnorm(layer.ln2.scale, x)
    if cfg.moe is not None:
        h, aux = L.moe_apply(layer.ffn, h_in, cfg)
    else:
        h, aux = L.mlp_apply(layer.ffn, h_in), None
    return x + h, aux


def _mamba_layer_fwd(cfg: ModelConfig, layer: MambaLayer, x):
    return x + S.mamba2_scan(layer.mamba, L.rmsnorm(layer.ln1.scale, x), cfg)


def _shared_block_fwd(cfg: ModelConfig, block: DecoderLayer, x, positions):
    h = L.attention_apply(block.attn, L.rmsnorm(block.ln1.scale, x), cfg,
                          positions, window=cfg.sliding_window)
    x = x + h
    h = L.mlp_apply(block.ffn, L.rmsnorm(block.ln2.scale, x))
    return x + h


def _remat(body, remat: bool):
    return flags.remat_wrap(body) if remat else body


def forward(model: Transformer, tokens_or_embeds: torch.Tensor,
            cfg: ModelConfig, *,
            mrope_positions: Optional[torch.Tensor] = None,
            encoder_out: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden_states (B,S,D), aux_loss ()): the moe family's aux
    summed over layers, else 0.  ``mrope_positions`` (3, B, S): the vlm
    family's position ids (default: every axis 0..S-1).  ``encoder_out``
    (B, S_enc, D): the encdec family's encoder states (:func:`encode`),
    which its decoder needs.  A hybrid config runs its Mamba-2 layers
    alone, as JAX's ``forward`` does; :func:`hybrid_forward` is its
    model.  ``remat``: under grad, each layer body goes through
    ``flags.remat_wrap``."""
    check_family(cfg)
    if not tokens_or_embeds.is_floating_point():
        x = embed(model, tokens_or_embeds)
    else:
        x = tokens_or_embeds                    # stubbed frontend embeddings
    B, Sq = x.shape[:2]
    positions = _positions(cfg, B, Sq, mrope_positions, x.device)
    aux = torch.zeros((), dtype=f32, device=x.device)
    if cfg.family == "encdec":
        return _encdec_forward(model, x, cfg, encoder_out, positions,
                               remat), aux

    def body(layer, x, aux):
        x, a = _decoder_layer_fwd(cfg, layer, x, positions)
        return x, (aux if a is None else aux + a)

    body_fn = _remat(body, remat)
    for layer in model.layers:
        x, aux = body_fn(layer, x, aux)
    x = L.rmsnorm(model.final_norm.scale, x)
    return x, aux


def hybrid_forward(model: Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, *, remat: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zamba2: groups of ``shared_attn_period`` Mamba-2 layers, the shared
    block before each; the ``n_layers % period`` layers left over run
    after the last group without it.  Returns (hidden (B,S,D), aux 0).
    ``remat`` wraps the Mamba-2 layers (not the shared block), as JAX."""
    check_family(cfg)
    x = embed(model, tokens)
    B, Sq = x.shape[:2]
    positions = _positions(cfg, B, Sq, None, x.device)
    period = cfg.shared_attn_period
    n_groups = cfg.n_layers // period
    mamba = _remat(lambda layer, x: _mamba_layer_fwd(cfg, layer, x), remat)
    for gi in range(n_groups):
        x = _shared_block_fwd(cfg, model.shared, x, positions)
        for layer in model.layers[gi * period:(gi + 1) * period]:
            x = mamba(layer, x)
    for layer in model.layers[n_groups * period:]:
        x = mamba(layer, x)
    x = L.rmsnorm(model.final_norm.scale, x)
    return x, torch.zeros((), dtype=f32, device=x.device)


def _encdec_forward(model: Transformer, x, cfg: ModelConfig, encoder_out,
                    positions, remat: bool = True):
    """Whisper's decoder: per layer causal self attention (RoPE), cross
    attention to ``encoder_out`` (no RoPE, no mask), SwiGLU."""
    if encoder_out is None:
        raise ValueError("encdec needs encoder_out")
    B, Sq = x.shape[:2]
    hd = cfg.resolved_head_dim

    def body(layer, x):
        h = L.attention_apply(layer.attn, L.rmsnorm(layer.ln1.scale, x),
                              cfg, positions)
        x = x + h
        # cross attention (bidirectional over encoder states)
        xq = L.rmsnorm(layer.ln_x.scale, x)
        q = L.split_heads(xq @ layer.xattn.wq, cfg.n_heads, hd)
        k = L.split_heads(encoder_out @ layer.xattn.wk, cfg.n_kv_heads, hd)
        v = L.split_heads(encoder_out @ layer.xattn.wv, cfg.n_kv_heads, hd)
        q, k, v = L.pin_qkv(q, k, v)
        o = L.flash_attention(q, k, v, causal=False)
        x = x + L.out_proj(o, layer.xattn.wo)
        h = L.mlp_apply(layer.ffn, L.rmsnorm(layer.ln2.scale, x))
        return x + h

    body_fn = _remat(body, remat)
    for layer in model.dec_layers:
        x = body_fn(layer, x)
    return L.rmsnorm(model.final_norm.scale, x)


def encode(model: Transformer, frame_embeds: torch.Tensor,
           cfg: ModelConfig, *, remat: bool = True) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, S, D): per layer
    bidirectional self attention (RoPE on q and k, ``causal=False``) and
    SwiGLU, then ``enc_norm``."""
    check_family(cfg)
    x = frame_embeds
    B, Sq = x.shape[:2]
    positions = _positions(cfg, B, Sq, None, x.device)

    def body(layer, x):
        h_in = L.rmsnorm(layer.ln1.scale, x)
        q, k, v = L.pin_qkv(*L.attention_qkv(layer.attn, h_in, cfg,
                                             positions))
        o = L.flash_attention(q, k, v, causal=False)
        x = x + L.out_proj(o, layer.attn.wo)
        h = L.mlp_apply(layer.ffn, L.rmsnorm(layer.ln2.scale, x))
        return x + h

    body_fn = _remat(body, remat)
    for layer in model.enc_layers:
        x = body_fn(layer, x)
    return L.rmsnorm(model.enc_norm.scale, x)


def logits_fn(model: Transformer, hidden, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return hidden @ model.embedding.T
    return hidden @ model.lm_head


def lm_forward(model: Transformer, tokens, cfg: ModelConfig, **kw):
    """tokens -> (logits (B,S,V) in the model dtype, aux); ``kw`` goes to
    :func:`forward` (a hybrid config: :func:`hybrid_forward`)."""
    if cfg.family == "hybrid":
        hidden, aux = hybrid_forward(model, tokens, cfg)
    else:
        hidden, aux = forward(model, tokens, cfg, **kw)
    return logits_fn(model, hidden, cfg), aux


__all__ = ["model_spec", "stacked_model_spec", "param_axes", "layer_spec",
           "shared_block_spec", "encoder_layer_spec",
           "decoder_xattn_layer_spec", "Transformer", "DecoderLayer",
           "DecoderXAttnLayer", "RWKVLayer", "MambaLayer", "init_params",
           "load_stacked", "stacked_params", "stacked_grads",
           "make_trainable", "zero_grads", "forward", "hybrid_forward",
           "Unsharded", "unsharded", "embed",
           "encode", "logits_fn", "lm_forward", "check_family"]
