"""Wrapper of the CUDA flash attention kernels.

Port of the Pallas kernel ``repro/kernels/flash_attention.py``
(``flash_attention_pallas``): causal / sliding-window GQA attention
forward with an online softmax and float32 statistics.

:func:`flash_attention` takes q (B, Sq, H, hd), k (B, Sk, KV, hd) and v
(B, Sk, KV, hd_v) in that layout, with no transpose and no expanded K/V;
hd_v is hd but for DeepSeek-V2's MLA (q/k 192 against v 128, as the JAX
package's ``layers.flash_attention`` takes ``hd_v = v.shape[-1]``).  A
tensor on the CPU goes to the plain version :func:`.ref.flash_attention_ref`.
CUDA tensors go to one kernel per dtype, or the wrapper raises, both in
``csrc/flash_attention_sm90.cu`` on the tensor cores:

- bfloat16 -> ``fa_fwd_wgmma<hd, hd_v, false>`` (p split exactly into
  three bf16 terms for p @ v);
- float32 -> :func:`split_bf16x3` of q, k and v into bf16 planes, then
  ``fa_fwd_wgmma<hd, hd_v, true>`` (six plane products per float32
  product, each tile's p @ v merged into the output on the CUDA cores).

Under autograd (grad enabled and q, k or v requiring grad) the call goes
through a ``torch.autograd.Function``: the forward kernel also stores each
row's log-sum-exp, and the backward is :func:`flash_attention_bwd`, which
launches ``csrc/flash_attention_bwd_sm90.cu`` for CUDA tensors or raises
(dQ then dK / dV on the tensor cores, ``fa_bwd_dq_wgmma<hd, hd_v, F32>``
/ ``fa_bwd_dkdv_wgmma<hd, hd_v, F32>``: bf16 directly; float32 after
:func:`split_bf16x3` of q, k, v and dO, six plane products per float32
product), and runs
:func:`.ref.flash_attention_bwd_ref` for CPU tensors.  The JAX package has
no Pallas backward: it differentiates the jnp chunked attention, the same
function.  Under ``no_grad`` / ``inference_mode`` (serving) no statistic is
stored and nothing else changes.

``LAUNCHES`` counts each kernel's launches under its own key
(``"flash_attention"`` the bf16 kernel, ``"flash_attention_f32"`` the
float32 one, ``"split_bf16x3"`` the split, three per float32 call,
``"flash_attention_bwd"`` / ``"flash_attention_bwd_f32"`` one per backward
call, which launches the backward source's two kernels, float32 after
four splits); plain-version calls are not counted.

JAX's ``flags.ATTN_P_BF16`` (``models.flags.ATTN_P_BF16``, read at each
call; off by default) selects the p_bf16 function: each JAX key chunk's p
rounded to bf16 against the chunk's row max, times bf16(v), summed in
float32 (``ref.flash_attention_ref(p_bf16=True)``).  CUDA tensors then go
to the source's p_bf16 routes, again one per dtype or raise:
``fa_fwd_wgmma<hd, hd_v, F32, true>`` (``PB_ROUTES``: one bf16 term of p;
float32 after :func:`split_bf16x3` of q, k and v, of whose v only the hi
plane is read), and under autograd ``fa_bwd_dq_wgmma`` /
``fa_bwd_dkdv_wgmma<hd, hd_v, F32, true>`` (``PB_BWD_ROUTES``), the
gradient ``jax.vjp`` forms, which also reads each row's chunk maxima that
the forward stores (``mstat``, B H Sq ceil(Sk / 1024) x 4 float32: the
maximum, its first and last key and how many keys hold it, as
:func:`.ref.chunk_max_stats`; :func:`check_mstat`).  The
meta route records a p_bf16 call as it records the other: the function's
flops are the same, and p never leaves the registers on this card, so
the roofline has no p bytes to halve (JAX's XLA count halves its score
tile's bytes under the flag).

Tensors on the ``meta`` device (``launch.dryrun``'s counting pass) launch
nothing and compute nothing: the forward and the backward take the dtypes
and head dims the kernels take (else raise, as on the card), allocate
their outputs (and the LSE) on ``meta`` and, while ``count_step`` has
installed a list as ``META_CALLS``, append the call to it as a
:class:`MetaCall`, which the roofline counts with the kernels' flop and
byte formulas.

DTensors (a step on a ``DeviceMesh``) have no sharding rule for these
kernels, so the wrapper runs them on local shards
(``torch.distributed.tensor.experimental.local_map``, :func:`_on_shards`):
q pinned batch on ``models.flags.BATCH_AXES`` and heads on ``HEAD_AXES``,
k and v on the batch axes and, where KV == H, on the head axes too (JAX's
pins, ``layers.flash_attention``).  GQA k and v stay whole over the head
axes and each rank takes the kv heads its q heads read (their gradient
then Partial over those axes: each rank adds its heads' part), so every
rank launches the kernels on its own (B/dp, S, H/tp, hd) shard.  On
``meta`` the calls are recorded at those local shapes: the dry-run's
flops are per device, as XLA's ``cost_analysis`` is.  A shard the kernels
do not take (local q heads that no whole group of kv heads serves)
raises, on the card and on ``meta`` alike.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import is_dtensor
from . import ref
from ._build import load

# The head dims the kernels take: csrc/flash_attention_sm90.cu's HEAD_DIMS
# list, one instantiation each (tests/test_torch_attention.py holds the
# two equal).  Any multiple of 16 would tile; these are the zoo's.
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
# The (q/k, v) head-dim pairs of unequal widths they take: the .cu's
# HEAD_DIM_PAIRS list (held equal by the same test); DeepSeek-V2's MLA.
HEAD_DIM_PAIRS = ((192, 128),)
SOURCE = "flash_attention_sm90"
# dtype -> (C entry point, LAUNCHES key)
ROUTES = {
    torch.bfloat16: ("fa_forward_bf16", "flash_attention"),
    torch.float32: ("fa_forward_f32", "flash_attention_f32"),
}
SPLIT = "split_bf16x3"  # its C entry point and LAUNCHES key
BWD_SOURCE = "flash_attention_bwd_sm90"
# dtype -> (C entry point of the backward, LAUNCHES key)
BWD_ROUTES = {
    torch.bfloat16: ("fa_backward_bf16", "flash_attention_bwd"),
    torch.float32: ("fa_backward_f32", "flash_attention_bwd_f32"),
}
# The p_bf16 routes (JAX's ATTN_P_BF16), forward and backward, by dtype.
PB_ROUTES = {
    torch.bfloat16: ("fa_forward_bf16_pbf16", "flash_attention_pbf16"),
    torch.float32: ("fa_forward_f32_pbf16", "flash_attention_f32_pbf16"),
}
PB_BWD_ROUTES = {
    torch.bfloat16: ("fa_backward_bf16_pbf16", "flash_attention_bwd_pbf16"),
    torch.float32: ("fa_backward_f32_pbf16",
                    "flash_attention_bwd_f32_pbf16"),
}
# Keys of one of JAX's key chunks, against whose row max p_bf16 rounds.
CHUNK_KEYS = 1024
# Floats per (row, key chunk) of the p_bf16 forward's mstat: the chunk's
# row max, its first and last maximal key, and their count.
MSTAT_FIELDS = 4
# The attention entries' own error codes (a tensor map could not be made).
_TMA_ERRORS = {-1: "cuTensorMapEncodeTiled is not available",
               -2: "cuTensorMapEncodeTiled refused a TMA tensor map"}

LAUNCHES: Dict[str, int] = {
    key: 0 for _, key in (*ROUTES.values(), *BWD_ROUTES.values(),
                          *PB_ROUTES.values(), *PB_BWD_ROUTES.values())}
LAUNCHES[SPLIT] = 0


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


class MetaCall(NamedTuple):
    """One call on ``meta`` tensors: the work a kernel would do."""
    B: int
    Sq: int
    Sk: int
    H: int
    KV: int
    hd: int
    hd_v: int
    causal: bool
    window: Optional[int]
    dtype: str        # "bfloat16" | "float32"
    kind: str         # "fwd" | "bwd"


# The list ``launch.dryrun.count_step`` installs while it counts a step;
# None outside it, when meta calls are checked and not recorded.
META_CALLS: Optional[List[MetaCall]] = None


def _record_meta(q, k, v, causal, window, kind: str, routes) -> None:
    """Check a meta call as the card route does and record it."""
    if q.dtype not in routes:
        raise TypeError(f"dtype {q.dtype} not in {list(routes)}")
    B, Sq, H, hd = q.shape
    check_head_dims(hd, v.shape[3])
    if META_CALLS is not None:
        META_CALLS.append(MetaCall(B, Sq, k.shape[1], H, k.shape[2], hd,
                                   v.shape[3], bool(causal), window,
                                   str(q.dtype).split(".")[-1], kind))


@lru_cache(maxsize=None)
def _entry(name: str):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == SPLIT:
        fn = getattr(load(SOURCE), name)
        fn.argtypes = [P, P, ctypes.c_longlong, ctypes.c_longlong, P]
    elif name.startswith("fa_backward"):
        # q, k, v, o, dO, [float32: dO's planes,] lse, [p_bf16: mstat,] D,
        # [p_bf16: tstat,] dq, dk, dv, B, Sq, Sk, H, KV, hd, hd_v, scale,
        # causal, window, stream
        fn = getattr(load(BWD_SOURCE), name)
        n_ptr = (10 + ("_f32" in name) + 2 * name.endswith("_pbf16"))
        fn.argtypes = [P] * n_ptr + [I] * 7 + [F, I, I, P]
    else:
        # q, k, v, o, lse, [p_bf16: mstat,] B, Sq, Sk, H, KV, hd, hd_v,
        # scale, causal, window, stream
        fn = getattr(load(SOURCE), name)
        n_ptr = 5 + name.endswith("_pbf16")
        fn.argtypes = [P] * n_ptr + [I] * 7 + [F, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned (the split's vector loads and TMA's
    global addresses need it)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """float32 x -> bf16 planes (3, *x.shape): hi, mid, lo of
    :func:`.ref.split_bf16x3`, whose sum is x exactly for |x| from about
    2^-110 up to bf16's largest finite value.  A CPU tensor runs the plain
    version; a CUDA tensor launches ``split_bf16x3_kernel``."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x3 takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return torch.stack(ref.split_bf16x3(x))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = _aligned(x)
    n = x.numel()
    # Each plane starts 8-byte aligned for the kernel's vector stores: the
    # planes are contiguous when n % 4 == 0 (always, for attention's q, k
    # and v), else rows of a (3, n rounded up to 4) buffer.
    stride = -(-n // 4) * 4
    buf = torch.empty((3, stride), dtype=torch.bfloat16, device=x.device)
    if n == 0:
        return buf.view(3, *x.shape)
    err = _entry(SPLIT)(x.data_ptr(), buf.data_ptr(), n, stride,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{SPLIT}: CUDA error ({err})")
    LAUNCHES[SPLIT] += 1
    return buf[:, :n].view(3, *x.shape)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or (
            v.shape[:3] != k.shape[:3]):
        raise ValueError(f"want q (B,Sq,H,hd), k (B,Sk,KV,hd), v "
                         f"(B,Sk,KV,hd_v); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H % KV must be 0)")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q/k/v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def check_head_dims(hd: int, hd_v: int) -> None:
    """Raise unless the CUDA kernels take q/k head dim ``hd`` against v head
    dim ``hd_v``: equal and in ``HEAD_DIMS``, or a pair of
    ``HEAD_DIM_PAIRS``.  (The plain version takes any.)"""
    if hd == hd_v and hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}: the CUDA "
                         f"kernels are instantiated for these only")
    if hd != hd_v and (hd, hd_v) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims q/k {hd} against v {hd_v} not in "
                         f"{HEAD_DIM_PAIRS}: the CUDA kernels are "
                         f"instantiated for these pairs only")


def _on_card(q: torch.Tensor, routes) -> None:
    """Raise unless the kernels take q (and k, v of its shapes) on the
    card."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in routes:
        raise TypeError(f"dtype {q.dtype} not in {list(routes)}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _forward(q, k, v, causal: bool, window: Optional[int], want_lse: bool,
             p_bf16: bool = False):
    """(out, lse, mstat): lse (B, H, Sq) float32 when ``want_lse`` else
    None; mstat, the p_bf16 route's chunk statistics for its backward, (B,
    H, Sq, ceil(Sk / 1024), MSTAT_FIELDS) float32 on the card when
    ``want_lse`` and ``p_bf16`` (:func:`check_mstat`), else None.  The
    plain version for CPU tensors, else the dtype's kernel (``p_bf16``:
    its p_bf16 route)."""
    if q.device.type == "cpu":
        out, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True,
                                           p_bf16=p_bf16)
        return out, (lse if want_lse else None), None
    routes = PB_ROUTES if p_bf16 else ROUTES
    if q.device.type == "meta":
        _record_meta(q, k, v, causal, window, "fwd", routes)
        B, Sq, H, _ = q.shape
        out = q.new_empty((B, Sq, H, v.shape[3]))
        lse = (q.new_empty((B, H, Sq), dtype=torch.float32) if want_lse
               else None)
        return out, lse, None
    _on_card(q, routes)
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    check_head_dims(hd, hd_v)
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    mstat = (torch.empty((B, H, Sq, -(-Sk // CHUNK_KEYS), MSTAT_FIELDS),
                         dtype=torch.float32, device=q.device)
             if want_lse and p_bf16 else None)
    if out.numel() == 0:
        return out, lse, mstat
    if Sk == 0:
        raise ValueError("attention over zero keys")
    if q.dtype == torch.float32:
        q, k, v = split_bf16x3(q), split_bf16x3(k), split_bf16x3(v)
    else:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    name, key = routes[out.dtype]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr()]
    if p_bf16:
        ptrs.append(None if mstat is None else mstat.data_ptr())
    err = _entry(name)(
        *ptrs, B, Sq, Sk, H, KV, hd, hd_v, 1.0 / math.sqrt(hd), int(causal),
        window or 0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: {_TMA_ERRORS.get(err, 'CUDA error')} "
                           f"({err})")
    LAUNCHES[key] += 1
    return out, lse, mstat


def check_mstat(mstat: Optional[torch.Tensor], B: int, H: int, Sq: int,
                Sk: int) -> None:
    """Raise unless ``mstat`` is what the p_bf16 forward stores for q (B,
    Sq, H, .) against Sk keys: float32 (B, H, Sq, ceil(Sk / 1024),
    MSTAT_FIELDS), each row's (chunk max, first and last maximal key,
    their count) per JAX key chunk (:func:`.ref.chunk_max_stats`)."""
    want = (B, H, Sq, -(-Sk // CHUNK_KEYS), MSTAT_FIELDS)
    if (mstat is None or mstat.dtype != torch.float32
            or tuple(mstat.shape) != want):
        got = None if mstat is None else (tuple(mstat.shape), mstat.dtype)
        raise ValueError(f"the p_bf16 backward takes the forward's mstat "
                         f"{want} float32, got {got}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, p_bf16: bool = False,
                        mstat: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v, from its output
    ``o``, its saved ``lse`` (B, H, Sq) and the output's gradient ``do``,
    in q's dtype.  CPU tensors run :func:`.ref.flash_attention_bwd_ref`;
    CUDA tensors launch the dtype's backward or raise: bf16
    ``fa_backward_bf16``, float32 :func:`split_bf16x3` of q, k, v and do
    (four launches) then ``fa_backward_f32`` on their planes (o and do
    also in float32, for D); each ``fa_bwd_dq_wgmma`` then
    ``fa_bwd_dkdv_wgmma`` of its dtype.  ``p_bf16``: the gradient of the
    p_bf16 function, on the card its routes (``fa_backward_*_pbf16``),
    which take the forward's ``mstat`` (:func:`_forward`)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           p_bf16=p_bf16)
    routes = PB_BWD_ROUTES if p_bf16 else BWD_ROUTES
    if q.device.type == "meta":
        _record_meta(q, k, v, causal, window, "bwd", routes)
        return tuple(torch.empty_like(x) for x in (q, k, v))
    _on_card(q, routes)
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    check_head_dims(hd, hd_v)
    if not (q.dtype == o.dtype == do.dtype) or lse.dtype != torch.float32:
        raise TypeError(f"o / do must be {q.dtype} and lse float32, got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    n_chunks = -(-Sk // CHUNK_KEYS)
    if p_bf16:
        check_mstat(mstat, B, H, Sq, Sk)
    q, k, v, o, do = (_aligned(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    name, key = routes[q.dtype]
    ptrs = [q, k, v, o, do]
    if q.dtype == torch.float32:
        planes = [split_bf16x3(x) for x in (q, k, v, do)]
        ptrs = [*planes[:3], o, do, planes[3]]
    ptrs.append(lse)
    if p_bf16:
        # mstat, then D, then the dQ kernel's T per row and chunk.
        tstat = torch.empty((B, H, Sq, n_chunks), dtype=torch.float32,
                            device=q.device)
        ptrs += [mstat.contiguous(), D, tstat]
    else:
        ptrs.append(D)
    err = _entry(name)(
        *(x.data_ptr() for x in ptrs),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, hd,
        hd_v,
        1.0 / math.sqrt(hd), int(causal), window or 0,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: {_TMA_ERRORS.get(err, 'CUDA error')} "
                           f"({err})")
    LAUNCHES[key] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The attention with its gradient: the forward stores the row
    log-sum-exp and saves q, k, v, o and it; the backward is
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, p_bf16):
        out, lse, mstat = _forward(q, k, v, causal, window, want_lse=True,
                                   p_bf16=p_bf16)
        ctx.save_for_backward(q, k, v, out, lse, mstat)
        ctx.causal, ctx.window, ctx.p_bf16 = causal, window, p_bf16
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mstat = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         p_bf16=ctx.p_bf16, mstat=mstat)
        return dq, dk, dv, None, None, None


def _heads_rank(mesh, q_pl, k_pl) -> Tuple[int, int]:
    """(this rank's index, count) over the mesh dims that shard q's heads
    (dim 2) and not k's, major first; (0, 1) where there are none."""
    idx, n = 0, 1
    for m, (pq, pk) in enumerate(zip(q_pl, k_pl)):
        if pq.is_shard(2) and not pk.is_shard(2):
            size = mesh.size(m)
            idx, n = idx * size + mesh.get_local_rank(m), n * size
    return idx, n


def _on_shards(q, k, v, causal: bool, window: Optional[int]):
    """:func:`flash_attention` of DTensors q, k, v: each rank's kernels on
    its local shards (the module docstring), each local call reading
    ``flags.ATTN_P_BF16`` itself."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    from ..models import flags
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    q_pl = flags.pinned_placements(q, "batch", None, "heads", None)
    k_pl = flags.pinned_placements(k, "batch", None,
                                   "heads" if KV == H else None, None)
    idx, n = _heads_rank(mesh, q_pl, k_pl)
    h_loc, G = H // n, H // KV          # the pins shard H evenly
    lo, hi = idx * h_loc // G, ((idx + 1) * h_loc - 1) // G + 1
    if n > 1 and not (h_loc % G == 0 or G % h_loc == 0):
        raise ValueError(f"{H} q heads over {n} ranks ({h_loc} a rank) are "
                         f"not served by whole groups of {KV} kv heads: the "
                         f"kernels take H % KV == 0 on every shard")
    # GQA k / v whole over the heads' axes: each rank's gradient holds
    # only its heads' part.
    k_grad = [Partial() if (pq.is_shard(2) and not pk.is_shard(2)) else pk
              for pq, pk in zip(q_pl, k_pl)]

    def local(ql, kl, vl):
        if n > 1:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return flash_attention(ql, kl, vl, causal=causal, window=window)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, k_pl, k_pl),
                     in_grad_placements=(q_pl, k_grad, k_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    positions_q0: int = 0) -> torch.Tensor:
    """Attention forward -> (B, Sq, H, hd_v) in q's dtype, scores scaled by
    1 / sqrt(hd) (q's head dim).

    Causality is top-left aligned (query i sees keys 0..i), as in the
    Pallas kernel; ``window`` keeps keys with kpos > qpos - window.  CUDA
    tensors must be bfloat16 or float32 (each dtype has its kernel) with
    hd == hd_v in ``HEAD_DIMS`` or (hd, hd_v) in ``HEAD_DIM_PAIRS``
    (:func:`check_head_dims`); Sq and Sk may be any length.  The plain
    version (CPU tensors) runs with its default chunks, which need Sq and
    Sk at most 1024 or multiples of it.  ``positions_q0`` must be 0 on
    either device: the Pallas kernel has no such argument.
    Differentiable: with grad enabled and q, k or v requiring grad it goes
    through ``_Attention`` (forward kernel with the row log-sum-exp, the
    backward kernels in the backward); otherwise the forward alone.
    DTensors run on their local shards (:func:`_on_shards`).  With
    ``models.flags.ATTN_P_BF16`` set (read here, at each call) it computes
    the p_bf16 function through its own routes.
    """
    _check(q, k, v, window)
    if positions_q0 != 0:
        raise ValueError("the kernel counts query positions from 0 (as the "
                         "Pallas kernel); positions_q0 must be 0")
    if is_dtensor(q):
        return _on_shards(q, k, v, causal, window)
    from ..models import flags
    p_bf16 = bool(flags.ATTN_P_BF16)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window, p_bf16)
    return _forward(q, k, v, causal, window, want_lse=False,
                    p_bf16=p_bf16)[0]


__all__ = ["flash_attention", "flash_attention_bwd", "split_bf16x3",
           "LAUNCHES", "reset_launches", "META_CALLS", "MetaCall",
           "HEAD_DIMS", "HEAD_DIM_PAIRS", "check_head_dims", "check_mstat",
           "MSTAT_FIELDS", "ROUTES",
           "BWD_ROUTES", "PB_ROUTES", "PB_BWD_ROUTES"]
