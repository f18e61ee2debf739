"""Rank functions of tests/test_torch_sharded.py (not a test module).

``repro_torch.core.sharded.spawn_fleet`` runs a function here on every
rank of a fresh process group and checks that the ranks' results are
equal.  This module imports nothing of the JAX package, so a rank starts
without it.
"""
import torch.distributed as dist

from repro_torch.core import batched as B
from repro_torch.core import sharded as SH
from repro_torch.core import streaming as ST


def fleet_outputs(padded, indivisible, cap, runs, device):
    """This rank's replays of ``padded`` in a fleet of the group's world
    size: ``{name: (SimResult, output arrays, graphs captured)}`` for
    each ``(name, policy, cfg, chunk_events)`` of ``runs`` (chunked where
    ``chunk_events`` is set), and under ``"indivisible"`` the message a
    fleet raises on ``indivisible``'s GPUs (``None`` where K divides
    them)."""
    k = dist.get_world_size()
    got = {}
    for name, pol, kw, chunk in runs:
        if chunk:
            run = ST.make_chunked_replay(padded, pol, chunk_events=chunk,
                                         num_shards=k, device=device, **kw)
            events = run.events
        else:
            run = SH.make_sharded_replay(padded, pol, k, device, **kw)
            events = padded
        out = {key: v.cpu().numpy() for key, v in run(cap).items()}
        got[name] = (B.result_from_arrays(events, pol, out), out,
                     len(run.runner.graphs))
    try:
        SH.make_sharded_replay(indivisible, B.FF, k, device)
        got["indivisible"] = None
    except ValueError as e:
        got["indivisible"] = str(e)
    return got


def fail_on_rank(rank_to_fail, device):
    """Raise on rank ``rank_to_fail``; the other ranks return their
    index."""
    rank = dist.get_rank()
    if rank == rank_to_fail:
        raise ArithmeticError(f"rank {rank} fails on purpose")
    return rank
