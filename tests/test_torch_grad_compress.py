"""The port's int8 gradient compression (``repro_torch.train.
grad_compress``) vs the JAX package's.

On the deterministic path ``compress`` gives JAX's int8 values and scale
bit for bit for float32 and bf16 inputs; ``decompress`` and
``quantization_error`` follow.  JAX's three tests
(tests/test_scale_features.py) are mirrored; the stochastic path is held
by unbiasedness, as JAX's is (its noise comes from a ``torch.Generator``,
not JAX's PRNG).  ``cross_pod_int8`` without a group is JAX's no-axis
fallback; over K = 2 gloo ranks (``sharded.spawn_fleet``) it equals JAX's
``psum`` branch under ``shard_map`` over 2 placeholder host devices (a
subprocess), including inputs whose int32 sum the cast back to int8 wraps
(ROADMAP.md, Queue 3: found in the reference).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pod_ranks import cross_pod_outputs
from repro.train import grad_compress as J
from repro_torch.core import sharded
from repro_torch.train import grad_compress as T

ROOT = Path(__file__).resolve().parents[1]


def _draw(seed, shape, scale):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((4097,), 1.0), ((64, 33), 3e-4),
                                         ((7, 5, 3), 250.0), ((1,), -2.0),
                                         ((300,), 1e-20)])
def test_compress_equals_jax(shape, scale, dtype):
    x = _draw(len(shape) * 7 + shape[0], shape, scale)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    q, s = T.compress(xt)
    qj, sj = J.compress(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert s.numpy().tobytes() == np.asarray(sj).tobytes()
    for out in (torch.float32, torch.bfloat16):
        got = T.decompress(q, s, out).float().numpy()
        want = np.asarray(J.decompress(qj, sj, getattr(jnp, str(out)[6:]))
                          .astype(jnp.float32))
        assert got.tobytes() == want.tobytes()
    assert (T.quantization_error(xt).numpy().tobytes()
            == np.asarray(J.quantization_error(xj)).tobytes())


def test_compress_roundtrip_error_bounded():
    x = torch.randn(1024, generator=torch.Generator().manual_seed(1)) * 3.0
    q, s = T.compress(x)
    back = T.decompress(q, s)
    # max error bounded by half a quantization step
    assert float((back - x).abs().max()) <= float(s) * 0.5 + 1e-6
    assert q.dtype == torch.int8


def test_compress_zero_tensor():
    q, s = T.compress(torch.zeros(16))
    assert float(T.decompress(q, s).abs().max()) == 0.0


def test_stochastic_rounding_unbiased():
    x = torch.full((20000,), 0.31)
    gen = torch.Generator().manual_seed(0)
    q, s = T.compress(x, generator=gen)
    mean = float(T.decompress(q, s).mean())
    assert abs(mean - 0.31) < 5e-3
    # Off the grid (0.31 at a scale of 1 / 127: 39.37 steps) the noise
    # rounds some values up and some down, unbiased; the same generator
    # state draws the same noise.
    x = torch.cat([torch.full((20000,), 0.31), torch.ones(1)])
    q, s = T.compress(x, generator=torch.Generator().manual_seed(1))
    assert set(q[:-1].tolist()) == {39, 40}
    assert abs(float(T.decompress(q, s)[:-1].mean()) - 0.31) < 5e-3
    q2, _ = T.compress(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(q, q2)
    assert set(T.compress(x)[0][:-1].tolist()) == {39}


def test_cross_pod_int8_without_a_group_is_jax_fallback():
    grads = {"a": _draw(1, (33, 5), 0.02), "b": {"c": _draw(2, (8,), 5.0)}}
    got = T.cross_pod_int8({"a": torch.from_numpy(grads["a"]),
                            "b": {"c": torch.from_numpy(grads["b"]["c"])}})
    want = J.cross_pod_int8(jax.tree.map(jnp.asarray, grads))
    assert got["a"].numpy().tobytes() == np.asarray(want["a"]).tobytes()
    assert (got["b"]["c"].numpy().tobytes()
            == np.asarray(want["b"]["c"]).tobytes())
    bf = T.cross_pod_int8(torch.from_numpy(grads["a"]).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16


# Two ranks' gradients: "normal" leaves at different scales, and "wrap"
# leaves whose quantized values reach 127 on both ranks, so the int32 sum
# (up to 254) wraps when cast back to int8.
def _two_ranks():
    base = _draw(5, (257,), 1.0)
    return [{"normal": _draw(3, (96,), 0.01), "wrap": base,
             "mixed": _draw(7, (4, 9), 2.0)},
            {"normal": _draw(4, (96,), 0.03), "wrap": base * 0.999,
             "mixed": -_draw(8, (4, 9), 1.0)}]


JAX_PSUM = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.train.grad_compress import cross_pod_int8
ranks = [{k: np.asarray(v, np.float32) for k, v in r.items()}
         for r in json.loads(sys.stdin.read())]
mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
stacked = {k: jnp.stack([r[k] for r in ranks]) for k in ranks[0]}
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
f = shard_map(lambda g: jax.tree.map(lambda x: x[None], cross_pod_int8(
    jax.tree.map(lambda x: x[0], g), "pod")), mesh=mesh, in_specs=P("pod"),
    out_specs=P("pod"))
out = jax.jit(f)(stacked)
print(json.dumps({k: np.asarray(v).tolist() for k, v in out.items()}))
"""


def test_cross_pod_int8_two_gloo_ranks_equal_jax_psum():
    ranks = _two_ranks()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_PSUM], env=env, capture_output=True,
        text=True, timeout=300,
        input=json.dumps([{k: v.tolist() for k, v in r.items()}
                          for r in ranks]))
    assert proc.returncode == 0, proc.stderr
    want = {k: np.asarray(v, np.float32) for k, v in
            json.loads(proc.stdout.strip().splitlines()[-1]).items()}
    got = sharded.spawn_fleet(cross_pod_outputs, 2, ranks, device="cpu",
                              timeout=240)
    for k in ranks[0]:
        # every device of the JAX mesh holds the same sum
        np.testing.assert_array_equal(want[k][0], want[k][1])
        assert got[k].tobytes() == want[k][0].tobytes(), k
    # The "wrap" leaf's int32 sums pass 127: the reference's cast wraps
    # them, so the result's sign flips where both ranks were near the max.
    q = [T.compress(torch.from_numpy(r["wrap"]))[0].int() for r in ranks]
    total = (q[0] + q[1]).numpy()
    assert np.abs(total).max() > 127
    big = np.abs(total) > 127
    assert (np.sign(got["wrap"][big]) != np.sign(ranks[0]["wrap"][big])).all()
