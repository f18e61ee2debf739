"""Random fleets for the pick tests (not a test module; numpy only, so the
card tests can use it where JAX is not installed).

``fleet`` draws one arrival's inputs to ``mask_scores.mcc_pick`` /
``ecc_pick`` from a seed; ``CASES`` names the kinds of fleet it draws.
"""
import numpy as np

CASES = ("random", "ties", "none_fit", "blocked", "high_bits")


def fleet(model, G, seed, case="random", H=None, contiguous=False):
    """(free, gpu_host, host_used, cap_g, need) as numpy arrays.

    Hosts get float32 headroom at, just under and just over ``need``, so
    the float32 add-and-compare decides some GPUs by one rounding.
    ``ties``: a few masks repeated, so many GPUs share the best score;
    ``none_fit``: no free block anywhere; ``blocked``: every host full;
    ``high_bits``: random bits above ``num_blocks`` (bit 31 on every
    fifth GPU).  GPUs go to random hosts, or with ``contiguous`` host by
    host, G // H or one more each (every host holds one when G >= H), as
    a cluster numbers them."""
    rng = np.random.default_rng(seed)
    H = H or max(1, G // 3)
    free = rng.integers(0, model.num_masks, G).astype(np.int32)
    if case == "ties":
        free = rng.choice(free[:3], G).astype(np.int32)
    elif case == "none_fit":
        free = np.zeros(G, np.int32)
    elif case == "high_bits":
        high = rng.integers(0, 1 << (31 - model.num_blocks), G,
                            dtype=np.int64) << model.num_blocks
        free = (free.astype(np.int64) | high).astype(np.uint32).view(
            np.int32).copy()
        free[::5] |= np.int32(-2 ** 31)
    gpu_host = rng.integers(0, H, G).astype(np.int64)
    if contiguous:
        gpu_host = np.arange(G, dtype=np.int64) * H // G
    cap = np.stack([rng.choice([16.0, 32.0, 96.0], H),
                    rng.choice([64.0, 256.0, 1024.0], H)], 1).astype(
                        np.float32)
    need = np.array([rng.choice([0.1, 1.0, 7.5]),
                     rng.choice([0.3, 4.0, 31.25])], np.float32)
    # used = cap - need (or one ulp either side of it), or a random fill.
    edge = (cap - need).astype(np.float32)
    nudge = rng.integers(-1, 2, (H, 2))
    used = np.where(nudge < 0, np.nextafter(edge, -np.inf),
                    np.where(nudge > 0, np.nextafter(edge, np.inf), edge))
    fill = (rng.uniform(0, 1.1, (H, 2)) * cap).astype(np.float32)
    used = np.where(rng.random((H, 1)) < 0.5, used, fill).astype(np.float32)
    if case == "blocked":
        used = cap.copy()
    return free, gpu_host, used, cap[gpu_host], need


def weights(model, seed):
    """(integer counts, real probabilities) as float32."""
    rng = np.random.default_rng(seed)
    n = model.num_profiles
    return (rng.integers(0, 60, n).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32))
