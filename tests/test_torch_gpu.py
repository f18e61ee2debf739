"""The port's CUDA kernels on the card (skipped where there is none).

Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel must equal its plain version exactly, on every mask x
profile of the four device presets at a ragged length, and the replay's
kernel path must launch once per MCC/MECC arrival and decide as the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batched as B
from repro_torch.core.mig import DEVICE_MODELS
from repro_torch.kernels import mask_scores as K, ref
from repro_torch.workload.alibaba import TraceConfig, generate

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("name", sorted(DEVICE_MODELS))
def test_kernels_equal_plain_versions_on_card(name):
    _need_card()
    model = DEVICE_MODELS[name]
    base = torch.arange(model.num_masks, dtype=torch.int32)
    masks = base.repeat(1860 // model.num_masks + 1)[:1859].cuda()
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.dirichlet(np.ones(model.num_profiles)).astype(
        np.float32)).cuda()
    assert torch.equal(K.cc(masks, model), ref.cc_ref(masks, model))
    assert torch.equal(K.frag(masks, model), ref.frag_ref(masks, model))
    for p in range(model.num_profiles):
        assert torch.equal(K.mcc(masks, p, model),
                           ref.mcc_score_ref(masks, p, model))
        assert torch.equal(K.ecc(masks, p, w, model),
                           ref.ecc_score_ref(masks, p, w, model))
    torch.cuda.synchronize()


@pytest.mark.parametrize("policy", [B.MCC, B.MECC])
def test_replay_kernel_path_on_card(policy):
    _need_card()
    cluster, vms = generate(TraceConfig(scale=0.05, seed=2))
    events = B.build_events(vms, cluster)
    K.reset_launches()
    card = B.replay(events, policy, device="cuda", score_backend="kernel")
    arrivals = int((events.kind == B.ARRIVAL).sum())
    assert K.LAUNCHES["mcc" if policy == B.MCC else "ecc"] == arrivals
    cpu = B.replay(events, policy, device="cpu", score_backend="tables")
    assert card.accepted_ids == cpu.accepted_ids
    assert card.hourly_active_hw == cpu.hourly_active_hw
