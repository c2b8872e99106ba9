"""The port's learner chunk kernel (csrc/fused_chunk.cu) against its plain
PyTorch version (ops/fused_chunk.fused_chunk_reference), on an NVIDIA GPU.

Marker `cuda`: every test skips without a card. This file imports nothing
of JAX (tests/conftest.py does), so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest -m cuda tests/test_torch_on_card.py

One case per branch of the kernel, at a small size (obs 3, act 1, nets
32x32, batch 8, K 4), from step 5 so TD3's delay schedule is offset:
DDPG; TD3 at delay 1 without smoothing noise (no eps input); TD3 at
delay 2 with noise (one eps stream drawn on the card, given to both);
D4PG with 21 atoms on [-5, 5], then again after the support moved to
[-8, 3] (set_value_bounds rewrites the launch's support in place).
Tolerances: rtol 1e-4, atol 1e-5 (f32 with another summation order).
"""

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, init_train_state
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.types import pack_batch_np

OBS, ACT, B, K, STEP0 = 3, 1, 8, 4, 5
HIDDEN = (32, 32)
RTOL, ATOL = 1e-4, 1e-5
BRANCHES = {
    "ddpg": {},
    "td3-delay1": dict(twin_critic=True),
    "td3-delay2-noise": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0),
}


def _batches(seed):
    rng = np.random.default_rng(seed)
    return pack_batch_np({
        "obs": rng.standard_normal((K, B, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, (K, B, ACT)).astype(np.float32),
        "reward": rng.standard_normal((K, B)).astype(np.float32),
        "discount": np.full((K, B), 0.99, np.float32),
        "next_obs": rng.standard_normal((K, B, OBS)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, (K, B)).astype(np.float32),
    })


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_kernel_matches_reference_on_card(branch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     device="cuda", **BRANCHES[branch])
    state = init_train_state(cfg, OBS, ACT, cfg.seed, "cuda")
    state = state._replace(step=torch.tensor(STEP0, dtype=torch.int32, device="cuda"))
    packed = torch.from_numpy(_batches(5)).cuda()
    eps = (fc.td3_noise_eps(cfg, torch.Generator(device="cuda"), STEP0, K, B, ACT)
           if cfg.takes_noise else None)
    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, 2.0, 0.0, chunk_size=K, device="cuda")
    new, td, met = run(state, packed, eps)
    ref, rtd, rmet = fc.fused_chunk_reference(cfg, state, packed, 2.0, 0.0, eps)
    torch.cuda.synchronize()
    _close(fc.flatten_state(new).cpu(), fc.flatten_state(ref).cpu())
    _close(td.cpu(), rtd.cpu())
    for name in METRIC_KEYS:
        _close(float(met[name]), float(rmet[name]))
    want = fc.actor_updates(cfg, STEP0, K)
    assert int(new.actor_opt.count) == int(ref.actor_opt.count) == want
    assert int(new.critic_opt.count) == K and int(new.step) == STEP0 + K
    if cfg.distributional:
        run.set_value_bounds(-8.0, 3.0)
        new, td, met = run(state, packed, eps)
        ref, rtd, rmet = fc.fused_chunk_reference(
            cfg.replace(v_min=-8.0, v_max=3.0), state, packed, 2.0, 0.0, eps)
        torch.cuda.synchronize()
        _close(fc.flatten_state(new).cpu(), fc.flatten_state(ref).cpu())
        _close(td.cpu(), rtd.cpu())
