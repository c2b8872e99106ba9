"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU: the learner chunk kernel (csrc/fused_chunk.cu, against
ops/fused_chunk.fused_chunk_reference) and the fused Adam + Polyak update
(csrc/fused_update.cu, against ops/fused_update.fused_adam_polyak_reference).

Marker `cuda`: every test skips without a card. This file imports nothing
of JAX (tests/conftest.py does), so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest -m cuda tests/test_torch_on_card.py

One case per branch of the kernel, at a small size (obs 3, act 1, nets
32x32, batch 8, K 4), from step 5 so TD3's delay schedule is offset:
DDPG; TD3 at delay 1 without smoothing noise (no eps input); TD3 at
delay 2 with noise (one eps stream drawn on the card, given to both);
D4PG with 21 atoms on [-5, 5], then again after the support moved to
[-8, 3] (set_value_bounds rewrites the launch's support in place); SAC
with the temperature learned, and again with both critic members equal
(every row of the min gate ties), both with two normal streams drawn on
the card, given to both. Then DDPG, TD3 (delay 2, noise), D4PG and SAC
again with compute_dtype='bfloat16' (both versions round every product's
operands to bf16 and sum in f32).
Tolerances: rtol 1e-4, atol 1e-5 (f32 with another summation order), for
the bf16 cases too.

The fused update: three steps on the JAX test's ragged leaves
(tests/test_fused.py:23), on a 32x32 DDPG critic, on leaves of odd
lengths, on unaligned views and on more leaves than one launch's table
holds, each step one launch a table, at rtol 1e-6, atol 1e-7
(tests/test_fused.py's) and bit for bit (0 ULP), with the inputs left as
they were; one device operation a call on the Pendulum critic, counted by
torch.profiler; the wrapper in a CUDA graph against eager calls; the
kernel's bias corrections against torch.pow for every count to 2^20. The
scan route (parallel/learner.make_scan_chunk_fn)
with fused_update, DDPG and D4PG, on the card against the same chunk on
the CPU (rtol 1e-4, atol 1e-5); D4PG's eager step once indexed past the
last atom on the card only (ops/losses.categorical_projection).
"""

import numpy as np
import pytest
import torch

from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import (
    METRIC_KEYS,
    init_train_state,
    train_state_from_numpy,
    train_state_to_numpy,
)
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.ops import fused_update as fu
from distributed_ddpg_tpu_torch.ops.optim import tree_leaves
from distributed_ddpg_tpu_torch.parallel.learner import make_scan_chunk_fn
from distributed_ddpg_tpu_torch.tools import update_trees as ut
from distributed_ddpg_tpu_torch.types import OptState, pack_batch_np

OBS, ACT, B, K, STEP0 = 3, 1, 8, 4, 5
HIDDEN = (32, 32)
RTOL, ATOL = 1e-4, 1e-5
BRANCHES = {
    "ddpg": {},
    "td3-delay1": dict(twin_critic=True),
    "td3-delay2-noise": dict(twin_critic=True, policy_delay=2, target_noise=0.2),
    "d4pg": dict(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0),
    "sac": dict(sac=True),
    "sac-tied": dict(sac=True),
    "ddpg-bf16": dict(compute_dtype="bfloat16"),
    "td3-delay2-noise-bf16": dict(twin_critic=True, policy_delay=2, target_noise=0.2,
                                  compute_dtype="bfloat16"),
    "d4pg-bf16": dict(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0,
                      compute_dtype="bfloat16"),
    "sac-bf16": dict(sac=True, compute_dtype="bfloat16"),
}

# One torch thread: the tests' own host work is tiny.
torch.set_num_threads(1)


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
    if branch == "sac-tied":
        tie = tuple({k: torch.stack([v[0], v[0]]) for k, v in layer.items()}
                    for layer in state.critic_params)
        state = state._replace(critic_params=tie, target_critic_params=tie)
    packed = torch.from_numpy(_batches(5)).cuda()
    if cfg.sac:
        eps = fc.sac_noise_eps(cfg, torch.Generator(device="cuda"), STEP0, K, B, ACT)
    elif cfg.takes_noise:
        eps = fc.td3_noise_eps(cfg, torch.Generator(device="cuda"), STEP0, K, B, ACT)
    else:
        eps = None
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
    if cfg.sac:
        assert int(new.alpha_opt.count) == int(ref.alpha_opt.count) == K
    if cfg.distributional:
        run.set_value_bounds(-8.0, 3.0)
        new, td, met = run(state, packed, eps)
        ref, rtd, rmet = fc.fused_chunk_reference(
            cfg.replace(v_min=-8.0, v_max=3.0), state, packed, 2.0, 0.0, eps)
        torch.cuda.synchronize()
        _close(fc.flatten_state(new).cpu(), fc.flatten_state(ref).cpu())
        _close(td.cpu(), rtd.cpu())


# The fused update's trees: tools/update_trees.SHAPES (the JAX test's
# ragged leaves; leaves of odd lengths; the ragged leaves as unaligned
# views; more leaves than one launch's table holds) and a 32x32 critic.
UPDATE_TREES = [*ut.SHAPES, "critic"]


def _critic_shapes(hidden):
    cfg = DDPGConfig(actor_hidden=hidden, critic_hidden=hidden, device="cpu")
    return [(tuple(l["w"].shape), tuple(l["b"].shape))
            for l in init_train_state(cfg, OBS, ACT, 0).critic_params]


def _update_inputs(tree: str, hidden=HIDDEN):
    """(params, opt, targets, grads-of-step-i function) on the card, from a
    seeded numpy draw (tools/update_trees.update_inputs, count 5): a tree
    of tools/update_trees.SHAPES, or a DDPG critic of `hidden`."""
    shapes = ut.SHAPES[tree] if tree in ut.SHAPES else _critic_shapes(hidden)
    return ut.update_inputs(shapes, ut.SHIFTS.get(tree, ut.NO_SHIFTS))


def _leaves(*trees):
    return [x for tree in trees for x in tree_leaves(tree)]


@pytest.mark.cuda
@pytest.mark.parametrize("tree", UPDATE_TREES)
def test_fused_update_matches_reference_on_card(tree):
    """Three steps, each against the plain version bit for bit (0 ULP), with
    the inputs left as they were and one launch a table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    params, opt, targets, grads_at = _update_inputs(tree)
    p, o, t = params, opt, targets
    rp, ro, rt = params, opt, targets
    per_call = len(fu.plan(tuple(x.shape for x in tree_leaves(params))).launches)
    assert per_call == (2 if tree == "many" else 1)
    launches = fc.KERNEL_LAUNCHES["fused_update"]
    for i in range(3):
        grads = grads_at(i, rp)
        before = [x.clone() for x in _leaves(p, o.mu, o.nu, t, grads)] + [o.count.clone()]
        new = fu.fused_adam_polyak(p, grads, o, t, 1e-3, 0.05)
        torch.cuda.synchronize()
        for a, b in zip(before, _leaves(p, o.mu, o.nu, t, grads) + [o.count]):
            assert torch.equal(a, b)
        p, o, t = new
        rp, ro, rt = fu.fused_adam_polyak_reference(rp, grads, ro, rt, 1e-3, 0.05)
        torch.cuda.synchronize()
        for got, want in ((p, rp), (o.mu, ro.mu), (o.nu, ro.nu), (t, rt)):
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                           rtol=1e-6, atol=1e-7)
                assert torch.equal(a, b)            # 0 ULP
    assert o.count.dtype == torch.int32
    assert int(o.count) == int(ro.count) == 8
    assert fc.KERNEL_LAUNCHES["fused_update"] == launches + 3 * per_call


@pytest.mark.cuda
def test_fused_update_is_one_launch_on_card():
    """A call on the Pendulum DDPG critic (2x256) is one device operation,
    counted by torch.profiler: no gather, no bias-correction launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    params, opt, targets, grads_at = _update_inputs("critic", hidden=(256, 256))
    grads = grads_at(0, params)
    fu.fused_adam_polyak(params, grads, opt, targets, 1e-3, 5e-3)
    torch.cuda.synchronize()
    launches = fc.KERNEL_LAUNCHES["fused_update"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            fu.fused_adam_polyak(params, grads, opt, targets, 1e-3, 5e-3)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in events) == 4, [(e.key, e.count) for e in events]
    assert fc.KERNEL_LAUNCHES["fused_update"] == launches + 4


@pytest.mark.cuda
def test_fused_update_in_a_cuda_graph_matches_eager():
    """The wrapper captured in a CUDA graph, replayed twice (each replay's
    outputs copied back into the graph's inputs), gives the two eager
    calls' trees and count bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    params, opt, targets, grads_at = _update_inputs("critic")
    grads = grads_at(0, params)
    eager = [(params, opt, targets)]
    for _ in range(2):
        p, o, t = eager[-1]
        eager.append(fu.fused_adam_polyak(p, grads, o, t, 1e-3, 0.05))

    static = [x.clone() for x in _leaves(params, opt.mu, opt.nu, targets)] + [opt.count.clone()]
    it = iter(static)
    sp, smu, snu, st = (tuple({"w": next(it), "b": next(it)} for _ in params) for _ in range(4))
    sopt = OptState(mu=smu, nu=snu, count=next(it))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fu.fused_adam_polyak(sp, grads, sopt, st, 1e-3, 0.05)     # warm up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fu.fused_adam_polyak(sp, grads, sopt, st, 1e-3, 0.05)
    new = _leaves(out[0], out[1].mu, out[1].nu, out[2]) + [out[1].count]
    for step in (1, 2):
        graph.replay()
        torch.cuda.synchronize()
        p, o, t = eager[step]
        for a, b in zip(new, _leaves(p, o.mu, o.nu, t) + [o.count]):
            assert torch.equal(a, b)
        for dst, src in zip(static, new):
            dst.copy_(src)
    assert int(new[-1]) == 7


@pytest.mark.cuda
def test_fused_update_bias_corrections_match_torch_pow():
    """The kernel's 1 - B^c for every new count c in 1..2^20, against the
    plain version's 1.0 - torch.pow(B, c) on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from distributed_ddpg_tpu_torch.ops.optim import B1, B2

    counts = 2 ** 20
    bc1, bc2 = fu.kernel_bias_corrections(counts)
    c = torch.arange(1, counts + 1, dtype=torch.int32, device="cuda").to(torch.float32)
    assert torch.equal(bc1, 1.0 - torch.pow(B1, c))
    assert torch.equal(bc2, 1.0 - torch.pow(B2, c))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ddpg", "d4pg"])
def test_scan_chunk_on_card_matches_cpu(family):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0) \
        if family == "d4pg" else {}
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     device="cpu", fused_update=True, **over)
    state = init_train_state(cfg, OBS, ACT, cfg.seed)
    packed = torch.from_numpy(_batches(6))
    run = make_scan_chunk_fn(cfg, OBS, ACT, 2.0, 0.0, chunk_size=K)
    launches = fc.KERNEL_LAUNCHES["fused_update"]
    on_card = train_state_from_numpy(train_state_to_numpy(state), "cuda")
    new, td, met = run(on_card, packed.cuda(), None, step0=0)
    ref, rtd, rmet = run(state, packed, None, step0=0)
    torch.cuda.synchronize()
    assert fc.KERNEL_LAUNCHES["fused_update"] == launches + 2 * K
    _close(fc.flatten_state(new).cpu(), fc.flatten_state(ref))
    _close(td.cpu(), rtd)
    for name in METRIC_KEYS:
        _close(float(met[name]), float(rmet[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ddpg", "d4pg"])
def test_per_chunk_on_card_matches_cpu(family):
    """One prioritized chunk (run_sample_chunk_per, the kernel route) on the
    card against the same chunk on the CPU: the draw on dyadic priorities
    (exact sums, so the same indices on both), then the chunk on those
    idx and weights; the state, td, the priority vector and max_priority
    within RTOL and ATOL, a slot drawn twice at its last draw's value, and
    the replay's rows untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import (
        DevicePrioritizedReplay,
        draw_per_indices,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    over = dict(distributional=True, num_atoms=21, v_min=-5.0, v_max=5.0) \
        if family == "d4pg" else {}
    cap, fill = 512, 384
    rng = np.random.default_rng(6)
    rows = _batches(7).reshape(K * B, -1)
    rows = np.concatenate([rows] * (fill // len(rows)))
    rows[:, -1] = 1.0
    prios = np.zeros(cap, np.float32)
    prios[:fill] = rng.integers(1, 33, fill) / 8.0
    uniform = torch.from_numpy(rng.uniform(0, 1, (K, B)).astype(np.float32))
    runs = {}
    for device in ("cuda", "cpu"):
        cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                         device=device, prioritized=True, fused_chunk="on", **over)
        state = init_train_state(cfg, OBS, ACT, cfg.seed, "cpu")
        state = train_state_from_numpy(train_state_to_numpy(state), device)
        learner = ShardedLearner(cfg, OBS, ACT, 2.0, 0.0, chunk_size=K, state=state)
        rep = DevicePrioritizedReplay(cap, OBS, ACT, device, block_size=64)
        rep.add_packed(rows)
        rep.set_per_state(torch.from_numpy(prios.copy()).to(device),
                          torch.tensor(4.0, device=device))
        idx, w = draw_per_indices(rep.priorities, fill, (K, B), 0.5,
                                  uniform=uniform.to(device))
        out = learner.run_sample_chunk_per(rep, 0.5, idx=idx, weights=w)
        runs[device] = (idx.cpu(), w.cpu(), fc.flatten_state(learner.state).cpu(),
                        out.td_errors.cpu(), rep.priorities.cpu(), float(rep.max_priority),
                        rep.storage.cpu())
    (gi, gw, gs, gtd, gp, gm, gst), (ri, rw, rs, rtd, rp, rm, rst) = runs["cuda"], runs["cpu"]
    assert torch.equal(gi, ri)
    _close(gw, rw)
    _close(gs, rs)
    _close(gtd, rtd)
    _close(gp, rp)
    _close(gm, rm)
    assert torch.equal(gst, rst) and torch.equal(gst[:fill, -1], torch.ones(fill))
    new_p = (gtd.abs() + 1e-6) ** 0.6
    flat = gi.reshape(-1).tolist()
    last = {i: float(v) for i, v in zip(flat, new_p.reshape(-1))}
    for slot, v in last.items():
        if flat.count(slot) > 1:
            _close(gp[slot], v)
