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

Prioritized replay: a PER chunk a family (DDPG, D4PG) on the card against
the CPU; the draw bit-identical twice at capacity 1M on priorities that
are not dyadic (its prefix sum has a fixed order). Data parallelism: two
ranks over gloo on the one card (tests/torch_mesh_child.py; the mesh
launch and the scan route's PER chunk) end with bit-identical replicas.
Checkpoint and resume: a TD3 kernel-route state and its PER replay saved
and restored on the card bit for bit, and the next chunk the same bits.
Ingest: rows inserted while a K = 800 chunk runs, on the main path's
pipeline and inline from the pinned pool with the PER stamp, make no
synchronizing call (torch's sync debug mode, "error") and leave the chunk
running. Environments: K1 (a) on terminal rows (discount 0) at
MountainCar's shapes (obs 2, act 1). The host replay: chunks through the
prefetcher (depth 1 and 2), put_chunk and run_chunk_async bit for bit
what run_chunk gives on the same draws. Lockstep mode: two strict-sync
runs through train() on the kernel route and on the scan route with K2,
the same records but for their wall-clock fields. Guardrails: the guarded scan chunk
with K2 bit for bit the unguarded one on healthy rows, an injected NaN
step and loss spike skipped exactly (bit for bit the chunk with those
updates left out), the row screen of more than 32 bad rows as on the CPU.
"""

import time

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


@pytest.mark.cuda
def test_per_draw_is_bit_identical_twice_on_card():
    """The PER draw's prefix sum has a fixed order on the card
    (replay/device.fixed_order_cumsum): at the main path's capacity (1M)
    on priorities that are not dyadic, two draws with the same uniforms
    give the same indices and weights bit for bit, and the prefix sum
    itself is the same twice (torch's 1-D CUDA cumsum is not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the draw's fixed order is a property of the card")
    from distributed_ddpg_tpu_torch.replay.device import draw_per_indices, fixed_order_cumsum

    cap = 1_000_000
    rng = np.random.default_rng(31)
    p = (np.abs(5.0 * rng.standard_normal(cap)) + 1e-6) ** 0.6
    prios = torch.from_numpy(p.astype(np.float32)).cuda()
    uniform = torch.from_numpy(rng.uniform(0, 1, (800, 64)).astype(np.float32)).cuda()
    draws = [draw_per_indices(prios, cap, (800, 64), 0.4, uniform=uniform) for _ in range(2)]
    cums = [fixed_order_cumsum(prios) for _ in range(2)]
    assert torch.equal(draws[0][0], draws[1][0])
    assert torch.equal(draws[0][1].view(torch.int32), draws[1][1].view(torch.int32))
    assert torch.equal(cums[0].view(torch.int32), cums[1].view(torch.int32))
    want = torch.cumsum(prios.double().cpu(), 0)
    assert float((cums[0].double().cpu() - want).abs().max()) < 1e-6 * float(want[-1])


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_keep_the_replicas_identical(tmp_path):
    """Two ranks over gloo on the one card: two chunks of the mesh launch
    (DDPG, the chunk kernel on each rank's own draws, the state averaged)
    and two PER chunks on the scan route (the global draw, the gradient
    all-reduce, the td gathered): both ranks' states, and PER's priority
    vectors and max priority, bit-identical, and the td the same global
    [K, 2B] on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks run the CUDA kernel")
    from torch_mesh_child import run_ranks

    rows = _batches(9).reshape(K * B, -1)
    rows = np.concatenate([rows] * 8)
    for per in (False, True):
        spec = dict(kind="chunk", device="cuda", obs=OBS, act=ACT, k=K, scale=2.0,
                    offset=0.0, capacity=512, block=64, per=per, beta=0.5, chunks=2,
                    config=dict(actor_hidden=list(HIDDEN), critic_hidden=list(HIDDEN),
                                batch_size=B, seed=3, prioritized=per))
        results = run_ranks(tmp_path, spec, dict(rows=rows), name=f"per{int(per)}")
        for res in results:
            assert bool(res["replicas"]) and res["td"].shape == (K, 2 * B)
            assert str(res["route"]) == ("scan" if per else "mesh")
            assert np.isfinite(res["metrics"]).all()
        np.testing.assert_array_equal(results[0]["td"], results[1]["td"])


@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_kernel_state_on_card(tmp_path):
    """A TD3 learner on the kernel route (delay 2, smoothing noise drawn
    on the card) and its PER replay, one chunk in, saved and restored into
    a fresh learner and replay on the card: the state, the priorities and
    max_priority bit for bit, the host step resynced, and the next chunk
    on the same indices the same bits as the uninterrupted learner's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from distributed_ddpg_tpu_torch import checkpoint as ckpt
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner, state_tensors
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     device="cuda", prioritized=True, fused_chunk="on",
                     **BRANCHES["td3-delay2-noise"])
    rows = _batches(11).reshape(K * B, -1)
    rows = np.concatenate([rows] * 12)
    rows[:, -1] = 1.0

    def build():
        return (ShardedLearner(cfg, OBS, ACT, 2.0, 0.0, chunk_size=K),
                DevicePrioritizedReplay(512, OBS, ACT, "cuda", block_size=64))

    learner, rep = build()
    rep.add_packed(rows)
    learner.run_sample_chunk_per(rep, 0.5)
    ckpt.save(str(tmp_path), int(learner.state.step), learner.state, rep, cfg)
    saved = [t.clone() for t in state_tensors(learner.state) + [rep.priorities,
                                                                 rep.max_priority]]
    idx = torch.from_numpy(np.random.default_rng(12).integers(0, len(rows), (K, B)))
    weights = torch.full((K, B), 0.75)
    out = learner.run_sample_chunk_per(rep, 0.5, idx=idx, weights=weights)
    want = state_tensors(learner.state) + [out.td_errors, rep.priorities, rep.max_priority]

    fresh, frep = build()
    state, step, _ = ckpt.restore(str(tmp_path), fresh.state, frep, config=cfg)
    fresh.load_state(state)
    assert step == fresh._step == K
    restored = state_tensors(fresh.state) + [frep.priorities, frep.max_priority]
    assert all(t.is_cuda for t in restored)
    for a, b in zip(restored, saved):
        assert torch.equal(a, b)
    out = fresh.run_sample_chunk_per(frep, 0.5, idx=idx, weights=weights)
    got = state_tensors(fresh.state) + [out.td_errors, frep.priorities, frep.max_priority]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["scheduler", "inline-per"])
def test_add_packed_makes_no_synchronizing_call_while_a_chunk_runs(pipeline):
    """Rows inserted while a K = 800 DDPG chunk (2x256, batch 64, ~70 ms)
    runs, with torch's sync debug mode at "error" (any synchronizing call
    raises): on the main path's pipeline (add_packed stages, the
    scheduler's thread ships from the pinned pool), and shipped inline
    from the pinned pool with the PER stamp (the D > 1 ranks'). Every
    add_packed returns while the chunk still runs, no ship failed, and
    the rows landed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.replay.device import DevicePrioritizedReplay, DeviceReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    learner = ShardedLearner(DDPGConfig(), OBS, ACT, 2.0, 0.0, chunk_size=800)
    rng = np.random.default_rng(21)
    width = 2 * OBS + ACT + 3
    big = DeviceReplay(8192, OBS, ACT, "cuda", block_size=1024)
    big.add_packed(rng.standard_normal((8192, width)).astype(np.float32))
    rows = rng.standard_normal((4096, width)).astype(np.float32)
    sched = TransferScheduler().start()
    try:
        if pipeline == "scheduler":
            rep = DeviceReplay(16384, OBS, ACT, "cuda", block_size=1024, async_ship=True,
                               scheduler=sched, adaptive_coalesce=True, host_pool=True)
            pieces = np.split(rows, 4)
        else:
            rep = DevicePrioritizedReplay(16384, OBS, ACT, "cuda", block_size=1024,
                                          host_pool=True)
            pieces = [rows]
        for piece in pieces:   # warm: the pool's first buffers are allocated
            rep.add_packed(piece)
        rep.drain_pending()
        learner.run_sample_chunk(big)
        torch.cuda.synchronize()
        learner.run_sample_chunk(big)   # the running chunk
        torch.cuda.set_sync_debug_mode("error")
        try:
            for piece in pieces:
                rep.add_packed(piece)
            running = not learner.chunk_done()
            while rep.pending_rows:
                time.sleep(0.0002)
            with rep.dispatch_lock:
                pass
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert running
        rep.drain_pending()
        assert rep.ingest_snapshot()["ingest_shipper_restarts"] == 0
        assert rep.size == 2 * len(rows)
        assert torch.equal(rep.storage[len(rows):2 * len(rows)].cpu(), torch.from_numpy(rows))
        rep.close()
    finally:
        sched.close()


@pytest.mark.cuda
def test_kernel_on_terminal_rows_at_mountain_car_shapes_on_card():
    """K1 (a) on rows a quarter of which are terminal (discount 0, reward
    100) at MountainCarContinuous-v0's shapes (obs 2, act 1, action scale
    1): the kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    obs, act = 2, 1
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     device="cuda")
    rng = np.random.default_rng(8)
    done = rng.random((K, B)) < 0.25
    done[0, 0] = True
    packed = torch.from_numpy(pack_batch_np({
        "obs": rng.uniform(-1.2, 0.6, (K, B, obs)).astype(np.float32),
        "action": rng.uniform(-1, 1, (K, B, act)).astype(np.float32),
        "reward": np.where(done, 100.0, -0.1).astype(np.float32),
        "discount": np.where(done, 0.0, 0.99).astype(np.float32),
        "next_obs": rng.uniform(-1.2, 0.6, (K, B, obs)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.0, (K, B)).astype(np.float32),
    })).cuda()
    state = init_train_state(cfg, obs, act, cfg.seed, "cuda")
    run = fc.make_fused_chunk_fn(cfg, obs, act, 1.0, 0.0, chunk_size=K, device="cuda")
    new, td, met = run(state, packed, None)
    ref, rtd, rmet = fc.fused_chunk_reference(cfg, state, packed, 1.0, 0.0, None)
    torch.cuda.synchronize()
    _close(fc.flatten_state(new).cpu(), fc.flatten_state(ref).cpu())
    _close(td.cpu(), rtd.cpu())
    for name in METRIC_KEYS:
        _close(float(met[name]), float(rmet[name]))


GUARD_K = 16


@pytest.mark.cuda
def test_guarded_chunk_on_card():
    """The guarded scan chunk with K2 on the card: on healthy rows bit for
    bit the unguarded chunk; with numeric:grad:nan@3 and
    numeric:loss:spike@9 (warmup 4) exactly those steps skipped, bit for
    bit the chunk with those updates left out; and more than 32
    non-finite rows screened as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from distributed_ddpg_tpu_torch import guardrails as gl
    from distributed_ddpg_tpu_torch.learner import make_learner_step
    from distributed_ddpg_tpu_torch.parallel.learner import state_tensors
    from distributed_ddpg_tpu_torch.types import unpack_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3,
                     device="cuda", fused_update=True, fused_chunk="off", guardrails=True,
                     guardrail_warmup_steps=4, guardrail_zmax=50.0)
    plain_cfg = cfg.replace(guardrails=False)
    state = init_train_state(plain_cfg, OBS, ACT, cfg.seed, "cuda")
    rng = np.random.default_rng(9)
    packed = torch.from_numpy(pack_batch_np({
        "obs": rng.standard_normal((GUARD_K, B, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, (GUARD_K, B, ACT)).astype(np.float32),
        "reward": rng.standard_normal((GUARD_K, B)).astype(np.float32),
        "discount": np.full((GUARD_K, B), 0.99, np.float32),
        "next_obs": rng.standard_normal((GUARD_K, B, OBS)).astype(np.float32),
    })).cuda()
    pre_bad = torch.zeros(GUARD_K, dtype=torch.bool, device="cuda")

    def outputs(s, td, met):
        return state_tensors(s) + [td] + [met[k] for k in METRIC_KEYS]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    plain = make_scan_chunk_fn(plain_cfg, OBS, ACT, 2.0, 0.0, chunk_size=GUARD_K)
    launches = fc.KERNEL_LAUNCHES["fused_update"]
    guarded = make_scan_chunk_fn(cfg, OBS, ACT, 2.0, 0.0, chunk_size=GUARD_K, guard=True)
    new, g, td, met = guarded.guarded(state, gl.init_guard_state(device="cuda"), packed,
                                      None, STEP0, pre_bad)
    assert fc.KERNEL_LAUNCHES["fused_update"] == launches + 2 * GUARD_K
    assert same(outputs(new, td, met), outputs(*plain(state, packed, None, STEP0)))
    assert gl.health_vector(g).tolist() == [GUARD_K, 0, 0, 0, 0]

    inject = {"grad": (3,), "loss": (9,)}
    injected = make_scan_chunk_fn(cfg, OBS, ACT, 2.0, 0.0, chunk_size=GUARD_K, guard=True,
                                  inject=inject)
    new, g, td, met = injected.guarded(state, gl.init_guard_state(device="cuda"), packed,
                                       None, STEP0, pre_bad)
    assert gl.health_vector(g).tolist() == [GUARD_K, 1, 1, 2, 0]
    step = make_learner_step(plain_cfg, 2.0, 0.0)
    s, tds, ms = state, [], []
    for k in range(GUARD_K):
        out = step(s, unpack_batch(packed[k], OBS, ACT), None, step_index=STEP0 + k)
        left_out = k + 1 in (3, 9)
        s = s._replace(step=out.state.step) if left_out else out.state
        tds.append(torch.zeros_like(out.td_errors) if left_out else out.td_errors)
        ms.extend(torch.zeros_like(out.metrics[n]) if left_out else out.metrics[n]
                  for n in METRIC_KEYS)
    means = torch.stack(ms).view(GUARD_K, len(METRIC_KEYS)).mean(dim=0)
    assert same(outputs(new, td, met),
                outputs(s, torch.stack(tds), dict(zip(METRIC_KEYS, means.unbind()))))

    bad = packed.clone()
    ks, bs = np.nonzero(rng.random((GUARD_K, B)) < 0.4)
    bad[torch.from_numpy(ks), torch.from_numpy(bs), 0] = float("inf")
    assert len(ks) > gl.GUARD_BAD_IDX
    idx = torch.from_numpy(rng.integers(0, 1_000_000, (GUARD_K, B))).cuda()
    assert ([x.cpu().tolist() for x in gl.batch_row_health(bad, idx)]
            == [x.tolist() for x in gl.batch_row_health(bad.cpu(), idx.cpu())])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_prefetched_chunk_on_card_matches_run_chunk(depth):
    """The host replay's chunks on the card: chunks drawn by a
    ChunkPrefetcher (its puts on the transfer scheduler's prefetch class)
    from a PER replay, put on the card by put_chunk (pinned buffer,
    side-stream copy) and dispatched with run_chunk_async without waiting,
    against the same draws through run_chunk one at a time, on the kernel
    route (DDPG): the indices, every td and the end state bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the copy stream and the kernel are the card's")
    from distributed_ddpg_tpu_torch.parallel.learner import ShardedLearner
    from distributed_ddpg_tpu_torch.parallel.prefetch import ChunkPrefetcher
    from distributed_ddpg_tpu_torch.replay import PrioritizedReplay
    from distributed_ddpg_tpu_torch.transfer import TransferScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    k = 64
    cfg = DDPGConfig(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3)
    state = train_state_to_numpy(init_train_state(cfg, OBS, ACT, cfg.seed, "cpu"))

    def replay():
        rng = np.random.default_rng(4)
        rep = PrioritizedReplay(4096, OBS, ACT, seed=2)
        rep.add_batch(rng.standard_normal((3000, OBS)).astype(np.float32),
                      rng.uniform(-1, 1, (3000, ACT)).astype(np.float32),
                      rng.standard_normal(3000).astype(np.float32),
                      np.full(3000, 0.99, np.float32),
                      rng.standard_normal((3000, OBS)).astype(np.float32))
        rep.update_priorities(np.arange(0, 3000, 2), rng.uniform(0, 5, 1500))
        return rep

    a, b = (ShardedLearner(cfg, OBS, ACT, 2.0, 0.0, chunk_size=k,
                           state=train_state_from_numpy(state, "cuda")) for _ in range(2))
    assert a.fused_chunk_active
    sched = TransferScheduler().start()
    prefetch = ChunkPrefetcher(replay(), a.put_chunk, B, k, depth=depth,
                               scheduler=sched).start()
    got = []
    try:
        for _ in range(4):
            device_chunk, idx = prefetch.next(timeout=60.0)
            got.append((a.run_chunk_async(device_chunk).td_errors, idx))
    finally:
        prefetch.stop()
        sched.close()
    rb = replay()
    for td, idx in got:
        draws = [rb.sample(B) for _ in range(k)]
        chunk = {f: np.stack([d[f] for d in draws]) for f in draws[0]}
        np.testing.assert_array_equal(chunk.pop("indices"), idx)
        assert torch.equal(b.run_chunk(chunk).td_errors, td)
    assert torch.equal(fc.flatten_state(a.state), fc.flatten_state(b.state))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "scan"])
def test_strict_sync_pair_on_card_is_bit_identical(tmp_path, route):
    """Two --strict_sync runs of one tiny config through train() on the
    card (inline actors: no process is started), on the kernel route and
    on the scan route with the fused update: the same records once the
    wall-clock fields (tests/test_strict_sync.py's, env_steps_per_sec and
    every t_* field) are stripped."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lockstep contract is tested on the card")
    import json

    from distributed_ddpg_tpu_torch.train import train

    wall = ("wall_time", "learner_steps_per_sec", "actor_steps_per_sec",
            "ingest_rows_per_sec", "ingest_stall_ms", "ingest_ship_ms", "env_steps_per_sec")
    records = []
    for run in range(2):
        log = tmp_path / f"{route}{run}.jsonl"
        cfg = DDPGConfig(strict_sync=True, max_learn_ratio=1.0, max_ingest_ratio=1.0,
                         num_actors=2, actor_hidden=(16, 16), critic_hidden=(16, 16),
                         n_step=2, batch_size=32, replay_min_size=192, total_env_steps=1000,
                         learner_chunk=8, eval_every=400, eval_episodes=1,
                         fused_update=route == "scan", log_path=str(log))
        summary = train(cfg, echo=False)
        assert summary["fused_chunk_active"] is (route == "kernel")
        records.append([{k: v for k, v in json.loads(line).items()
                         if k not in wall and not k.startswith("t_")}
                        for line in log.read_text().splitlines()])
    assert records[0] == records[1]
    assert any(r["kind"] == "train" for r in records[0])
