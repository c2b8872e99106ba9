"""The port's learner chunk (distributed_ddpg_tpu_torch/ops/fused_chunk.py)
against the JAX package's Pallas megakernel, on the CPU at a small size.

- fused_chunk_reference (the plain version the wrapper runs on the CPU)
  against JAX make_fused_chunk_fn(..., interpret=True), from one JAX-made
  TrainState carried across: end state, td, the 6 metrics and the counts.
- The kernel's task program (what csrc/fused_chunk.cu executes), run by a
  small numpy interpreter of the same table, against the plain version:
  this is how the CPU checks the offsets, strides, epilogues and stage
  order the CUDA kernel reads, since the kernel itself runs only on a card.

The kernel itself against the plain version is tests/test_torch_on_card.py
(marker `cuda`), which imports no JAX so that it runs on the card's machine.

Tolerances: rtol 2e-5, atol 1e-6, as tests/test_fused_chunk.py:60 uses for
the JAX kernel against its scan path; the chunk-mean metrics 5e-5 (their
sums run in another order, as there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_ddpg_tpu.config import DDPGConfig as JaxConfig
from distributed_ddpg_tpu.learner import init_train_state as jax_init
from distributed_ddpg_tpu.ops import fused_chunk as jax_fused_chunk
from distributed_ddpg_tpu_torch.config import DDPGConfig
from distributed_ddpg_tpu_torch.learner import METRIC_KEYS, train_state_from_numpy
from distributed_ddpg_tpu_torch.ops import fused_chunk as fc
from distributed_ddpg_tpu_torch.ops.optim import B1, B2, EPS
from distributed_ddpg_tpu_torch.types import pack_batch_np

OBS, ACT, B, K = 3, 1, 8, 4
HIDDEN = (32, 32)
RTOL, ATOL, METRIC_RTOL = 2e-5, 1e-6, 5e-5


def _batches(seed, k=K, b=B, obs=OBS, act=ACT):
    rng = np.random.default_rng(seed)
    return pack_batch_np(
        {
            "obs": rng.standard_normal((k, b, obs)).astype(np.float32),
            "action": rng.uniform(-1, 1, (k, b, act)).astype(np.float32),
            "reward": rng.standard_normal((k, b)).astype(np.float32),
            "discount": np.full((k, b), 0.99, np.float32),
            "next_obs": rng.standard_normal((k, b, obs)).astype(np.float32),
            "weight": rng.uniform(0.5, 1.0, (k, b)).astype(np.float32),
        }
    )


def _configs(device="cpu"):
    common = dict(actor_hidden=HIDDEN, critic_hidden=HIDDEN, batch_size=B, seed=3)
    return JaxConfig(**common), DDPGConfig(device=device, **common)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _close_trees(port, ref, rtol=RTOL, atol=ATOL):
    for lp, lr in zip(port, ref):
        for key in ("w", "b"):
            _close(lp[key].detach().cpu().numpy(), lr[key], rtol, atol)


def test_reference_matches_jax_kernel():
    jcfg, cfg = _configs()
    jstate = jax_init(jcfg, OBS, ACT, seed=jcfg.seed)
    packed = _batches(7)
    run_jax = jax_fused_chunk.make_fused_chunk_fn(
        jcfg, OBS, ACT, 2.0, 0.0, chunk_size=K, interpret=True
    )
    jnew, jtd, jmet = jax.jit(run_jax)(jstate, jnp.asarray(packed))
    jnew = jax.tree.map(np.asarray, jnew)

    run = fc.make_fused_chunk_fn(cfg, OBS, ACT, 2.0, 0.0, chunk_size=K, device="cpu")
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    new, td, met = run(state, torch.from_numpy(packed))

    _close_trees(new.actor_params, jnew.actor_params)
    _close_trees(new.critic_params, jnew.critic_params)
    _close_trees(new.target_actor_params, jnew.target_actor_params)
    _close_trees(new.target_critic_params, jnew.target_critic_params)
    _close_trees(new.actor_opt.mu, jnew.actor_opt.mu)
    _close_trees(new.actor_opt.nu, jnew.actor_opt.nu)
    _close_trees(new.critic_opt.mu, jnew.critic_opt.mu)
    _close_trees(new.critic_opt.nu, jnew.critic_opt.nu)
    assert int(new.actor_opt.count) == int(jnew.actor_opt.count) == K
    assert int(new.critic_opt.count) == int(jnew.critic_opt.count) == K
    assert int(new.step) == int(jnew.step) == K
    _close(td.numpy(), np.asarray(jtd))
    for name in METRIC_KEYS:
        _close(float(met[name]), float(jmet[name]), METRIC_RTOL, ATOL)


# --- the kernel's program, interpreted ------------------------------------


def _softmax(x):
    e = np.exp(x - np.max(x, -1, keepdims=True))
    return e, np.sum(e, -1, keepdims=True)


def _interpret_program(cfg, state, packed, scale, offset, eps=None, obs=OBS, act=ACT):
    """Executes fc._plan's task table the way csrc/fused_chunk.cu does
    (same offsets, strides, epilogues, C51's row tasks, stage order, TD3's
    skipped tiles on steps without an actor update, optimizer pass and
    metric reduction), in numpy. Returns (flat state, td, metrics)."""
    k_steps, b, d = packed.shape
    prog = fc._plan(cfg, obs, act)
    na, nc = prog.n_actor, prog.n_critic
    twin, c51 = cfg.twin_critic, cfg.distributional
    delay = cfg.policy_delay if twin else 1
    step0 = int(state.step)
    flat = fc.flatten_state(state).numpy().copy()
    scratch = np.zeros(prog.scratch_size, np.float32)
    if c51:
        support, (v_min, v_max, dz) = fc.support_params(cfg)
    else:
        scratch[prog.scratch["dqpi"]:prog.scratch["dqpi"] + b] = -1.0 / b
    td_out = np.zeros((k_steps, b), np.float32)
    scale = np.broadcast_to(np.float32(scale), (act,))
    offset = np.broadcast_to(np.float32(offset), (act,))
    step_vals = []
    for k in range(k_steps):
        batch = packed[k].reshape(-1)
        x = packed[k]
        rew, disc, wgt = x[:, obs + act], x[:, obs + act + 1], x[:, -1]
        bases = {fc.BASE_STATE: flat, fc.BASE_SCRATCH: scratch, fc.BASE_BATCH: batch}
        step = step0 + k
        upd = step % delay == 0
        tiles = prog.stage_tiles if upd else prog.stage_tiles_skip

        def gather(base, off, s_row, s_col, rows, cols):
            if base == fc.BASE_ONES:
                return np.ones((rows, cols), np.float32)
            idx = off + np.arange(rows)[:, None] * s_row + np.arange(cols)[None, :] * s_col
            return bases[base][idx]

        for s in range(len(prog.stage_tiles)):
            for row in prog.tasks[prog.stage_start[s]:prog.stage_start[s + 1]]:
                if row[fc.F_TILE0] >= tiles[s]:
                    continue      # the kernel's tile loop stops before this task
                M, N = int(row[fc.F_M]), int(row[fc.F_N])
                if row[fc.F_OP] == fc.OP_ROWS:
                    _interpret_rows(row, bases, support, v_min, v_max, dz, rew, disc,
                                    wgt, td_out[k], b)
                    continue
                z = np.zeros((M, N), np.float32)
                for g in range(int(row[fc.F_NSEG])):
                    ab, ao, asm, asj, bb, bo, bsj, bsn, J = (int(v) for v in row[fc.F_SEG + 9 * g:fc.F_SEG + 9 * g + 9])
                    z += gather(ab, ao, asm, asj, M, J) @ gather(bb, bo, bsj, bsn, J, N)
                if row[fc.F_BIAS] >= 0:
                    z = z + gather(int(row[fc.F_BIAS]), int(row[fc.F_BIAS + 1]), 0, 1, 1, N)
                epi = int(row[fc.F_EPI])
                aux_b, aux_o, aux_sm = (int(v) for v in row[fc.F_AUX:fc.F_AUX + 3])
                a2b, a2o = int(row[fc.F_AUX2]), int(row[fc.F_AUX2 + 1])
                out = z
                if epi == fc.EPI_RELU:
                    out = np.maximum(z, 0.0)
                elif epi in (fc.EPI_TANH, fc.EPI_TANH_NOISE):
                    t = np.tanh(z)
                    bases[aux_b][aux_o + np.arange(M)[:, None] * aux_sm + np.arange(N)] = t
                    out = t * scale + offset
                    if epi == fc.EPI_TANH_NOISE:
                        out = np.minimum(np.maximum(out + eps[k], offset - scale), offset + scale)
                elif epi == fc.EPI_TD:
                    q = bases[aux_b][aux_o:aux_o + M]
                    td = (rew + disc * z[:, 0]) - q
                    td_out[k] = td
                    bases[a2b][a2o:a2o + M] = (np.float32(-2.0 / b) * wgt) * td
                elif epi == fc.EPI_TD3:
                    q = [bases[aux_b][aux_o + i * aux_sm:aux_o + i * aux_sm + M] for i in range(4)]
                    y = rew + disc * np.minimum(q[0], q[1])
                    td0, td1 = y - q[2], y - q[3]
                    for i, v in enumerate(((np.float32(-1.0 / b) * wgt) * td0,
                                           (np.float32(-1.0 / b) * wgt) * td1, td0, td1)):
                        bases[a2b][a2o + i * aux_sm:a2o + i * aux_sm + M] = v
                    td_out[k] = 0.5 * (td0 + td1)
                elif epi == fc.EPI_MASK:
                    h = gather(aux_b, aux_o, aux_sm, 1, M, N)
                    out = z * (h > 0)
                elif epi == fc.EPI_TANH_BWD:
                    t = gather(aux_b, aux_o, aux_sm, 1, M, N)
                    out = (z * scale) * (1.0 - t * t)
                if row[fc.F_C] >= 0:
                    cb, co, csm, csn = (int(v) for v in row[fc.F_C:fc.F_C + 4])
                    bases[cb][co + np.arange(M)[:, None] * csm + np.arange(N)[None, :] * csn] = out
        # Optimizer pass: critic, then actor, each net's own count; the
        # actor and every Polyak update only on update steps.
        done_a = -(-step // delay) - -(-step0 // delay)
        sums = []
        for net, n, lr, t_net, (p, t, mu, nu), g in (
            ("c", nc, cfg.critic_lr, int(state.critic_opt.count) + k + 1,
             (na, 2 * na + nc, 4 * na + 2 * nc, 4 * na + 3 * nc), prog.scratch["g_c"]),
            ("a", na, cfg.actor_lr, int(state.actor_opt.count) + done_a + 1,
             (0, na + nc, 2 * (na + nc), 3 * na + 2 * nc), prog.scratch["g_a"]),
        ):
            if net == "a" and not upd:
                sums.append(0.0)
                continue
            tt = np.float32(t_net)
            bc1 = np.float32(1) - np.exp(tt * np.float32(np.log(B1)))
            bc2 = np.float32(1) - np.exp(tt * np.float32(np.log(B2)))
            grad = scratch[g:g + n]
            m = np.float32(B1) * flat[mu:mu + n] + np.float32(1.0 - B1) * grad
            v = np.float32(B2) * flat[nu:nu + n] + np.float32(1.0 - B2) * (grad * grad)
            flat[mu:mu + n], flat[nu:nu + n] = m, v
            flat[p:p + n] = flat[p:p + n] - np.float32(lr) * (m / bc1) / (np.sqrt(v / bc2) + np.float32(EPS))
            if upd:
                flat[t:t + n] = np.float32(cfg.tau) * flat[p:p + n] + np.float32(1.0 - cfg.tau) * flat[t:t + n]
            sums.append(np.sqrt(np.sum(grad * grad)))
        td = td_out[k]
        if c51:
            closs = np.sum(scratch[prog.scratch["c51_wce"]:prog.scratch["c51_wce"] + b]) / b
        elif twin:
            td0 = scratch[prog.scratch["td0"]:prog.scratch["td0"] + b]
            td1 = scratch[prog.scratch["td1"]:prog.scratch["td1"] + b]
            closs = np.sum(wgt * td0 * td0 + wgt * td1 * td1) * 0.5 / b
        else:
            closs = np.sum(wgt * td * td) / b
        q_off = prog.scratch["pi_qexp" if c51 else "pi_q"]   # E[Z] under C51
        q_pi = scratch[q_off:q_off + b]
        aloss = -np.sum(q_pi) / b
        step_vals.append([closs, aloss, -aloss, np.sum(np.abs(td)) / b, sums[0], sums[1]])
    return flat, td_out, np.mean(np.asarray(step_vals, np.float64), axis=0)


def _interpret_rows(row, bases, z, v_min, v_max, dz, rew, disc, wgt, td_k, b):
    """C51's row tasks, as csrc/fused_chunk.cu's run_rows computes them."""
    M, A = int(row[fc.F_M]), int(row[fc.F_N])
    aux_b, aux_o, aux_sm = (int(v) for v in row[fc.F_AUX:fc.F_AUX + 3])
    cb, co, csm, _ = (int(v) for v in row[fc.F_C:fc.F_C + 4])
    a2b, a2o = int(row[fc.F_AUX2]), int(row[fc.F_AUX2 + 1])
    rows = np.arange(M)[:, None] * aux_sm + np.arange(A)
    out_idx = co + np.arange(M)[:, None] * csm + np.arange(A)
    if row[fc.F_EPI] == fc.EPI_C51:
        e_t, s_t = _softmax(bases[aux_b][aux_o + rows])
        p_t = e_t / s_t
        tz = np.minimum(np.maximum(rew[:, None] + disc[:, None] * z, v_min), v_max)
        proj = np.zeros((M, A), np.float32)
        for i in range(A):
            proj = proj + p_t[:, i:i + 1] * np.maximum(
                np.float32(0), np.float32(1) - np.abs(tz[:, i:i + 1] - z) / dz)
        q = bases[aux_b][aux_o + M * aux_sm + rows]
        e, s = _softmax(q)
        logp = q - (np.max(q, -1, keepdims=True) + np.log(s))
        ce = -np.sum(proj * logp, -1)
        td_k[:] = np.sum(proj * z, -1) - np.sum((e / s) * z, -1)
        bases[cb][out_idx] = (e / s - proj) * (wgt * np.float32(1.0 / b))[:, None]
        bases[a2b][a2o:a2o + M] = wgt * ce
    else:                                   # EPI_C51_PI
        e, s = _softmax(bases[aux_b][aux_o + rows])
        p = e / s
        q_exp = np.sum(p * z, -1, keepdims=True)
        bases[cb][out_idx] = (np.float32(-1.0 / b) * p) * (z - q_exp)
        bases[a2b][a2o:a2o + M] = q_exp[:, 0]


def test_kernel_program_matches_reference():
    jcfg, cfg = _configs()
    state = train_state_from_numpy(
        jax.tree.map(np.asarray, jax_init(jcfg, OBS, ACT, seed=jcfg.seed))
    )
    packed = _batches(11)
    flat, td, met = _interpret_program(cfg, state, packed, 2.0, 0.0)
    new, rtd, rmet = fc.fused_chunk_reference(cfg, state, torch.from_numpy(packed), 2.0, 0.0)
    _close(flat, fc.flatten_state(new).numpy())
    _close(td, rtd.numpy())
    _close(met, torch.stack([rmet[k] for k in METRIC_KEYS]).numpy(), METRIC_RTOL, ATOL)


def _assert_stage_dependencies(prog, b, update=True):
    """Every scratch buffer a task reads was written in an EARLIER stage of
    the same step (the kernel's only ordering is the barrier between
    stages), and no two tasks write overlapping scratch ranges. With
    update=False only the tiles a step without an actor update runs."""
    written = {}   # scratch offset -> stage
    tiles = prog.stage_tiles if update else prog.stage_tiles_skip

    def span(base, off, sm, sn, rows, cols):
        if base != fc.BASE_SCRATCH:
            return set()
        return {off + r * sm + c * sn for r in range(rows) for c in range(cols)}

    # DDPG's and TD3's dqpi is a constant the wrapper fills; C51 writes it.
    c51 = any(row[fc.F_EPI] == fc.EPI_C51_PI for row in prog.tasks)
    const = set() if c51 else set(range(prog.scratch["dqpi"], prog.scratch["dqpi"] + b))

    for s in range(len(prog.stage_tiles)):
        tasks = [row for row in prog.tasks[prog.stage_start[s]:prog.stage_start[s + 1]]
                 if row[fc.F_TILE0] < tiles[s]]
        for row in tasks:
            M, N = int(row[fc.F_M]), int(row[fc.F_N])
            aux = (int(row[fc.F_AUX]), int(row[fc.F_AUX + 1]), int(row[fc.F_AUX + 2]))
            reads = set()
            for g in range(int(row[fc.F_NSEG])):
                ab, ao, asm, asj, bb, bo, bsj, bsn, J = (int(v) for v in row[fc.F_SEG + 9 * g:fc.F_SEG + 9 * g + 9])
                reads |= span(ab, ao, asm, asj, M, J) | span(bb, bo, bsj, bsn, J, N)
            if row[fc.F_EPI] in (fc.EPI_MASK, fc.EPI_TANH_BWD):
                reads |= span(*aux, 1, M, N)
            if row[fc.F_EPI] == fc.EPI_TD:
                reads |= span(aux[0], aux[1], 1, 0, M, 1)
            if row[fc.F_EPI] == fc.EPI_TD3:          # the four heads
                reads |= span(aux[0], aux[1], 1, aux[2], M, 4)
            if row[fc.F_EPI] == fc.EPI_C51:          # target, then online head
                reads |= span(aux[0], aux[1], aux[2], 1, 2 * M, N)
            if row[fc.F_EPI] == fc.EPI_C51_PI:       # the actor's head
                reads |= span(aux[0], aux[1], aux[2], 1, M, N)
            for addr in reads - const:
                assert addr in written and written[addr] < s, (s, addr)
        for row in tasks:
            M, N = int(row[fc.F_M]), int(row[fc.F_N])
            aux = (int(row[fc.F_AUX]), int(row[fc.F_AUX + 1]), int(row[fc.F_AUX + 2]))
            out = set()
            if row[fc.F_C] >= 0:
                cb, co, csm, csn = (int(v) for v in row[fc.F_C:fc.F_C + 4])
                out |= span(cb, co, csm, csn, M, N)
            if row[fc.F_EPI] in (fc.EPI_TANH, fc.EPI_TANH_NOISE):   # stores tanh
                out |= span(*aux, 1, M, N)
            if row[fc.F_EPI] == fc.EPI_TD:         # stores the critic's cotangent
                out |= span(int(row[fc.F_AUX2]), int(row[fc.F_AUX2 + 1]), 1, 0, M, 1)
            if row[fc.F_EPI] == fc.EPI_TD3:        # dq0, dq1, td0, td1
                out |= span(int(row[fc.F_AUX2]), int(row[fc.F_AUX2 + 1]), 1, aux[2], M, 4)
            if row[fc.F_OP] == fc.OP_ROWS:         # one value a row: w*ce or E[Z]
                out |= span(int(row[fc.F_AUX2]), int(row[fc.F_AUX2 + 1]), 1, 0, M, 1)
            assert not (out & set(written)), "a scratch range is written twice"
            written.update({x: s for x in out})


def test_program_stages_respect_dependencies():
    _, cfg = _configs()
    _assert_stage_dependencies(fc._plan(cfg, OBS, ACT), B)

