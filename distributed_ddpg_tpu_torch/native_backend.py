"""`--backend native`: the pure-numpy learner on the CPU.

A copy of distributed_ddpg_tpu/native_backend.py (numpy, no framework).
It is the CPU baseline that a user asks for by name (`--backend=native`,
train.train_native), never a fallback for a missing card, and a third
oracle: the same MLP shapes, loss formulas, Adam (ops/optim.py's
constants, B1, B2 and EPS) and Polyak lerp as the port's eager step, with hand-derived
numpy backprop, so agreement is an independent check. Equivalence is
tolerance-bounded (f32 sums in another order).

Its surface is the reference's: plain DDPG (uniform or PER batches, the
n-step discounts folded upstream). The distributional (D4PG) and twin
(TD3) critics raise here, and the config refuses SAC, TD3 and bf16 under
this backend with the JAX package's messages.

The state comes in with numpy leaves: the port's init_train_state(...,
device="cpu") through learner.train_state_to_numpy (the JAX module maps
its TrainState with jax.tree.map), or the JAX package's state as numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from distributed_ddpg_tpu_torch.config import DDPGConfig

# Adam's constants, those of ops/optim.py (which imports torch; this
# module imports none).
B1, B2, EPS = 0.9, 0.999, 1e-8


def _layers(tree) -> list:
    """A params tree as a list of {"w", "b"} f32 numpy dicts (copies)."""
    return [{k: np.array(layer[k], np.float32) for k in ("w", "b")} for layer in tree]


class NativeLearner:
    """Numpy mirror of learner.make_learner_step for non-distributional DDPG."""

    def __init__(self, config: DDPGConfig, state, action_scale, action_offset=0.0):
        if config.distributional or config.twin_critic:
            raise NotImplementedError(
                "--backend native implements the reference's plain-DDPG surface; "
                "the distributional (D4PG) and twin (TD3) critics are "
                "jax_tpu-only"
            )
        self.config = config
        self.scale = np.asarray(action_scale, np.float32)
        self.offset = np.asarray(action_offset, np.float32)
        s = state
        self.actor = _layers(s.actor_params)
        self.critic = _layers(s.critic_params)
        self.target_actor = _layers(s.target_actor_params)
        self.target_critic = _layers(s.target_critic_params)
        self.actor_opt = {
            "mu": _layers(s.actor_opt.mu),
            "nu": _layers(s.actor_opt.nu),
            "count": int(np.asarray(s.actor_opt.count)),
        }
        self.critic_opt = {
            "mu": _layers(s.critic_opt.mu),
            "nu": _layers(s.critic_opt.nu),
            "count": int(np.asarray(s.critic_opt.count)),
        }
        self.step_count = int(np.asarray(s.step))

    # ---- forward passes (mirror models/mlp.py) ----

    def actor_forward(self, obs) -> Tuple[np.ndarray, list]:
        x = obs
        cache = []
        for layer in self.actor[:-1]:
            z = x @ layer["w"] + layer["b"]
            cache.append((x, z))
            x = np.maximum(z, 0.0)
        z = x @ self.actor[-1]["w"] + self.actor[-1]["b"]
        cache.append((x, z))
        t = np.tanh(z)
        return t * self.scale + self.offset, cache + [t]

    def _critic_forward(self, params, obs, action) -> Tuple[np.ndarray, list]:
        ail = self.config.action_insert_layer
        x = obs
        cache = []
        n = len(params)
        for i, layer in enumerate(params):
            if i == ail:
                x = np.concatenate([x, action], axis=-1)
            z = x @ layer["w"] + layer["b"]
            cache.append((x, z))
            x = np.maximum(z, 0.0) if i < n - 1 else z
        return x[:, 0], cache

    def _critic_backward(self, params, cache, dq) -> Tuple[list, np.ndarray]:
        """Backprop dL/dq -> (param grads, dL/d_action)."""
        ail = self.config.action_insert_layer
        act_dim = self.actor[-1]["w"].shape[1]
        n = len(params)
        grads = [None] * n
        dx = dq[:, None]  # d wrt pre-activation of last layer (linear output)
        d_action = None
        for i in range(n - 1, -1, -1):
            x, z = cache[i]
            if i < n - 1:
                dz = dx * (z > 0.0)
            else:
                dz = dx
            grads[i] = {
                "w": x.T @ dz,
                "b": dz.sum(axis=0),
            }
            dx = dz @ params[i]["w"].T
            if i == ail:
                d_action = dx[:, -act_dim:]
                dx = dx[:, :-act_dim]
        return grads, d_action

    def _actor_backward(self, cache, d_action) -> list:
        """Backprop dL/d_mu(s) through tanh*scale+offset and the MLP."""
        t = cache[-1]
        layer_caches = cache[:-1]
        n = len(self.actor)
        grads = [None] * n
        dz = d_action * self.scale * (1.0 - t * t)  # through tanh & scale
        for i in range(n - 1, -1, -1):
            x, z = layer_caches[i]
            if i < n - 1:
                dz = dz * (z > 0.0)
            grads[i] = {"w": x.T @ dz, "b": dz.sum(axis=0)}
            if i > 0:
                dz = dz @ self.actor[i]["w"].T
        return grads

    # ---- Adam + Polyak (mirror ops/optim.py, ops/polyak.py) ----

    def _adam(self, params, grads, opt, lr):
        opt["count"] += 1
        c = float(opt["count"])
        bc1 = 1.0 - B1**c
        bc2 = 1.0 - B2**c
        for p, g, m, v in zip(params, grads, opt["mu"], opt["nu"]):
            for k in ("w", "b"):
                m[k] = B1 * m[k] + (1.0 - B1) * g[k]
                v[k] = B2 * v[k] + (1.0 - B2) * g[k] * g[k]
                p[k] = p[k] - lr * (m[k] / bc1) / (np.sqrt(v[k] / bc2) + EPS)

    def _polyak(self, online, target, tau):
        for o, t in zip(online, target):
            for k in ("w", "b"):
                t[k] = tau * o[k] + (1.0 - tau) * t[k]

    # ---- the step (mirror learner.make_learner_step) ----

    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        cfg = self.config
        obs = batch["obs"]
        action = batch["action"]
        reward = batch["reward"]
        discount = batch["discount"]
        next_obs = batch["next_obs"]
        weight = batch.get("weight", np.ones_like(reward))
        bsz = obs.shape[0]

        # critic TD loss
        next_action, _ = self._target_actor_forward(next_obs)
        next_q, _ = self._critic_forward(self.target_critic, next_obs, next_action)
        y = reward + discount * next_q
        q, ccache = self._critic_forward(self.critic, obs, action)
        td = y - q
        closs = float(np.mean(weight * td * td))
        dq = -2.0 * weight * td / bsz
        cgrads, _ = self._critic_backward(self.critic, ccache, dq)
        if cfg.critic_l2 > 0.0:
            closs += cfg.critic_l2 * sum(float(np.sum(l["w"] ** 2)) for l in self.critic)
            for g, p in zip(cgrads, self.critic):
                g["w"] = g["w"] + 2.0 * cfg.critic_l2 * p["w"]

        # actor DPG loss (pre-update critic, matching learner.py)
        mu, acache = self.actor_forward(obs)
        q_pi, pcache = self._critic_forward(self.critic, obs, mu)
        aloss = -float(np.mean(q_pi))
        dq_pi = np.full(bsz, -1.0 / bsz, np.float32)
        _, d_action = self._critic_backward(self.critic, pcache, dq_pi)
        agrads = self._actor_backward(acache, d_action)

        self._adam(self.critic, cgrads, self.critic_opt, cfg.critic_lr)
        self._adam(self.actor, agrads, self.actor_opt, cfg.actor_lr)
        self._polyak(self.actor, self.target_actor, cfg.tau)
        self._polyak(self.critic, self.target_critic, cfg.tau)
        self.step_count += 1

        return {
            "critic_loss": closs,
            "actor_loss": aloss,
            "mean_q": -aloss,
            "td_abs_mean": float(np.mean(np.abs(td))),
            "td_errors": td,
        }

    def _target_actor_forward(self, obs):
        x = obs
        for layer in self.target_actor[:-1]:
            x = np.maximum(x @ layer["w"] + layer["b"], 0.0)
        z = x @ self.target_actor[-1]["w"] + self.target_actor[-1]["b"]
        return np.tanh(z) * self.scale + self.offset, None

    def act(self, obs: np.ndarray) -> np.ndarray:
        out, _ = self.actor_forward(np.atleast_2d(obs))
        return out

    def params_close_to(self, state, rtol=1e-4, atol=1e-5) -> bool:
        """Tolerance-bounded comparison against a TrainState with numpy
        leaves (learner.train_state_to_numpy, or the JAX package's)."""
        mine = (self.actor, self.critic, self.target_actor, self.target_critic)
        theirs = tuple(_layers(t) for t in (
            state.actor_params,
            state.critic_params,
            state.target_actor_params,
            state.target_critic_params,
        ))
        for m_net, t_net in zip(mine, theirs):
            for m_l, t_l in zip(m_net, t_net):
                for k in ("w", "b"):
                    if not np.allclose(m_l[k], t_l[k], rtol=rtol, atol=atol):
                        return False
        return True
