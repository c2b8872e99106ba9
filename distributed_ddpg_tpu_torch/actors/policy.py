"""Pure-numpy actor policy for rollout workers.

A trimmed copy of distributed_ddpg_tpu/actors/policy.py: the deterministic
head and SAC's Gaussian head. Workers run this numpy mirror of the actor
MLP and never import torch, so they are cheap to spawn and never touch
the card.

Params travel learner -> workers as ONE flat f32 array in shared memory
(pool.py); `param_layout`/`flatten_params`/`NumpyPolicy.load_flat` define
the stable layout (layer order, w-then-b, C order) — the same layout as
the JAX package, which the learner's actor_params_to_host publishes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Layout = List[Tuple[Tuple[int, ...], Tuple[int, ...]]]  # [(w_shape, b_shape)]


def actor_head_dim(act_dim: int, sac: bool) -> int:
    """Actor output width: SAC's Gaussian head is [mean | log_std]."""
    return 2 * act_dim if sac else act_dim


def param_layout(obs_dim: int, act_dim: int, hidden: Sequence[int]) -> Layout:
    """`act_dim` here is the HEAD width: pass actor_head_dim(...) for SAC."""
    dims = [obs_dim, *hidden, act_dim]
    return [((dims[i], dims[i + 1]), (dims[i + 1],)) for i in range(len(dims) - 1)]


def layout_size(layout: Layout) -> int:
    return sum(int(np.prod(w)) + int(np.prod(b)) for w, b in layout)


def encode_version(version: int) -> np.float32:
    """Bit-cast an int32 param-version tag into the shm ring's f32 version
    column (a float(version) would lose exactness past 2^24). Every hop
    of the column is a bit-preserving f32 copy."""
    return np.int32(version).view(np.float32)


def decode_version(tag) -> int:
    return int(np.float32(tag).view(np.int32))


def seqlock_snapshot(shared, version, out: np.ndarray, seen_version: int):
    """One seqlock read attempt of the pool's broadcast buffer
    (ActorPool.broadcast writes it: version odd while the flat array is
    mid-write, even when consistent). Copies into `out` and returns the
    new version when a CONSISTENT, not-yet-seen snapshot was read; returns
    None otherwise (nothing new, write in progress, or torn — the caller
    keeps acting on its previous params)."""
    v = version.value
    if v == seen_version or v % 2 == 1:
        return None
    flat = np.frombuffer(shared, dtype=np.float32)
    out[:] = flat[: out.size]
    if version.value != v:
        return None
    return v


def flatten_params(params, out: np.ndarray | None = None) -> np.ndarray:
    """Flatten a (tuple of {'w','b'}) tree into one f32 vector (w then b,
    layer order). Writes into `out` when given (the shared-memory buffer)."""
    chunks = []
    for layer in params:
        chunks.append(np.asarray(layer["w"], np.float32).ravel())
        chunks.append(np.asarray(layer["b"], np.float32).ravel())
    flat = np.concatenate(chunks)
    if out is not None:
        out[: flat.size] = flat
        return out
    return flat


class NumpyPolicy:
    """mu(s) in numpy: relu hiddens, tanh output onto the action box.

    `gaussian=True` is SAC's head (models/mlp.actor_gaussian_apply): the
    final layer is [mean | log_std_raw]; the deterministic mode acts on
    tanh(mean), `stochastic=True` samples the tanh-Gaussian with a numpy
    RNG of its own (workers explore by sampling the policy, no OU noise)."""

    def __init__(self, layout: Layout, action_scale, action_offset=0.0,
                 gaussian: bool = False, stochastic: bool = False,
                 seed: int | None = None, log_std_min: float = -5.0,
                 log_std_max: float = 2.0):
        self.layout = layout
        self.scale = np.asarray(action_scale, np.float32)
        self.offset = np.asarray(action_offset, np.float32)
        self.gaussian = gaussian
        self.stochastic = stochastic
        self.log_std_min = log_std_min
        self.log_std_max = log_std_max
        self._rng = np.random.default_rng(seed) if stochastic else None
        self.layers = [
            {"w": np.zeros(w, np.float32), "b": np.zeros(b, np.float32)}
            for w, b in layout
        ]

    def load_flat(self, flat: np.ndarray) -> None:
        i = 0
        for layer, (w_shape, b_shape) in zip(self.layers, self.layout):
            n = int(np.prod(w_shape))
            layer["w"] = flat[i : i + n].reshape(w_shape).copy()
            i += n
            n = int(np.prod(b_shape))
            layer["b"] = flat[i : i + n].copy()
            i += n

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(obs)
        for layer in self.layers[:-1]:
            x = np.maximum(x @ layer["w"] + layer["b"], 0.0)
        x = x @ self.layers[-1]["w"] + self.layers[-1]["b"]
        if self.gaussian:
            mean, log_std_raw = np.split(x, 2, axis=-1)
            if not self.stochastic:
                return np.tanh(mean) * self.scale + self.offset
            # The learner's soft clamp, so that the workers draw from the
            # distribution the learner scores.
            log_std = self.log_std_min + 0.5 * (
                self.log_std_max - self.log_std_min) * (np.tanh(log_std_raw) + 1.0)
            u = mean + np.exp(log_std) * self._rng.standard_normal(
                mean.shape).astype(np.float32)
            return np.tanh(u) * self.scale + self.offset
        return np.tanh(x) * self.scale + self.offset
