"""The BASELINE.md benchmark ladder as runnable configs, for the port: the
counterpart of distributed_ddpg_tpu/ladder.py, whose RUNGS and _SMOKE it
holds field for field, trained through the port's train().

Each rung of BASELINE.json:6-12 maps to a DDPGConfig; `run(rung)` trains it
and emits the primary metric (learner grad-steps/sec + final return) as one
JSONL record per rung. `--smoke` shrinks every rung — step budgets AND net
sizes — so each completes in seconds; topology (actors, backend, mesh,
PER) is unchanged.

Rungs (BASELINE.md):
  1 Pendulum-v1          1 actor   uniform       native (CPU baseline)
  2 LunarLanderContinuous 4 actors  uniform      jax_tpu, 1 core
  3 BipedalWalker-v3      8 actors  prioritized  jax_tpu, data-parallel mesh
  4 HalfCheetah-v4       16 actors  uniform      jax_tpu, full local mesh
  5 Humanoid-v4          64 actors  uniform      jax_tpu, multi-host
    (the backend names are the JAX package's: jax_tpu is the port's
     learner on --device; rung 5 spans hosts under torchrun's pod
     variables — parallel/multihost.py; single-host it runs on one rank.)

The rungs run on the card unless the caller passes --device=cpu (the
port's counterpart of the JAX package's platform_util guard). Each
record's `platform` says which hardware ran it: "gpu" on the card, "cpu"
otherwise, and always "cpu" for the native rung, which never touches the
card.

Usage:
    python -m distributed_ddpg_tpu_torch.ladder --rungs=1,2 --smoke
    python -m distributed_ddpg_tpu_torch.ladder --rungs=2 --smoke --device=cpu
    python -m distributed_ddpg_tpu_torch.ladder --rungs=4          # full rung 4
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

from distributed_ddpg_tpu_torch.config import DDPGConfig

_COMMON = dict(actor_hidden=(256, 256), critic_hidden=(256, 256))
# The jax rungs pin ~1 grad step per env step from BOTH sides
# (config.py: ratio product >= 1 is livelock-free): that is the
# reference's sync replay ratio, which the equal-return gate compares
# against. Free-running async (the throughput mode bench.py measures)
# is a flag away: --max_learn_ratio=0 --max_ingest_ratio=0.
# watchdog_s: ladder runs are driver-managed wall-clock budgets — a wedged
# device must crash loudly (watchdog.py, exit 70) instead of eating the
# budget as a silent hang.
_GATED = dict(
    max_learn_ratio=1.0, max_ingest_ratio=1.0, watchdog_s=300.0, **_COMMON
)

RUNGS: Dict[int, DDPGConfig] = {
    1: DDPGConfig(
        env_id="Pendulum-v1", backend="native", num_actors=1,
        total_env_steps=50_000, **_COMMON,
    ),
    2: DDPGConfig(
        env_id="LunarLanderContinuous-v2", backend="jax_tpu", num_actors=4,
        total_env_steps=300_000, **_GATED,
    ),
    3: DDPGConfig(
        env_id="BipedalWalker-v3", backend="jax_tpu", num_actors=8,
        prioritized=True, total_env_steps=1_000_000,
        # n-step 3: vanilla (1-step) plateaus at 74 final / eval peak 141
        # over 1M steps; 3-step credit assignment SOLVES the env — eval 301
        # by 400k, final 293 at 600k (runs/r4_rung3_nstep3.jsonl). BASELINE
        # pins env/actors/PER for this rung, not the return horizon.
        n_step=3, **_GATED,
    ),
    4: DDPGConfig(
        env_id="HalfCheetah-v4", backend="jax_tpu", num_actors=16,
        total_env_steps=1_000_000, **_GATED,
    ),
    5: DDPGConfig(
        env_id="Humanoid-v4", backend="jax_tpu", num_actors=64,
        total_env_steps=2_000_000, **_GATED,
    ),
}

_SMOKE = dict(
    total_env_steps=3_000,
    replay_min_size=256,
    # Small dispatches, explicitly: the card's auto chunk (800) exceeds the
    # gated rungs' initial allowance at replay_min 256 (the trainer's
    # startup-livelock check would refuse to run).
    learner_chunk=8,
    eval_every=3_000,
    eval_episodes=1,
    replay_capacity=50_000,
    # Smoke means seconds-per-rung: shrink the nets too, or rung 1's
    # (256,256) native numpy learner alone blows the budget.
    actor_hidden=(64, 64),
    critic_hidden=(64, 64),
    # Pace ingest so smoke runs exercise a real actor/learner interleaving
    # instead of the actors blowing through the whole step budget during
    # first chunk (free-running ratio 0 is meaningless at this scale: 8
    # learner steps against 16k env steps).
    max_ingest_ratio=50.0,
)


def run(rung: int, smoke: bool = False, log_dir: str = "",
        device: str = "cuda") -> Dict[str, float]:
    from distributed_ddpg_tpu_torch.train import train

    config = RUNGS[rung].replace(device=device)
    if smoke:
        config = config.replace(**_SMOKE)
    if log_dir:
        import os

        os.makedirs(log_dir, exist_ok=True)
        config = config.replace(
            log_path=os.path.join(log_dir, f"rung{rung}_{config.env_id}.jsonl")
        )
    summary = train(config)
    # platform: the backend field says which CODE PATH ran (jax_tpu = the
    # learner on --device); the platform says which HARDWARE it ran on, as
    # the JAX ladder prints it ("gpu" for the card). The native rung is
    # CPU by definition and never touches the card.
    if config.backend == "native":
        platform = "cpu"
    else:
        from distributed_ddpg_tpu_torch.devices import require_device

        platform = "gpu" if require_device(config.device).type == "cuda" else "cpu"

    record = {
        "kind": "ladder",
        "rung": rung,
        "env_id": config.env_id,
        "backend": config.backend,
        "platform": platform,
        "num_actors": config.num_actors,
        "prioritized": config.prioritized,
        **{k: round(v, 3) if isinstance(v, float) else v for k, v in summary.items()},
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="distributed_ddpg_tpu_torch.ladder")
    p.add_argument("--rungs", default="1,2,3,4,5",
                   help="comma-separated rung numbers from BASELINE.md")
    p.add_argument("--smoke", action="store_true",
                   help="seconds-per-rung budgets (topology unchanged)")
    p.add_argument("--log_dir", default="",
                   help="write per-rung JSONL metrics under this directory")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the learner runs (default: the card)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    for rung in (int(r) for r in args.rungs.split(",")):
        run(rung, smoke=args.smoke, log_dir=args.log_dir, device=args.device)


if __name__ == "__main__":
    main()
