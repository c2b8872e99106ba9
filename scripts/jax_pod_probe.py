"""What the JAX trainer does on a pod of two processes, on the CPU.

    python scripts/jax_pod_probe.py MODE [--port PORT]

starts two processes of the JAX package's own multi-process bootstrap
(tests/multihost_child.py's: two fake CPU devices a process,
jax.distributed over localhost, gloo collectives, the pod's startup
barrier), each running train_jax on Pendulum-v1 at 16x16 for 1500 env
steps, and prints each process's exit code and the last lines of its
output. MODE:

  hostper   --host_replay=true --prioritized=true (data_axis 4)
  hostuni   --host_replay=true (data_axis 4)
  tpserve   --serve_actors --serve_backend=jax, a (2, 2) mesh: each
            process's devices one model group
  tpserve4  the same on a (1, 4) mesh: the model group spans the processes

The port refuses the modes that fail here on a pod
(distributed_ddpg_tpu_torch/train.py check_pod_config). Each run takes
~10-20 s; it imports JAX and never the port.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "hostper": dict(host_replay=True, prioritized=True),
    "hostuni": dict(host_replay=True),
    "tpserve": dict(serve_actors=True, serve_backend="jax", model_axis=2, data_axis=2,
                    fused_chunk="off"),
    "tpserve4": dict(serve_actors=True, serve_backend="jax", model_axis=4, data_axis=1,
                     fused_chunk="off"),
}


def child(pid: int, port: int, mode: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES="2",
                      JAX_PROCESS_ID=str(pid))
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    sys.path.insert(0, REPO)
    import tempfile

    from distributed_ddpg_tpu.config import DDPGConfig
    from distributed_ddpg_tpu.parallel import multihost
    from distributed_ddpg_tpu.train import train_jax

    assert multihost.initialize() is True
    multihost.startup_barrier(120.0)
    config = DDPGConfig(
        backend="jax_tpu", env_id="Pendulum-v1", actor_hidden=(16, 16),
        critic_hidden=(16, 16), batch_size=16, num_actors=1, total_env_steps=1500,
        replay_min_size=128, replay_capacity=8192, eval_every=0, eval_episodes=1,
        log_path=tempfile.mktemp(suffix=".jsonl"), watchdog_s=120.0, learner_chunk=4,
        **MODES[mode])
    out = train_jax(config)
    print(f"RESULT process {pid} {mode}: learner_steps={out['learner_steps']} "
          f"serve_requests={out.get('serve_requests')}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=sorted(MODES))
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--child", type=int, default=-1)
    args = parser.parse_args()
    if args.child >= 0:
        child(args.child, args.port, args.mode)
        return 0
    port = args.port
    if not port:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), args.mode,
                               f"--port={port}", f"--child={p}"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p in range(2)]
    for p, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        # The run's result, or its errors: each raised error's line, the
        # root cause first.
        keep = [line.strip()[:300] for line in out.splitlines()
                if line.startswith("RESULT") or "Error:" in line or "what():" in line]
        print(f"--- process {p}: exit {proc.returncode}")
        print("\n".join(dict.fromkeys(keep)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
