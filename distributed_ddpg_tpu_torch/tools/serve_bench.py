"""Serve-path traffic generator, the port of
distributed_ddpg_tpu/tools/serve_bench.py (docs/SERVING.md): drive an
InferenceServer with synthetic closed-loop clients — no Gym, no learner,
no replay. The local in-process RPC front for load-testing the serving
stack by itself:

    python -m distributed_ddpg_tpu_torch.tools.serve_bench \
        --clients=8 --duration_s=3 --max_batch=32 --max_latency_ms=5

Prints ONE JSON line: the serve_* digest (metrics.ServeStats) plus the
client-side view (served requests/sec, sheds) and an A/B against the
per-worker local act() path at the same thread count — what dynamic
batching buys or costs on this host.

numpy + stdlib only on the default backend. --backend=jax (the JAX
package's flag value) is the device apply over batches padded to
(max_batch, obs_dim), on --device: the card (the default, which raises
without one) or the CPU.

--transport socket drives the NETWORK front instead (serve/front/;
docs/SERVING.md 'Network front'): each client thread opens its own
framed-TCP FrontClient connection against a local FrontServer and the
digest gains the front_*/tenant_* families plus wire_p50_ms/wire_p95_ms
— client-measured round-trip tails over the real socket.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from distributed_ddpg_tpu_torch.actors.policy import (
    NumpyPolicy,
    layout_size,
    param_layout,
)
from distributed_ddpg_tpu_torch.serve import (
    InferenceServer,
    ServeDispatchError,
    ServeOverload,
    ServeTimeout,
)


# Reap bound for bench client threads after stop is set: generous next to
# serve_fallback_s (the longest a client blocks per request), so a join
# miss means a wedged client, not a slow one — the threads are daemons and
# the measurement is already taken either way.
_CLIENT_JOIN_S = 10.0


def _random_flat(layout, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(layout_size(layout)) * 0.1).astype(np.float32)


def run_socket_bench(
    clients: int = 8,
    duration_s: float = 3.0,
    obs_dim: int = 17,
    act_dim: int = 6,
    hidden: Sequence[int] = (256, 256),
    max_batch: int = 32,
    max_latency_ms: float = 5.0,
    queue: int = 1024,
    backend: str = "numpy",
    seed: int = 0,
    tenants: str = "",
    device: str = "cuda",
) -> Dict[str, float]:
    """Closed-loop load over the REAL TCP front: `clients` threads, one
    persistent framed connection each, tenant ids bench-0..N-1 (or the
    names from `tenants`, round-robin). Returns the front_*/tenant_*
    digest plus client-measured wire round-trip tails."""
    from distributed_ddpg_tpu_torch.serve.front import FrontClient, FrontError
    from distributed_ddpg_tpu_torch.serve.front.qos import parse_tenants

    layout = param_layout(obs_dim, act_dim, tuple(hidden))
    flat = _random_flat(layout, seed)

    def make_engine():
        return InferenceServer(
            layout,
            1.0,
            max_batch=max_batch,
            max_latency_s=max_latency_ms / 1000.0,
            max_queue=queue,
            backend=backend,
            seed=seed,
            device=device,
        )

    from distributed_ddpg_tpu_torch.serve.front import FrontServer

    front = FrontServer(make_engine, tenants=tenants, seed=seed)
    front.publish("bench-0", flat)
    front.start()

    names = list(parse_tenants(tenants)) if tenants else []
    stop = threading.Event()
    served = [0] * clients
    sheds = [0] * clients
    # Client-side wire latency samples (bounded: the tail computation is
    # exact over the run, not reservoir-thinned — a bench run is short).
    lats: list = [[] for _ in range(clients)]

    def client_loop(i: int) -> None:
        tenant = names[i % len(names)] if names else f"bench-{i}"
        rng = np.random.default_rng(seed + 1 + i)
        obs = rng.standard_normal((64, obs_dim)).astype(np.float32)
        try:
            cli = FrontClient(front.port, tenant=tenant, timeout_s=5.0)
        except OSError:
            return
        j = 0
        with cli:
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    cli.act(obs[j % 64])
                    served[i] += 1
                    lats[i].append(time.perf_counter() - t0)
                except FrontError:
                    sheds[i] += 1
                except (ConnectionError, OSError):
                    return
                j += 1

    threads = [
        threading.Thread(target=client_loop, args=(i,), daemon=True)
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=_CLIENT_JOIN_S)
    elapsed = time.perf_counter() - t0
    snap = front.snapshot()
    front.stop()

    all_lats = sorted(x for per in lats for x in per)

    def pct(q: float) -> float:
        if not all_lats:
            return 0.0
        return round(
            1000.0 * all_lats[min(len(all_lats) - 1, int(q * len(all_lats)))],
            3,
        )

    return {
        "clients": clients,
        "backend": backend,
        "transport": "socket",
        "served_rps": round(sum(served) / elapsed, 1),
        "client_sheds": int(sum(sheds)),
        "wire_p50_ms": pct(0.50),
        "wire_p95_ms": pct(0.95),
        **snap,
    }


def run_serve_bench(
    clients: int = 8,
    duration_s: float = 3.0,
    obs_dim: int = 17,
    act_dim: int = 6,
    hidden: Sequence[int] = (256, 256),
    max_batch: int = 32,
    max_latency_ms: float = 5.0,
    queue: int = 1024,
    backend: str = "numpy",
    seed: int = 0,
    scheduler=None,
    measure_local: bool = True,
    device: str = "cuda",
) -> Dict[str, float]:
    """One measurement: `clients` closed-loop threads hammer the server
    for `duration_s`; returns the serve_* digest + client-side rates and
    (measure_local) the same-thread-count local-act A/B."""
    layout = param_layout(obs_dim, act_dim, tuple(hidden))
    flat = _random_flat(layout, seed)
    server = InferenceServer(
        layout,
        1.0,
        max_batch=max_batch,
        max_latency_s=max_latency_ms / 1000.0,
        max_queue=queue,
        backend=backend,
        scheduler=scheduler,
        seed=seed,
        device=device,
    ).start()
    server.refresh(flat)

    stop = threading.Event()
    served = [0] * clients
    sheds = [0] * clients

    def client_loop(i: int) -> None:
        cli = server.client(timeout_s=5.0)
        rng = np.random.default_rng(seed + 1 + i)
        obs = rng.standard_normal((64, obs_dim)).astype(np.float32)
        j = 0
        while not stop.is_set():
            try:
                cli.act(obs[j % 64])
                served[i] += 1
            except (ServeOverload, ServeTimeout, ServeDispatchError):
                sheds[i] += 1
            j += 1

    threads = [
        threading.Thread(target=client_loop, args=(i,), daemon=True)
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=_CLIENT_JOIN_S)
    elapsed = time.perf_counter() - t0
    snap = server.snapshot()
    server.close()

    result: Dict[str, float] = {
        "clients": clients,
        "backend": backend,
        "served_rps": round(sum(served) / elapsed, 1),
        "client_sheds": int(sum(sheds)),
        **snap,
    }
    if measure_local:
        result["local_act_rps"] = round(
            _measure_local_act(layout, flat, clients, min(duration_s, 1.0),
                               obs_dim, seed),
            1,
        )
        if result["local_act_rps"]:
            result["served_vs_local"] = round(
                result["served_rps"] / result["local_act_rps"], 3
            )
    return result


def _measure_local_act(layout, flat, threads_n: int, duration_s: float,
                       obs_dim: int, seed: int) -> float:
    """The A/B denominator: per-worker act() — each thread owns its own
    NumpyPolicy mirror (exactly the worker topology) and acts closed-loop."""
    stop = threading.Event()
    counts = [0] * threads_n

    def local_loop(i: int) -> None:
        policy = NumpyPolicy(layout, 1.0)
        policy.load_flat(flat)
        rng = np.random.default_rng(seed + 101 + i)
        obs = rng.standard_normal((64, obs_dim)).astype(np.float32)
        j = 0
        while not stop.is_set():
            policy(obs[j % 64])
            counts[i] += 1
            j += 1

    threads = [
        threading.Thread(target=local_loop, args=(i,), daemon=True)
        for i in range(threads_n)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=_CLIENT_JOIN_S)
    return sum(counts) / (time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_ddpg_tpu_torch.tools.serve_bench",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--duration_s", type=float, default=3.0)
    parser.add_argument("--obs_dim", type=int, default=17)
    parser.add_argument("--act_dim", type=int, default=6)
    parser.add_argument("--hidden", default="256,256",
                        help="comma-separated hidden sizes")
    parser.add_argument("--max_batch", type=int, default=32)
    parser.add_argument("--max_latency_ms", type=float, default=5.0)
    parser.add_argument("--queue", type=int, default=1024)
    parser.add_argument("--backend", choices=("numpy", "jax"),
                        default="numpy")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where --backend=jax applies the policy")
    parser.add_argument(
        "--transport", choices=("local", "socket"), default="local",
        help="local = in-process ServeClient; socket = framed TCP "
             "through a FrontServer (the network-front path)",
    )
    parser.add_argument(
        "--tenants", default="",
        help="front tenant table (socket transport): "
             "name:priority[:rate[:burst]];...",
    )
    args = parser.parse_args(argv)
    kwargs = dict(
        clients=args.clients,
        duration_s=args.duration_s,
        obs_dim=args.obs_dim,
        act_dim=args.act_dim,
        hidden=tuple(int(x) for x in args.hidden.split(",")),
        max_batch=args.max_batch,
        max_latency_ms=args.max_latency_ms,
        queue=args.queue,
        backend=args.backend,
        seed=args.seed,
        device=args.device,
    )
    if args.transport == "socket":
        result = run_socket_bench(tenants=args.tenants, **kwargs)
    else:
        result = run_serve_bench(**kwargs)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
