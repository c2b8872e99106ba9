"""The alternating runner that tools/ab_chunk.py and tools/ab_update.py
share: each round runs the trees in order and then in reverse (A B B A
for two), each in a fresh child process of the calling tool whose
PYTHONPATH is that tree, so the tree's own package, kernel source and
chip_smoke.py are the ones used.

A child prints one JSON line whose `key` entry maps names to figures;
`alternate` prints each line and returns the median of each figure per
tree. It is imported only by the tool's parent process: a child runs on
another tree's package, which may not hold this module.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from typing import Dict, Sequence


def alternate(script: str, trees: Sequence[str], rounds: int, child_args: Sequence[str],
              key: str) -> Dict[str, Dict[str, float]]:
    """Runs `script --child *child_args` for each tree, A B B A a round, for
    `rounds` rounds; returns {tree: {name: median}} of the children's
    `key` figures."""
    trees = [os.path.abspath(t) for t in trees]
    order = (trees + trees[::-1]) * rounds
    results = {t: {} for t in trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run([sys.executable, script, "--child", *child_args],
                             cwd=tree, env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            raise RuntimeError(f"timing child for {tree} exited {out.returncode}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        for name, value in json.loads(line)[key].items():
            results[tree].setdefault(name, []).append(value)
    return {tree: {name: statistics.median(v) for name, v in r.items()}
            for tree, r in results.items()}
