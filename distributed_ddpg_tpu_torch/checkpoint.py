"""Checkpoint and resume of the port (counterpart of distributed_ddpg_tpu/checkpoint.py).

A checkpoint is the whole learner-side state, as the JAX package's is:
the TrainState (params, targets, both Adam states, the step; SAC's
log_alpha and alpha_opt), the device replay's contents (its state_dict
under the JAX package's keys: packed, ptr, size and, under PER,
priorities and max_priority), the env-step count and, for an auto-sized
C51 support, the resolved bounds. The JAX package writes it with orbax,
which imports JAX; the port has its own format, one directory a step:

    DIR/step_<N>/state.npz     the TrainState's leaves keyed by their path
                               (actor_params/0/w, critic_opt/count, step,
                               log_alpha, alpha_opt/mu, ...)
    DIR/step_<N>/replay.npz    the replay's state_dict
    DIR/step_<N>/meta.json     {"env_steps": E, "v_bounds": [lo, hi]}
    DIR/config_<N>.json        the run's config (nan written as null)
    DIR/manifest_<N>.json      {"step": N, "files": {rel: [size, crc32]}}

The step directory is written as step_<N>.tmp and published with
os.replace, the counterpart of orbax's atomic finalization, so a step_<N>
that exists finished writing; the manifest, written after it, certifies
that. The manifest's format is the JAX package's (size and a crc32 of the
first and last MiB of each file), so each package's verify_checkpoint
reads the other's checkpoints. Arrays are read back with
allow_pickle=False.

Kept from the JAX module, by name: COMPAT_FIELDS and
check_config_compatible (nan and null both mean an auto bound), _steps,
_prune (stale steps above the save that just landed go, loudly; below it
the newest keep - 1 stay), _digest_file, _write_manifest,
verify_checkpoint, _quarantine_corrupt (a step that fails verification
becomes corrupt_step_<N>), _write (retries with exponential backoff on
OSError; `fault`, any object with a tick() method, is ticked once an
attempt; a failed attempt's directory is cleared), save, AsyncSaver (the
snapshot on the caller's thread, the write on one background thread; a
save while it is busy is skipped and counted), latest_step, valid_steps
and restore (with step=None the newest-first walk: verify, quarantine on
failure, check the config outside the load's try, fall back past a load
error; an explicit step has no fallback) and discard_above (the
guardrails' rollback: checkpoints newer than the restored step become
diverged_step_<N>). A checkpoint holds the logical state, as the JAX
package's does: under model_axis > 1 every rank gathers its shards over
its model group (parallel/learner.ShardedLearner.logical_state) and rank
0 writes; a restore takes the logical template (state_template) and
load_state keeps each rank's shards, so a run resumes at another
model_axis, bit for bit. `pod_dir` is a pod node's own directory for its
emergency checkpoint after a peer loss (JAX train.py's pod_ckpt_dir):
node 0 writes into the checkpoint directory, node k into its proc<k>
subdirectory, so a shared filesystem never has two writers on one step.

The all-writer replay slices of a sharded replay (JAX checkpoint.py
:597-803, the same layout and names, so a slice set written by one
package loads in the other's):

    DIR/replay_slices/step_<N>/slice_<k>_of_<n>.npz   rank k's slice
    DIR/replay_slices/step_<N>/slice_<k>_of_<n>.json  its digest sidecar

Each of the n ranks writes its own file (replay/device.py
slice_state_dict: the logical positions it owns and their rows), as a
temporary file renamed into place, then the sidecar with the payload's
size and crc32, so a slice with a sidecar finished writing. A step's set
is complete when every one of some n's slices is there and verifies
(slice_status); verify_replay_slices quarantines a slice that fails
(-> .corrupt) and leaves its siblings and the step's learner state;
latest_complete_slice_step is the adoption's input, load_replay_slices
its reader; _prune removes a step's slices with the step but keeps the
newest complete set. `ckpt_has_replay` in restore's meta_out says whether
the learner checkpoint carried the replay (a sharded run's does not).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import sys
import threading
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from distributed_ddpg_tpu_torch import trace
from distributed_ddpg_tpu_torch.learner import (
    state_signature,
    train_state_from_flat,
    train_state_to_flat,
)
from distributed_ddpg_tpu_torch.types import TrainState

# Fields that must match between a checkpoint and the run restoring it: the
# restored state's shapes and meaning depend on them.
COMPAT_FIELDS = (
    "env_id",
    "actor_hidden",
    "critic_hidden",
    "action_insert_layer",
    "distributional",
    "twin_critic",
    "sac",
    "sac_autotune",
    "num_atoms",
    "v_min",
    "v_max",
    "prioritized",
    "replay_capacity",
    "n_step",
)

# Checkpoints retained after each successful write (the newest N).
KEEP_CHECKPOINTS = 3

STATE_FILE, REPLAY_FILE, META_FILE = "state.npz", "replay.npz", "meta.json"
# The device actors' rollout carry (actors/device_pool.carry_state_dict),
# the JAX package's sidecar name: flat numpy leaves, inside the step
# directory, so the manifest covers it.
DEVACTOR_FILE = "devactor_carry.npz"


def _snapshot(step: int, state: TrainState, replay, env_steps: int,
              v_bounds=None, devactor_state=None) -> Dict[str, Any]:
    """Everything on the host: the only part that reads device memory. Once
    it returns the learner may go on updating its state and the replay;
    the write can run on any thread. The replay's state_dict holds its
    dispatch_lock, so its rows, ptr, size and priorities are those between
    two ships, whichever thread ships; its D2H copy is queued on the
    current stream, so it reads the priorities a chunk queued before it
    wrote. (Rows still staged on the host are not saved, as in the JAX
    package.)"""
    ckpt: Dict[str, Any] = {
        "state": train_state_to_flat(state),
        "meta": {"env_steps": int(env_steps)},
    }
    if v_bounds is not None:
        # The resolved auto support: expansions cannot be rebuilt from the
        # rewards, and the critic's logits mean nothing on other atoms.
        ckpt["meta"]["v_bounds"] = [float(v_bounds[0]), float(v_bounds[1])]
    if replay is not None:
        ckpt["replay"] = replay.state_dict()
    if devactor_state:
        ckpt["devactor"] = devactor_state
    return ckpt


def _steps(directory: str):
    """Every step N with a step_N directory (step_N.tmp is not one)."""
    return sorted(
        int(name.split("_", 1)[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and name.split("_", 1)[1].isdigit()
    )


def _prune(directory: str, keep: int, current: int) -> None:
    """Delete old step_*/config_*/manifest_* triples, keeping `current`
    (the save that just landed) and the newest keep - 1 steps below it.
    Steps above `current` are stale (a previous run's, in a directory
    reused with --resume=false) and go too, loudly: left in place they
    would hold the retention slots and keep resume pointing at another
    run's state. Best-effort: a failed unlink does not fail the save."""
    if keep <= 0:
        return
    steps = _steps(directory)
    stale_above = [s for s in steps if s > current]
    below = [s for s in steps if s < current]
    if stale_above:
        print(
            f"[checkpoint] pruning stale checkpoint(s) above the current save "
            f"step_{current}: " + ", ".join(f"step_{s}" for s in stale_above)
            + " (a previous run's leftovers: resume must track this run's "
            "latest state)",
            file=sys.stderr, flush=True,
        )
    doomed = stale_above + (below[: -(keep - 1)] if keep > 1 else below)
    # The newest complete replay slice set is never pruned: after a shrink
    # it is the only copy of the lost rank's shard, and the survivors go on
    # checkpointing learner state past it (JAX :178-186).
    protected = latest_complete_slice_step(directory)
    doomed = [s for s in doomed if s != protected]
    for old in doomed:
        try:
            shutil.rmtree(os.path.join(directory, f"step_{old}"), ignore_errors=True)
            shutil.rmtree(_slice_step_dir(directory, old), ignore_errors=True)
            for side in (f"config_{old}.json", f"manifest_{old}.json"):
                side_path = os.path.join(directory, side)
                if os.path.exists(side_path):
                    os.unlink(side_path)
        except OSError:
            pass


# --- the integrity manifest ---------------------------------------------------

# Digest window a file: crc32 over its first and last MiB, and its size.
_DIGEST_CAP = 1 << 20


def _digest_file(path: str) -> Tuple[int, int]:
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        crc = zlib.crc32(f.read(_DIGEST_CAP))
        if size > _DIGEST_CAP:
            f.seek(max(size - _DIGEST_CAP, _DIGEST_CAP))
            crc = zlib.crc32(f.read(_DIGEST_CAP), crc)
    return size, crc


def _write_manifest(directory: str, step: int) -> None:
    """Every file under step_<step> with its size and head/tail crc32,
    written after the directory is published."""
    root = os.path.join(directory, f"step_{step}")
    files: Dict[str, Any] = {}
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            full = os.path.join(dirpath, name)
            files[os.path.relpath(full, root)] = list(_digest_file(full))
    path = os.path.join(directory, f"manifest_{step}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "files": files}, f)
    os.replace(tmp, path)


def verify_checkpoint(directory: str, step: int) -> Tuple[bool, str]:
    """(ok, why) of one retained checkpoint against its manifest. A
    checkpoint without a manifest verifies as ok, as the JAX package's
    does: the load is its check, and restore's fallback catches a failed
    one."""
    directory = os.path.abspath(directory)
    root = os.path.join(directory, f"step_{step}")
    if not os.path.isdir(root):
        return False, "missing checkpoint directory"
    mpath = os.path.join(directory, f"manifest_{step}.json")
    if not os.path.exists(mpath):
        return True, "no manifest (pre-manifest checkpoint)"
    try:
        with open(mpath) as f:
            entries = json.load(f)["files"]
    except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
        return False, f"unreadable manifest: {e!r}"
    for rel, (size, crc) in entries.items():
        try:
            got_size, got_crc = _digest_file(os.path.join(root, rel))
        except OSError:
            return False, f"missing/unreadable file {rel}"
        if got_size != size:
            return False, f"size mismatch {rel}: {got_size} != {size}"
        if got_crc != crc:
            return False, f"digest mismatch {rel}"
    # A torn replay slice quarantines only itself: the step's learner state
    # verified above, and adoption has its own fallback
    # (latest_complete_slice_step).
    verify_replay_slices(directory, step, quarantine=True)
    return True, "ok"


def _quarantine_corrupt(directory: str, step: int) -> None:
    """Move a checkpoint that failed verification to corrupt_step_<N> (kept
    for inspection) and drop its manifest and config, so a resumed run
    that reaches step N again writes a fresh one there. Best-effort."""
    directory = os.path.abspath(directory)
    src = os.path.join(directory, f"step_{step}")
    dst = os.path.join(directory, f"corrupt_step_{step}")
    try:
        if os.path.isdir(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.rename(src, dst)
        for side in (f"manifest_{step}.json", f"config_{step}.json"):
            side_path = os.path.join(directory, side)
            if os.path.exists(side_path):
                os.unlink(side_path)
        print(f"[checkpoint] quarantined corrupt step_{step} -> corrupt_step_{step}",
              file=sys.stderr, flush=True)
    except OSError:
        pass


def discard_above(directory: str, step: int) -> list:
    """Move every retained checkpoint NEWER than `step` out of the step_N
    namespace (-> diverged_step_N; its manifest and config removed, so
    latest_step and valid_steps stop seeing it; the payload kept for
    inspection). The guardrails' rollback (train.py) calls this right after
    restoring `step`: checkpoints written after the divergence began are
    presumed poisoned, and a crash before the next clean save must resume
    from `step`, not from them. Returns the steps discarded."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    discarded = []
    for s in _steps(directory):
        if s <= step:
            continue
        src = os.path.join(directory, f"step_{s}")
        dst = os.path.join(directory, f"diverged_step_{s}")
        try:
            if os.path.isdir(dst):
                shutil.rmtree(dst, ignore_errors=True)
            os.rename(src, dst)
            for side in (f"manifest_{s}.json", f"config_{s}.json"):
                side_path = os.path.join(directory, side)
                if os.path.exists(side_path):
                    os.unlink(side_path)
            discarded.append(s)
        except OSError:
            pass
    if discarded:
        print(
            "[checkpoint] rollback quarantined diverged checkpoint(s): "
            + ", ".join(f"step_{s} -> diverged_step_{s}" for s in discarded),
            file=sys.stderr, flush=True,
        )
    return discarded


# --- writing ---------------------------------------------------------------------


def _write_once(directory: str, step: int, ckpt: Dict[str, Any], config,
                keep: int = KEEP_CHECKPOINTS) -> str:
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}")
    tmp = path + ".tmp"
    # A leftover at this step (a corrupt checkpoint restore skipped, or a
    # failed attempt) is replaced: this writer is the step's one author.
    for leftover in (path, tmp):
        if os.path.isdir(leftover):
            shutil.rmtree(leftover)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        np.savez(f, **ckpt["state"])
    if "replay" in ckpt:
        with open(os.path.join(tmp, REPLAY_FILE), "wb") as f:
            np.savez(f, **ckpt["replay"])
    if "devactor" in ckpt:
        with open(os.path.join(tmp, DEVACTOR_FILE), "wb") as f:
            np.savez(f, **ckpt["devactor"])
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump(ckpt["meta"], f)
    os.replace(tmp, path)
    if config is not None:
        # nan (the auto bounds) as null: a bare NaN is not valid JSON.
        fields = {k: (None if isinstance(v, float) and math.isnan(v) else v)
                  for k, v in dataclasses.asdict(config).items()}
        with open(os.path.join(directory, f"config_{step}.json"), "w") as f:
            json.dump(fields, f, indent=2, default=list)
    _write_manifest(directory, step)
    _prune(directory, keep, step)
    return path


def _write(directory: str, step: int, ckpt: Dict[str, Any], config,
           keep: int = KEEP_CHECKPOINTS, retries: int = 0, backoff_s: float = 0.5,
           fault=None) -> Tuple[str, int]:
    """Write with up to `retries` retries on OSError, waiting backoff_s,
    2 backoff_s, ... between attempts. Returns (path, retries used).
    `fault.tick()` runs once an attempt (retries advance its count) and
    may raise OSError to script a failed attempt."""
    for attempt in range(retries + 1):
        try:
            if fault is not None:
                fault.tick()
            return _write_once(directory, step, ckpt, config, keep=keep), attempt
        except OSError as e:
            for part in (f"step_{step}", f"step_{step}.tmp"):
                shutil.rmtree(os.path.join(os.path.abspath(directory), part),
                              ignore_errors=True)
            if attempt >= retries:
                raise
            delay = backoff_s * (2.0 ** attempt)
            trace.instant("ckpt_write_retry", step=step, attempt=attempt + 1)
            print(f"[checkpoint] write of step_{step} failed ({e!r}); retry "
                  f"{attempt + 1}/{retries} in {delay:.2f}s", file=sys.stderr, flush=True)
            time.sleep(delay)
    raise AssertionError("unreachable")


def save(directory: str, step: int, state: TrainState, replay=None, config=None,
         env_steps: int = 0, v_bounds=None, keep: int = KEEP_CHECKPOINTS,
         retries: int = 0, backoff_s: float = 0.5, fault=None,
         devactor_state=None) -> str:
    """Write checkpoint directory/step_<step> now; returns its path.
    `devactor_state` (actors/device_pool.carry_state_dict) rides as the
    devactor_carry.npz sidecar inside the step directory."""
    path, _ = _write(directory, step,
                     _snapshot(step, state, replay, env_steps, v_bounds, devactor_state),
                     config, keep=keep, retries=retries, backoff_s=backoff_s, fault=fault)
    return path


class AsyncSaver:
    """Checkpoints off the training loop: save_async takes the snapshot on
    the caller's thread (the state's and the replay's device-to-host
    copies) and hands the write to one background thread. While a write is
    in flight a further save is skipped (`skipped` counts them): a fresher
    one is coming, and a queue would hold a replay copy per entry. A
    failed write lands in `errors` and is raised by wait(); write_retries
    counts the retries the writes used."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.skipped = 0
        self.errors: list = []
        self.write_retries = 0

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def save_async(self, directory: str, step: int, state: TrainState, replay=None,
                   config=None, env_steps: int = 0, v_bounds=None,
                   keep: int = KEEP_CHECKPOINTS, retries: int = 0, backoff_s: float = 0.5,
                   fault=None, devactor_state=None) -> bool:
        """Snapshot now, write in the background. False (and skipped) while
        the previous write is in flight. `devactor_state` is a host
        snapshot already (carry_state_dict)."""
        with self._lock:
            if self.busy:
                self.skipped += 1
                return False
            ckpt = _snapshot(step, state, replay, env_steps, v_bounds, devactor_state)

            def run():
                try:
                    with trace.span("ckpt_write", step=step):
                        _, used = _write(directory, step, ckpt, config, keep=keep,
                                         retries=retries, backoff_s=backoff_s, fault=fault)
                    self.write_retries += used
                except Exception as e:   # raised by wait()
                    self.errors.append(e)

            self._thread = threading.Thread(target=run, name=f"ckpt-writer-{step}",
                                            daemon=True)
            self._thread.start()
            return True

    def wait(self) -> None:
        """Block until the write in flight (if any) lands; raise the last
        failed write's error."""
        if self._thread is not None:
            self._thread.join()
        if self.errors:
            raise self.errors[-1]


# --- reading ---------------------------------------------------------------------


def check_config_compatible(directory: str, step: int, config) -> None:
    """Raise ValueError when the checkpoint's config differs from `config`
    in any of COMPAT_FIELDS."""
    path = os.path.join(os.path.abspath(directory), f"config_{step}.json")
    if not os.path.exists(path):
        return
    with open(path) as f:
        saved = json.load(f)
    current = dataclasses.asdict(config)
    mismatches = [
        f"{k}: checkpoint={saved[k]!r} run={_listify(current[k])!r}"
        for k in COMPAT_FIELDS
        if k in saved and not _compat_eq(saved[k], _listify(current[k]))
    ]
    if mismatches:
        raise ValueError(
            f"checkpoint {directory}/step_{step} is incompatible with this "
            "run's config (pass --resume=false or a fresh --checkpoint_dir):\n  "
            + "\n  ".join(mismatches)
        )


def _listify(v):
    return list(v) if isinstance(v, tuple) else v


def _compat_eq(a, b) -> bool:
    """Equal, with nan and null (the auto bounds, as written) equal."""
    def _is_auto(v) -> bool:
        return v is None or (isinstance(v, float) and math.isnan(v))

    if _is_auto(a) and _is_auto(b):
        return True
    return a == b


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def pod_dir(directory: str, process_index: int) -> str:
    """The directory pod node `process_index` writes its emergency
    checkpoint into (module docstring): `directory` itself for node 0,
    directory/proc<k> for node k."""
    if not directory or int(process_index) == 0:
        return directory
    return os.path.join(directory, f"proc{int(process_index)}")


def valid_steps(directory: str, limit: Optional[int] = None):
    """The retained steps that verify, ascending (JAX checkpoint.valid_steps):
    the input of the pod's resume election (parallel/multihost.
    elect_resume_step). `limit` keeps only the newest N."""
    if not directory or not os.path.isdir(directory):
        return []
    out = [s for s in _steps(directory) if verify_checkpoint(directory, s)[0]]
    return out[-limit:] if limit else out


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def restore(directory: str, state_template: TrainState, replay=None,
            step: Optional[int] = None, config=None,
            meta_out: Optional[Dict[str, Any]] = None,
            at_most: Optional[int] = None,
            device=None) -> Tuple[TrainState, int, int]:
    """Restore (TrainState, step, env_steps); `replay`, when given, is
    filled in place. The state comes back on `device` (by default the
    template's: a template of meta tensors, a tensor-parallel learner's
    state_template, needs it), with the template's paths and shapes (else
    a ValueError). With `config` the
    checkpoint's config is checked first. `meta_out` receives, for an
    auto support, "v_bounds" (lo, hi), and where the checkpoint carries the
    device actors' sidecar, "devactor_carry" (its leaves as host arrays:
    the pool that takes them is built after the restore).

    With step=None the retained checkpoints are tried newest first: one
    that fails verification is quarantined, one that fails to load is
    passed over, each with a note on stderr, so a corrupt newest
    checkpoint costs one cadence of progress. A config mismatch raises
    either way. An explicit step restores that step or raises. `at_most`
    limits the walk to steps <= it (the guardrails' rollback: the newest
    checkpoint from before the divergence began)."""
    if step is None:
        candidates = _steps(os.path.abspath(directory)) if os.path.isdir(directory) else []
        if at_most is not None:
            candidates = [s for s in candidates if s <= at_most]
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        failures = []
        for s in sorted(candidates, reverse=True):
            ok, why = verify_checkpoint(directory, s)
            if not ok:
                print(f"[checkpoint] step_{s} failed verification ({why}); falling "
                      "back to the previous retained checkpoint",
                      file=sys.stderr, flush=True)
                failures.append(f"step_{s}: {why}")
                _quarantine_corrupt(directory, s)
                continue
            # Outside the load's try: a mismatch is the caller's error, not
            # corruption, and must not fall back.
            if config is not None:
                check_config_compatible(directory, s, config)
            try:
                return restore(directory, state_template, replay=replay, step=s,
                               meta_out=meta_out, device=device)
            except Exception as e:
                print(f"[checkpoint] step_{s} failed to load ({e!r}); falling back "
                      "to the previous retained checkpoint", file=sys.stderr, flush=True)
                failures.append(f"step_{s}: load error: {e!r}")
        raise RuntimeError(f"no restorable checkpoint under {directory}; tried newest-"
                           "first: " + "; ".join(failures))
    if config is not None:
        check_config_compatible(directory, step, config)
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    state = train_state_from_flat(_load_npz(os.path.join(path, STATE_FILE)),
                                  device or state_template.step.device)
    if state_signature(state) != state_signature(state_template):
        raise ValueError(f"checkpoint step_{step}'s state does not match this run's "
                         "learner (paths, shapes or dtypes)")
    has_replay = os.path.exists(os.path.join(path, REPLAY_FILE))
    if replay is not None:
        if has_replay:
            replay.load_state_dict(_load_npz(os.path.join(path, REPLAY_FILE)))
        else:
            print(f"[checkpoint] step_{step} carries no replay contents; the buffer "
                  "resumes empty", file=sys.stderr, flush=True)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta_out is not None:
        # The slice adoption's gate (train.py): a learner checkpoint that
        # carried no replay leaves the ring to the slice sets.
        meta_out["ckpt_has_replay"] = has_replay
    if meta_out is not None and "v_bounds" in meta:
        meta_out["v_bounds"] = (float(meta["v_bounds"][0]), float(meta["v_bounds"][1]))
    carry = os.path.join(path, DEVACTOR_FILE)
    if meta_out is not None and os.path.exists(carry):
        try:
            meta_out["devactor_carry"] = _load_npz(carry)
        except (OSError, ValueError) as e:
            print(f"[checkpoint] {DEVACTOR_FILE} unreadable ({e!r}); the rollout state "
                  "starts fresh", file=sys.stderr, flush=True)
    return state, step, int(meta.get("env_steps", 0))


# --- the all-writer replay slices (module docstring) --------------------------

SLICE_DIRNAME = "replay_slices"
_SLICE_RE = re.compile(r"^slice_(\d+)_of_(\d+)\.npz$")


def _slice_step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), SLICE_DIRNAME, f"step_{step}")


def _slice_steps(directory: str):
    """The steps with a slice directory, ascending."""
    root = os.path.join(os.path.abspath(directory), SLICE_DIRNAME)
    if not os.path.isdir(root):
        return []
    return sorted(int(name.split("_", 1)[1]) for name in os.listdir(root)
                  if name.startswith("step_") and name.split("_", 1)[1].isdigit())


def write_replay_slice(directory: str, step: int, proc: int, nprocs: int,
                       slice_state: Dict[str, Any], fault=None) -> str:
    """Write rank `proc`'s slice of `nprocs` for `step` (a temporary file
    renamed into place), then its digest sidecar; returns the payload's
    path. `slice_state` is replay/device.py slice_state_dict's. `fault`
    (faults.FaultPlan.slice_site) is ticked once a call: `kill` dies
    before any byte lands, `corrupt` (faults.InjectedCorruption) tears the
    payload after the sidecar recorded the intact one, the torn write
    verification must quarantine."""
    torn = False
    if fault is not None:
        from distributed_ddpg_tpu_torch.faults import InjectedCorruption

        try:
            fault.tick()
        except InjectedCorruption:
            torn = True
    root = _slice_step_dir(directory, step)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"slice_{proc}_of_{nprocs}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **slice_state)
    os.replace(tmp, path)
    size, crc = _digest_file(path)
    jpath = os.path.join(root, f"slice_{proc}_of_{nprocs}.json")
    jtmp = jpath + ".tmp"
    with open(jtmp, "w") as f:
        json.dump({"step": step, "proc": proc, "nprocs": nprocs, "digest": [size, crc]}, f)
    os.replace(jtmp, jpath)
    if torn:
        # The sidecar covered the intact file; the payload is now shorter.
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    return path


def _verify_slice(root: str, proc: int, nprocs: int) -> Tuple[bool, str]:
    path = os.path.join(root, f"slice_{proc}_of_{nprocs}.npz")
    jpath = os.path.join(root, f"slice_{proc}_of_{nprocs}.json")
    if not os.path.exists(path):
        return False, "missing slice"
    if not os.path.exists(jpath):
        return False, "no digest sidecar (write did not finish)"
    try:
        with open(jpath) as f:
            size, crc = json.load(f)["digest"]
    except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
        return False, f"unreadable digest sidecar: {e!r}"
    try:
        got_size, got_crc = _digest_file(path)
    except OSError:
        return False, "unreadable slice"
    if got_size != size:
        return False, f"size mismatch: {got_size} != {size}"
    if got_crc != crc:
        return False, "digest mismatch"
    return True, "ok"


def slice_status(directory: str, step: int):
    """(complete, nprocs, {proc: (ok, why)}) of a step's slice set: complete
    when some writer count n has all n slices present and verified;
    `nprocs` is that n (the largest seen when none is complete; None with
    no slices at all)."""
    root = _slice_step_dir(directory, step)
    if not os.path.isdir(root):
        return False, None, {}
    by_n: Dict[int, set] = {}
    for name in os.listdir(root):
        m = _SLICE_RE.match(name)
        if m:
            by_n.setdefault(int(m.group(2)), set()).add(int(m.group(1)))
    if not by_n:
        return False, None, {}
    for n in sorted(by_n, reverse=True):
        if by_n[n] == set(range(n)):
            status = {k: _verify_slice(root, k, n) for k in range(n)}
            return all(ok for ok, _ in status.values()), n, status
    n = max(by_n)
    return False, n, {k: _verify_slice(root, k, n) for k in sorted(by_n[n])}


def verify_replay_slices(directory: str, step: int,
                         quarantine: bool = True) -> Tuple[bool, int]:
    """Verify a step's slice set; with `quarantine`, move each slice that
    fails its digest to <name>.corrupt (kept for inspection; the set reads
    incomplete after). Returns (complete, nprocs or 0)."""
    complete, n, status = slice_status(directory, step)
    if quarantine:
        root = _slice_step_dir(directory, step)
        for proc, (ok, why) in status.items():
            if ok or why == "missing slice":
                continue
            src = os.path.join(root, f"slice_{proc}_of_{n}.npz")
            if not os.path.exists(src):
                continue
            try:
                os.replace(src, src + ".corrupt")
                print(f"[checkpoint] quarantined corrupt replay slice {proc}/{n} at "
                      f"step_{step} ({why}) -> .corrupt; the step's learner state stays "
                      "valid", file=sys.stderr, flush=True)
            except OSError:
                pass
    return complete, (n or 0)


def latest_complete_slice_step(directory: str,
                               at_or_below: Optional[int] = None) -> Optional[int]:
    """The newest step (at most `at_or_below`) whose slice set is complete
    and verifies: the elastic restart's adoption input (train.py). None
    when no step qualifies."""
    if not directory:
        return None
    for s in sorted(_slice_steps(directory), reverse=True):
        if at_or_below is not None and s > at_or_below:
            continue
        if slice_status(directory, s)[0]:
            return s
    return None


def load_replay_slices(directory: str, step: int):
    """The complete slice set at `step`, one dict of host arrays a writer
    (merge_slice_states takes them in any order)."""
    complete, n, status = slice_status(directory, step)
    if not complete:
        bad = {k: why for k, (ok, why) in status.items() if not ok}
        raise RuntimeError(f"replay slice set at step_{step} is incomplete "
                           f"(world={n}, failures={bad})")
    root = _slice_step_dir(directory, step)
    return [_load_npz(os.path.join(root, f"slice_{k}_of_{n}.npz")) for k in range(n)]
