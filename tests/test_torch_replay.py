"""The port's replay pieces against the JAX package's, on the CPU: the same
insert sequence, with wrap-around, into the port's DeviceReplay and the JAX
DeviceReplay gives the same ring, ptr and size; the staging ring and the
n-step accumulator (copies) give the same streams."""

import jax
import numpy as np
import pytest
import torch

from distributed_ddpg_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from distributed_ddpg_tpu.replay.nstep import NStepAccumulator as JaxNStep
from distributed_ddpg_tpu.replay.staging import HostStagingRing as JaxStagingRing
from distributed_ddpg_tpu_torch.replay.device import DeviceReplay
from distributed_ddpg_tpu_torch.replay.nstep import NStepAccumulator
from distributed_ddpg_tpu_torch.replay.staging import HostStagingRing

# Tiny nets: one torch thread per test process eases the CPU contention
# of a run with many test workers.
torch.set_num_threads(1)

OBS, ACT = 3, 1
WIDTH = 2 * OBS + ACT + 3


def _rows(rng, n):
    return rng.standard_normal((n, WIDTH)).astype(np.float32)


def _assert_same(port, ref):
    assert len(port) == len(ref)
    assert port.ptr == int(jax.device_get(ref.ptr))
    np.testing.assert_array_equal(port.storage.numpy(), np.asarray(ref.storage))


@pytest.mark.parametrize("capacity,block", [(40, 16), (64, 8), (10, 4)])
def test_device_replay_matches_jax(capacity, block):
    """Adds of uneven sizes wrap the ring several times; a flush pads the
    sub-block tail by repetition. Every intermediate state agrees."""
    port = DeviceReplay(capacity, OBS, ACT, device="cpu", block_size=block)
    ref = JaxDeviceReplay(capacity, OBS, ACT, block_size=block)
    rng = np.random.default_rng(capacity)
    for n in (3, 10, 20, 7, 33, 50, 1, 2 * capacity + 5):
        rows = _rows(rng, n)
        port.add_packed(rows)
        ref.add_packed(rows)
        _assert_same(port, ref)
        assert port.pending_rows == ref.pending_rows
    port.flush()
    ref.flush()
    _assert_same(port, ref)
    storage, size = port.device_state()
    assert storage.shape == (capacity, WIDTH) and size == len(ref)


def test_device_replay_state_dict_round_trip():
    port = DeviceReplay(32, OBS, ACT, device="cpu", block_size=8)
    port.add_packed(_rows(np.random.default_rng(0), 45))
    state = port.state_dict()
    other = DeviceReplay(32, OBS, ACT, device="cpu", block_size=8)
    other.load_state_dict(state)
    assert (other.ptr, len(other)) == (port.ptr, len(port)) == (40 % 32, 32)  # 5 full blocks of 8 shipped
    np.testing.assert_array_equal(other.storage.numpy(), port.storage.numpy())


def test_staging_ring_matches_jax():
    port, ref = HostStagingRing(WIDTH, 8), JaxStagingRing(WIDTH, 8)
    rng = np.random.default_rng(1)
    for push, pop in ((5, 3), (7, 6), (20, 10), (1, 14)):
        rows = _rows(rng, push)
        port.push(rows)
        ref.push(rows)
        np.testing.assert_array_equal(port.peek(len(port)), ref.peek(len(ref)))
        np.testing.assert_array_equal(port.pop(pop), ref.pop(pop))
        assert len(port) == len(ref) and port.capacity == ref.capacity


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_matches_jax(n):
    port, ref = NStepAccumulator(n, 0.99), JaxNStep(n, 0.99)
    rng = np.random.default_rng(n)
    for t in range(12):
        args = (rng.standard_normal((1, OBS)), rng.standard_normal((1, ACT)),
                [float(rng.standard_normal())], [t in (5, 11)],
                rng.standard_normal((1, OBS)))
        got, want = list(port.push(*args)), list(ref.push(*args))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
