"""The port's two-level network, timeline plans and gate draws against the
JAX package's.

Everything here is numpy arithmetic or integer hashing on both sides, so
the tolerance is exact equality: H, V, Z, T_k, a, zeta and gamma; the plans
of every readiness policy and rate model given Generators with the same
seed, and their trace documents; the Bernoulli gate's uniform draws, bit
for bit against `jax.random`.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as jh
from repro.core import protocol as jprotocol
from repro.core import timeline as jtl
from repro.core import topology as jtopo
from repro_torch.core import hierarchy as th
from repro_torch.core import prng
from repro_torch.core import protocol as tprotocol
from repro_torch.core import timeline as ttl
from repro_torch.core import topology as ttopo

NETWORKS = [
    # (topology, workers_per_subnet, weights, rates)
    ("ring", (2, 2), None, (1.0, 0.8, 1.0, 0.6)),
    ("complete", (3, 3, 3), tuple(range(1, 10)), None),
    ("path", (1, 2, 3), None, (0.5,) * 6),
    ("star", (2, 2, 2, 2), None, (0.9, 0.3) * 4),
    ("torus2d", (1,) * 4, None, None),
    ("erdos", (2,) * 5, None, (1.0, 0.7) * 5),
]


def _build(mod, topology, wps, weights, rates):
    return mod.MultiLevelNetwork.build(topology, wps, worker_weights=weights,
                                       worker_rates=rates, seed=3)


@pytest.mark.parametrize("topology,wps,weights,rates", NETWORKS)
def test_network_matrices_exactly_equal(topology, wps, weights, rates):
    jn = _build(jh, topology, wps, weights, rates)
    tn = _build(th, topology, wps, weights, rates)
    for name in ("adj", "h", "b"):
        np.testing.assert_array_equal(getattr(tn.hub_net, name),
                                      getattr(jn.hub_net, name))
    assert tn.zeta == jn.zeta
    assert ttopo.gamma(tn.zeta) == jtopo.gamma(jn.zeta)
    np.testing.assert_array_equal(tn.a, jn.a)
    np.testing.assert_array_equal(tn.v_matrix(), jn.v_matrix())
    np.testing.assert_array_equal(tn.z_matrix(), jn.z_matrix())
    for k in range(1, 9):
        np.testing.assert_array_equal(tn.t_matrix(k, 2, 2),
                                      jn.t_matrix(k, 2, 2))
    assert tn.avg_rate == jn.avg_rate


def test_schedule_and_phase_agree():
    js, ts = jh.MLLSchedule(tau=3, q=2), th.MLLSchedule(tau=3, q=2)
    for k in range(1, 20):
        assert ts.phase(k) == js.phase(k)
        assert tprotocol.phase_of(k, 3, 2) == int(jprotocol.phase_of(
            jnp.int32(k), 3, 2))


@pytest.mark.parametrize("policy", ["barrier", "deadline", "gossip"])
@pytest.mark.parametrize("rate_model", ["bernoulli", "deterministic"])
def test_plans_and_traces_equal_given_the_same_generator(policy, rate_model,
                                                         tmp_path):
    args = ("ring", (2, 2, 2), None, (1.0, 0.8, 1.0, 0.6, 0.9, 0.5))
    jn, tn = _build(jh, *args), _build(th, *args)
    jp = jtl.get_policy(policy).plan(jn, jh.MLLSchedule(2, 2), 24,
                                     np.random.default_rng(5),
                                     rate_model=rate_model)
    tp = ttl.get_policy(policy).plan(tn, th.MLLSchedule(2, 2), 24,
                                     np.random.default_rng(5),
                                     rate_model=rate_model)
    for name in ("active", "op_ids", "busy_slots", "idle_slots",
                 "round_costs"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert tp.gate_mode == jp.gate_mode and tp.slots_used == jp.slots_used
    assert sorted((tp.op_mats or {})) == sorted((jp.op_mats or {}))
    for s, m in (jp.op_mats or {}).items():
        np.testing.assert_array_equal(tp.op_mats[s], m)
    meta = dict(policy=policy, rate_model=rate_model)
    assert ttl.plan_trace(tp, **meta) == jtl.plan_trace(jp, **meta)
    # a trace the port exports is read by the JAX package
    path = ttl.export_trace(str(tmp_path / "t.json"), tp, **meta)
    assert jtl.load_trace(path) == json.loads(json.dumps(
        jtl.plan_trace(jp, **meta)))


def test_measured_rates_and_calibration_round_trip(tmp_path):
    calib = ttl.RateCalibration(step_times=(0.2, 0.4, 0.2, 0.8))
    jcalib = jtl.RateCalibration(step_times=(0.2, 0.4, 0.2, 0.8))
    np.testing.assert_array_equal(calib.rates, jcalib.rates)
    assert calib.to_json() == jcalib.to_json()
    path = calib.save(str(tmp_path / "c.json"))
    assert jtl.RateCalibration.load(path) == jcalib
    net = _build(th, "ring", (2, 2), None, None)
    assert list(ttl.network_with_rates(net, calib.rates).worker_rates) == \
        list(calib.rates)
    with pytest.raises(ValueError, match="rates"):
        ttl.network_with_rates(net, np.array([1.0, 0.0, 1.0, 1.0]))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_gate_draws_are_jax_random_bit_for_bit(seed):
    """`prng.uniform(fold_in(prng_key(seed), step), W)` equals
    ``jax.random.uniform(fold_in(PRNGKey(seed), step), (W,))`` bit for bit,
    and so does the gate."""
    rates = np.array([1.0, 0.8, 1.0, 0.6, 0.3, 0.95, 0.5], np.float32)
    for step in (1, 2, 3, 17, 1000, 123457):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        for w in (1, 4, 7, 33):
            want = np.asarray(jax.random.uniform(key, (w,), jnp.float32))
            got = prng.uniform(prng.fold_in(prng.prng_key(seed), step), w)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
        theta = tprotocol.gate_sample(seed, step, torch.from_numpy(rates))
        want = jprotocol.gate_sample(seed, jnp.int32(step),
                                     jnp.asarray(rates))
        np.testing.assert_array_equal(theta.numpy(), np.asarray(want))
