"""Webster parity: the port's webster_plain (the plain version of K4,
karmada_tpu_torch/ops/csrc/webster_batch.cu) equals the JAX package's
webster_divide_batch and its serial ops/webster.py golden path, exactly,
on the cases and seeds of tests/test_solver_webster.py and on K4's
card-test cases."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.ops.solver import webster_divide_batch
from karmada_tpu.ops.webster import allocate_webster_seats, dispense_by_weight
from karmada_tpu_torch.ops.solver import webster_batch, webster_plain


def _problem(n, votes, init=None, descending=False, pad_to=None):
    names = sorted(set(votes) | set(init or {}))
    C = pad_to or len(names)
    w = np.zeros(C, np.int64)
    s0 = np.zeros(C, np.int64)
    active = np.zeros(C, bool)
    order = sorted(names, reverse=descending)
    rank = np.zeros(C, np.int64)
    for i, name in enumerate(names):
        w[i] = votes.get(name, 0)
        s0[i] = (init or {}).get(name, 0)
        active[i] = True
        rank[i] = order.index(name)
    rank[len(names):] = np.arange(len(names), C)
    return names, (np.int64(n), w, s0, active, rank)


def _both(problems):
    """Seats per problem from JAX webster_divide_batch and the port's
    webster_plain on one stacked batch (problems share a lane count)."""
    cols = [np.stack([p[k] for p in problems]) for k in range(5)]
    jax_seats = np.asarray(webster_divide_batch(*map(jnp.asarray, cols)))
    port = webster_plain(*map(torch.from_numpy, cols)).numpy()
    return jax_seats, port


def _serial(n, votes, init=None, descending=False):
    return {p.name: p.seats
            for p in allocate_webster_seats(n, votes, init, descending)}


CASES = [
    ("proportional", 7, {"a": 100, "b": 50, "c": 25}, None, False),
    ("ties_asc", 4, {"a": 10, "b": 10, "c": 10}, None, False),
    ("ties_desc", 4, {"a": 10, "b": 10, "c": 10}, None, True),
    ("initial_kept", 4, {"a": 5, "b": 5}, {"a": 3, "c": 2}, False),
    # a zero total weight awards nothing (dispense_by_weight semantics)
    ("zero_weight", 5, {"a": 0, "b": 0}, {"a": 2}, False),
    ("zero_seats", 0, {"a": 7, "b": 3}, {"a": 1}, False),
    ("single_party", 9, {"solo": 1}, None, False),
    ("large_seat_count", 100_000, {"a": 997, "b": 601, "c": 89, "d": 11},
     None, False),
    ("large_init_regression", 200, {"a": 1000, "b": 1}, {"a": 100}, False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_golden_cases(case):
    _, n, votes, init, desc = case
    names, prob = _problem(n, votes, init, desc, pad_to=16)
    jax_seats, port = _both([prob])
    assert np.array_equal(port, jax_seats)
    want = (dict(init, b=0) if case[0] == "zero_weight"
            else _serial(n, votes, init, desc))
    for i, nm in enumerate(names):
        assert port[0, i] == want.get(nm, 0), (nm, port[0], want)
    assert (port[0, len(names):] == 0).all()  # padding lanes inert


def _random_property_problem(seed):
    rng = random.Random(seed)
    n_parties = rng.randint(1, 12)
    names = [f"c{i:02d}" for i in range(n_parties)]
    if rng.random() < 0.5:
        pool = [rng.randint(0, 20) for _ in range(3)]
        votes = {nm: rng.choice(pool) for nm in names}
    else:
        votes = {nm: rng.randint(0, 10_000) for nm in names}
    init = {}
    if rng.random() < 0.5:
        for nm in rng.sample(names, rng.randint(0, n_parties)):
            init[nm] = rng.randint(0, 5)
    return rng.randint(0, 200), votes, init, rng.random() < 0.5


def _random_large_init_problem(seed):
    rng = random.Random(1000 + seed)
    names = [f"c{i}" for i in range(rng.randint(1, 6))]
    votes = {nm: rng.randint(0, 5000) for nm in names}
    init = {nm: rng.randint(0, 500)
            for nm in rng.sample(names, rng.randint(1, len(names)))}
    return rng.randint(0, 800), votes, init, False


@pytest.mark.parametrize("family,seeds", [
    ("property_random", range(30)), ("property_large_init", range(8))])
def test_random_families(family, seeds):
    make = (_random_property_problem if family == "property_random"
            else _random_large_init_problem)
    specs = [make(s) for s in seeds]
    probs = [_problem(n, v, i, d, pad_to=16) for n, v, i, d in specs]
    jax_seats, port = _both([p for _, p in probs])
    assert np.array_equal(port, jax_seats)
    for (n, votes, init, desc), (names, _), row in zip(specs, probs, port):
        want = _serial(n, votes, init, desc)
        for i, nm in enumerate(names):
            assert row[i] == want.get(nm, 0), (n, votes, init, desc)


def test_batch_against_dispense():
    B, C = 8, 6
    rng = np.random.default_rng(0)
    n = rng.integers(0, 50, size=B).astype(np.int64)
    w = rng.integers(0, 100, size=(B, C)).astype(np.int64)
    s0 = rng.integers(0, 3, size=(B, C)).astype(np.int64)
    active = np.ones((B, C), bool)
    rank = np.tile(np.arange(C, dtype=np.int64), (B, 1))
    seats = webster_plain(*map(torch.from_numpy, (n, w, s0, active, rank)))
    jax_seats = np.asarray(webster_divide_batch(
        *map(jnp.asarray, (n, w, s0, active, rank))))
    assert np.array_equal(seats.numpy(), jax_seats)
    names = [f"c{i}" for i in range(C)]
    for b in range(B):
        votes = {names[i]: int(w[b, i]) for i in range(C)}
        init = {names[i]: int(s0[b, i]) for i in range(C) if s0[b, i]}
        want = dispense_by_weight(int(n[b]), votes, init, "")
        for i, nm in enumerate(names):
            expect = (want.get(nm, init.get(nm, 0)) if want
                      else init.get(nm, 0))
            assert int(seats[b, i]) == expect


def test_wrapper_takes_plain_version_on_cpu():
    """webster_batch on CPU tensors is webster_plain (the kernel runs only
    for CUDA tensors)."""
    _, prob = _problem(11, {"a": 3, "b": 5, "c": 8}, pad_to=8)
    cols = [torch.from_numpy(np.asarray(x)[None]) for x in prob]
    assert torch.equal(webster_batch(*cols), webster_plain(*cols))


@pytest.mark.parametrize("name", S.WEBSTER_CASES)
def test_kernel_cases_plain_matches_jax(name):
    """webster_plain equals JAX webster_divide_batch on K4's card-test
    cases (tests/torch_scenarios.webster_case, CPU-sized): the main path's
    layouts and the contract's edges (caps, equal weights, many seats of a
    lane in one tie block, inactive rows, ranks beyond the lane count)."""
    cols = S.webster_case(name, small=True)
    jax_seats = np.asarray(webster_divide_batch(*map(jnp.asarray, cols)))
    port = webster_plain(*map(torch.from_numpy, cols)).numpy()
    assert np.array_equal(port, jax_seats)

