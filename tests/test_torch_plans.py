"""The plans the benchmark times are the plans the CPU tests hold against
the JAX package and the oracles: each ``h100bench/queries/<q>.mplan``
equals ``torch_plans.PLAN_<Q>`` byte for byte.  The benchmark keeps its own
frozen copies; this test reads them and writes nothing."""

import os

import pytest

import torch_plans

QUERIES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100bench", "queries")


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6", "q9", "q13", "q17"])
def test_benchmark_plan_is_the_tests_plan(q):
    with open(os.path.join(QUERIES, f"{q}.mplan"), "rb") as f:
        frozen = f.read()
    assert frozen == getattr(torch_plans, f"PLAN_{q.upper()}").encode()
