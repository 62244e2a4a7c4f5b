"""Data-parallel fleet serving: N engine replicas behind one router
(PyTorch port of `repro.fleet`).

`FleetRouter` owns the replicas (router.py), `Replica` wraps one
engine + driver with lock-free routing state (replica.py), and the
dispatch policies live in policy.py.  The API gateway builds a router
(or wraps a single engine in a one-replica fleet) and speaks only to
it — see repro_torch.api.gateway.  On one card the replicas share the
packed weights; each keeps its own KV pool, CUDA graphs and stream.
"""
from .policy import (LeastLoadedPolicy, Policy, PrefixAffinityPolicy,
                     RoundRobinPolicy, make_policy)
from .replica import Replica
from .router import FleetRouter, aggregate_histograms, aggregate_summaries

__all__ = [
    "FleetRouter", "Replica", "Policy", "RoundRobinPolicy",
    "LeastLoadedPolicy", "PrefixAffinityPolicy", "make_policy",
    "aggregate_summaries", "aggregate_histograms",
]
