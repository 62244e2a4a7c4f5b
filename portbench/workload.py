"""The general traffic generator: reads a mix from `traffic/<name>.json`
and gives each client its requests, drawn from the seed.

A mix names its loop kind (`loops/<kind>.py`), its number of clients and
the lognormal laws of prompt and output lengths (median, sigma, clip).
Every seed gets the same set of sizes: `sizes` stratified quantiles of
each law, clipped, cut into `clients` bands of neighbouring sizes.  A
client's j-th request takes its output length from band (c + j) and
its prompt length from band (3 c + 5 j), modulo the bands, so the first
few requests of the clients together cover every band, whatever the
seed; the seed picks the size inside each band, and draws the token
ids.  So two seeds do nearly the same work in a window in another
order, and a run's spread is the system's, not the draw's.  Client c's
first request is cut to a share (c + 1) / clients of its output length,
so the first requests end one after another, as in a loop that has run
for a while.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Iterator, List

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str, overrides: dict = None) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    for key, val in (overrides or {}).items():
        if isinstance(val, dict):
            mix[key] = {**mix[key], **val}
        else:
            mix[key] = val
    return mix


def sizes(law: dict, n: int) -> List[int]:
    """n stratified quantiles of a clipped lognormal law, in order."""
    nd = NormalDist()
    mu, sigma = math.log(law["median"]), law.get("sigma", 0.0)
    out = []
    for i in range(n):
        x = math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(x), law["min"]), law["max"])))
    return out


@dataclass
class Plan:
    """One request of a client."""
    client: int
    prompt: np.ndarray          # int32 token ids
    max_new_tokens: int


def client_plans(mix: dict, seed: int, vocab: int) -> List[Iterator[Plan]]:
    """One endless iterator of requests per client, all from `seed`."""
    n, clients = mix["sizes"], mix["clients"]
    bands = [_bands(sizes(mix[k], n), clients)
             for k in ("prompt_tokens", "output_tokens")]
    return [_client(c, *bands, clients, seed, vocab, mix)
            for c in range(clients)]


def _bands(values: List[int], k: int) -> List[List[int]]:
    per = -(-len(values) // k)
    return [values[i * per:(i + 1) * per] for i in range(k)]


def _client(c: int, prompts, outputs, clients: int, seed: int,
            vocab: int, mix: dict) -> Iterator[Plan]:
    rng = np.random.default_rng([seed, 1, c])
    j = 0
    while True:
        p_band = prompts[(3 * c + 5 * j) % len(prompts)]
        o_band = outputs[(c + j) % len(outputs)]
        out = o_band[rng.integers(len(o_band))]
        if j == 0 and mix.get("first_request") == "staggered":
            out = max(1, round(out * (c + 1) / clients))
        ids = rng.integers(0, vocab, p_band[rng.integers(len(p_band))],
                           dtype=np.int64)
        yield Plan(c, ids.astype(np.int32), int(out))
        j += 1


def prefill_step_share(mix: dict, chunk: int) -> float:
    """Share of the steps of a full batch that carry a prefill call, from
    the sizes alone: each request prefills ceil(prompt / chunk) chunks
    over the steps of its output, and the clients' calls rarely meet."""
    n = mix["sizes"]
    chunks = sum(math.ceil(p / chunk) for p in sizes(mix["prompt_tokens"], n))
    steps = sum(sizes(mix["output_tokens"], n))
    return mix["clients"] * chunks / steps
